"""PPO on one device: rollout, batched critic, GAE, minibatch epochs.

Per learning iteration:

- rollout: ``nr_steps`` env steps with the policy sampling from a device
  ``torch.Generator`` (the env is stepped in place on the device);
- values and next values from ONE batched critic call over ``[T*B]`` rows
  each (critic parameters are constant during the rollout);
- GAE over ``[T, B]`` (the CUDA kernel on the card);
- step-major flatten, the five update arrays packed into one ``[T*B, D]``
  matrix, each epoch's permutation applied as a single row gather, and
  minibatches taken as contiguous slices;
- per-minibatch advantage normalization, the clipped PPO loss, a global-norm
  gradient clip and Adam, separately for the policy and the critic, with the
  learning rate annealed linearly on the optimizer step count.

The three phases run under ``torch.profiler.record_function`` spans
(``ppo/rollout``, ``ppo/advantages``, ``ppo/update``), which cost nothing
measurable without an active profiler and give a trace its per-phase host
time.

The optimizer matches ``optax.chain(clip_by_global_norm(max_grad_norm),
inject_hyperparams(adam)(lr=schedule))``: gradients are scaled by
``max_norm / norm`` only when ``norm >= max_norm``, Adam uses eps=1e-8, and
the learning rate is evaluated from the step count before each step.
"""

import time

import torch
from torch.profiler import record_function

from rlx_tpu_torch.algorithms.ppo.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.train_state import clip_by_global_norm_
from rlx_tpu_torch.models.policy_factory import make_critic, make_policy
from rlx_tpu_torch.ops.gae import gae_advantages
from rlx_tpu_torch.utils.logging import MetricsLogger, rlx_logger


class PPO:
    def __init__(self, config, train_env, eval_env, run_path=None, writer=None):
        self.config = config
        self.train_env = train_env
        self.eval_env = eval_env
        self.device = train_env.device

        a = config.algorithm
        self.seed = config.environment.seed
        self.total_timesteps = int(a.total_timesteps)
        self.nr_envs = config.environment.nr_envs
        self.learning_rate = a.learning_rate
        self.anneal_learning_rate = a.anneal_learning_rate
        self.nr_steps = a.nr_steps
        self.nr_epochs = a.nr_epochs
        self.minibatch_size = a.minibatch_size
        self.gamma = a.gamma
        self.gae_lambda = a.gae_lambda
        self.clip_range = a.clip_range
        self.entropy_coef = a.entropy_coef
        self.critic_coef = a.critic_coef
        self.max_grad_norm = a.max_grad_norm
        self.logging_active = a.logging_active

        self.batch_size = self.nr_envs * self.nr_steps
        self.nr_updates = self.total_timesteps // self.batch_size
        self.nr_minibatches = self.batch_size // self.minibatch_size
        if self.nr_minibatches * self.minibatch_size != self.batch_size:
            raise ValueError("minibatch_size must divide nr_envs * nr_steps")

        self.logger = MetricsLogger(config.runner.track_console)
        rlx_logger.info(f"Using device: {self.device}")

        # parameters are initialized on the CPU from the seed, then moved
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            self.policy = make_policy(config, train_env, "cpu")
            self.critic = make_critic(config, train_env, "cpu")
        self.policy.module.to(self.device)
        self.critic.to(self.device)
        self.policy_optimizer = torch.optim.Adam(
            self.policy.module.parameters(), lr=self.learning_rate, eps=1e-8
        )
        self.critic_optimizer = torch.optim.Adam(
            self.critic.parameters(), lr=self.learning_rate, eps=1e-8
        )
        self.nr_optimizer_steps = 0
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.env_state = None
        self.metrics_history = []  # per-iteration float metrics when logging is active

    def learning_rate_at(self, count):
        """Learning rate for the update that follows ``count`` updates."""
        if not self.anneal_learning_rate:
            return self.learning_rate
        fraction = 1.0 - (count // (self.nr_minibatches * self.nr_epochs)) / max(self.nr_updates, 1)
        return self.learning_rate * fraction

    # ------------------------------------------------------------------ train

    @torch.no_grad()
    def _rollout(self, env_state):
        T = self.nr_steps
        observations, final_observations, actions, rewards, terminations, log_probs = (
            [] for _ in range(6)
        )
        info_sums = None
        for _ in range(T):
            observation = env_state.observation
            action, log_prob = self.policy.sample_and_log_prob(observation, self.generator)
            env_state = self.train_env.step(env_state, self.policy.process_action(action))
            observations.append(observation)
            final_observations.append(env_state.final_observation)
            actions.append(action)
            rewards.append(env_state.reward)
            terminations.append(env_state.terminated)
            log_probs.append(log_prob)
            if info_sums is None:
                info_sums = {k: v.float().sum() for k, v in env_state.info.items()}
            else:
                for k, v in env_state.info.items():
                    info_sums[k] = info_sums[k] + v.float().sum()
        stack = lambda xs: torch.stack(xs)
        batch = tuple(stack(x) for x in (observations, final_observations, actions, rewards,
                                        terminations, log_probs))
        infos = {k: v / (T * self.nr_envs) for k, v in info_sums.items()}
        return env_state, batch, infos

    def learning_iteration(self, env_state):
        """One rollout + GAE + minibatch-epochs update; returns the new env
        state and the iteration's metrics (device scalars)."""
        with record_function("ppo/rollout"):
            env_state, batch, infos = self._rollout(env_state)
        observations, final_observations, actions, rewards, terminations, log_probs = batch
        T, B = rewards.shape

        with torch.no_grad(), record_function("ppo/advantages"):
            values = self.critic(observations.reshape(T * B, -1)).reshape(T, B)
            next_values = self.critic(final_observations.reshape(T * B, -1)).reshape(T, B)
            advantages, returns = gae_advantages(
                rewards, values, next_values, terminations, self.gamma, self.gae_lambda
            )

        flat = lambda x: x.reshape((T * B,) + x.shape[2:])
        with record_function("ppo/update"):
            metrics = self._optimize(
                (flat(observations), flat(actions), flat(log_probs), flat(returns), flat(advantages))
            )
        metrics["v_value/explained_variance"] = 1.0 - torch.var(returns - values, unbiased=False) / (
            torch.var(returns, unbiased=False) + 1e-8
        )
        metrics["policy/std_dev"] = torch.exp(self.policy.module.policy_logstd.detach()).mean()
        return env_state, {**infos, **metrics}

    def _loss(self, obs_mb, action_mb, log_prob_mb, return_mb, advantage_mb):
        new_log_prob, entropy = self.policy.log_prob_entropy(obs_mb, action_mb)
        logratio = new_log_prob - log_prob_mb
        ratio = torch.exp(logratio)
        approx_kl = ((ratio - 1.0) - logratio).mean()
        clip_fraction = (torch.abs(ratio - 1.0) > self.clip_range).float().mean()

        pg_loss1 = -advantage_mb * ratio
        pg_loss2 = -advantage_mb * torch.clamp(ratio, 1.0 - self.clip_range, 1.0 + self.clip_range)
        pg_loss = torch.maximum(pg_loss1, pg_loss2).mean()
        entropy_loss = entropy.mean()

        new_value = self.critic(obs_mb).squeeze(-1)
        critic_loss = (0.5 * (new_value - return_mb) ** 2).mean()

        loss = pg_loss - self.entropy_coef * entropy_loss + self.critic_coef * critic_loss
        metrics = {
            "loss/policy_gradient_loss": pg_loss,
            "loss/critic_loss": critic_loss,
            "loss/entropy_loss": entropy_loss,
            "policy_ratio/approx_kl": approx_kl,
            "policy_ratio/clip_fraction": clip_fraction,
        }
        return loss, metrics

    def _optimize(self, batch_arrays, epoch_indices=None):
        """Minibatch-epochs PPO-Clip update over a flat batch.

        ``epoch_indices`` ([nr_epochs, batch]) are the per-epoch
        permutations; drawn from ``self.generator`` when not given."""
        batch_observations, batch_actions, batch_log_probs, batch_returns, batch_advantages = batch_arrays
        N = self.batch_size
        if epoch_indices is None:
            epoch_indices = torch.stack([
                torch.randperm(N, generator=self.generator, device=self.device)
                for _ in range(self.nr_epochs)
            ])
        obs_dim = batch_observations.shape[1]
        action_dim = batch_actions.shape[1]
        packed = torch.cat(
            [batch_observations, batch_actions, batch_log_probs[:, None],
             batch_returns[:, None], batch_advantages[:, None]],
            dim=1,
        )
        policy_params = list(self.policy.module.parameters())
        critic_params = list(self.critic.parameters())
        history = []
        lr = self.learning_rate
        for idx_e in epoch_indices:
            shuffled = packed[idx_e.to(self.device)]
            for m in range(self.nr_minibatches):
                mb = shuffled[m * self.minibatch_size:(m + 1) * self.minibatch_size]
                obs_mb = mb[:, :obs_dim]
                action_mb = mb[:, obs_dim:obs_dim + action_dim]
                log_prob_mb = mb[:, obs_dim + action_dim]
                return_mb = mb[:, obs_dim + action_dim + 1]
                adv_mb = mb[:, obs_dim + action_dim + 2]
                adv_mb = (adv_mb - adv_mb.mean()) / (adv_mb.std(unbiased=False) + 1e-8)

                self.policy_optimizer.zero_grad(set_to_none=False)
                self.critic_optimizer.zero_grad(set_to_none=False)
                loss, metrics = self._loss(obs_mb, action_mb, log_prob_mb, return_mb, adv_mb)
                loss.backward()
                with torch.no_grad():
                    metrics["gradients/policy_grad_norm"] = clip_by_global_norm_(
                        [p.grad for p in policy_params], self.max_grad_norm
                    )
                    metrics["gradients/critic_grad_norm"] = clip_by_global_norm_(
                        [p.grad for p in critic_params], self.max_grad_norm
                    )
                lr = self.learning_rate_at(self.nr_optimizer_steps)
                for optimizer in (self.policy_optimizer, self.critic_optimizer):
                    optimizer.param_groups[0]["lr"] = lr
                    optimizer.step()
                self.nr_optimizer_steps += 1
                history.append({k: v.detach() for k, v in metrics.items()})
        out = {k: torch.stack([h[k] for h in history]).mean() for k in history[0]}
        out["lr/learning_rate"] = torch.tensor(lr)
        return out

    def train(self):
        if self.env_state is None:
            self.env_state = self.train_env.reset(self.seed)
        start = last = time.time()
        for iteration in range(self.nr_updates):
            self.env_state, metrics = self.learning_iteration(self.env_state)
            if self.logging_active:
                values = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                values["time/sps"] = int(self.batch_size / max(now - last, 1e-9))
                last = now
                values["steps/nr_env_steps"] = (iteration + 1) * self.batch_size
                values["steps/nr_updates"] = self.nr_optimizer_steps
                self.metrics_history.append(values)
                self.logger.log_dict(values, (iteration + 1) * self.batch_size)
        rlx_logger.info(f"Average time: {time.time() - start:.2f} s")

    def general_properties():
        return GeneralProperties
