"""PPO with a recurrent policy, shared by ``ppo_lstm``, ``ppo_gru``,
``ppo_mamba2`` and ``ppo_transformer`` (the JAX package's
``algorithms/recurrent_ppo.py``).

Per learning iteration:

- rollout: ``nr_steps`` env steps of ``policy.one_step``, sampling from
  the algorithm's device ``torch.Generator``; the carry is zeroed per env
  after a step that ends its episode (terminated or truncated), and the
  carry at the start of the window is kept for the update;
- values and next values from one batched critic call each (the critic is
  feedforward), GAE over ``[T, E]`` (kernel B1 on the card);
- ``nr_epochs`` permutations of the env axis, each split into
  ``nr_minibatches`` minibatches of envs with the time axis intact; per
  minibatch one loss: the policy's ``sequence`` re-run over the window
  from the saved start carry (the carry zeroed before a step that follows
  a done), the clipped PPO objective on advantages normalized over the
  minibatch (population std), the entropy bonus and the critic's squared
  error; a global-norm clip and Adam for each net, the learning rate
  annealed on the optimizer step count (``nr_minibatches * nr_epochs`` a
  learning iteration).

Evaluation runs ``horizon`` steps of the mean action from a fresh eval
reset and a fresh carry; ``save``, ``load`` and ``test`` follow the JAX
package's (checkpoint ``policy`` and ``critic``, with the optimizer state
when ``runner.save_optimizer_state`` is set).  Every draw can be given to
``learning_iteration``: the rollout's action normals and the epochs' env
permutations.  Parallel seeds are not ported (``nr_parallel_seeds`` above
1 raises).  The phases run under ``record_function`` spans
``recurrent_ppo/rollout``, ``/advantages``, ``/update`` and ``/eval``.
"""

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from rlx_tpu_torch.algorithms.evaluation import collect_test_returns
from rlx_tpu_torch.algorithms.train_state import (
    clip_by_global_norm_, load_module_state_dict, module_state_dict,
)
from rlx_tpu_torch.algorithms.training_program import run_training_program, train_reset_seed
from rlx_tpu_torch.models import distributions as D
from rlx_tpu_torch.models.policy_factory import make_critic
from rlx_tpu_torch.models.recurrent import RecurrentPolicy, map_carry, mask_carry
from rlx_tpu_torch.ops.gae import gae_advantages
from rlx_tpu_torch.utils import checkpoint as ckpt
from rlx_tpu_torch.utils.logging import MetricsLogger, rlx_logger


class RecurrentPPO:
    cell_type = "lstm"   # set by each registered subclass

    def __init__(self, config, train_env, eval_env, run_path=None, writer=None):
        self.config = config
        self.train_env = train_env
        self.eval_env = eval_env
        self.device = train_env.device

        a = config.algorithm
        if int(a.nr_parallel_seeds) > 1:
            raise NotImplementedError("nr_parallel_seeds > 1 is not ported (ROADMAP Queue A item 19, scale-out)")
        self.save_model = config.runner.save_model
        self.save_path = ckpt.save_path_for(config, run_path)
        self.seed = config.environment.seed
        self.total_timesteps = int(a.total_timesteps)
        self.nr_envs = config.environment.nr_envs
        self.learning_rate = a.learning_rate
        self.anneal_learning_rate = a.anneal_learning_rate
        self.nr_steps = a.nr_steps
        self.nr_epochs = a.nr_epochs
        self.nr_minibatches = a.nr_minibatches
        self.gamma = a.gamma
        self.gae_lambda = a.gae_lambda
        self.clip_range = a.clip_range
        self.entropy_coef = a.entropy_coef
        self.critic_coef = a.critic_coef
        self.max_grad_norm = a.max_grad_norm
        self.logging_active = a.logging_active
        self.evaluation_active = a.evaluation_active

        if self.nr_envs % self.nr_minibatches != 0:
            raise ValueError("nr_minibatches must divide nr_envs: minibatches are taken over envs")
        self.nr_minibatch_envs = self.nr_envs // self.nr_minibatches
        self.batch_size = self.nr_envs * self.nr_steps
        self.nr_updates = max(self.total_timesteps // self.batch_size, 1)
        self.eval_save_frequency = a.evaluation_and_save_frequency
        if self.eval_save_frequency == -1:
            self.eval_save_frequency = self.batch_size * self.nr_updates
        if self.eval_save_frequency % self.batch_size != 0:
            raise ValueError("evaluation_and_save_frequency must be a multiple of nr_envs * nr_steps")
        self.nr_eval_save_iterations = max(self.total_timesteps // self.eval_save_frequency, 1)
        self.nr_updates_per_eval_save_iteration = self.eval_save_frequency // self.batch_size
        self.horizon = train_env.horizon

        self.logger = MetricsLogger(config.runner.track_console)
        rlx_logger.info(f"Using device: {self.device}")

        obs_dim = math.prod(train_env.single_observation_space.shape)
        action_dim = math.prod(train_env.single_action_space.shape)
        # parameters are initialized on the CPU from the seed, then moved
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            self.policy = RecurrentPolicy(
                obs_dim, action_dim, cell_type=self.cell_type, std_dev=a.std_dev,
                obs_encoding_dim=a.obs_encoding_dim, hidden_dim=a.rnn_hidden_dim,
                combine_method=a.rnn_obs_combine_method, share_encoder=a.share_rnn_obs_encoder,
                observation_indices=getattr(train_env, "policy_observation_indices", None),
                cell_state_dim=a.get("cell_state_dim", 16), cell_conv_kernel=a.get("cell_conv_kernel", 4),
                cell_context_len=a.get("tf_context_len", 16), cell_nr_heads=a.get("tf_nr_heads", 4),
                cell_nr_blocks=a.get("tf_nr_blocks", 2),
            )
            self.critic = make_critic(config, train_env, "cpu")
        self.policy.to(self.device)
        self.critic.to(self.device)
        self.policy_optimizer = torch.optim.Adam(self.policy.parameters(), lr=self.learning_rate, eps=1e-8)
        self.critic_optimizer = torch.optim.Adam(self.critic.parameters(), lr=self.learning_rate, eps=1e-8)
        self.nr_optimizer_steps = 0

        if a.action_clipping_and_rescaling:
            low, high = train_env.single_action_space.low, train_env.single_action_space.high
            self.process_action = lambda action: low + 0.5 * (torch.clamp(action, -1.0, 1.0) + 1.0) * (high - low)
        else:
            self.process_action = lambda action: action

        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        # seeds of the eval and test resets
        self.host_generator = torch.Generator().manual_seed(self.seed)
        self.env_state = None
        self.policy_carry = None
        self.nr_train_resets = 0
        self.metrics_history = []  # per-iteration float metrics when logging is active
        self.eval_history = None

    def learning_rate_at(self, count):
        """Learning rate for the update that follows ``count`` updates."""
        if not self.anneal_learning_rate:
            return self.learning_rate
        return self.learning_rate * (1.0 - (count // (self.nr_minibatches * self.nr_epochs)) / self.nr_updates)

    # ------------------------------------------------------------------ train

    @torch.no_grad()
    def _rollout(self, env_state, policy_carry, noise=None):
        """-> (env state, carry after the window, [T, E] batch, info means)."""
        observations, final_observations, actions, rewards, terminations, dones, log_probs = ([] for _ in range(7))
        info_sums = None
        for t in range(self.nr_steps):
            observation = env_state.observation
            mean, logstd, next_carry = self.policy.one_step(observation, policy_carry)
            action = D.gaussian_sample(mean, logstd, self.generator, None if noise is None else noise[t])
            env_state = self.train_env.step(env_state, self.process_action(action))
            done = env_state.terminated | env_state.truncated
            policy_carry = mask_carry(next_carry, done)
            observations.append(observation)
            final_observations.append(env_state.final_observation)
            actions.append(action)
            rewards.append(env_state.reward)
            terminations.append(env_state.terminated)
            dones.append(done)
            log_probs.append(D.gaussian_log_prob(mean, logstd, action))
            sums = {k: v.float().sum() for k, v in env_state.info.items()}
            info_sums = sums if info_sums is None else {k: info_sums[k] + v for k, v in sums.items()}
        batch = tuple(torch.stack(x) for x in (observations, final_observations, actions, rewards, terminations,
                                               dones, log_probs))
        infos = {k: v / (self.nr_steps * self.nr_envs) for k, v in info_sums.items()}
        return env_state, policy_carry, batch, infos

    @torch.no_grad()
    def _advantages(self, observations, final_observations, rewards, terminations):
        """-> (values, advantages, returns), each ``[T, E]``."""
        T, E = rewards.shape
        values = self.critic(observations.reshape(T * E, -1)).reshape(T, E)
        next_values = self.critic(final_observations.reshape(T * E, -1)).reshape(T, E)
        advantages, returns = gae_advantages(rewards, values, next_values, terminations, self.gamma, self.gae_lambda)
        return values, advantages, returns

    def learning_iteration(self, env_state, policy_carry, noise=None, env_indices=None):
        """One rollout + GAE + minibatch-epochs update from ``policy_carry``;
        returns the new env state, the carry after the window and the
        iteration's metrics (device scalars).  ``noise`` ``[T, E, A]`` and
        ``env_indices`` ``[nr_epochs * nr_minibatches, E / nr_minibatches]``
        are drawn from the generator unless given."""
        init_carry = policy_carry
        with record_function("recurrent_ppo/rollout"):
            env_state, policy_carry, batch, infos = self._rollout(env_state, policy_carry, noise)
        observations, final_observations, actions, rewards, terminations, dones, log_probs = batch
        with record_function("recurrent_ppo/advantages"):
            values, advantages, returns = self._advantages(observations, final_observations, rewards, terminations)
        with record_function("recurrent_ppo/update"):
            metrics = self._optimize((observations, actions, log_probs, returns, advantages, dones), init_carry,
                                     env_indices)
        metrics["v_value/explained_variance"] = 1.0 - torch.var(returns - values, unbiased=False) / (
            torch.var(returns, unbiased=False) + 1e-8)
        metrics["policy/std_dev"] = torch.exp(self.policy.policy_logstd.detach()).mean()
        return env_state, policy_carry, {**infos, **metrics}

    def _loss(self, obs_seq, action_seq, log_prob_seq, return_seq, advantage_seq, done_seq, init_carry):
        mean_seq, logstd_seq = self.policy.sequence(obs_seq, done_seq, init_carry)
        new_log_prob = D.gaussian_log_prob(mean_seq, logstd_seq, action_seq)
        entropy = D.gaussian_entropy(logstd_seq).expand(new_log_prob.shape)

        logratio = new_log_prob - log_prob_seq
        ratio = torch.exp(logratio)
        approx_kl = ((ratio - 1.0) - logratio).mean()
        clip_fraction = (torch.abs(ratio - 1.0) > self.clip_range).float().mean()

        pg_loss1 = -advantage_seq * ratio
        pg_loss2 = -advantage_seq * torch.clamp(ratio, 1.0 - self.clip_range, 1.0 + self.clip_range)
        pg_loss = torch.maximum(pg_loss1, pg_loss2).mean()
        entropy_loss = entropy.mean()

        new_value = self.critic(obs_seq).squeeze(-1)
        critic_loss = (0.5 * (new_value - return_seq) ** 2).mean()

        loss = pg_loss - self.entropy_coef * entropy_loss + self.critic_coef * critic_loss
        metrics = {
            "loss/policy_gradient_loss": pg_loss,
            "loss/critic_loss": critic_loss,
            "loss/entropy_loss": entropy_loss,
            "policy_ratio/approx_kl": approx_kl,
            "policy_ratio/clip_fraction": clip_fraction,
        }
        return loss, metrics

    def _optimize(self, batch, init_carry, env_indices=None):
        """Minibatch-epochs update over envs: ``batch`` = (observations,
        actions, log-probs, returns, advantages, dones), each ``[T, E, ...]``;
        ``init_carry`` the carry before the window's first step."""
        observations, actions, log_probs, returns, advantages, dones = batch
        if env_indices is None:
            env_indices = torch.stack([
                torch.randperm(self.nr_envs, generator=self.generator, device=self.device)
                for _ in range(self.nr_epochs)
            ]).reshape(self.nr_epochs * self.nr_minibatches, self.nr_minibatch_envs)
        dones = dones.to(observations.dtype)
        policy_params = list(self.policy.parameters())
        critic_params = list(self.critic.parameters())
        history = []
        lr = self.learning_rate
        for idx in env_indices.to(self.device):
            take = lambda x: x[:, idx]
            adv = take(advantages)
            adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
            self.policy_optimizer.zero_grad(set_to_none=False)
            self.critic_optimizer.zero_grad(set_to_none=False)
            loss, metrics = self._loss(take(observations), take(actions), take(log_probs), take(returns), adv,
                                       take(dones), map_carry(lambda c: c[idx], init_carry))
            loss.backward()
            with torch.no_grad():
                metrics["gradients/policy_grad_norm"] = clip_by_global_norm_(
                    [p.grad for p in policy_params], self.max_grad_norm)
                metrics["gradients/critic_grad_norm"] = clip_by_global_norm_(
                    [p.grad for p in critic_params], self.max_grad_norm)
            lr = self.learning_rate_at(self.nr_optimizer_steps)
            for optimizer in (self.policy_optimizer, self.critic_optimizer):
                optimizer.param_groups[0]["lr"] = lr
                optimizer.step()
            self.nr_optimizer_steps += 1
            history.append({k: v.detach() for k, v in metrics.items()})
        out = {k: torch.stack([h[k] for h in history]).mean() for k in history[0]}
        out["lr/learning_rate"] = torch.tensor(lr)
        return out

    # ------------------------------------------------------- eval/save loop

    @torch.no_grad()
    def _eval_iteration(self, eval_save_iteration):
        """``horizon`` steps of the mean action from a fresh eval reset and a
        fresh carry; every ``rollout/*`` info key becomes ``eval/*`` (mean
        over envs).  The train env state is not touched."""
        seed = int(torch.randint(2**31 - 1, (), generator=self.host_generator))
        with record_function("recurrent_ppo/eval"):
            eval_env_state = self.eval_env.reset(seed, eval_mode=True)
            carry = self.policy.initialize_carry(self.nr_envs)
            for _ in range(self.horizon):
                eval_env_state, carry = self._deterministic_step((eval_env_state, carry))
        eval_metrics = {
            "eval/" + k.split("rollout/", 1)[1]: float(v.float().mean())
            for k, v in eval_env_state.info.items() if k.startswith("rollout/")
        }
        if self.logging_active:
            self.logger.log_dict(eval_metrics, (eval_save_iteration + 1) * self.eval_save_frequency)
        return eval_metrics

    def _deterministic_step(self, carry):
        env_state, policy_carry = carry
        mean, _, next_carry = self.policy.one_step(env_state.observation, policy_carry)
        env_state = self.eval_env.step(env_state, self.process_action(mean))
        return env_state, mask_carry(next_carry, env_state.terminated | env_state.truncated)

    def _init_train_carry(self):
        """(env state from the reset that starts this ``train()`` call, a
        zero policy carry, best eval return)."""
        self.env_state = self.train_env.reset(train_reset_seed(self))
        self.policy_carry = self.policy.initialize_carry(self.nr_envs)
        return self.env_state, self.policy_carry, -math.inf

    def _eval_save_iteration(self, carry, eval_save_iteration):
        env_state, policy_carry, best_return = carry
        for j in range(self.nr_updates_per_eval_save_iteration):
            env_state, policy_carry, metrics = self.learning_iteration(env_state, policy_carry)
            if self.logging_active:
                iteration = eval_save_iteration * self.nr_updates_per_eval_save_iteration + j + 1
                values = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                values["time/sps"] = int(self.batch_size / max(now - self._last_log_time, 1e-9))
                self._last_log_time = now
                values["steps/nr_env_steps"] = iteration * self.batch_size
                values["steps/nr_updates"] = iteration * self.nr_epochs * self.nr_minibatches
                self.metrics_history.append(values)
                self.logger.log_dict(values, iteration * self.batch_size)
        self.env_state, self.policy_carry = env_state, policy_carry
        eval_metrics, is_best = None, False
        if self.evaluation_active:
            eval_metrics = self._eval_iteration(eval_save_iteration)
            is_best = eval_metrics["eval/episode_return"] > best_return
            best_return = max(best_return, eval_metrics["eval/episode_return"])
        if self.save_model:
            self.save()
            if is_best:
                self.save(file_name="best.model")
        return (env_state, policy_carry, best_return), eval_metrics

    def train(self):
        start = self._last_log_time = time.time()
        (self.env_state, self.policy_carry, _), eval_history = run_training_program(self)
        self.eval_history = None
        if eval_history is not None:
            steps = (np.arange(self.nr_eval_save_iterations) + 1) * self.eval_save_frequency
            self.eval_history = {"steps": steps, **eval_history}
        rlx_logger.info(f"Average time: {time.time() - start:.2f} s")

    # ----------------------------------------------------- save / load / test

    def checkpoint_tree(self):
        if self.config.runner.save_optimizer_state:
            return {"full": {
                "policy": module_state_dict(self.policy, self.policy_optimizer),
                "critic": module_state_dict(self.critic, self.critic_optimizer),
                "nr_optimizer_steps": self.nr_optimizer_steps,
            }}
        return {"policy": self.policy.state_dict(), "critic": self.critic.state_dict()}

    def restore_from_tree(self, tree):
        if "full" in tree:
            full = tree["full"]
            load_module_state_dict(full["policy"], self.policy, self.policy_optimizer)
            load_module_state_dict(full["critic"], self.critic, self.critic_optimizer)
            self.nr_optimizer_steps = full["nr_optimizer_steps"]
        else:
            self.policy.load_state_dict(tree["policy"])
            self.critic.load_state_dict(tree["critic"])

    def save(self, file_name="latest.model"):
        ckpt.save_model_file(self.save_path, file_name, self.checkpoint_tree(), self.config.algorithm.to_dict())

    @classmethod
    def load(cls, config, train_env, eval_env, run_path, writer, explicitly_set_algorithm_params):
        return ckpt.load_model(cls, config, train_env, eval_env, run_path, writer,
                               explicitly_set_algorithm_params)

    @torch.no_grad()
    def test(self, episodes):
        """Mean-action rollouts with the carry, until ``episodes`` episodes
        are done (the JAX package's ``nr_test_episodes`` semantics)."""
        seed = int(torch.randint(2**31 - 1, (), generator=self.host_generator))
        env_state = self.eval_env.reset(seed, eval_mode=True)
        carry = (env_state, self.policy.initialize_carry(self.nr_envs))
        return collect_test_returns(self._deterministic_step, carry, episodes, self.horizon,
                                    extract=lambda c: c[0])
