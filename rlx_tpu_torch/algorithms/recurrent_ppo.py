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

As PPO's, the iteration reads nothing back to the host: the step count
and the rate live on the device (``train_state.DeviceStepSchedule``), Adam
is ``train_state.adam_step_``.  So on one CUDA device it is captured as a
CUDA graph over the env state and the policy carry and replayed
(``training_program.CapturedIteration``), B1 and B2 inside it.

Evaluation runs ``horizon`` steps of the mean action from a fresh eval
reset and a fresh carry; ``save``, ``load`` and ``test`` follow the JAX
package's (checkpoint ``policy`` and ``critic``, with the optimizer state
when ``runner.save_optimizer_state`` is set).  Every draw can be given to
``learning_iteration``: the rollout's action normals and the epochs' env
permutations.  The phases run under ``record_function`` spans
``recurrent_ppo/rollout``, ``/advantages``, ``/update`` and ``/eval``.

With parallel seeds (``parallel_seeds.py``) the policy and the critic are
seed-stacked and mapped over the seeds (the LSTM and GRU cells then run
their unfused math, ``models/recurrent.py``), each seed's carry is its
envs' rows, and each seed's noise and env permutations come from its own
generator; GAE (B1) runs once over ``[T, S * N]``.

On a dp mesh (``parallel/mesh.py``) each rank steps its rows of the envs,
drawing its rows of the global action normals, and runs GAE (B1) on them;
the update gathers every rank's env rows (time intact) and their start
carries, permutes the envs as at dp = 1, and each rank takes its slice of
every minibatch's envs, with the advantages normalized over the global
minibatch and the gradients averaged over dp, so dp = k equals dp = 1 up
to the order of the reductions.
"""

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from rlx_tpu_torch.algorithms.evaluation import collect_test_returns
from rlx_tpu_torch.algorithms.parallel_seeds import (
    NoGenerator, ParallelSeeds, check_config, finish, nr_parallel_seeds, stack_modules,
)
from rlx_tpu_torch.algorithms.train_state import (
    DeviceStepSchedule, clip_by_global_norm_, load_module_state_dict, module_state_dict,
)
from rlx_tpu_torch.algorithms.training_program import (
    eval_means, eval_reset_seed, run_training_program, train_reset_seed,
)
from rlx_tpu_torch.models import distributions as D
from rlx_tpu_torch.models.policy_factory import make_critic
from rlx_tpu_torch.models.recurrent import RecurrentPolicy, map_carry, mask_carry
from rlx_tpu_torch.ops.gae import gae_advantages
from rlx_tpu_torch.utils import checkpoint as ckpt
from rlx_tpu_torch.parallel.mesh import mesh_for
from rlx_tpu_torch.utils.logging import MetricsLogger, rlx_logger


class RecurrentPPO(DeviceStepSchedule):
    cell_type = "lstm"   # set by each registered subclass
    # the learning iteration runs as a captured CUDA graph on one device
    # (``training_program.capture_choice``)
    capturable = True

    def __init__(self, config, train_env, eval_env, run_path=None, writer=None):
        self.config = config
        self.train_env = train_env
        self.eval_env = eval_env
        self.device = train_env.device

        a = config.algorithm
        check_config(config)
        self.save_model = config.runner.save_model
        self.save_path = ckpt.save_path_for(config, run_path)
        self.seed = config.environment.seed
        nr_seeds = nr_parallel_seeds(config)
        self.parallel = ParallelSeeds(self.seed, nr_seeds, self.device) if nr_seeds > 1 else None
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
        self.mesh = mesh_for(config, self.device)
        self.dp = self.mesh.dp
        if self.nr_minibatch_envs % self.dp:
            raise ValueError("a minibatch's envs must divide over the dp mesh axis")
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

        self.logger = MetricsLogger(config.runner.track_console, writer)
        rlx_logger.info(f"Using device: {self.device}")

        obs_dim = math.prod(train_env.single_observation_space.shape)
        action_dim = math.prod(train_env.single_action_space.shape)
        # parameters are initialized on the CPU from the seed, then moved
        def build():
            policy = RecurrentPolicy(
                obs_dim, action_dim, cell_type=self.cell_type, std_dev=a.std_dev,
                obs_encoding_dim=a.obs_encoding_dim, hidden_dim=a.rnn_hidden_dim,
                combine_method=a.rnn_obs_combine_method, share_encoder=a.share_rnn_obs_encoder,
                observation_indices=getattr(train_env, "policy_observation_indices", None),
                cell_state_dim=a.get("cell_state_dim", 16), cell_conv_kernel=a.get("cell_conv_kernel", 4),
                cell_context_len=a.get("tf_context_len", 16), cell_nr_heads=a.get("tf_nr_heads", 4),
                cell_nr_blocks=a.get("tf_nr_blocks", 2),
            )
            return policy, make_critic(config, train_env, "cpu")

        if self.parallel is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self.seed)
                self.policy, self.critic = build()
        else:
            built = self.parallel.init(build)
            self.policy, self.critic = (stack_modules([b[i] for b in built]) for i in range(2))
            self.policy.cell.fused = False
        self.policy.to(self.device)
        self.critic.to(self.device)
        self.policy_optimizer = torch.optim.Adam(self.policy.parameters(), lr=self.learning_rate, eps=1e-8)
        self.critic_optimizer = torch.optim.Adam(self.critic.parameters(), lr=self.learning_rate, eps=1e-8)
        self.init_optimizer_steps(self.device)

        if a.action_clipping_and_rescaling:
            low, high = train_env.single_action_space.low, train_env.single_action_space.high
            self.process_action = lambda action: low + 0.5 * (torch.clamp(action, -1.0, 1.0) + 1.0) * (high - low)
        else:
            self.process_action = lambda action: action

        if self.parallel is None:
            self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
            # seeds of the eval and test resets
            self.host_generator = torch.Generator().manual_seed(self.seed)
        else:
            self.generator = self.host_generator = NoGenerator()
        self.env_state = None
        self.policy_carry = None
        self.nr_train_resets = 0
        self.captured_iteration = None   # a train() call's CapturedIteration
        self.metrics_history = []  # per-iteration float metrics when logging is active
        self.eval_history = None

    # ----------------------------------------------------------- parallel seeds

    def _nets(self):
        return {"policy": self.policy, "critic": self.critic}

    def _seed_map(self, fn, *xs):
        """``fn`` per seed over ``[S, ...]`` inputs with that seed's nets."""
        return self.parallel.map(fn, self._nets(), *xs)

    def _split_carry(self, carry):
        return map_carry(self.parallel.split, carry)

    def _merge_carry(self, carry):
        return map_carry(self.parallel.merge, carry)

    def _step_policy(self, observation, policy_carry, noise=None):
        """(action, log-prob, next carry) of a rollout step; with parallel
        seeds each seed's noise from its own generator."""
        if self.parallel is None:
            mean, logstd, next_carry = self.policy.one_step(observation, policy_carry)
            if noise is None and self.dp > 1:
                # this rank's rows of the global draw
                noise = self.mesh.rows(torch.randn((self.nr_envs,) + mean.shape[1:], generator=self.generator,
                                                   device=self.device, dtype=mean.dtype))
            action = D.gaussian_sample(mean, logstd, self.generator, noise)
            return action, D.gaussian_log_prob(mean, logstd, action), next_carry
        P = self.parallel
        if noise is None:
            shape = (self.nr_envs,) + tuple(self.train_env.single_action_space.shape)
            dtype = self.policy.policy_logstd.dtype
            noise = P.merge(P.draw(lambda g: torch.randn(shape, generator=g, device=self.device, dtype=dtype)))

        def step(obs, carry, n):
            mean, logstd, next_carry = self.policy.one_step(obs, carry)
            action = D.gaussian_sample(mean, logstd, None, n)
            return action, D.gaussian_log_prob(mean, logstd, action), next_carry

        action, log_prob, next_carry = self._seed_map(step, P.split(observation), self._split_carry(policy_carry),
                                                      P.split(noise))
        return P.merge(action), P.merge(log_prob), self._merge_carry(next_carry)

    def _optimize_seeds(self, batch, init_carry, env_indices=None):
        """``_optimize`` for every seed at once: ``batch`` arrays ``[T, S * N,
        ...]``, ``env_indices`` ``[S, nr_epochs * nr_minibatches, N /
        nr_minibatches]`` (each seed's permutations of its own envs)."""
        P = self.parallel
        observations, actions, log_probs, returns, advantages, dones = batch
        if env_indices is None:
            env_indices = P.draw(lambda g: torch.stack([
                torch.randperm(self.nr_envs, generator=g, device=self.device) for _ in range(self.nr_epochs)
            ]).reshape(self.nr_epochs * self.nr_minibatches, self.nr_minibatch_envs))
        T = observations.shape[0]
        # [T, S * N, ...] -> [S, N, T, ...]: a seed's env rows, time intact
        by_env = lambda x: P.split(x.transpose(0, 1))
        arrays = tuple(by_env(x) for x in (observations, actions, log_probs, returns, advantages,
                                           dones.to(observations.dtype)))
        carry = self._split_carry(init_carry)
        policy_params = list(self.policy.parameters())
        critic_params = list(self.critic.parameters())
        history = []
        for m in range(env_indices.shape[1]):
            idx = env_indices[:, m].to(self.device)
            mb = tuple(P.take(x, idx).transpose(1, 2) for x in arrays)   # [S, T, envs, ...]
            mb_carry = map_carry(lambda c: P.take(c, idx), carry)
            self.policy_optimizer.zero_grad(set_to_none=False)
            self.critic_optimizer.zero_grad(set_to_none=False)
            loss, metrics = self._seed_map(self._minibatch_loss, *mb, mb_carry)
            loss.sum().backward()
            with torch.no_grad():
                metrics["gradients/policy_grad_norm"] = clip_by_global_norm_(
                    [p.grad for p in policy_params], self.max_grad_norm, per_seed=True)
                metrics["gradients/critic_grad_norm"] = clip_by_global_norm_(
                    [p.grad for p in critic_params], self.max_grad_norm, per_seed=True)
            lr = self._step_optimizers()
            history.append({k: v.detach() for k, v in metrics.items()})
        out = {k: torch.stack([h[k] for h in history]).mean(dim=0) for k in history[0]}
        out["lr/learning_rate"] = lr.float()
        return out

    def _minibatch_loss(self, obs, actions, log_probs, returns, adv, dones, init_carry):
        """One seed's minibatch loss, its advantages normalized first (over
        the global minibatch on a dp mesh)."""
        if self.dp == 1:
            adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
        else:
            mean, var = self.mesh.global_mean_var(adv)
            adv = (adv - mean) / (torch.sqrt(var) + 1e-8)
        return self._loss(obs, actions, log_probs, returns, adv, dones, init_carry)

    # ------------------------------------------------------------------ train

    @torch.no_grad()
    def _rollout(self, env_state, policy_carry, noise=None):
        """-> (env state, carry after the window, [T, E] batch, info means)."""
        observations, final_observations, actions, rewards, terminations, dones, log_probs = ([] for _ in range(7))
        info_sums = None
        for t in range(self.nr_steps):
            observation = env_state.observation
            action, log_prob, next_carry = self._step_policy(observation, policy_carry,
                                                             None if noise is None else noise[t])
            env_state = self.train_env.step(env_state, self.process_action(action))
            done = env_state.terminated | env_state.truncated
            policy_carry = mask_carry(next_carry, done)
            observations.append(observation)
            final_observations.append(env_state.final_observation)
            actions.append(action)
            rewards.append(env_state.reward)
            terminations.append(env_state.terminated)
            dones.append(done)
            log_probs.append(log_prob)
            sums = {k: v.float().sum() for k, v in env_state.info.items()}
            info_sums = sums if info_sums is None else {k: info_sums[k] + v for k, v in sums.items()}
        batch = tuple(torch.stack(x) for x in (observations, final_observations, actions, rewards, terminations,
                                               dones, log_probs))
        infos = {k: v / (self.nr_steps * self.train_env.nr_envs) for k, v in info_sums.items()}
        return env_state, policy_carry, batch, infos

    @torch.no_grad()
    def _advantages(self, observations, final_observations, rewards, terminations):
        """-> (values, advantages, returns), each ``[T, E]``."""
        T, E = rewards.shape
        if self.parallel is None:
            values = self.critic(observations.reshape(T * E, -1)).reshape(T, E)
            next_values = self.critic(final_observations.reshape(T * E, -1)).reshape(T, E)
        else:
            P = self.parallel
            values, next_values = (P.merge_time(self._seed_map(self.critic, P.split_time(x)), T).reshape(T, E)
                                   for x in (observations, final_observations))
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
        metrics["v_value/explained_variance"] = 1.0 - self.mesh.global_mean_var(returns - values)[1] / (
            self.mesh.global_mean_var(returns)[1] + 1e-8)
        metrics["policy/std_dev"] = torch.exp(self.policy.policy_logstd.detach()).mean()
        return env_state, policy_carry, self.mesh.mean_metrics({**infos, **metrics})


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
        ``init_carry`` the carry before the window's first step.  On a dp
        mesh every rank's env rows are gathered (``gather_rows``) and each
        rank takes its slice of every minibatch's envs."""
        if self.parallel is not None:
            return self._optimize_seeds(batch, init_carry, env_indices)
        if self.dp > 1:
            batch = tuple(self.mesh.gather_rows(x.transpose(0, 1).contiguous()).transpose(0, 1) for x in batch)
            init_carry = map_carry(self.mesh.gather_rows, init_carry)
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
        local = self.nr_minibatch_envs // self.dp
        for idx in env_indices.to(self.device):
            idx = idx[self.mesh.dp_rank * local:(self.mesh.dp_rank + 1) * local]
            take = lambda x: x[:, idx]
            self.policy_optimizer.zero_grad(set_to_none=False)
            self.critic_optimizer.zero_grad(set_to_none=False)
            loss, metrics = self._minibatch_loss(take(observations), take(actions), take(log_probs), take(returns),
                                                 take(advantages), take(dones), map_carry(lambda c: c[idx], init_carry))
            loss.backward()
            with torch.no_grad():
                self.mesh.all_reduce_mean_([p.grad for p in policy_params + critic_params])
                metrics["gradients/policy_grad_norm"] = clip_by_global_norm_(
                    [p.grad for p in policy_params], self.max_grad_norm)
                metrics["gradients/critic_grad_norm"] = clip_by_global_norm_(
                    [p.grad for p in critic_params], self.max_grad_norm)
            lr = self._step_optimizers()
            history.append({k: v.detach() for k, v in metrics.items()})
        out = {k: torch.stack([h[k] for h in history]).mean() for k in history[0]}
        out["lr/learning_rate"] = lr.float()
        return out

    # ------------------------------------------------------- eval/save loop

    @torch.no_grad()
    def _eval_iteration(self, eval_save_iteration):
        """``horizon`` steps of the mean action from a fresh eval reset and a
        fresh carry; every ``rollout/*`` info key becomes ``eval/*`` (mean
        over envs).  The train env state is not touched."""
        seed = eval_reset_seed(self)
        with record_function("recurrent_ppo/eval"):
            eval_env_state = self.eval_env.reset(seed, eval_mode=True)
            carry = self.policy.initialize_carry(self.eval_env.nr_envs)
            for _ in range(self.horizon):
                eval_env_state, carry = self._deterministic_step((eval_env_state, carry))
        eval_metrics = eval_means(self, eval_env_state.info)
        if self.logging_active:
            self.logger.log_dict(eval_metrics, (eval_save_iteration + 1) * self.eval_save_frequency)
        return eval_metrics

    def _deterministic_step(self, carry):
        env_state, policy_carry = carry
        if self.parallel is None:
            mean, _, next_carry = self.policy.one_step(env_state.observation, policy_carry)
        else:
            P = self.parallel
            mean, next_carry = self._seed_map(lambda o, c: self.policy.one_step(o, c)[::2], P.split(env_state.observation),
                                              self._split_carry(policy_carry))
            mean, next_carry = P.merge(mean), self._merge_carry(next_carry)
        env_state = self.eval_env.step(env_state, self.process_action(mean))
        return env_state, mask_carry(next_carry, env_state.terminated | env_state.truncated)

    def _init_train_carry(self):
        """(env state from the reset that starts this ``train()`` call, a
        zero policy carry, best eval return)."""
        self.env_state = self.train_env.reset(train_reset_seed(self))
        self.policy_carry = self.policy.initialize_carry(self.train_env.nr_envs)
        return self.env_state, self.policy_carry, -math.inf

    def _eval_save_iteration(self, carry, eval_save_iteration):
        env_state, policy_carry, best_return = carry
        iterate = self.captured_iteration or self.learning_iteration
        for j in range(self.nr_updates_per_eval_save_iteration):
            env_state, policy_carry, metrics = iterate(env_state, policy_carry)
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
            # elementwise: with parallel seeds the return is one per seed
            is_best = np.all(eval_metrics["eval/episode_return"] > best_return)
            best_return = np.maximum(best_return, eval_metrics["eval/episode_return"])
        if self.save_model:
            self.save()
            if is_best:
                self.save(file_name="best.model")
        return (env_state, policy_carry, best_return), eval_metrics

    def train(self):
        start = self._last_log_time = time.time()
        (self.env_state, self.policy_carry, _), eval_history = run_training_program(self)
        if self.parallel is not None:
            finish(self, (self.policy, self.policy_optimizer), (self.critic, self.critic_optimizer))
            self.policy.cell.fused = True
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
        ckpt.save_model_file(self.save_path, file_name, self.checkpoint_tree(), self.config.algorithm.to_dict(),
                             mesh=self.mesh)

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
        carry = (env_state, self.policy.initialize_carry(self.eval_env.nr_envs))
        return collect_test_returns(self._deterministic_step, carry, episodes, self.horizon,
                                    extract=lambda c: c[0])
