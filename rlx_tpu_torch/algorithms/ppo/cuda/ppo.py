"""PPO on one device: rollout, batched critic, GAE, minibatch epochs.

Per learning iteration:

- rollout: ``nr_steps`` env steps with the policy sampling from a device
  ``torch.Generator`` (the env is stepped in place on the device);
- values and next values from ONE batched critic call over ``[T*B]`` rows
  each (critic parameters are constant during the rollout);
- GAE over ``[T, B]`` (the CUDA kernel on the card);
- step-major flatten, the five update arrays packed into one ``[T*B, D]``
  matrix (discrete actions as one f32 column, exact below 2**24), each
  epoch's permutation applied as a single row gather, and minibatches
  taken as contiguous slices; image observations (NatureCNN policy and
  critic) are gathered per minibatch instead;
- per-minibatch advantage normalization, the clipped PPO loss, a global-norm
  gradient clip and Adam, separately for the policy and the critic, with the
  learning rate annealed linearly on the optimizer step count.

Nothing in ``learning_iteration`` reads a device value back to the host:
the optimizer step count is a device tensor (``optimizer_steps``; the host's
``nr_optimizer_steps`` reads it), the learning rate is computed from it on
the device (``learning_rate_tensor``; both from
``train_state.DeviceStepSchedule``), Adam is ``train_state.adam_step_``
and the permutations come from the model's device generator.  So on one
CUDA device the iteration is captured as a CUDA graph and replayed
(``training_program.CapturedIteration``, ``capturable`` below), B1 and B2
inside it; the CPU and every other configuration run it eagerly, with the
same arithmetic.

The learning iterations run in eval/save iterations, with the JAX
package's sizing (``rlx_tpu/algorithms/ppo/tpu/ppo.py``): after each, an
evaluation of ``horizon`` deterministic steps from a fresh eval reset and,
with ``runner.save_model``, ``latest.model`` (and ``best.model`` when the
eval return is the best so far).  ``save``, ``load`` and ``test`` follow the
JAX package's.

The phases run under ``torch.profiler.record_function`` spans
(``ppo/rollout``, ``ppo/advantages``, ``ppo/update``, ``ppo/eval``), which
cost nothing measurable without an active profiler and give a trace its
per-phase host time.

The optimizer matches ``optax.chain(clip_by_global_norm(max_grad_norm),
inject_hyperparams(adam)(lr=schedule))``: gradients are scaled by
``max_norm / norm`` only when ``norm >= max_norm``, Adam uses eps=1e-8, and
the learning rate is evaluated from the step count before each step.  The
``torch.optim.Adam`` objects only hold Adam's state (the checkpoint's
format); ``train_state.adam_step_`` takes the step, seed-stacked nets
included (all seeds step together).

With ``nr_parallel_seeds = S > 1`` (``algorithms/parallel_seeds.py``) the
nets are seed-stacked and ``self.parallel`` holds the seed axis: the
rollout samples each seed's actions from its own generator in one batched
policy call over the ``S * N`` envs, the critic and GAE (B1) run once over
``[T, S * N]``, each seed takes its own permutations (``epoch_indices``
``[S, nr_epochs, batch]``), and each minibatch's loss, advantage
normalization included, is a per-seed loss whose sum over seeds is
differentiated; the gradients are clipped per seed.  The iteration's
metrics are then ``[S]`` tensors.

On a dp mesh (``parallel/mesh.py``, one process per device) each rank
steps its ``nr_envs / dp`` rows of the envs, drawing its rows of the
global action noise, and runs GAE (B1) on them.  The update, as the JAX
package's (``rlx_tpu/algorithms/ppo/tpu/ppo.py``):

- ``shard_local_minibatching`` (default): each rank flattens its rows
  env-major and permutes them itself (``epoch_indices`` ``[nr_epochs, dp,
  batch / dp]``, the global draw; a rank takes its own), taking
  ``minibatch_size / dp`` rows a minibatch;
- otherwise the batch is gathered (``gather_rows``), flattened step-major
  and permuted as at dp = 1, and each rank takes its slice of every
  minibatch, so dp = k equals dp = 1 up to the order of the reductions.

Advantages are normalized over the global minibatch
(``global_mean_var``), the gradients averaged over dp before the
global-norm clip, and the metrics and eval means averaged over dp.  On a
tp mesh the policy and the critic are split over tp
(``parallel/partition.py``; the clip's norm sums the split parameters over
tp) and a checkpoint holds the whole parameters and moments.
"""

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from rlx_tpu_torch import convert
from rlx_tpu_torch.algorithms.evaluation import collect_test_returns
from rlx_tpu_torch.algorithms.parallel_seeds import (
    NoGenerator, ParallelSeeds, check_config, finish, nr_parallel_seeds, stack_modules,
)
from rlx_tpu_torch.algorithms.ppo.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.train_state import (
    DeviceStepSchedule, clip_by_global_norm_, load_module_state_dict, module_state_dict,
)
from rlx_tpu_torch.algorithms.training_program import (
    eval_means, eval_reset_seed, run_training_program, train_reset_seed,
)
from rlx_tpu_torch.environments.types import ActionSpaceType
from rlx_tpu_torch.models import distributions as D
from rlx_tpu_torch.models.policy_factory import make_critic, make_policy
from rlx_tpu_torch.ops.gae import gae_advantages
from rlx_tpu_torch.parallel import partition
from rlx_tpu_torch.parallel.mesh import mesh_for
from rlx_tpu_torch.utils import checkpoint as ckpt
from rlx_tpu_torch.utils.logging import MetricsLogger, rlx_logger


class PPO(DeviceStepSchedule):
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
        self.minibatch_size = a.minibatch_size
        self.gamma = a.gamma
        self.gae_lambda = a.gae_lambda
        self.clip_range = a.clip_range
        self.entropy_coef = a.entropy_coef
        self.critic_coef = a.critic_coef
        self.max_grad_norm = a.max_grad_norm
        self.logging_active = a.logging_active
        self.evaluation_active = a.evaluation_active

        self.batch_size = self.nr_envs * self.nr_steps
        self.nr_updates = self.total_timesteps // self.batch_size
        self.nr_minibatches = self.batch_size // self.minibatch_size
        if self.nr_minibatches * self.minibatch_size != self.batch_size:
            raise ValueError("minibatch_size must divide nr_envs * nr_steps")
        self.eval_save_frequency = a.evaluation_and_save_frequency
        if self.eval_save_frequency == -1:
            self.eval_save_frequency = self.batch_size * max(self.nr_updates, 1)
        if self.eval_save_frequency % self.batch_size != 0:
            raise ValueError("evaluation_and_save_frequency must be a multiple of nr_envs * nr_steps")
        self.nr_eval_save_iterations = max(self.total_timesteps // self.eval_save_frequency, 1)
        self.nr_updates_per_eval_save_iteration = self.eval_save_frequency // self.batch_size
        self.horizon = train_env.horizon
        self.continuous = train_env.general_properties.action_space_type == ActionSpaceType.CONTINUOUS
        if not self.continuous and train_env.single_action_space.n > 2**24:
            raise ValueError("discrete actions travel as one f32 column, exact only below 2**24 actions")
        self.mesh = mesh_for(config, self.device)
        self.dp = self.mesh.dp
        if self.dp > 1 and self.minibatch_size % self.dp:
            raise ValueError("minibatch_size must divide over the dp mesh axis")
        # each dp rank permutes its own rows (the JAX package's
        # shard-local minibatching; at dp = 1 the global permutation)
        self.shard_local_minibatching = bool(a.get("shard_local_minibatching", True)) and self.dp > 1

        self.logger = MetricsLogger(config.runner.track_console, writer)
        rlx_logger.info(f"Using device: {self.device}")

        # parameters are initialized on the CPU from the seed, then moved
        if self.parallel is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self.seed)
                self.policy = make_policy(config, train_env, "cpu")
                self.critic = make_critic(config, train_env, "cpu")
        else:
            built = self.parallel.init(lambda: (make_policy(config, train_env, "cpu"),
                                                make_critic(config, train_env, "cpu")))
            self.policy = built[0][0]
            stack_modules([b[0].module for b in built])
            self.critic = stack_modules([b[1] for b in built])
        self.policy.module.to(self.device)
        self.critic.to(self.device)
        if self.mesh.tp > 1:
            if self.parallel is not None:
                raise NotImplementedError("nr_parallel_seeds > 1 does not run on a tp mesh")
            partition.shard_module_(self.policy.module, self.mesh)
            partition.shard_module_(self.critic, self.mesh)
        self.policy_optimizer = torch.optim.Adam(
            self.policy.module.parameters(), lr=self.learning_rate, eps=1e-8
        )
        self.critic_optimizer = torch.optim.Adam(
            self.critic.parameters(), lr=self.learning_rate, eps=1e-8
        )
        self.init_optimizer_steps(self.device)
        if self.parallel is None:
            self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
            # seeds of the eval and test resets
            self.host_generator = torch.Generator().manual_seed(self.seed)
        else:
            self.generator = self.host_generator = NoGenerator()
        self.env_state = None
        self.nr_train_resets = 0
        self.captured_iteration = None   # a train() call's CapturedIteration
        self.metrics_history = []  # per-iteration float metrics when logging is active
        self.eval_history = None

    # ----------------------------------------------------------- parallel seeds

    def _nets(self):
        """The nets a per-seed function reads (``ParallelSeeds.map``)."""
        return {"policy": self.policy.module, "critic": self.critic}

    def _seed_map(self, fn, *rows):
        """``fn`` per seed over seed-major ``[S * N, ...]`` rows, in one
        batched call; outputs back as ``[S * N, ...]`` rows."""
        out = self.parallel.map(fn, self._nets(), *(self.parallel.split(x) for x in rows))
        return tuple(self.parallel.merge(x) for x in out) if isinstance(out, tuple) else self.parallel.merge(out)

    def _sample_action(self, observation):
        """(action, log-prob) of a rollout step; with parallel seeds each
        seed's noise comes from its own generator, drawn as its one-seed run
        draws it."""
        if self.parallel is None and self.dp == 1:
            return self.policy.sample_and_log_prob(observation, self.generator)
        dtype = next(self.policy.module.parameters()).dtype
        if self.parallel is None:
            # this rank's rows of the global draw
            if self.continuous:
                shape = (self.nr_envs,) + tuple(self.train_env.single_action_space.shape)
                noise = torch.randn(shape, generator=self.generator, device=self.device, dtype=dtype)
            else:
                shape = (self.nr_envs, self.train_env.single_action_space.n)
                noise = D.gumbel_noise(torch.rand(shape, generator=self.generator, device=self.device, dtype=dtype))
            return self.policy.sample_and_log_prob(observation, None, self.mesh.rows(noise))
        if self.continuous:
            shape = (self.nr_envs,) + tuple(self.train_env.single_action_space.shape)
            noise = self.parallel.draw(lambda g: torch.randn(shape, generator=g, device=self.device, dtype=dtype))
        else:
            shape = (self.nr_envs, self.train_env.single_action_space.n)
            noise = D.gumbel_noise(self.parallel.draw(
                lambda g: torch.rand(shape, generator=g, device=self.device, dtype=dtype)))
        return self._seed_map(lambda o, n: self.policy.sample_and_log_prob(o, None, n), observation,
                              self.parallel.merge(noise))

    def _values(self, observations):
        """The critic's values ``[T, B]`` of ``[T, B, ...]`` observations."""
        T, B = observations.shape[:2]
        if self.parallel is None:
            return self.critic(observations.reshape((T * B,) + observations.shape[2:])).reshape(T, B)
        P = self.parallel
        values = P.map(self.critic, self._nets(), P.split_time(observations))
        return P.merge_time(values, T).reshape(T, B)

    def _mode(self, observation):
        if self.parallel is None:
            return self.policy.mode(observation)
        return self._seed_map(self.policy.mode, observation)

    def _policy_std(self):
        """``exp(policy_logstd)``'s mean (per seed with parallel seeds)."""
        std = torch.exp(self.policy.module.policy_logstd.detach())
        if self.parallel is None:
            return std.mean()
        return std.reshape(self.parallel.nr_seeds, -1).mean(dim=1)

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
            action, log_prob = self._sample_action(observation)
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
        infos = {k: v / (T * self.train_env.nr_envs) for k, v in info_sums.items()}
        return env_state, batch, infos

    def learning_iteration(self, env_state):
        """One rollout + GAE + minibatch-epochs update; returns the new env
        state and the iteration's metrics (device scalars)."""
        with record_function("ppo/rollout"):
            env_state, batch, infos = self._rollout(env_state)
        observations, final_observations, actions, rewards, terminations, log_probs = batch
        T, B = rewards.shape

        with torch.no_grad(), record_function("ppo/advantages"):
            values = self._values(observations)
            next_values = self._values(final_observations)
            advantages, returns = gae_advantages(
                rewards, values, next_values, terminations, self.gamma, self.gae_lambda
            )

        flat = self._flat
        if self.parallel is not None:
            flat = self.parallel.split_time
        with record_function("ppo/update"):
            metrics = self._optimize(
                (flat(observations), flat(actions), flat(log_probs), flat(returns), flat(advantages))
            )
        metrics["v_value/explained_variance"] = 1.0 - self.mesh.global_mean_var(returns - values)[1] / (
            self.mesh.global_mean_var(returns)[1] + 1e-8
        )
        if self.continuous:
            metrics["policy/std_dev"] = self._policy_std()
        return env_state, self.mesh.mean_metrics({**infos, **metrics})

    def _flat(self, x):
        """``[T, B, ...]`` -> the update's ``[T * B, ...]`` rows: step-major;
        on a dp mesh env-major (a rank's own rows, shard-local) or the
        global batch gathered from every rank, step-major."""
        T, B = x.shape[:2]
        if self.dp == 1:
            return x.reshape((T * B,) + x.shape[2:])
        by_env = x.transpose(0, 1)
        if self.shard_local_minibatching:
            return by_env.reshape((T * B,) + x.shape[2:])
        return self.mesh.gather_rows(by_env.contiguous()).transpose(0, 1).reshape((T * B * self.dp,) + x.shape[2:])

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

    def _minibatch_loss(self, obs_mb, action_mb, log_prob_mb, return_mb, adv_mb):
        """One seed's minibatch loss, its advantages normalized first (over
        the global minibatch on a dp mesh)."""
        if self.dp == 1:
            adv_mb = (adv_mb - adv_mb.mean()) / (adv_mb.std(unbiased=False) + 1e-8)
        else:
            mean, var = self.mesh.global_mean_var(adv_mb)
            adv_mb = (adv_mb - mean) / (torch.sqrt(var) + 1e-8)
        return self._loss(obs_mb, action_mb, log_prob_mb, return_mb, adv_mb)

    def _clip_gradients(self, metrics):
        """Average the gradients over dp, then clip each net's by its global
        norm (summed over tp for a split net) into the grad-norm metrics."""
        for name, module in (("policy", self.policy.module), ("critic", self.critic)):
            grads = [p.grad for p in module.parameters()]
            self.mesh.all_reduce_mean_(grads)
            if self.mesh.tp > 1:
                norm = partition.clip_by_global_norm_(module, grads, self.max_grad_norm)
            else:
                norm = clip_by_global_norm_(grads, self.max_grad_norm)
            metrics[f"gradients/{name}_grad_norm"] = norm

    def _epoch_indices(self):
        """Each epoch's permutation, drawn from ``self.generator``: ``[nr_epochs,
        batch]``; with shard-local minibatching ``[nr_epochs, dp, batch /
        dp]``, every rank's, as the JAX package draws them."""
        if self.shard_local_minibatching:
            rows = self.batch_size // self.dp
            return torch.stack([torch.stack([torch.randperm(rows, generator=self.generator, device=self.device)
                                             for _ in range(self.dp)]) for _ in range(self.nr_epochs)])
        return torch.stack([
            torch.randperm(self.batch_size, generator=self.generator, device=self.device)
            for _ in range(self.nr_epochs)
        ])

    def _minibatch_stream(self, batch_arrays, epoch_indices):
        """The minibatches of this process: at dp = 1 ``_minibatches``; on a
        dp mesh this rank's rows of each (its own permutation's
        ``minibatch_size / dp`` rows shard-local, else its slice of the
        global minibatch)."""
        if self.dp == 1:
            return self._minibatches(batch_arrays, epoch_indices)
        local = self.minibatch_size // self.dp
        if self.shard_local_minibatching:
            return self._minibatches(batch_arrays, epoch_indices[:, self.mesh.dp_rank], local)
        lo = self.mesh.dp_rank * local
        return (tuple(x[lo:lo + local] for x in mb) for mb in self._minibatches(batch_arrays, epoch_indices))

    def _optimize(self, batch_arrays, epoch_indices=None):
        """Minibatch-epochs PPO-Clip update over a flat batch.

        ``epoch_indices`` ([nr_epochs, batch]) are the per-epoch
        permutations; drawn from ``self.generator`` when not given.  With
        parallel seeds every array has a leading seed axis (``[S, batch,
        ...]``, ``epoch_indices`` ``[S, nr_epochs, batch]``).  On a dp mesh
        the arrays are this rank's (``_flat``) and ``epoch_indices`` the
        global draw (``_epoch_indices``)."""
        if self.parallel is not None:
            return self._optimize_seeds(batch_arrays, epoch_indices)
        if epoch_indices is None:
            epoch_indices = self._epoch_indices()
        history = []
        for obs_mb, action_mb, log_prob_mb, return_mb, adv_mb in self._minibatch_stream(batch_arrays, epoch_indices):
            self.policy_optimizer.zero_grad(set_to_none=False)
            self.critic_optimizer.zero_grad(set_to_none=False)
            loss, metrics = self._minibatch_loss(obs_mb, action_mb, log_prob_mb, return_mb, adv_mb)
            loss.backward()
            with torch.no_grad():
                self._clip_gradients(metrics)
            lr = self._step_optimizers()
            history.append({k: v.detach() for k, v in metrics.items()})
        out = {k: torch.stack([h[k] for h in history]).mean() for k in history[0]}
        out["lr/learning_rate"] = lr.float()
        return out

    def _optimize_seeds(self, batch_arrays, epoch_indices=None):
        """``_optimize`` over all seeds at once: each minibatch is every
        seed's minibatch of its own permutation (from its own generator
        unless given), the loss mapped over the seeds, the backward of their
        sum, a per-seed clip and one Adam step of each net (elementwise, so
        each seed's is its one-seed step)."""
        P = self.parallel
        if epoch_indices is None:
            epoch_indices = P.draw(lambda g: torch.stack([
                torch.randperm(self.batch_size, generator=g, device=self.device) for _ in range(self.nr_epochs)]))
        history = []
        batch_observations = batch_arrays[0]
        for e in range(self.nr_epochs):
            idx_e = epoch_indices[:, e].to(self.device)
            shuffled = None if batch_observations.ndim != 3 else tuple(P.take(x, idx_e) for x in batch_arrays)
            for m in range(self.nr_minibatches):
                rows = slice(m * self.minibatch_size, (m + 1) * self.minibatch_size)
                if shuffled is None:
                    mb = tuple(P.take(x, idx_e[:, rows]) for x in batch_arrays)
                else:
                    mb = tuple(x[:, rows] for x in shuffled)
                self.policy_optimizer.zero_grad(set_to_none=False)
                self.critic_optimizer.zero_grad(set_to_none=False)
                loss, metrics = P.map(self._minibatch_loss, self._nets(), *mb)
                loss.sum().backward()
                with torch.no_grad():
                    for name, module in (("policy", self.policy.module), ("critic", self.critic)):
                        metrics[f"gradients/{name}_grad_norm"] = clip_by_global_norm_(
                            [p.grad for p in module.parameters()], self.max_grad_norm, per_seed=True)
                lr = self._step_optimizers()
                history.append({k: v.detach() for k, v in metrics.items()})
        out = {k: torch.stack([h[k] for h in history]).mean(dim=0) for k in history[0]}
        out["lr/learning_rate"] = lr.float()
        return out

    def _minibatches(self, batch_arrays, epoch_indices, minibatch_size=None):
        """The minibatches ``(observations, actions, log-probs, returns,
        advantages)`` of each epoch's permutation in turn, of
        ``minibatch_size`` rows (the config's unless given).  Flat
        observations travel packed with the rest in one ``[N, D]`` matrix,
        gathered once an epoch and cut into contiguous slices; images
        (``[N, H, W, C]``) are gathered per minibatch, as the JAX package
        does, so no shuffled copy of the whole rollout is made."""
        batch_observations, batch_actions = batch_arrays[:2]
        size = minibatch_size or self.minibatch_size
        slices = [slice(m * size, (m + 1) * size) for m in range(self.nr_minibatches)]
        epoch_indices = epoch_indices.to(self.device)
        if batch_observations.ndim != 2:
            for idx_e in epoch_indices:
                for rows in slices:
                    yield tuple(x[idx_e[rows]] for x in batch_arrays)
            return
        obs_dim = batch_observations.shape[1]
        action_2d = batch_actions.reshape(batch_observations.shape[0], -1)
        action_dim = action_2d.shape[1]
        packed = torch.cat(
            [batch_observations, action_2d.to(batch_observations.dtype)] + [x[:, None] for x in batch_arrays[2:]],
            dim=1,
        )
        for idx_e in epoch_indices:
            shuffled = packed[idx_e]
            for rows in slices:
                mb = shuffled[rows]
                action_mb = mb[:, obs_dim:obs_dim + action_dim].to(batch_actions.dtype).reshape(
                    (-1,) + batch_actions.shape[1:])
                yield (mb[:, :obs_dim], action_mb, mb[:, obs_dim + action_dim], mb[:, obs_dim + action_dim + 1],
                       mb[:, obs_dim + action_dim + 2])

    # ------------------------------------------------------- eval/save loop

    @torch.no_grad()
    def _eval_iteration(self, eval_save_iteration):
        """``horizon`` steps of ``policy.mode`` from a fresh eval reset; every
        ``rollout/*`` info key becomes ``eval/*`` (mean over envs), with
        ``eval/policy_std`` for continuous actions.  The train env state is
        not touched (the Ant's eval env is its train env)."""
        seed = eval_reset_seed(self)
        with record_function("ppo/eval"):
            eval_env_state = self.eval_env.reset(seed, eval_mode=True)
            for _ in range(self.horizon):
                action = self._mode(eval_env_state.observation)
                eval_env_state = self.eval_env.step(eval_env_state, self.policy.process_action(action))
        eval_metrics = eval_means(self, eval_env_state.info)
        if self.continuous:
            std = self._policy_std()
            eval_metrics["eval/policy_std"] = float(std) if self.parallel is None else std.cpu().numpy()
        if self.logging_active:
            self.logger.log_dict(eval_metrics, (eval_save_iteration + 1) * self.eval_save_frequency)
        return eval_metrics

    def _init_train_carry(self):
        """(env state from the reset that starts this ``train()`` call, best
        eval return)."""
        self.env_state = self.train_env.reset(train_reset_seed(self))
        return self.env_state, -math.inf

    def _eval_save_iteration(self, carry, eval_save_iteration):
        env_state, best_return = carry
        iterate = self.captured_iteration or self.learning_iteration
        for j in range(self.nr_updates_per_eval_save_iteration):
            env_state, metrics = iterate(env_state)
            if self.logging_active:
                iteration = eval_save_iteration * self.nr_updates_per_eval_save_iteration + j + 1
                values = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                values["time/sps"] = int(self.batch_size / max(now - self._last_log_time, 1e-9))
                self._last_log_time = now
                values["steps/nr_env_steps"] = iteration * self.batch_size
                # this call's updates, as JAX logs them; nr_optimizer_steps
                # also counts earlier calls and restored ones
                values["steps/nr_updates"] = iteration * self.nr_epochs * self.nr_minibatches
                self.metrics_history.append(values)
                self.logger.log_dict(values, iteration * self.batch_size)
        self.env_state = env_state
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
        return (env_state, best_return), eval_metrics

    def train(self):
        start = self._last_log_time = time.time()
        (self.env_state, _), eval_history = run_training_program(self)
        if self.parallel is not None:
            finish(self, (self.policy.module, self.policy_optimizer), (self.critic, self.critic_optimizer))
        self.eval_history = None
        if eval_history is not None:
            steps = (np.arange(self.nr_eval_save_iterations) + 1) * self.eval_save_frequency
            self.eval_history = {"steps": steps, **eval_history}
        rlx_logger.info(f"Average time: {time.time() - start:.2f} s")

    # ----------------------------------------------------- save / load / test

    def checkpoint_tree(self):
        """The nets' parameters (and with ``runner.save_optimizer_state`` the
        optimizers' state); nets split over tp are saved whole."""
        if self.config.runner.save_optimizer_state:
            tree = {"full": {
                "policy": module_state_dict(self.policy.module, self.policy_optimizer),
                "critic": module_state_dict(self.critic, self.critic_optimizer),
                "nr_optimizer_steps": self.nr_optimizer_steps,
            }}
            if self.mesh.tp > 1:
                for name, module in (("policy", self.policy.module), ("critic", self.critic)):
                    state = tree["full"][name]
                    state["params"] = convert.tp_unshard_state_dict(module, state["params"])
                    state["opt_state"] = convert.tp_unshard_optimizer_state(module, state["opt_state"])
            return tree
        if self.mesh.tp > 1:
            return {"policy": convert.tp_unshard_state_dict(self.policy.module),
                    "critic": convert.tp_unshard_state_dict(self.critic)}
        return {"policy": self.policy.module.state_dict(), "critic": self.critic.state_dict()}

    def restore_from_tree(self, tree):
        """The inverse of ``checkpoint_tree`` (a whole net split over tp again)."""
        if "full" in tree:
            full = tree["full"]
            for name, module, optimizer in (("policy", self.policy.module, self.policy_optimizer),
                                            ("critic", self.critic, self.critic_optimizer)):
                state = full[name]
                if self.mesh.tp > 1:
                    state = {"params": convert.tp_shard_state_dict(module, state["params"]),
                             "opt_state": convert.tp_shard_optimizer_state(module, state["opt_state"])}
                load_module_state_dict(state, module, optimizer)
            self.nr_optimizer_steps = full["nr_optimizer_steps"]
        else:
            for name, module in (("policy", self.policy.module), ("critic", self.critic)):
                module.load_state_dict(convert.tp_shard_state_dict(module, tree[name]) if self.mesh.tp > 1
                                       else tree[name])

    def save(self, file_name="latest.model"):
        ckpt.save_model_file(self.save_path, file_name, self.checkpoint_tree(), self.config.algorithm.to_dict(),
                             mesh=self.mesh)

    @classmethod
    def load(cls, config, train_env, eval_env, run_path, writer, explicitly_set_algorithm_params):
        return ckpt.load_model(cls, config, train_env, eval_env, run_path, writer,
                               explicitly_set_algorithm_params)

    @torch.no_grad()
    def test(self, episodes):
        """Deterministic rollouts until ``episodes`` episodes are done (the
        JAX package's ``nr_test_episodes`` semantics)."""
        def step(env_state):
            action = self.policy.mode(env_state.observation)
            return self.eval_env.step(env_state, self.policy.process_action(action))

        seed = int(torch.randint(2**31 - 1, (), generator=self.host_generator))
        env_state = self.eval_env.reset(seed, eval_mode=True)
        return collect_test_returns(step, env_state, episodes, self.horizon)

    def general_properties():
        return GeneralProperties
