"""Shared scaffolding of the off-policy algorithms.

The same skeleton as the JAX package's ``algorithms/offpolicy.py`` with
Python loops in place of its scans: a packed replay buffer on the device, a
random prefill, then learning steps (1 env step : 1 gradient update) in
logging iterations inside eval/save iterations, with the same sizing, so
the counts of env steps, updates and log lines equal the JAX package's.
After each eval/save iteration come the evaluation and, with
``runner.save_model``, ``latest.model`` (and ``best.model`` when the eval
return is the best so far); ``save``, ``load`` and ``test`` follow the JAX
package's.  Each algorithm implements:

- ``setup_states()``                              networks, targets, optimizers
- ``state_names``                                 attributes the checkpoint holds:
                                                  ``TrainState``s and dicts of tensors
- ``act(observation, step) -> action``             normalized [-1, 1] or
                                                  discrete; ``step`` is
                                                  the learning step of this
                                                  ``train()`` call
- ``eval_act(observation) -> action``
- ``update(batch, step, ...) -> metrics``          device scalars
- ``observe_transition(observation, env_state)``   optional hook
- ``pre_act(step)``                                optional hook before
                                                  ``act`` (FlashSAC's
                                                  repeated noise)
- ``extra_buffer_fields()``                        optional extra replay
                                                  fields ``{name: (shape, dtype)}``
- ``update_with_buffer(buffer, step) -> metrics``  optional: replaces the
                                                  sample and ``update`` of a
                                                  learning step (the
                                                  high-UTD ensembles draw
                                                  their own batches)

The learning step's count (``step``, the learning steps this ``train()``
call has taken) is a 0-dim int64 tensor on the device where ``train()``
captures the learning step (a family that declares ``capturable``:
FastTD3, FastSAC, SAC, TD3, DDPG), a host int in the eager loop; the replay buffer's write head and fill are device tensors and
its samplers draw below the device fill (``ops/replay_buffer.py``); the
buffer is held by the model (``buffer``), and a logging iteration's
metrics are summed on the device in place (``metric_sums``), read once at
its end.  So for those five a learning step reads nothing back, and on
one CUDA device ``train()`` replays it as one captured CUDA graph
(``learning_iteration``, ``training_program.CapturedIteration``); the
prefill, evaluation, saving and logging stay eager on the host.

The phases of a learning step run under ``torch.profiler.record_function``
spans ``<algorithm>/act``, ``/env_step``, ``/store``, ``/sample`` and
``/update``; they cost nothing measurable without an active profiler.

FastMPO's per-env sizing keys (``learning_starts_per_env``,
``buffer_size_per_env``: when positive, learning starts at that many env
steps per env and the buffer holds that many rows per env) and its action
pipeline (``action_clipping``, then ``action_rescaling`` of ``"none"``,
``"normal"`` or ``"fastsac"``) apply where the config has the keys; every
other continuous algorithm clips to [-1, 1] and rescales to the env's
bounds, as the JAX package's ``else`` branch.

Image observations (an IMAGES env) are replayed as uint8, ``observation``
and ``next_observation`` alike, in the buffer's unpacked layout: the envs
emit integral floats in 0..255, so the cast is exact, and ``NatureCNN``
turns them back into float32 on the way in.

Parallel seeds (``algorithm.nr_parallel_seeds = S > 1``,
``parallel_seeds.py``): ``setup_states`` runs once per seed under that
seed with that seed's generator (as the JAX package's), and every state is
seed-stacked; the buffer holds the ``S * N`` env rows, each seed samples
only its own rows from its own generator (the prefill's random actions
likewise), and an algorithm that declares ``parallel_seeds = True`` in its
own class body supplies ``act_draws(generator)`` (the act's draws of one
seed, in its one-seed order) and ``update_seeds(batch, step)`` (or, with
``update_with_buffer``, maps its own updates), which maps its losses over
the seeds (``seed_map``; ``plain_call`` is its one-seed counterpart, so one
update serves both), runs a kernel between the mapped parts on the seeds'
folded rows (``fold_seeds``) and steps the stacked optimizers.  Every
family declares it; a class that does not raises ``NotImplementedError``
at S > 1.

On a dp mesh (``parallel/mesh.py``: ``runner.mesh_dp``, one process per
device) each rank steps its ``nr_envs / dp`` env rows and its replay holds
only them (``nr_envs`` stays the global count: the sizing and every draw
are the dp = 1 run's, each rank keeping its rows of the act's draws,
``act_draws``, and of the prefill's random actions).  A batch of
``batch_size`` rows is split over the ranks, ``batch_size / dp`` each:

- ``shard_local_sampling`` (default, the JAX package's layout): batch row
  ``i`` reads env shard ``i % dp`` at a global time index, and rank ``r``
  takes the rows ``i % dp == r``, all its own (no communication);
- otherwise the dp = 1 run's uniform sample: every rank draws the global
  indices, reads the rows it owns, the rest zero, and an all_reduce sums
  them into the whole batch, of which rank ``r`` keeps the ``r``-th slice.

A family's draws inside an update are drawn whole (``update_draws``: the
dp = 1 run's draws in its order, the function parallel seeds draw per
seed) and each rank keeps its batch rows (``batch_rows``); gradients are averaged over dp in
``TrainState.apply_gradients``, batch statistics (BatchRenorm, FlashSAC's
BatchNorm) and the running observation and reward normalizers reduce over
dp (``models/layers.set_batch_mesh``, ``ops/normalizers``), and the metrics
and eval means are averaged over dp.  So with ``shard_local_sampling``
off, dp = k equals dp = 1 up to the order of the reductions.
"""

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from rlx_tpu_torch.algorithms.evaluation import collect_test_returns
from rlx_tpu_torch.algorithms.parallel_seeds import (
    NoGenerator, ParallelSeeds, check_config, finish, first_seed_state, nr_parallel_seeds, refuse, stack_states,
)
from rlx_tpu_torch.algorithms.train_state import TrainState
from rlx_tpu_torch.algorithms.training_program import (
    capture_choice, eval_means, eval_reset_seed, run_training_program, train_reset_seed,
)
from rlx_tpu_torch.environments.types import ActionSpaceType
from rlx_tpu_torch.models import layers
from rlx_tpu_torch.models.mlp import observation_width
from rlx_tpu_torch.models.policy_factory import image_shape
from rlx_tpu_torch.ops import normalizers
from rlx_tpu_torch.ops import replay_buffer as rb
from rlx_tpu_torch.parallel.mesh import mesh_for
from rlx_tpu_torch.utils import checkpoint as ckpt
from rlx_tpu_torch.utils.logging import MetricsLogger, rlx_logger


def action_pipeline(space, clip=True, rescaling="normal"):
    """The env action of a policy action: clipped to [-1, 1] with ``clip``,
    then rescaled by ``rescaling``: ``"normal"`` maps [-1, 1] onto
    [low, high], ``"fastsac"`` multiplies by ``max(|low - center|, |high -
    center|) / scale``, ``"none"`` leaves it as it is."""
    if rescaling not in ("none", "normal", "fastsac"):
        raise ValueError(f"unknown action_rescaling {rescaling!r}")
    low, high = space.low, space.high
    action_scale = torch.maximum(torch.abs(low - space.center), torch.abs(high - space.center)) / space.scale

    def process(action):
        if clip:
            action = torch.clamp(action, -1.0, 1.0)
        if rescaling == "normal":
            action = low + 0.5 * (action + 1.0) * (high - low)
        elif rescaling == "fastsac":
            action = action * action_scale
        return action

    return process


class OffPolicyAlgorithm:
    def __init__(self, config, train_env, eval_env, run_path=None, writer=None):
        self.config = config
        self.train_env = train_env
        self.eval_env = eval_env
        self.device = train_env.device

        a = config.algorithm
        self.name = a.name.split(".")[0]
        check_config(config)
        nr_seeds = nr_parallel_seeds(config)
        if nr_seeds > 1 and not type(self).__dict__.get("parallel_seeds", False):
            refuse(config, f"algorithm {a.name}")
        self.save_model = config.runner.save_model
        self.save_path = ckpt.save_path_for(config, run_path)
        self.seed = config.environment.seed
        self.total_timesteps = int(a.total_timesteps)
        self.nr_envs = config.environment.nr_envs
        self.learning_rate = a.learning_rate
        self.buffer_size = int(a.get("buffer_size", 0))   # FastMPO sizes its buffer per env
        self.learning_starts = int(a.learning_starts)
        self.batch_size = a.batch_size
        self.gamma = a.gamma
        self.tau = a.get("tau", 0.005)   # the DQN family has no Polyak update
        self.logging_frequency = int(a.logging_frequency)
        self.logging_active = a.logging_active
        self.evaluation_active = a.evaluation_active
        self.n_step = int(getattr(a, "n_step", 1))
        if a.get("learning_starts_per_env", 0) > 0:
            self.learning_starts = int(a.learning_starts_per_env) * self.nr_envs

        self.total_training_timesteps = self.total_timesteps - self.learning_starts
        self.eval_save_frequency = a.evaluation_and_save_frequency
        if self.eval_save_frequency == -1:
            self.eval_save_frequency = self.nr_envs * max(self.total_training_timesteps // self.nr_envs, 1)
        # ceil, so the whole requested budget is trained
        self.nr_eval_save_iterations = max(
            int(math.ceil(self.total_training_timesteps / self.eval_save_frequency)), 1
        )
        self.nr_loggings_per_eval_save_iteration = max(self.eval_save_frequency // self.logging_frequency, 1)
        self.nr_updates_per_logging_iteration = max(self.logging_frequency // self.nr_envs, 1)
        if a.get("buffer_size_per_env", 0) > 0:
            self.capacity = int(a.buffer_size_per_env)
        else:
            self.capacity = max(self.buffer_size // self.nr_envs, 1)
        self.prefill_iterations = (
            int(math.ceil(self.learning_starts / self.nr_envs)) if self.learning_starts > 0 else 0
        )

        self.horizon = train_env.horizon
        self.os_shape = tuple(train_env.single_observation_space.shape)
        # the observation columns each net reads (the env's asymmetric
        # policy / critic index sets; None: all of them)
        self.policy_observation_indices = getattr(train_env, "policy_observation_indices", None)
        self.critic_observation_indices = getattr(train_env, "critic_observation_indices", None)
        self.policy_obs_dim = observation_width(self.os_shape, self.policy_observation_indices)
        self.critic_obs_dim = observation_width(self.os_shape, self.critic_observation_indices)
        # [H, W, C] of an IMAGES env (the nets' NatureCNN input), else None
        self.image_shape = image_shape(train_env)
        # the replay's floats: torch's default float type (float32 but where
        # a test runs a whole program in float64)
        self.float_dtype = torch.get_default_dtype()
        self.obs_store_dtype = self.float_dtype if self.image_shape is None else torch.uint8
        self.discrete = train_env.general_properties.action_space_type == ActionSpaceType.DISCRETE
        if self.discrete:
            # int32 actions, stored as they are and neither clipped nor rescaled
            self.nr_actions = train_env.single_action_space.n
            self.action_dim = 1
            self.process_action = lambda action: action
        else:
            self.action_dim = int(np.prod(train_env.single_action_space.shape))
            self.process_action = action_pipeline(train_env.single_action_space, a.get("action_clipping", True),
                                                  a.get("action_rescaling", "normal"))

        self.logger = MetricsLogger(config.runner.track_console, writer)
        rlx_logger.info(f"Using device: {self.device}")

        self.mesh = mesh_for(config, self.device)
        self.dp = self.mesh.dp
        self.shard_local_sampling = bool(a.get("shard_local_sampling", True))
        if self.dp > 1 and self.batch_size % self.dp:
            raise ValueError("batch_size must divide over the dp mesh axis")
        self.parallel = None
        if nr_seeds == 1:
            self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
            self.host_generator = torch.Generator().manual_seed(self.seed)
            self.setup_states()
            for name in self.state_names:
                state = getattr(self, name)
                if isinstance(state, TrainState):
                    state.mesh = self.mesh
                    layers.set_batch_mesh([m for m in (state.module, state.target) if m is not None], self.mesh)
        else:
            self._setup_seed_states(ParallelSeeds(self.seed, nr_seeds, self.device))
        self.nr_train_resets = 0
        self.buffer = None           # this train() call's replay buffer
        self.captured_iteration = None   # a train() call's CapturedIteration
        self.metric_sums = {}        # name -> a logging iteration's device sum of a metric
        self.nr_updates = 0          # learning steps taken, over every train() call
        self.metrics_history = []   # per-logging-iteration float metrics
        self.eval_history = None

    # --- algorithm hooks ---------------------------------------------------
    state_names = ()
    parallel_seeds = False   # declared True by a family's own class body
    # whether a learning step reads nothing back (``learning_iteration``):
    # a family that captures declares it, and a subclass that does not
    # capture declares False
    capturable = False

    def setup_states(self):
        raise NotImplementedError

    def act(self, observation, step=0):
        raise NotImplementedError

    def eval_act(self, observation):
        raise NotImplementedError

    def update(self, batch, step):
        raise NotImplementedError

    def observe_transition(self, observation, env_state):
        """Hook after each learning env step (running normalizers)."""

    def pre_act(self, step):
        """Hook before each learning step's ``act``."""

    def extra_buffer_fields(self):
        """Extra per-transition replay fields, ``{name: (shape, dtype)}``."""
        return {}

    def act_draws(self, generator):
        """The draws of one ``act`` call of one seed, ``{keyword: tensor}``."""
        raise NotImplementedError

    def update_seeds(self, batch, step):
        """``update`` for all seeds at once; ``batch`` fields ``[S, B, ...]``."""
        raise NotImplementedError

    def update_draws(self, generator):
        """The draws of one ``update`` call, ``{keyword: tensor}``, whole (of
        ``batch_size`` rows), in its order; a family that draws inside its
        update defines it (with ``batch_draw_dims``)."""
        return {}

    # {keyword of update_draws: its batch axis}; the others are not split
    batch_draw_dims = {}

    # {dict state name: its keys that hold one row per env} (FlashSAC's held
    # noise, the reward normalizer's running returns): on a dp mesh a rank
    # holds its rows, and a checkpoint every rank's
    env_row_states = {}

    # --- dp mesh -----------------------------------------------------------
    def _whole_env_rows(self, name, state):
        rows = self.env_row_states.get(name, ())
        if self.dp == 1 or not rows:
            return state
        return {k: self.mesh.gather_rows(v) if k in rows else v for k, v in state.items()}

    def batch_rows(self, x, dim=0):
        """This dp rank's rows of a whole batch's tensor (``batch_size`` rows
        along ``dim``, or k batches one after another): rows ``i % dp ==
        rank`` with shard-local sampling, else the rank's contiguous slice
        of each batch."""
        if self.dp == 1:
            return x
        if self.shard_local_sampling:
            index = torch.arange(self.mesh.dp_rank, x.shape[dim], self.dp, device=x.device)
            return x.index_select(dim, index)
        dim = dim % x.ndim
        k = x.shape[dim] // self.batch_size
        batches = x.reshape(x.shape[:dim] + (k, self.batch_size) + x.shape[dim + 1:])
        return self.mesh.rows(batches, dim + 1).reshape(x.shape[:dim] + (-1,) + x.shape[dim + 1:])

    def local_update_draws(self, draws):
        """This rank's part of ``update_draws``' whole draws."""
        return {k: self.batch_rows(v, self.batch_draw_dims[k]) if k in self.batch_draw_dims else v
                for k, v in draws.items()}

    def _update_dp(self, batch, step):
        """``update`` on this rank's batch rows with its rows of the whole
        draws (the dp = 1 run's)."""
        return self.update(batch, step, **self.local_update_draws(self.update_draws(self.generator)))

    # --- parallel seeds ----------------------------------------------------
    def _setup_seed_states(self, parallel):
        """``setup_states`` once per seed under that seed and with its
        generator (FlashSAC draws its first exploration noise there), each
        state then seed-stacked; the one-seed generators stand aside until
        ``train()`` hands seed 0's back (``_keep_first_seed``)."""
        seed = self.seed
        per_seed = []
        for s in range(parallel.nr_seeds):
            self.seed, self.generator = parallel.seeds[s], parallel.generators[s]
            self.setup_states()
            per_seed.append({name: getattr(self, name) for name in self.state_names})
        self.seed = seed
        for name in self.state_names:
            setattr(self, name, stack_states([states[name] for states in per_seed]))
        self.parallel = parallel
        self.generator = self.host_generator = NoGenerator()

    def _keep_first_seed(self):
        for name in self.state_names:
            setattr(self, name, first_seed_state(getattr(self, name)))
        finish(self)

    def seed_map(self, fn, *xs):
        """``fn(*xs_s)`` per seed in one batched call (``ParallelSeeds.map``)
        over ``[S, ...]`` inputs: every ``TrainState``'s net and target is
        seed s's, and every dict state is seed s's while ``fn`` runs."""
        modules, dicts = {}, {}
        for name in self.state_names:
            state = getattr(self, name)
            if isinstance(state, TrainState):
                modules[name] = state.module
                if state.target is not None:
                    modules[f"{name}_target"] = state.target
            else:
                dicts[name] = state

        def with_dicts(states, *args):
            saved = {name: getattr(self, name) for name in states}
            self.__dict__.update(states)
            try:
                return fn(*args)
            finally:
                self.__dict__.update(saved)

        return self.parallel.map(with_dicts, modules, dicts, *xs)

    @staticmethod
    def plain_call(fn, *xs):
        """``fn(*xs)``: the one-seed counterpart of ``seed_map``, for an
        update written once for both."""
        return fn(*xs)

    def updated_obs_normalizer(self, observation):
        """``obs_normalizer`` after the rows ``observation`` (with parallel
        seeds each seed's after its own ``N`` of the ``S * N`` rows)."""
        if self.parallel is None:
            return normalizers.obs_normalizer_update(self.obs_normalizer, observation, self.mesh)
        return self.parallel.map(normalizers.obs_normalizer_update, {}, self.obs_normalizer,
                                 self.parallel.split(observation))

    def update_obs_normalizer_(self, observation):
        """``obs_normalizer`` after the rows ``observation``, written into its
        own tensors (a captured learning step keeps one set of tensors)."""
        for key, value in self.updated_obs_normalizer(observation).items():
            self.obs_normalizer[key].copy_(value)

    def updated_reward_normalizer(self, env_state):
        """``reward_normalizer`` after an env step's rewards and done flags
        (per seed, as ``updated_obs_normalizer``)."""
        rows = (env_state.reward, env_state.terminated, env_state.truncated)
        if self.parallel is None:
            return normalizers.reward_normalizer_update(self.reward_normalizer, *rows, self.gamma, self.mesh)
        return self.parallel.map(lambda state, *xs: normalizers.reward_normalizer_update(state, *xs, self.gamma),
                                 {}, self.reward_normalizer, *(self.parallel.split(x) for x in rows))

    def fold_seeds(self, kernel, *xs):
        """``kernel(*xs)``; with parallel seeds the inputs are ``[S, B,
        ...]`` and the kernel, which has no batching rule, runs once on the
        seeds' rows folded into ``[S * B, ...]``, its output split back."""
        if self.parallel is None:
            return kernel(*xs)
        return self.parallel.split(kernel(*(self.parallel.merge(x) for x in xs)))

    def _act(self, observation, step):
        if self.parallel is None and self.dp > 1:
            draws = {k: self.mesh.rows(v) for k, v in self.act_draws(self.generator).items()}
            return self.act(observation, step=step, **draws)
        if self.parallel is None:
            return self.act(observation, step=step)
        P = self.parallel
        draws = P.draw(self.act_draws)
        return P.merge(self.seed_map(lambda o, d: self.act(o, step=step, **d), P.split(observation), draws))

    def _eval_act(self, observation):
        if self.parallel is None:
            return self.eval_act(observation)
        return self.parallel.merge(self.seed_map(self.eval_act, self.parallel.split(observation)))

    def _sample_seeds(self, buffer, batch_size=None):
        """Each seed's batch of ``batch_size`` (the config's unless given)
        from its own env rows and generator, drawn as its one-seed run draws
        it; one gather for all seeds -> ``[S, batch_size, ...]``."""
        P = self.parallel
        batch_size = self.batch_size if batch_size is None else batch_size
        high = rb.start_rows(buffer, self.n_step)
        idx = P.draw(lambda g: torch.stack([rb.draw_indices(g, high, batch_size, self.device),
                                            rb.draw_indices(g, self.nr_envs, batch_size, self.device)]))
        t_idx = idx[:, 0].reshape(-1)
        e_idx = P.rows(idx[:, 1], self.nr_envs)
        total = P.nr_seeds * batch_size
        if self.n_step > 1:
            flat = rb.sample_nstep(buffer, None, total, self.n_step, self.gamma, t0=t_idx, e_idx=e_idx)
        else:
            flat = rb.sample(buffer, None, total, t_idx=t_idx, e_idx=e_idx)
        return {k: P.split(v) for k, v in flat.items()}

    # --- scaffolding -------------------------------------------------------
    def _make_buffer(self):
        nr_env_rows = self.train_env.nr_envs
        return rb.create(self.capacity, nr_env_rows, {
            "observation": (self.os_shape, self.obs_store_dtype),
            "next_observation": (self.os_shape, self.obs_store_dtype),
            "action": ((), torch.int32) if self.discrete else ((self.action_dim,), self.float_dtype),
            "reward": ((), self.float_dtype),
            "terminated": ((), self.float_dtype),
            "truncated": ((), self.float_dtype),
            **self.extra_buffer_fields(),
        }, device=self.device)

    def _store_step(self, buffer, observation, action, env_state):
        rb.add(buffer, {
            "observation": observation.to(self.obs_store_dtype),
            "next_observation": env_state.final_observation.to(self.obs_store_dtype),
            "action": action,
            "reward": env_state.reward,
            "terminated": env_state.terminated.to(self.float_dtype),
            "truncated": env_state.truncated.to(self.float_dtype),
        })

    def sample_batch(self, buffer):
        """One batch under the ``<name>/sample`` span."""
        with record_function(f"{self.name}/sample"), torch.no_grad():
            return self._sample(buffer)

    def _sample(self, buffer, batch_size=None, t_idx=None, e_idx=None):
        """A batch of ``batch_size`` (the config's unless given); on a dp mesh
        this rank's rows of it (``t_idx`` / ``e_idx``: the whole batch's
        indices, drawn unless given)."""
        if self.parallel is not None:
            return self._sample_seeds(buffer, batch_size)
        batch_size = self.batch_size if batch_size is None else batch_size
        if self.dp > 1:
            return self._sample_dp(buffer, batch_size, t_idx, e_idx)
        if self.n_step > 1:
            return rb.sample_nstep(buffer, self.generator, batch_size, self.n_step, self.gamma,
                                   t0=t_idx, e_idx=e_idx)
        return rb.sample(buffer, self.generator, batch_size, t_idx=t_idx, e_idx=e_idx)

    def _sample_dp(self, buffer, batch_size, t_idx, e_idx):
        if t_idx is None:
            t_idx = rb.draw_indices(self.generator, rb.start_rows(buffer, self.n_step), batch_size, self.device)
        first, last = self.mesh.rows_of_rank(self.nr_envs)
        per_rank = last - first
        if self.shard_local_sampling:
            # row i reads env shard i % dp: this rank's rows are all its own
            if e_idx is None:
                local = rb.draw_indices(self.generator, per_rank, batch_size, self.device)
                e_idx = (torch.arange(batch_size, device=self.device) % self.dp) * per_rank + local
            t_idx, e_idx = self.batch_rows(t_idx), self.batch_rows(e_idx) - first
            return self._read(buffer, t_idx, e_idx)
        if e_idx is None:
            e_idx = rb.draw_indices(self.generator, self.nr_envs, batch_size, self.device)
        own = (e_idx >= first) & (e_idx < last)
        rows = self._read(buffer, t_idx, torch.where(own, e_idx - first, 0))
        whole = {k: self.mesh.all_reduce_sum(torch.where(own.reshape((-1,) + (1,) * (v.ndim - 1)), v,
                                                         torch.zeros((), dtype=v.dtype, device=v.device)))
                 for k, v in rows.items()}
        return {k: self.batch_rows(v) for k, v in whole.items()}

    def _read(self, buffer, t_idx, e_idx):
        if self.n_step > 1:
            return rb.sample_nstep(buffer, None, t_idx.shape[0], self.n_step, self.gamma, t0=t_idx, e_idx=e_idx)
        return rb.sample(buffer, None, t_idx.shape[0], t_idx=t_idx, e_idx=e_idx)

    def _learning_step(self, buffer, env_state, step):
        """pre_act -> act -> env step -> store -> observe -> sample -> update
        (or ``update_with_buffer``, which samples under its own spans)."""
        observation = env_state.observation
        with record_function(f"{self.name}/act"), torch.no_grad():
            self.pre_act(step)
            action = self._act(observation, step)
        with record_function(f"{self.name}/env_step"), torch.no_grad():
            env_state = self.train_env.step(env_state, self.process_action(action))
        with record_function(f"{self.name}/store"), torch.no_grad():
            self._store_step(buffer, observation, action, env_state)
            self.observe_transition(observation, env_state)
        if hasattr(self, "update_with_buffer"):
            with record_function(f"{self.name}/update"):
                return env_state, self.mesh.mean_metrics(self.update_with_buffer(buffer, step))
        batch = self.sample_batch(buffer)
        with record_function(f"{self.name}/update"):
            if self.parallel is not None:
                metrics = self.update_seeds(batch, step)
            elif self.dp > 1:
                metrics = self._update_dp(batch, step)
            else:
                metrics = self.update(batch, step)
        return env_state, self.mesh.mean_metrics(metrics)

    def _random_action(self):
        """Uniform in [-1, 1], or in [0, nr_actions) for discrete actions
        (each seed's rows from its own generator)."""
        if self.parallel is not None:
            return self.parallel.merge(self.parallel.draw(self._random_action_of))
        return self.mesh.rows(self._random_action_of(self.generator))

    def _random_action_of(self, generator):
        if self.discrete:
            return torch.randint(0, self.nr_actions, (self.nr_envs,), generator=generator,
                                 device=self.device, dtype=torch.int32)
        return 2.0 * torch.rand((self.nr_envs, self.action_dim), generator=generator,
                                device=self.device) - 1.0

    def _prefill(self, buffer, env_state):
        """Uniform random actions; the normalizers do not see these steps."""
        with torch.no_grad():
            for _ in range(self.prefill_iterations):
                action = self._random_action()
                observation = env_state.observation
                env_state = self.train_env.step(env_state, self.process_action(action))
                self._store_step(buffer, observation, action, env_state)
        return env_state

    def initial_step(self, count=0):
        """The learning-step count ``count`` as the learning step takes it: a
        0-dim int64 device tensor where ``train()`` replays a captured
        learning step (``capture_choice``), so that the step reads nothing
        back; a host int in the eager loop (the CPU, parallel seeds, a mesh,
        the families that do not capture), where a hook may branch on it."""
        if capture_choice(self)[0]:
            return torch.full((), count, dtype=torch.int64, device=self.device)
        return count

    def learning_iteration(self, env_state, step):
        """One learning step (``_learning_step``) on the model's buffer at the
        learning-step count ``step`` (``initial_step``), its metrics added
        into ``metric_sums`` when logging is active -> (env state, ``step +
        1``, the step's metrics).

        The unit a CUDA graph captures is this one step, not a logging
        iteration: a logging iteration's step count is a config value
        (``logging_frequency // nr_envs``, from 1 to thousands of steps), and
        a graph of one step keeps the capture, its memory pool and its node
        count one step's size, while a replay costs the host one graph
        launch; ``_logging_iteration`` replays it
        ``nr_updates_per_logging_iteration`` times."""
        env_state, metrics = self._learning_step(self.buffer, env_state, step)
        if self.logging_active:
            means = self.mesh.mean_metrics({key: v.float().mean() for key, v in env_state.info.items()})
            means.update(metrics)
            for key, v in means.items():
                if key not in self.metric_sums:
                    self.metric_sums[key] = torch.zeros_like(v.detach())
                self.metric_sums[key].add_(v.detach())
        return env_state, step + 1, metrics

    def _logging_iteration(self, env_state, step, step_base):
        """``nr_updates_per_logging_iteration`` learning steps from the count
        ``step`` (``step_base`` on the host), replayed where a graph was
        captured; then the log line of their mean metrics.  -> (env state,
        the count after them)."""
        iterate = self.captured_iteration or self.learning_iteration
        if self.metric_sums:
            torch._foreach_zero_(list(self.metric_sums.values()))
        for _ in range(self.nr_updates_per_logging_iteration):
            env_state, step, _ = iterate(env_state, step)
            self.nr_updates += 1
        nr_updates = step_base + self.nr_updates_per_logging_iteration
        if self.logging_active:
            values = {key: float(v) / self.nr_updates_per_logging_iteration for key, v in self.metric_sums.items()}
            now = time.time()
            values["time/sps"] = int(
                self.nr_envs * self.nr_updates_per_logging_iteration / max(now - self._last_log_time, 1e-9)
            )
            self._last_log_time = now
            values["steps/nr_env_steps"] = nr_updates * self.nr_envs
            values["steps/nr_updates"] = nr_updates
            self.metrics_history.append(values)
            self.logger.log_dict(values, nr_updates * self.nr_envs)
        return env_state, step

    @torch.no_grad()
    def _eval_iteration(self, eval_save_iteration):
        """``horizon`` deterministic steps from a fresh eval reset; the mean of
        every ``rollout/*`` info key becomes ``eval/*``."""
        eval_env_state = self.eval_env.reset(eval_reset_seed(self), eval_mode=True)
        for _ in range(self.horizon):
            action = self._eval_act(eval_env_state.observation)
            eval_env_state = self.eval_env.step(eval_env_state, self.process_action(action))
        eval_metrics = eval_means(self, eval_env_state.info)
        if self.logging_active:
            self.logger.log_dict(eval_metrics, (eval_save_iteration + 1) * self.eval_save_frequency)
        return eval_metrics

    def _init_train_carry(self):
        """(env state after the prefill, the learning-step count at 0, best
        eval return), from a new buffer (``self.buffer``) and the reset that
        starts this ``train()`` call; the metric sums start anew."""
        self.buffer = self._make_buffer()
        self.metric_sums = {}
        env_state = self._prefill(self.buffer, self.train_env.reset(train_reset_seed(self)))
        return env_state, self.initial_step(), -math.inf

    def _eval_save_iteration(self, carry, eval_save_iteration):
        env_state, step, best_return = carry
        for j in range(self.nr_loggings_per_eval_save_iteration):
            logging_iteration = eval_save_iteration * self.nr_loggings_per_eval_save_iteration + j
            step_base = logging_iteration * self.nr_updates_per_logging_iteration
            env_state, step = self._logging_iteration(env_state, step, step_base)
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
        return (env_state, step, best_return), eval_metrics

    def train(self):
        start = self._last_log_time = time.time()
        (self.env_state, _, _), eval_history = run_training_program(self)
        if self.parallel is not None:
            self._keep_first_seed()
        self.eval_history = None
        if eval_history is not None:
            # x-axis in env interactions consumed: the random prefill
            # (learning_starts) comes before the first recorded point
            steps = self.learning_starts + (np.arange(self.nr_eval_save_iterations) + 1) * self.eval_save_frequency
            self.eval_history = {"steps": steps, **eval_history}
        rlx_logger.info(f"Average time: {time.time() - start:.2f} s")

    # --- save / load / test ------------------------------------------------
    def checkpoint_tree(self):
        """``{name: params}`` per ``TrainState``, ``{name_target: target
        params}`` for each that has a target, and ``{name: tensors}`` per
        dict state; with
        ``runner.save_optimizer_state``, ``{"full": ...}`` with the
        optimizers' state and the update count as well."""
        states = {name: self._whole_env_rows(name, getattr(self, name)) for name in self.state_names}
        if self.config.runner.save_optimizer_state:
            full = {name: state.state_dict() if isinstance(state, TrainState) else state
                    for name, state in states.items()}
            return {"full": {**full, "nr_updates": self.nr_updates}}
        tree = {}
        for name, state in states.items():
            if isinstance(state, TrainState):
                tree[name] = state.module.state_dict()
                if state.target is not None:
                    tree[f"{name}_target"] = state.target.state_dict()
            else:
                tree[name] = state
        return tree

    def restore_from_tree(self, tree):
        full = tree.get("full")
        for name in self.state_names:
            state = getattr(self, name)
            if isinstance(state, TrainState):
                if full is not None:
                    state.load_state_dict(full[name])
                else:
                    state.module.load_state_dict(tree[name])
                    if state.target is not None:
                        state.target.load_state_dict(tree[f"{name}_target"])
            else:
                stored = (full if full is not None else tree)[name]
                rows = self.env_row_states.get(name, ())
                setattr(self, name, {k: self.mesh.rows(v.to(self.device)) if k in rows else v.to(self.device)
                                     for k, v in stored.items()})
        if full is not None:
            self.nr_updates = full["nr_updates"]

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
            action = self.eval_act(env_state.observation)
            return self.eval_env.step(env_state, self.process_action(action))

        seed = int(torch.randint(2**31 - 1, (), generator=self.host_generator))
        env_state = self.eval_env.reset(seed, eval_mode=True)
        return collect_test_returns(step, env_state, episodes, self.horizon)
