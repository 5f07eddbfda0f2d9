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
seed (as the JAX package's), and every state is seed-stacked; the buffer
holds the ``S * N`` env rows, each seed samples only its own rows from its
own generator (the prefill's random actions likewise), and an algorithm
that declares ``parallel_seeds = True`` in its own class body supplies
``act_draws(generator)`` (the act's draws of one seed, in its one-seed
order) and ``update_seeds(batch, step)``, which maps its losses over the
seeds (``seed_map``) and steps the stacked optimizers.  Any other family
raises ``NotImplementedError`` at S > 1.  Not ported yet (a config that asks
for it has no such key, so it raises): the device mesh.
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
    eval_means, eval_reset_seed, run_training_program, train_reset_seed,
)
from rlx_tpu_torch.environments.types import ActionSpaceType
from rlx_tpu_torch.models.mlp import observation_width
from rlx_tpu_torch.models.policy_factory import image_shape
from rlx_tpu_torch.ops import replay_buffer as rb
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
        self.obs_store_dtype = torch.float32 if self.image_shape is None else torch.uint8
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

        self.parallel = None
        if nr_seeds == 1:
            self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
            self.host_generator = torch.Generator().manual_seed(self.seed)
            self.setup_states()
        else:
            self._setup_seed_states(ParallelSeeds(self.seed, nr_seeds, self.device))
        self.nr_train_resets = 0
        self.nr_updates = 0          # learning steps taken, over every train() call
        self.metrics_history = []   # per-logging-iteration float metrics
        self.eval_history = None

    # --- algorithm hooks ---------------------------------------------------
    state_names = ()
    parallel_seeds = False   # declared True by a family's own class body

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

    # --- parallel seeds ----------------------------------------------------
    def _setup_seed_states(self, parallel):
        """``setup_states`` once per seed under that seed, each state then
        seed-stacked; the one-seed generators stand aside until ``train()``
        hands seed 0's back (``_keep_first_seed``)."""
        seed = self.seed
        per_seed = []
        for s in range(parallel.nr_seeds):
            self.seed = parallel.seeds[s]
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

    def _act(self, observation, step):
        if self.parallel is None:
            return self.act(observation, step=step)
        P = self.parallel
        draws = P.draw(self.act_draws)
        return P.merge(self.seed_map(lambda o, d: self.act(o, step=step, **d), P.split(observation), draws))

    def _eval_act(self, observation):
        if self.parallel is None:
            return self.eval_act(observation)
        return self.parallel.merge(self.seed_map(self.eval_act, self.parallel.split(observation)))

    def _sample_seeds(self, buffer):
        """Each seed's batch from its own env rows and generator, drawn as its
        one-seed run draws it; one gather for all seeds -> ``[S, B, ...]``."""
        P = self.parallel
        if self.n_step > 1:
            high = max(buffer.size - self.n_step + 1, 1)
        else:
            high = buffer.size
        idx = P.draw(lambda g: torch.stack([rb._randint(g, high, self.batch_size, self.device),
                                            rb._randint(g, self.nr_envs, self.batch_size, self.device)]))
        t_idx = idx[:, 0].reshape(-1)
        e_idx = P.rows(idx[:, 1], self.nr_envs)
        total = P.nr_seeds * self.batch_size
        if self.n_step > 1:
            flat = rb.sample_nstep(buffer, None, total, self.n_step, self.gamma, t0=t_idx, e_idx=e_idx)
        else:
            flat = rb.sample(buffer, None, total, t_idx=t_idx, e_idx=e_idx)
        return {k: P.split(v) for k, v in flat.items()}

    # --- scaffolding -------------------------------------------------------
    def _make_buffer(self):
        nr_env_rows = self.nr_envs * (1 if self.parallel is None else self.parallel.nr_seeds)
        return rb.create(self.capacity, nr_env_rows, {
            "observation": (self.os_shape, self.obs_store_dtype),
            "next_observation": (self.os_shape, self.obs_store_dtype),
            "action": ((), torch.int32) if self.discrete else ((self.action_dim,), torch.float32),
            "reward": ((), torch.float32),
            "terminated": ((), torch.float32),
            "truncated": ((), torch.float32),
            **self.extra_buffer_fields(),
        }, device=self.device)

    def _store_step(self, buffer, observation, action, env_state):
        rb.add(buffer, {
            "observation": observation.to(self.obs_store_dtype),
            "next_observation": env_state.final_observation.to(self.obs_store_dtype),
            "action": action,
            "reward": env_state.reward,
            "terminated": env_state.terminated.to(torch.float32),
            "truncated": env_state.truncated.to(torch.float32),
        })

    def sample_batch(self, buffer):
        """One batch under the ``<name>/sample`` span."""
        with record_function(f"{self.name}/sample"), torch.no_grad():
            return self._sample(buffer)

    def _sample(self, buffer):
        if self.parallel is not None:
            return self._sample_seeds(buffer)
        if self.n_step > 1:
            return rb.sample_nstep(buffer, self.generator, self.batch_size, self.n_step, self.gamma)
        return rb.sample(buffer, self.generator, self.batch_size)

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
                return env_state, self.update_with_buffer(buffer, step)
        batch = self.sample_batch(buffer)
        with record_function(f"{self.name}/update"):
            metrics = self.update(batch, step) if self.parallel is None else self.update_seeds(batch, step)
        return env_state, metrics

    def _random_action(self):
        """Uniform in [-1, 1], or in [0, nr_actions) for discrete actions
        (each seed's rows from its own generator)."""
        if self.parallel is not None:
            return self.parallel.merge(self.parallel.draw(self._random_action_of))
        return self._random_action_of(self.generator)

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

    def _logging_iteration(self, buffer, env_state, step_base):
        sums = {}
        for k in range(self.nr_updates_per_logging_iteration):
            env_state, metrics = self._learning_step(buffer, env_state, step_base + k)
            self.nr_updates += 1
            if self.logging_active:
                means = {key: v.float().mean() for key, v in env_state.info.items()}
                means.update(metrics)
                for key, v in means.items():
                    sums[key] = sums[key] + v.detach() if key in sums else v.detach()
        nr_updates = step_base + self.nr_updates_per_logging_iteration
        if self.logging_active:
            values = {key: float(v) / self.nr_updates_per_logging_iteration for key, v in sums.items()}
            now = time.time()
            values["time/sps"] = int(
                self.nr_envs * self.nr_updates_per_logging_iteration / max(now - self._last_log_time, 1e-9)
            )
            self._last_log_time = now
            values["steps/nr_env_steps"] = nr_updates * self.nr_envs
            values["steps/nr_updates"] = nr_updates
            self.metrics_history.append(values)
            self.logger.log_dict(values, nr_updates * self.nr_envs)
        return env_state

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
        """(buffer, env state after the prefill, best eval return), from a
        new buffer and the reset that starts this ``train()`` call."""
        buffer = self._make_buffer()
        env_state = self._prefill(buffer, self.train_env.reset(train_reset_seed(self)))
        return buffer, env_state, -math.inf

    def _eval_save_iteration(self, carry, eval_save_iteration):
        buffer, env_state, best_return = carry
        for j in range(self.nr_loggings_per_eval_save_iteration):
            logging_iteration = eval_save_iteration * self.nr_loggings_per_eval_save_iteration + j
            step_base = logging_iteration * self.nr_updates_per_logging_iteration
            env_state = self._logging_iteration(buffer, env_state, step_base)
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
        return (buffer, env_state, best_return), eval_metrics

    def train(self):
        start = self._last_log_time = time.time()
        (self.buffer, self.env_state, _), eval_history = run_training_program(self)
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
        states = {name: getattr(self, name) for name in self.state_names}
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
                setattr(self, name, {k: v.to(self.device) for k, v in stored.items()})
        if full is not None:
            self.nr_updates = full["nr_updates"]

    def save(self, file_name="latest.model"):
        ckpt.save_model_file(self.save_path, file_name, self.checkpoint_tree(), self.config.algorithm.to_dict())

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
