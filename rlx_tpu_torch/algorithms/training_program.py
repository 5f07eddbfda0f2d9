"""The training run as a host loop over eval/save iterations, and the
learning iteration captured as one CUDA graph.

Every algorithm's run is ``nr_eval_save_iterations`` calls of
``model._eval_save_iteration(carry, i)`` from ``model._init_train_carry()``,
as in the JAX package (``rlx_tpu/algorithms/training_program.py``).  JAX
runs it either fused (one jitted scan over the whole run) or chunked (one
device call per eval/save iteration, ``runner.chunked_train=True``); its
``tests/test_chunked_train.py`` pins both modes to the same eval history.
The port always runs the chunked loop, one host call per eval/save
iteration, and accepts ``runner.chunked_train`` with either value: eval,
saving and logging stay on the host between learning iterations.

On the card, torch's counterpart of a jitted learning iteration is a
captured CUDA graph (``CapturedIteration``): the rollout with its B2
launches, the value passes, B1 or the family's own targets and the
minibatch updates recorded once and replayed once per learning iteration,
with no host work between the kernels.  For the off-policy families that
capture (FastTD3, FastSAC, SAC, TD3 and DDPG) the unit is one learning
step (act, env step with its B2 launch, store, sample, update with its B3
launch for FastTD3 and FastSAC; ``offpolicy.py::learning_iteration``),
replayed ``nr_updates_per_logging_iteration`` times a logging iteration.
``capture_choice`` says when: a
model on a CUDA device, at dp = tp = 1, with one seed, whose class and env
both declare ``capturable`` (the PPO family, the recurrent PPOs, REPPO, PQN
and those five off-policy families on the Ant, CartPole and Pendulum, and
the continuous ones on the robot
envs, ``locomotion.robot`` on the plane or a heightfield and
``locomotion.soccer``, through any wrapper).  On the plane the graph holds
the substep kernel's launches; over a heightfield the engine's eager path,
whose constants live on the device.  Everything else, the CPU always, runs
the eager loop.  ``train()`` logs one INFO line
with the path and the reason.  A capture or a replay that fails raises;
nothing falls back to the eager loop.

Each ``train()`` call starts from a fresh env reset (``train_reset_seed``)
and captures anew.  With parallel seeds (``model.parallel``,
``parallel_seeds.py``) each eval metric is one value per seed, and the
history is ``[S, nr_eval_save_iterations]``, as the JAX package's vmapped
program returns it.
"""

import time

import numpy as np
import torch
import torch.utils._pytree as pytree

from rlx_tpu_torch.utils.logging import rlx_logger


def run_training_program(model):
    """-> (final_carry, eval_history).

    ``eval_history`` maps each eval metric to a numpy array of
    ``[nr_eval_save_iterations]`` values (``[S, nr_eval_save_iterations]``
    with S parallel seeds), or is None when evaluation is inactive.  Where
    ``capture_choice`` allows it, ``model.captured_iteration`` holds this
    call's ``CapturedIteration`` while the loop runs.
    """
    capture, reason = capture_choice(model)
    rlx_logger.info(f"Learning iterations: {'one captured CUDA graph, replayed' if capture else 'eager'} "
                    f"({reason})")
    carry = model._init_train_carry()
    evals = []
    if capture:
        model.captured_iteration = CapturedIteration(model)
    try:
        for i in range(model.nr_eval_save_iterations):
            carry, eval_metrics = model._eval_save_iteration(carry, i)
            if eval_metrics is not None:
                evals.append(eval_metrics)
    finally:
        if capture:
            model.captured_iteration.close()
            model.captured_iteration = None
    # [iterations] or [iterations, S] -> [iterations] or [S, iterations]
    eval_history = {k: np.asarray([e[k] for e in evals]).T for k in evals[0]} if evals else None
    return carry, eval_history


def capture_choice(model):
    """(whether ``train()`` replays a captured learning iteration, why).

    Reads only the model's attributes: ``device``, ``parallel`` (parallel
    seeds), ``mesh`` (its ``dp`` and ``tp``), ``train_env`` and the class's
    ``capturable`` (a subclass of a family that captures declares False
    when it does not); an env (a wrapper passes on its inner env's answer)
    declares ``capturable`` too."""
    name = type(model).__name__
    device = torch.device(getattr(model, "device", "cpu"))
    if device.type != "cuda":
        return False, f"the model is on {device.type}: only a CUDA device replays a graph"
    if not getattr(type(model), "capturable", False):
        return False, f"{name} has no captured learning iteration"
    parallel = getattr(model, "parallel", None)
    if parallel is not None:
        return False, f"{parallel.nr_seeds} parallel seeds"
    mesh = getattr(model, "mesh", None)
    if mesh is not None and (mesh.dp > 1 or mesh.tp > 1):
        return False, f"a dp = {mesh.dp}, tp = {mesh.tp} mesh"
    env = model.train_env
    if not getattr(env, "capturable", False):
        return False, f"the env {type(env).__name__} does not declare capture"
    return True, f"{name} on {type(env).__name__}, one seed, one device"


def launch_counters():
    """The kernel wrappers whose ``launches`` attribute counts their launches."""
    from rlx_tpu_torch.ops.engine_substep_cuda import step_cuda
    from rlx_tpu_torch.ops.gae_cuda import gae_advantages_cuda
    from rlx_tpu_torch.ops.projection_cuda import categorical_projection_cuda

    return step_cuda, gae_advantages_cuda, categorical_projection_cuda


def _module_tensors(name, module):
    return {f"{name}.{k}": t for k, t in [*module.named_parameters(), *module.named_buffers()]}


def _optimizer_tensors(name, optimizer):
    out = {}
    for i, p in enumerate(optimizer.param_groups[0]["params"]):
        out.update({f"{name}.{i}.{k}": t for k, t in optimizer.state[p].items()})
    return out


def model_tensors(model):
    """name -> every tensor ``model`` holds: its nets' parameters and
    buffers (a net or an object with a ``module`` net; a ``TrainState``'s
    target and its optimizer's state too), its optimizers' state, a replay
    buffer's storage, write head and fill, its tensor attributes and dicts
    of tensors.  A captured iteration reads and writes these tensors
    themselves, so an iteration must update each in place and bind no
    attribute to a new one."""
    from rlx_tpu_torch.ops.replay_buffer import ReplayBuffer

    out = {}
    for name, value in vars(model).items():
        module = value if isinstance(value, torch.nn.Module) else getattr(value, "module", None)
        if isinstance(module, torch.nn.Module):
            out.update(_module_tensors(name, module))
            if isinstance(getattr(value, "target", None), torch.nn.Module):
                out.update(_module_tensors(f"{name}.target", value.target))
            if isinstance(getattr(value, "optimizer", None), torch.optim.Optimizer):
                out.update(_optimizer_tensors(f"{name}.optimizer", value.optimizer))
        elif isinstance(value, torch.optim.Optimizer):
            out.update(_optimizer_tensors(name, value))
        elif isinstance(value, ReplayBuffer):
            storage = value.storage if isinstance(value.storage, dict) else {"storage": value.storage}
            out.update({f"{name}.{k}": t for k, t in storage.items()})
            out.update({f"{name}.pos": value.pos, f"{name}.size": value.size})
        elif isinstance(value, torch.Tensor):
            out[name] = value
        elif isinstance(value, dict) and value and all(isinstance(t, torch.Tensor) for t in value.values()):
            out.update({f"{name}.{k}": t for k, t in value.items()})
    return out


def copy_carry_(dst, src):
    """In place: each tensor of the carry ``dst`` (tensors in tuples, lists
    and dicts) takes the value of the same tensor of ``src``, a carry of the
    same structure, shapes and types (the end of a captured learning
    iteration, as ``EnvState.copy_``).  A tensor of ``src`` that is one of
    ``dst``'s is read before any is written."""
    (mine, spec), (theirs, other_spec) = pytree.tree_flatten(dst), pytree.tree_flatten(src)
    if spec != other_spec:
        raise ValueError("the carries differ in structure")
    written = {x.data_ptr() for x in mine}
    pairs = []
    for d, s in zip(mine, theirs):
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(f"a carry tensor {tuple(s.shape)} {s.dtype} cannot take the place of "
                             f"{tuple(d.shape)} {d.dtype}")
        pairs.append((d, s.clone() if s is not d and s.data_ptr() in written else s))
    for d, s in pairs:
        if s is not d:
            d.copy_(s)
    return dst


class CapturedIteration:
    """``model.learning_iteration`` captured once as a ``torch.cuda.CUDAGraph``
    and replayed; called as it, ``(env_state, *carry) -> (env_state, *carry,
    metrics)``, where ``carry`` is the rest of the iteration's device carry,
    tensors in tuples and dicts: the recurrent policy's carry, PQN's update
    step, the off-policy learning-step count, nothing for the PPO family.

    - The first call runs the iteration eagerly on the capture stream: a
      real iteration, and the warm-up (the kernels built, B2's tables
      uploaded and its shared memory granted, Adam's state and the
      gradients allocated).
    - The second copies its env state and carry into static tensors,
      allocated outside the graph's memory pool, captures one iteration
      from them that ends by copying the new env state and carry into
      them, and replays it.
    - Every later call replays it.

    A replay returns the static env state and carry and the graph's metric
    tensors; the next replay overwrites them, so read the metrics before
    it.  Everything else an iteration changes is the same tensors eagerly
    and in the graph, updated in place: the nets' parameters and gradients,
    Adam's moments and step counts, the model's device step count, REPPO's
    observation normalizer and old-policy snapshot, the off-policy targets,
    observation normalizer and metric sums, and the replay buffer's
    storage, write head and fill.  The buffer, a run's largest tensor, is
    held by the model and never in the carry, so a capture never clones
    it.  The model's generator
    and the env state's are registered with the graph: each replay draws
    fresh noise, the noise the eager iteration draws from the same
    generator states.

    The kernel wrappers' launch counters tick once while the capture
    records (which launches nothing); the capture takes that tick back and
    each replay adds the launches it recorded, so a counter counts the
    launches that ran, on either path.
    """

    def __init__(self, model):
        self.model = model
        self.device = torch.device(model.device)
        self.stream = torch.cuda.Stream(device=self.device)
        self.warm = False
        self.graph = None
        self.state = self.carry = self.metrics = None
        self.launches = None          # each counter's launches in one replay
        self.capture_seconds = None   # host seconds the capture took
        self.pool_bytes = None        # device memory the capture reserved

    def __call__(self, env_state, *carry):
        if not self.warm:
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                out = self.model.learning_iteration(env_state, *carry)
            current.wait_stream(self.stream)
            self.warm = True
            return out
        if self.graph is None:
            self.capture(env_state, carry)
        self.replay()
        return (self.state, *self.carry, self.metrics)

    def capture(self, env_state, carry=()):
        """Record one learning iteration from a static copy of ``env_state``
        and ``carry``."""
        model = self.model
        self.state = env_state.map_tensors(torch.clone)
        self.carry = pytree.tree_map(torch.clone, tuple(carry))
        graph = torch.cuda.CUDAGraph()
        for generator in (model.generator, *self.state.generators()):
            graph.register_generator_state(generator)
        counters = launch_counters()
        before = [c.launches for c in counters]
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=self.stream):
            new_state, *new_carry, self.metrics = model.learning_iteration(self.state, *self.carry)
            copy_carry_(self.carry, tuple(new_carry))
            self.state.copy_(new_state)
        self.capture_seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.launches = [c.launches - n for c, n in zip(counters, before)]
        for c, n in zip(counters, self.launches):
            c.launches -= n
        self.graph = graph

    def replay(self):
        """One learning iteration: the graph replayed on the current stream."""
        self.graph.replay()
        for c, n in zip(launch_counters(), self.launches):
            c.launches += n

    def close(self):
        """Drop the graph and its memory pool (the static env state and
        carry stay)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.metrics = None


def train_reset_seed(model):
    """The seed of the env reset that starts a ``train()`` call: the
    environment's seed on the model's first call, a fresh draw from
    ``model.host_generator`` on every later one (the JAX package splits a
    fresh reset key off the model's key for every call).  With parallel
    seeds, the list of each seed's."""
    model.nr_train_resets += 1
    parallel = getattr(model, "parallel", None)
    if parallel is not None:
        return parallel.seeds if model.nr_train_resets == 1 else parallel.host_seeds()
    if model.nr_train_resets == 1:
        return model.seed
    return int(torch.randint(2**31 - 1, (), generator=model.host_generator))


def eval_reset_seed(model):
    """The seed of an eval or test reset: a draw from ``model.host_generator``,
    or with parallel seeds one from each seed's."""
    parallel = getattr(model, "parallel", None)
    if parallel is not None:
        return parallel.host_seeds()
    return int(torch.randint(2**31 - 1, (), generator=model.host_generator))


def eval_means(model, info):
    """Each ``rollout/*`` info key as ``eval/*``: its mean over the envs, a
    float, or with parallel seeds over each seed's envs, a ``[S]`` array.
    On a dp mesh (``model.mesh``) the mean is over every rank's eval envs."""
    parallel = getattr(model, "parallel", None)
    mesh = getattr(model, "mesh", None)
    out = {}
    for k, v in info.items():
        if k.startswith("rollout/"):
            name = "eval/" + k.split("rollout/", 1)[1]
            v = v.to(torch.promote_types(v.dtype, torch.float32))
            if parallel is not None:
                out[name] = parallel.split(v).mean(dim=1).cpu().numpy()
            else:
                out[name] = v.mean()
    if mesh is not None and parallel is None:
        out = {k: float(v) for k, v in mesh.mean_metrics(out).items()}
    elif parallel is None:
        out = {k: float(v) for k, v in out.items()}
    return out
