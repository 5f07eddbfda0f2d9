"""How far the two f32 versions of a robot's physics substep part, and why.

    python -m rlx_tpu_torch.benchmarks.b2_robot_conditioning [--robots go2 quadruped] [--seeds 47 0 1 2]

For each robot on the plane and each seed of the action generator, the
case ``chip_smoke.py`` holds B2 on (4096 envs in evaluation mode, two env
steps after the reset, the env's own DomainParams with a per-dof damping
scale in [0.5, 1.5) times the env's, its delayed PD targets as a
ctrl_sequence, the envs the last step did not reset): the kernel
(``step_cuda``) against the f32 plain version (``engine.step_reference``),
and each against the plain version in float64, per env.  Prints one JSON
line per case: the max |err| of each pair, its 99.9th percentile over the
envs, and the number of envs beyond 1e-4.  Where the f32 plain version
itself stands beyond 1e-4 from float64 in some envs, the stiff contacts
there amplify rounding, and the two f32 versions part by as much without
either being wrong.  Needs a CUDA device.
"""

import argparse
import json

import torch

from rlx_tpu_torch.config import make_config
from rlx_tpu_torch.environments.locomotion.robot.cuda.environment import LocomotionEnv
from rlx_tpu_torch.ops import _build
from rlx_tpu_torch.ops.engine_substep_cuda import step_cuda
from rlx_tpu_torch.physics import engine


def per_env_err(outs, refs, nr_envs):
    """max |out - ref| per env over the substep's outputs, in float64."""
    return torch.stack([(o.double() - r.double()).abs().reshape(nr_envs, -1).max(1).values
                        for o, r in zip(outs, refs)]).max(0).values


def substep_case(env_class, env_name, overrides, g, nr_envs=4096):
    """(env, state, args, kw) of B2's robot case: ``env_class`` at
    ``nr_envs`` envs in evaluation mode (every randomization axis drawn),
    two env steps of actions from ``g`` after the reset, then the
    ``step_cuda`` / ``engine.step_reference`` arguments of the next control
    step: the env's own DomainParams with its damping scale times a factor
    in [0.5, 1.5) per dof and env, and its delayed PD targets as a
    ctrl_sequence (``chip_smoke.py`` phases 29 and 47 hold the kernel on
    it)."""
    dev = torch.device("cuda")
    config = make_config("ppo.cuda", env_name, **{"runner.device": "cuda", "environment.nr_envs": nr_envs,
                                                   **overrides})
    env = env_class(config.environment, nr_envs, device="cuda")
    state = env.reset(1, eval_mode=True)
    for _ in range(2):
        state = env.step(state, 2.0 * torch.rand(nr_envs, env.nr_actuator_joints, device=dev, generator=g) - 1.0)
    internal = state.physics["internal"]
    action = 2.0 * torch.rand(nr_envs, env.nr_actuator_joints, device=dev, generator=g) - 1.0
    delayed, _ = env.action_delay.delay_action(action, internal)
    targets = env.control_function.process_action(delayed, internal).contiguous()
    dr = env._domain_params(internal)
    dr = dr._replace(damping_scale=dr.damping_scale * (0.5 + torch.rand(dr.damping_scale.shape, device=dev,
                                                                         generator=g)))
    args = (env.model, state.physics["qpos"], state.physics["qvel"], targets[0])
    kw = dict(nr_substeps=env.nr_substeps, dr=dr, ctrl_sequence=targets, contact_state=state.physics["contact_anchor"])
    return env, state, args, kw


def float64_reference(args, kw):
    """``engine.step_reference`` on ``step_cuda``'s arguments in float64."""
    to64 = lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point() else x
    return engine.step_reference(
        args[0], *(to64(a) for a in args[1:]), nr_substeps=kw["nr_substeps"],
        dr=None if kw.get("dr") is None else type(kw["dr"])(*(to64(f) for f in kw["dr"])),
        ctrl_sequence=to64(kw.get("ctrl_sequence")), contact_state=to64(kw.get("contact_state")))


def case(robot, seed, nr_envs=4096):
    """One JSON row: the robot on the plane, the actions from ``seed``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    env, state, args, kw = substep_case(LocomotionEnv, "locomotion.robot.cuda", {
        "environment.robot": robot, "environment.terrain.type": "plane"}, g, nr_envs)
    kernel = step_cuda(*args, **kw)
    plain = engine.step_reference(*args, **kw)
    plain64 = float64_reference(args, kw)
    torch.cuda.synchronize()
    kept = ~(state.terminated | state.truncated)
    row = {"robot": robot, "seed": seed, "envs": int(kept.sum())}
    for name, outs, refs in (("kernel_vs_plain", kernel, plain), ("kernel_vs_float64", kernel, plain64),
                             ("plain_vs_float64", plain, plain64)):
        err = per_env_err(outs, refs, nr_envs)[kept]
        row[name] = {"max": err.max().item(), "p999": err.quantile(0.999).item(),
                     "envs_beyond_1e-4": int((err > 1e-4).sum())}
    return row


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--robots", nargs="+", default=["go2", "quadruped"])
    parser.add_argument("--seeds", nargs="+", type=int, default=[47, 0, 1, 2])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("b2_robot_conditioning runs the CUDA kernel: it needs a CUDA device")
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products, as chip_smoke.py
    for robot in args.robots:
        for seed in args.seeds:
            print(json.dumps(case(robot, seed)), flush=True)


if __name__ == "__main__":
    main()
