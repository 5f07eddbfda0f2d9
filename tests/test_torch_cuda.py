"""Kernels of rlx_tpu_torch against their plain versions on the card.

These tests need an NVIDIA GPU and skip without one.  They import neither
jax nor rlx_tpu, so they also run on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from rlx_tpu_torch.environments.locomotion.ant.cuda.environment import ANT_MODEL
from rlx_tpu_torch.ops.distributional import categorical_projection_dense, categorical_projection_reference
from rlx_tpu_torch.ops import engine_substep_cuda
from rlx_tpu_torch.ops.engine_substep_cuda import step_cuda
from rlx_tpu_torch.ops.gae import gae_advantages_reference
from rlx_tpu_torch.ops.gae_cuda import gae_advantages_cuda
from rlx_tpu_torch.ops.projection_cuda import categorical_projection_cuda
from rlx_tpu_torch.physics import engine, load_model


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,dtype", [
    (64, 4097, torch.bool),      # the PPO path's T, ragged B
    (64, 4096, torch.float32),
    (1, 1000, torch.bool),
    (17, 1000, torch.float32),
    (65, 1000, torch.uint8),     # two time chunks, the earlier one partial
    (200, 1000, torch.bool),
])
def test_gae_kernel_matches_reference(cuda, T, B, dtype):
    """f32, same operation order: rtol=atol=1e-5; two launches on the same
    input give the same bits."""
    rng = np.random.default_rng(T)
    r, v, nv = (torch.tensor(rng.normal(size=(T, B)), dtype=torch.float32, device=cuda)
                for _ in range(3))
    d = torch.tensor(rng.random((T, B)) < 0.05, device=cuda).to(dtype)
    launches = gae_advantages_cuda.launches
    out = gae_advantages_cuda(r, v, nv, d, 0.99, 0.95)
    assert gae_advantages_cuda.launches == launches + 1
    for o, x in zip(out, gae_advantages_reference(r, v, nv, d, 0.99, 0.95)):
        torch.testing.assert_close(o, x, rtol=1e-5, atol=1e-5)
    for o, again in zip(out, gae_advantages_cuda(r, v, nv, d, 0.99, 0.95)):
        assert torch.equal(o, again)


def _ant_variant(which):
    """The Ant, or the Ant without contacts / actuators (the ncon == 0 and
    nu == 0 branches; the card has no mujoco to compile another XML)."""
    model = load_model(ANT_MODEL)
    if which == "no_contacts":
        fields = ("con_body", "con_pos", "con_radius", "con_friction", "con_meff",
                  "con_m_app", "con_m_app_t")
    elif which == "no_actuators":
        fields = ("act_dof", "act_joint_body", "act_kp", "act_kv", "act_gear",
                  "act_is_position", "act_forcerange")
    else:
        fields = ()
    return model._replace(**{f: getattr(model, f)[:0] for f in fields})


def _ant_state(model, B, cuda, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    qpos0 = torch.as_tensor(model.qpos0, device=cuda)
    qpos = qpos0.repeat(B, 1) + 0.1 * torch.randn(B, model.nq, device=cuda, generator=g)
    qpos[:, 2] = 0.55 + 0.2 * torch.rand(B, device=cuda, generator=g)
    qpos[:, 3:7] /= qpos[:, 3:7].norm(dim=1, keepdim=True)
    qvel = 0.5 * torch.randn(B, model.nv, device=cuda, generator=g)
    nu = len(model.act_dof)
    ctrl = qpos0[7:7 + nu] + 0.3 * (2.0 * torch.rand(B, nu, device=cuda, generator=g) - 1.0)
    return qpos, qvel, ctrl, g


def _domain_params(model, B, cuda, g):
    u = lambda *shape: 0.8 + 0.4 * torch.rand(*shape, device=cuda, generator=g)
    nu = len(model.act_dof)
    return engine.DomainParams(
        mass_scale=u(model.nbody, B), damping_scale=u(B), frictionloss_scale=u(B),
        armature_scale=u(B), friction_scale=u(B), contact_stiffness_scale=u(B),
        kp_scale=u(nu, B), kv_scale=u(nu, B), forcerange_scale=u(nu, B),
        ctrl_offset=0.1 * (u(nu, B) - 1.0),
        gravity=torch.tensor([0.0, 0.0, -9.81], device=cuda)[:, None] * u(B),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("which,B,case", [
    ("ant", 256, "entry-pose anchors"),
    ("ant", 256, "given anchors"),
    ("ant", 4096, "all DomainParams"),
    ("ant", 1024, "given anchors"),
    ("ant", 1000, "all DomainParams"),
    ("ant", 1000, "ctrl_sequence"),
    ("no_contacts", 1000, "given anchors"),
    ("no_contacts", 256, "all DomainParams"),
    ("no_actuators", 1000, "entry-pose anchors"),
    ("no_actuators", 256, "all DomainParams"),
])
@pytest.mark.parametrize("lanes", [32, 16])
def test_substep_kernel_matches_reference(cuda, monkeypatch, which, B, case, lanes):
    """4 substeps (3 for ctrl_sequence), ragged B = 1000 included, at 32
    and 16 lanes per env; 1e-4 because the kernel sums in another order and
    contracts multiply-adds, which stiff contacts amplify."""
    monkeypatch.setattr(engine_substep_cuda, "lanes_per_env", lambda B: lanes)
    model = _ant_variant(which)
    qpos, qvel, ctrl, g = _ant_state(model, B, cuda)
    kw = {}
    if case != "entry-pose anchors":
        kw["contact_state"] = engine.contact_anchor_init(model, qpos)
    if case == "all DomainParams":
        kw["dr"] = _domain_params(model, B, cuda, g)
    if case == "ctrl_sequence":
        kw["ctrl_sequence"] = ctrl[None] + 0.1 * torch.randn(3, *ctrl.shape, device=cuda, generator=g)
    launches = step_cuda.launches
    out = step_cuda(model, qpos, qvel, ctrl, nr_substeps=4, **kw)
    assert step_cuda.launches == launches + 1
    ref = engine.step_reference(model, qpos, qvel, ctrl, nr_substeps=4, **kw)
    assert len(out) == len(ref) == (3 if "contact_state" in kw else 2)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_engine_step_dispatches_cuda_tensors_to_the_kernel(cuda):
    model = load_model(ANT_MODEL)
    qpos = torch.as_tensor(model.qpos0, device=cuda)[None].repeat(32, 1)
    qvel = torch.zeros(32, model.nv, device=cuda)
    launches = step_cuda.launches
    engine.step(model, qpos, qvel, qpos[:, 7:], nr_substeps=2)
    assert step_cuda.launches == launches + 1


@pytest.mark.cuda
def test_projection_kernel_matches_reference(cuda):
    """Ragged N, A_in != nr_atoms, positions beyond the support and on
    atoms; f32 with the same division, sums in another order: 1e-6."""
    rng = np.random.default_rng(5)
    z = rng.uniform(-14.0, 14.0, size=(1027, 51)).astype(np.float32)
    z[0, :3] = [-10.0, 0.0, 10.0]
    logits = rng.normal(size=z.shape)
    p = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    z, p = torch.tensor(z, device=cuda), torch.tensor(p, device=cuda)
    launches = categorical_projection_cuda.launches
    out = categorical_projection_dense(z, p, -10.0, 10.0, 101)
    assert categorical_projection_cuda.launches == launches + 1
    torch.testing.assert_close(out, categorical_projection_reference(z, p, -10.0, 10.0, 101),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError):
        categorical_projection_cuda(z, p.requires_grad_(), -10.0, 10.0, 101)


def _projection_case(name, rng):
    """(positions, masses, output atoms) of an edge case of the scatter."""
    shapes = {"fasttd3": (8192, 101), "v_max": (64, 101), "clipped": (64, 101), "two_atoms": (1000, 101),
              "wide_input": (64, 8192), "eleven_atoms": (1027, 101), "reversed": (512, 101)}
    n, a = shapes[name]
    z = rng.uniform(-14.0, 14.0, size=(n, a))
    if name in ("fasttd3", "reversed"):    # r + gamma_n (1 - d) atoms, increasing in j
        gamma = np.where(rng.random((n, 1)) < 0.1, 0.0, 0.97 ** rng.integers(1, 4, (n, 1)))
        z = 3.0 * rng.normal(size=(n, 1)) + gamma * np.linspace(-10.0, 10.0, a)
        z = z[:, ::-1] if name == "reversed" else z
    elif name == "v_max":                  # every b == A_out - 1
        z[:] = 10.0
    elif name == "clipped":                # runs of 32 lanes on one end atom
        z[: n // 2], z[n // 2:] = 13.0, -13.0
    logits = 2.0 * rng.normal(size=(n, a))
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    out_atoms = {"two_atoms": 2, "eleven_atoms": 11}.get(name, 101)
    return np.ascontiguousarray(z, dtype=np.float32), p.astype(np.float32), out_atoms


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fasttd3", "v_max", "clipped", "two_atoms", "wide_input",
                                  "eleven_atoms", "reversed"])
def test_projection_kernel_edge_cases(cuda, name):
    """The scatter's edge cases at 1e-6 against the dense plain version, and
    the same bits over two launches."""
    z, p, out_atoms = _projection_case(name, np.random.default_rng(6))
    z, p = torch.tensor(z, device=cuda), torch.tensor(p, device=cuda)
    out = categorical_projection_cuda(z, p, -10.0, 10.0, out_atoms)
    torch.testing.assert_close(out, categorical_projection_reference(z, p, -10.0, 10.0, out_atoms),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(out, categorical_projection_cuda(z, p, -10.0, 10.0, out_atoms))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "gru", "mamba2", "transformer"])
def test_recurrent_policy_on_the_card_matches_the_cpu(cuda, cell):
    """The recurrent policy's sequence re-run on the card (torch's fused
    LSTM / GRU cells there) gives the CPU's means and gradients, and every
    parameter gets a gradient (the fused LSTM cell drops the recurrent
    bias's gradient unless an input bias is passed too)."""
    from rlx_tpu_torch.models.recurrent import RecurrentPolicy

    torch.manual_seed(0)
    policy = RecurrentPolicy(3, 2, cell_type=cell, obs_encoding_dim=16, hidden_dim=8, cell_context_len=4,
                             cell_nr_heads=2, cell_state_dim=4, cell_conv_kernel=3)
    obs = torch.randn(12, 5, 3)
    dones = torch.rand(12, 5) < 0.2
    outs = {}
    for device in ("cpu", cuda):
        # gradients dropped before the move and copied after: Module.to
        # moves a parameter's gradient in place
        policy.zero_grad(set_to_none=True)
        policy.to(device)
        mean, logstd = policy.sequence(obs.to(device), dones.to(device), policy.initialize_carry(5))
        (mean.square().sum() + logstd.sum()).backward()
        assert all(p.grad is not None for p in policy.parameters())
        outs[str(device)] = [t.detach().cpu().clone() for t in (mean, *(p.grad for p in policy.parameters()))]
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("terrain", ["plane", "hfield_diverse"])
def test_robot_env_step_on_the_card_matches_the_cpu(cuda, terrain):
    """One step of the quadruped env at 64 envs in evaluation mode (every
    randomization axis drawn), from a state two steps after the reset,
    copied to the CPU, the card's draws replayed there, compared on the
    envs the state's last step did not reset (a reset leaves its lowest
    foot exactly on the ground, where the first contact's damper turns on
    the last bit of the kinematics): the plane step goes through
    the substep kernel, the heightfield step through the eager engine on
    the card; both against the CPU's eager engine at the kernel's
    tolerance, 1e-4 (f32, summed in other orders, through stiff contacts)."""
    from rlx_tpu_torch.config import make_config
    from rlx_tpu_torch.environments.locomotion.robot.cuda.draws import GeneratorDraws, ReplayDraws
    from rlx_tpu_torch.environments.locomotion.robot.cuda.environment import LocomotionEnv

    class Recording(GeneratorDraws):
        def __init__(self, *args):
            super().__init__(*args)
            self.values = []

        def uniform(self, *args):
            self.values.append(super().uniform(*args))
            return self.values[-1]

        def randint(self, *args):
            self.values.append(super().randint(*args))
            return self.values[-1]

        def bernoulli(self, *args):
            self.values.append(super().bernoulli(*args))
            return self.values[-1]

    def to_cpu(tree):
        return {k: to_cpu(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.cpu()

    config = make_config("ppo.cuda", "locomotion.robot.cuda", **{"runner.device": "cpu", "environment.nr_envs": 64,
                                                                 "environment.terrain.type": terrain})
    envs = {d: LocomotionEnv(config.environment, 64, device=d) for d in ("cuda", "cpu")}
    generator = torch.Generator().manual_seed(0)
    actions = [2.0 * torch.rand(64, envs["cpu"].nr_actuator_joints, generator=generator) - 1.0 for _ in range(3)]
    state = envs["cuda"].reset(0, eval_mode=True)
    for action in actions[:2]:
        state = envs["cuda"].step(state, action.to(cuda))
    cpu_state = state.replace(
        physics=to_cpu(state.physics), observation=state.observation.cpu(),
        final_observation=state.final_observation.cpu(), reward=state.reward.cpu(),
        terminated=state.terminated.cpu(), truncated=state.truncated.cpu(), info=to_cpu(state.info),
        episode_store=to_cpu(state.episode_store), generator=torch.Generator().manual_seed(0),
    )
    kept = ~(state.terminated | state.truncated).cpu()
    draws = Recording(torch.Generator(device="cuda").manual_seed(1), cuda)
    launches = step_cuda.launches
    state = envs["cuda"].step(state, actions[2].to(cuda), draws=draws)
    assert step_cuda.launches == launches + (terrain == "plane")
    cpu_state = envs["cpu"].step(cpu_state, actions[2], draws=ReplayDraws([v.cpu() for v in draws.values], "cpu"))
    assert int(kept.sum()) >= 32
    for name in ("qpos", "qvel", "contact_anchor"):
        torch.testing.assert_close(state.physics[name].cpu()[kept], cpu_state.physics[name][kept], rtol=1e-4,
                                   atol=1e-4)
    torch.testing.assert_close(state.reward.cpu()[kept], cpu_state.reward[kept], rtol=1e-4, atol=1e-4)
    assert torch.equal(state.terminated.cpu()[kept], cpu_state.terminated[kept])


@pytest.mark.cuda
def test_nature_cnn_on_the_card_matches_the_cpu(cuda):
    """NatureCNN's Q-network at batch 256 on 84 x 84 x 4 frames, uint8 in as
    the replay feeds it: outputs and every parameter's gradient (of the
    mean of the squared outputs, as ``chip_smoke.py`` phase 33) on the card
    (cuDNN's convolutions held to float32, as the runner sets them)
    against the CPU, at f32 tolerances for sums in another order: 1e-4
    relative, 1e-5 absolute."""
    from rlx_tpu_torch.models.mlp import DiscreteQNet

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    net = DiscreteQNet(None, 4, (512,), output_dim_per_action=51, image_shape=(84, 84, 4))
    frames = torch.randint(0, 256, (256, 84, 84, 4), dtype=torch.uint8)
    outs = {}
    for device in ("cpu", cuda):
        net.zero_grad(set_to_none=True)
        net.to(device)
        out = net(frames.to(device))
        out.square().mean().backward()
        outs[str(device)] = [t.detach().cpu().clone() for t in (out, *(p.grad for p in net.parameters()))]
    for a, b in zip(outs["cpu"], outs[str(cuda)]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pixel_grid", "pixel_chase"])
def test_pixel_env_steps_on_the_card_match_the_cpu(cuda, name):
    """64 steps of 128 envs on the card and on the CPU from the same initial
    state and actions, each reset's draws taken on the card and handed to the
    CPU env: observations, rewards, done flags, final observations and the
    uint8 frame stack equal exactly."""
    from rlx_tpu_torch.environments.classic.pixel_chase.cuda.environment import PixelChase
    from rlx_tpu_torch.environments.classic.pixel_grid.cuda.environment import PixelGrid

    draws = []

    def recording(cls):
        class Recording(cls):
            def initial_physics(self, generator, eval_mode):
                draws.append(super().initial_physics(generator, eval_mode))
                return draws[-1]
        return Recording

    def replaying(cls):
        class Replaying(cls):
            def initial_physics(self, generator, eval_mode):
                return type(draws[0])(*(t.cpu() for t in draws.pop(0)))
        return Replaying

    cls = PixelGrid if name == "pixel_grid" else PixelChase
    card, cpu = recording(cls)(128, 16, device=cuda), replaying(cls)(128, 16, device="cpu")
    state = card.reset(0)
    ref = cpu.reset(0)
    g = torch.Generator().manual_seed(1)
    for t in range(64):
        action = torch.randint(0, 4, (128,), generator=g, dtype=torch.int32)
        state = card.step(state, action.to(cuda))
        ref = cpu.step(ref, action)
        for field in ("observation", "final_observation", "reward", "terminated", "truncated"):
            assert torch.equal(getattr(state, field).cpu(), getattr(ref, field)), (t, field)
        for a, b in zip(state.physics, ref.physics):
            assert torch.equal(a.cpu(), b), t
    assert not draws


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["cart_pole", "pendulum"])
def test_native_env_on_the_card_matches_the_cpu(cuda, env_id):
    """The native C++ batcher with its results on the card and on the CPU,
    from the same seed under the same actions, over 450 steps with
    auto-resets: every tensor equal bit for bit.  Each step's state is kept
    and compared only after the next step has run, so a copy up still
    reading the pinned buffer when the next step writes it would show."""
    from rlx_tpu_torch.environments.native.batcher import NativeEnvBatch

    envs = {d: NativeEnvBatch(env_id, 64, seed=9, nr_threads=2, device=d) for d in (cuda, "cpu")}
    rng = np.random.default_rng(4)
    states = {d: env.reset(0) for d, env in envs.items()}
    assert states[cuda].observation.is_cuda and envs[cuda].edge.staging.is_pinned()
    kept = None
    for t in range(450):
        if env_id == "cart_pole":
            action = torch.tensor(rng.integers(0, 2, size=64), dtype=torch.int32)
        else:
            action = torch.tensor(rng.uniform(-2.5, 2.5, size=(64, 1)), dtype=torch.float32)
        # the action comes from the card (a blocking copy down) and the CPU
        states = {d: env.step(states[d], action.to(d)) for d, env in envs.items()}
        if kept is not None:
            for field in ("observation", "final_observation", "reward", "terminated", "truncated"):
                assert torch.equal(getattr(kept[cuda], field).cpu(), getattr(kept["cpu"], field)), (t, field)
            for key in kept["cpu"].info:
                assert torch.equal(kept[cuda].info[key].cpu(), kept["cpu"].info[key]), (t, key)
        kept = states
    assert float(states["cpu"].info["rollout/episode_length"].sum()) > 0
    for env in envs.values():
        env.close()


@pytest.mark.cuda
def test_host_edge_waits_for_its_copy_before_the_host_writes_again(cuda):
    """A reset right after a step (no action copied down in between) must
    not overwrite the staging buffer under the step's copy up: the step's
    results, read after the reset, equal the CPU's."""
    from rlx_tpu_torch.environments.native.batcher import NativeEnvBatch

    envs = {d: NativeEnvBatch("pendulum", 4096, seed=2, nr_threads=2, device=d) for d in (cuda, "cpu")}
    action = torch.full((4096, 1), 0.7)
    stepped = {d: env.step(env.reset(0), action.to(d)) for d, env in envs.items()}
    for env in envs.values():
        env.reset(0)
    for field in ("observation", "final_observation", "reward"):
        assert torch.equal(getattr(stepped[cuda], field).cpu(), getattr(stepped["cpu"], field)), field
    for env in envs.values():
        env.close()
