"""The port's deployment modules against the JAX package's, on the CPU.

- The Go2 runner (``locomotion/robot/deployment/unitree_go2``): the JAX
  runner on a JAX checkpoint and the port's on the same weights in a port
  checkpoint (``convert.policy_state_dict``), driven through the same
  scripted ``FakeGo2SDK`` states and remote bytes, publish the same modes
  and targets (exactly in the ramps, within 1e-6 in nn mode, f32 nets);
  the nine behaviours of ``tests/test_go2_deployment.py`` on the port; the
  mirror net of a PPO checkpoint (plain, with the optimizer state, with a
  bf16 trunk, split over tp) against the training policy.
- Soccer (``locomotion/soccer/deployment``): from flax ``RecurrentPolicy``
  (gru) parameters, JAX's ``convert_policy_params`` and the port's
  ``convert.recurrent_policy_state_dict`` + ``deployment_state_dict`` give
  ``TorchPolicyGRU`` state_dicts equal bit for bit, and the port's
  ``TorchPolicyGRU`` stays within 1e-5 of JAX's ``RecurrentPolicy`` over 16
  steps with carry; ``convert.main`` on a port checkpoint.
"""

import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_go2_deployment as jax_go2_tests
from rlx_tpu.environments.locomotion.robot.deployment.unitree_go2 import run as jax_run
from rlx_tpu.environments.locomotion.robot.deployment.unitree_go2 import sdk as jax_sdk
from rlx_tpu_torch import convert
from rlx_tpu_torch.config import create_model, make_config
from rlx_tpu_torch.environments.locomotion.robot.deployment.unitree_go2 import run
from rlx_tpu_torch.environments.locomotion.robot.deployment.unitree_go2 import sdk
from rlx_tpu_torch.environments.locomotion.soccer.deployment import convert as soccer_convert
from rlx_tpu_torch.environments.locomotion.soccer.deployment.torch_policy import TorchPolicyGRU
from rlx_tpu_torch.models.mlp import GaussianPolicy
from rlx_tpu_torch.utils import checkpoint as ckpt
from torch_mesh_spawn import shared_results, spawn
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY_CONFIG = {"policy_hidden_sizes": [32, 32], "activation": "elu", "layer_norm": True, "std_dev": 1.0}


# ------------------------------------------------------------------ Go2 runner


def scripted_ticks(seed=0):
    """(buttons, state fields) per tick: Y (stand up, 60 ticks), B once then
    no button (nn, 60 ticks, sticks moving), a joint-velocity spike over 25
    (forced stand up, 30 ticks), X (lie down, 60 ticks), A (stop, 10)."""
    rng = np.random.default_rng(seed)
    plan = [("Y",)] * 60 + [("B",)] + [()] * 59 + [("spike",)] + [()] * 29 + [("X",)] * 60 + [("A",)] * 10
    ticks = []
    for buttons in plan:
        quat = np.array([1.0, 0.0, 0.0, 0.0]) + 0.2 * rng.normal(size=4)
        velocities = np.clip(5.0 * rng.normal(size=12), -20.0, 20.0)
        if buttons == ("spike",):
            velocities[3], buttons = 30.0, ()
        ticks.append((buttons, {
            "joint_positions": run.NOMINAL_JOINT_POSITIONS + 0.2 * rng.normal(size=12),
            "joint_velocities": velocities,
            "orientation_wxyz": quat / np.linalg.norm(quat),
            "angular_velocity": 30.0 * rng.normal(size=3),
            "sticks": dict(zip(("Lx", "Rx", "Ry", "Ly"), rng.uniform(-1.2, 1.2, size=4))),
        }))
    return ticks


def drive(runner, fake_sdk, remote, ticks):
    """The runner's mode after each tick."""
    modes = []
    for buttons, fields in ticks:
        for name in ("joint_positions", "joint_velocities", "orientation_wxyz", "angular_velocity"):
            setattr(fake_sdk.state, name, fields[name].copy())
        fake_sdk.state.wireless_remote = remote.pack(buttons=buttons, **fields["sticks"])
        runner.tick()
        modes.append(runner.control_mode)
    return modes


def test_go2_runner_matches_jax(tmp_path):
    """JAX's runner on a JAX checkpoint and the port's (``device="cpu"``) on
    the same weights: the same modes, the same targets exactly in the ramps
    and within 1e-6 in nn mode, the same gains."""
    from rlx_tpu.models.mlp import GaussianPolicy as JaxGaussianPolicy
    from rlx_tpu.utils import checkpoint as jax_ckpt

    policy = JaxGaussianPolicy(action_dim=12, hidden_sizes=(32, 32), activation="elu", layer_norm=True, std_dev=1.0)
    params = policy.init(jax.random.PRNGKey(0), jnp.zeros((1, 45)))
    rng = np.random.default_rng(1)   # actions of order 1 (the head's init is 0.01)
    params = jax.tree.map(lambda x: np.asarray(x + 0.3 * rng.normal(size=x.shape), np.float32), params)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_ckpt.save_model_file(str(tmp_path / "jax"), "latest.model", {"policy": params, "critic": params}, POLICY_CONFIG)
    ckpt.save_model_file(str(tmp_path / "port"), "latest.model", {"policy": convert.policy_state_dict(params)},
                         POLICY_CONFIG)

    ticks = scripted_ticks()
    jax_fake, fake = jax_sdk.FakeGo2SDK(), sdk.FakeGo2SDK()
    jax_runner = jax_run.Go2DeploymentRunner(jax_fake, model_path=str(tmp_path / "jax" / "latest.model"))
    runner = run.Go2DeploymentRunner(fake, model_path=str(tmp_path / "port" / "latest.model"), device="cpu")
    jax_modes = drive(jax_runner, jax_fake, jax_run.RemoteControllerState, ticks)
    modes = drive(runner, fake, run.RemoteControllerState, ticks)

    assert modes == jax_modes
    assert modes[59] == "stand_up" and modes[60] == "nn" and modes[120] == "stand_up"
    assert modes[150] == "lie_down" and modes[-1] == "stop"
    assert len(fake.published) == len(jax_fake.published) == 60 + 60 + 30 + 60
    nn_ticks = 0
    for (targets, kp, kd), (jax_targets, jax_kp, jax_kd) in zip(fake.published, jax_fake.published):
        assert (kp, kd) == (jax_kp, jax_kd)
        if kp == runner.nn_p_gain:
            nn_ticks += 1
            np.testing.assert_allclose(targets, jax_targets, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(targets, jax_targets)
    assert nn_ticks == 60
    moved = max(np.abs(t - run.NOMINAL_JOINT_POSITIONS).max() for t, kp, _ in fake.published if kp == 20.0)
    assert moved > 0.05   # the policy's actions are not all near zero


BEHAVIOURS = [
    "test_remote_pack_parse_roundtrip",
    "test_factory_mode_released_and_stop_publishes_nothing",
    "test_stand_up_ramps_to_nominal",
    "test_nn_engages_only_from_standing",
    "test_nn_action_scaling_and_previous_action",
    "test_observation_layout_and_normalization",
    "test_velocity_safety_forces_stand_up",
    "test_gravity_vector_identity_quat",
]


@pytest.mark.parametrize("behaviour", BEHAVIOURS + ["test_checkpoint_mirror_net_loads"])
def test_go2_behaviour(behaviour, monkeypatch, tmp_path):
    """The nine cases of ``tests/test_go2_deployment.py`` on the port: the
    first eight run the JAX test's own body with the port's classes in
    place of the JAX package's; the checkpoint's mirror net is the port's
    (a port checkpoint, ``load_policy_apply`` on the CPU)."""
    if behaviour in BEHAVIOURS:
        for name in ("Go2DeploymentRunner", "NOMINAL_JOINT_POSITIONS", "RemoteControllerState",
                     "gravity_vector_from_quat_wxyz"):
            monkeypatch.setattr(jax_go2_tests, name, getattr(run, name))
        monkeypatch.setattr(jax_go2_tests, "FakeGo2SDK", sdk.FakeGo2SDK)
        getattr(jax_go2_tests, behaviour)()
        return
    policy = GaussianPolicy(45, 12, (32, 32), "elu", layer_norm=True, std_dev=1.0)
    ckpt.save_model_file(str(tmp_path), "latest.model", {"policy": policy.state_dict(),
                                                         "critic": policy.state_dict()}, POLICY_CONFIG)
    apply = run.load_policy_apply(str(tmp_path / "latest.model"), device="cpu")
    obs = np.linspace(-1.0, 1.0, 45)
    with torch.no_grad():
        expected, _ = policy(torch.as_tensor(obs, dtype=torch.float32)[None])
    np.testing.assert_allclose(apply(obs), expected[0].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("variant", ["plain", "optimizer_state", "bf16_trunk"])
def test_mirror_net_of_a_go2_ppo_checkpoint(variant, tmp_path):
    """A PPO checkpoint on the ``go2`` (plane): the env's 45 policy indices
    are the deployment's layout (q, qd, previous action, gyro, goals,
    gravity), and ``load_policy_apply`` of the checkpoint gives the training
    policy's mean on the env's observation.  With ``save_optimizer_state``
    the policy sits under ``full``; a bf16-trunk policy deploys in f32, as
    the JAX package's mirror net (no ``compute_dtype``)."""
    overrides = {"environment.robot": "go2", "environment.terrain.type": "plane", "environment.nr_envs": 4,
                 "runner.device": "cpu", "runner.save_optimizer_state": variant == "optimizer_state"}
    if variant == "bf16_trunk":
        overrides["algorithm.compute_dtype"] = "bfloat16"
    model = create_model(make_config("ppo.cuda", "locomotion.robot.cuda", **overrides), run_path=str(tmp_path))
    env = model.train_env
    layout = np.concatenate([env.joint_positions_obs_idx, env.joint_velocities_obs_idx,
                             env.joint_previous_actions_obs_idx, env.imu_angular_vel_obs_idx,
                             env.goal_velocities_obs_idx, env.gravity_vector_obs_idx])
    np.testing.assert_array_equal(env.policy_observation_indices, layout)
    assert len(layout) == run.OBSERVATION_SIZE and env.robot_config["scaling_factor"] == 0.3
    model.save()
    assert ("full" in ckpt.load_model_file(str(tmp_path / "models" / "latest.model"))[0]) == (
        variant == "optimizer_state")

    apply = run.load_policy_apply(str(tmp_path / "models" / "latest.model"), device="cpu")
    observation = model.train_env.reset(3).observation
    module = model.policy.module
    with torch.no_grad():
        mean = module(observation)[0]
        if variant == "bf16_trunk":
            module.trunk.compute_dtype = None
            f32_mean = module(observation)[0]
            assert (mean - f32_mean).abs().max() > 1e-6   # the bf16 trunk rounds; the mirror does not
            mean = f32_mean
    for row in range(observation.shape[0]):
        got = apply(observation[row, env.policy_observation_indices].double().numpy())
        np.testing.assert_allclose(got, mean[row].numpy(), rtol=0, atol=1e-6)


def test_mirror_net_of_a_tp_split_checkpoint(tmp_path_factory):
    """The tree of PPO split over tp = 2 (dp = 2, 4 gloo ranks; the
    spawn ``tests/test_torch_partition.py`` shares) holds the policy whole
    under the unsplit net's keys: an unsplit mirror loads it strictly and
    gives the split run's forward."""
    import torch_mesh_worker as worker

    results = shared_results(tmp_path_factory, "torch_partition", lambda d: spawn(["tp"], 4, d))
    got = torch.load(results / "tp.dp.pt")
    a = worker._tp_config().algorithm
    mirror = GaussianPolicy(34, 8, tuple(a.policy_hidden_sizes), a.activation, a.layer_norm, a.std_dev)
    mirror.load_state_dict(ckpt.policy_params(got["tree"]))
    obs = torch.linspace(-1.0, 1.0, 6 * 34).reshape(6, 34)
    with torch.no_grad():
        torch.testing.assert_close(mirror(obs)[0], got["forward"]["policy"], rtol=1e-5, atol=1e-5)


def test_go2_main_runs_the_fake_sdk(tmp_path, monkeypatch, capsys):
    """``main --fake --device cpu`` loads the checkpoint and ticks at 50 Hz
    (stopped here after three sleeps)."""
    policy = GaussianPolicy(45, 12, (32, 32), "elu", layer_norm=True, std_dev=1.0)
    ckpt.save_model_file(str(tmp_path), "latest.model", {"policy": policy.state_dict()}, POLICY_CONFIG)
    sleeps = []

    def sleep(seconds):
        sleeps.append(seconds)
        if len(sleeps) == 3:
            raise KeyboardInterrupt

    monkeypatch.setattr("time.sleep", sleep)
    with pytest.raises(KeyboardInterrupt):
        run.main(["--model", str(tmp_path / "latest.model"), "--fake", "--device", "cpu"])
    assert "Robot ready." in capsys.readouterr().out
    assert all(0.0 <= s <= 0.02 for s in sleeps)


# ---------------------------------------------------------------------- soccer


def _jax_deployment_module(name):
    """JAX's ``soccer/deployment/<name>.py``, loaded from its file as
    ``tests/test_soccer_locomotion.py`` loads it (the directory is no
    package)."""
    path = os.path.join(ROOT, "rlx_tpu", "environments", "locomotion", "soccer", "deployment", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_soccer_deployment_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("combine_method", ["concat", "film"])
@pytest.mark.parametrize("share_encoder", [False, True])
def test_soccer_conversion_matches_jax(combine_method, share_encoder, monkeypatch):
    """From flax RecurrentPolicy (gru) parameters (perturbed, so every bias
    is nonzero): JAX's converter and the port's give the same
    ``TorchPolicyGRU`` state_dict, key for key and bit for bit, and the
    same arch; the port's ``TorchPolicyGRU`` follows JAX's policy over 16
    steps with carry within 1e-5."""
    from rlx_tpu.models.recurrent import RecurrentPolicy as JaxRecurrentPolicy

    # JAX's convert.py sets JAX_PLATFORMS's default and prepends to sys.path at import
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(sys, "path", list(sys.path))
    jax_convert, jax_torch_policy = _jax_deployment_module("convert"), _jax_deployment_module("torch_policy")
    obs_dim, B = 20, 3
    policy = JaxRecurrentPolicy(action_dim=5, cell_type="gru", obs_encoding_dim=16, hidden_dim=12,
                                combine_method=combine_method, share_encoder=share_encoder)
    params = policy.init(jax.random.PRNGKey(0), jnp.zeros((B, obs_dim)), policy.initialize_carry(B),
                         method=policy.one_step)
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda x: np.asarray(x + 0.05 * rng.normal(size=x.shape), np.float32), params)

    jax_sd, jax_arch = jax_convert.convert_policy_params(params)
    jax_deployed = jax_torch_policy.TorchPolicyGRU(**jax_arch)
    jax_deployed.load_state_dict(jax_sd)
    port_state = convert.recurrent_policy_state_dict(params)
    assert torch.count_nonzero(port_state["cell.bias_hn"]) > 0
    sd, arch = soccer_convert.deployment_state_dict(port_state)
    deployed = TorchPolicyGRU(**arch)
    deployed.load_state_dict(sd)

    assert arch == jax_arch
    ours, theirs = deployed.state_dict(), jax_deployed.state_dict()
    assert list(ours) == list(theirs)
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype and torch.equal(ours[key], theirs[key]), key

    carry, jax_carry = deployed.initial_carry(B), policy.initialize_carry(B)
    for _ in range(16):
        obs = rng.normal(size=(B, obs_dim)).astype(np.float32)
        mean, _, jax_carry = policy.apply(params, jnp.asarray(obs), jax_carry, method=policy.one_step)
        got, carry = deployed(torch.from_numpy(obs), carry)
        np.testing.assert_allclose(got.numpy(), np.asarray(mean), rtol=0, atol=1e-5)
        np.testing.assert_allclose(carry.numpy(), np.asarray(jax_carry), rtol=0, atol=1e-5)


def test_soccer_convert_main(tmp_path):
    """``convert.main`` on a port ppo_gru checkpoint of the soccer env (on
    the CPU): the weights load into ``TorchPolicyGRU``, which follows the
    policy's ``one_step`` on the env's policy-indexed observations, and the
    meta JSON carries the env's indices, scaling, nominal pose and control
    frequency."""
    model = create_model(make_config("ppo_gru.cuda", "locomotion.soccer.cuda", **{
        "environment.nr_envs": 4, "runner.device": "cpu", "algorithm.rnn_hidden_dim": 16}), run_path=str(tmp_path))
    model.save()
    output, meta_output = tmp_path / "nn.pth", tmp_path / "meta.json"
    soccer_convert.main(["--model", str(tmp_path / "models" / "latest.model"), "--output", str(output),
                         "--meta-output", str(meta_output), "--device", "cpu"])
    meta = json.loads(meta_output.read_text())
    env = model.train_env
    assert meta["policy_observation_indices"] == env.policy_observation_indices.tolist()
    assert meta["action_scaling_factor"] == env.robot_config["scaling_factor"]
    assert meta["nominal_joint_positions"] == env.nominal_joint_positions.tolist()
    assert meta["control_frequency_hz"] == env.control_frequency_hz
    assert meta["hidden_dim"] == 16 and meta["algorithm_config"]["rnn_hidden_dim"] == 16

    deployed = TorchPolicyGRU(**{k: meta[k] for k in ("obs_dim", "action_dim", "obs_encoding_dim", "hidden_dim",
                                                        "combine_method", "share_encoder")})
    deployed.load_state_dict(torch.load(output, weights_only=True))
    state = env.reset(0)
    carry, ref_carry = deployed.initial_carry(4), model.policy.initialize_carry(4)
    index = torch.as_tensor(meta["policy_observation_indices"])
    with torch.no_grad():
        for _ in range(4):
            got, carry = deployed(state.observation[:, index], carry)
            mean, _, ref_carry = model.policy.one_step(state.observation, ref_carry)
            torch.testing.assert_close(got, mean, rtol=0, atol=1e-5)
            state = env.step(state, mean)
