"""Unitree Go2 deployment runner: joystick state machine driving a policy
trained in rlx_tpu_torch on the real robot (the JAX package's
``deployment/unitree_go2/run.py``).

Behavioral parity with `rl_x/environments/custom_mujoco/robot_locomotion/
deployment/unitree_go2/run.py:28-383`:

- wireless-remote parsing (button bitfields in bytes 2/3, stick floats at
  byte offsets 4/8/12/20);
- control modes Y=stand_up, B=nn, X=lie_down, A=stop; the policy only
  engages from standing (`run.py:280-283`); joint-velocity safety threshold
  forces stand_up (`run.py:216-220`);
- stand/lie = 1 s linear interpolation from the current pose under stiff
  PD (kp 70 / kd 3); nn mode = 50 Hz policy inference under the TRAINING
  gains (kp 20 / kd 0.5) with action scaling 0.3 about the nominal pose;
- observation assembly identical to the training env's policy subset
  (``locomotion/robot/cuda/environment.py``, the 45 policy indices of the
  ``go2``): (q - nominal)/3.14, qd/100, prev_action/10, clip(gyro/50), goal
  velocities (zero-clipped), gravity vector from the IMU quaternion —
  then nan_to_num + clip(+-10).

The nominal pose is the JAX package's ``[-+0.1, 0.8, -1.5]`` per leg, not
the ``go2`` model's keyframe ``[0, 0.8, -1.6]`` that the env trains about:
the deployment's constants are carried over as they are.

Design difference from the reference: hardware access goes through the
``Go2SDK`` interface (sdk.py), the tick loop is driven externally (real
runs: a 50 Hz thread; tests: direct calls), and the stand/lie ramp tracks
the interpolated pose every tick (the reference's ramp branch references an
unassigned target on its first ticks).

The runner's state stays float64 numpy on the host.  Each nn tick is one
round trip to the policy's device: the observation goes down as float32
``[1, 45]``, the action mean comes back as ``[12]``.
"""

import struct

import numpy as np
import torch

from rlx_tpu_torch.environments.locomotion.robot.deployment.unitree_go2.sdk import (
    FakeGo2SDK,
    Go2SDK,
    NR_MOTORS,
)

OBSERVATION_SIZE = 45

NOMINAL_JOINT_POSITIONS = np.array([
    -0.1, 0.8, -1.5,
    0.1, 0.8, -1.5,
    -0.1, 0.8, -1.5,
    0.1, 0.8, -1.5,
])

LYING_JOINT_POSITIONS = np.array([
    -0.04584759, 1.26458573, -2.79743123,
    0.03388786, 1.25516927, -2.7853148,
    -0.34251189, 1.27808392, -2.8028338,
    0.34323859, 1.27829576, -2.81149054,
])  # measured pose of the folded robot (`run.py:111-116`)


class RemoteControllerState:
    """Unitree wireless-remote wire format (40 bytes)."""

    BUTTONS_1 = ["R1", "L1", "Start", "Select", "R2", "L2", "F1", "F3"]
    BUTTONS_2 = ["A", "B", "X", "Y", "Up", "Right", "Down", "Left"]

    def __init__(self):
        for name in self.BUTTONS_1 + self.BUTTONS_2:
            setattr(self, name, 0)
        self.Lx = 0.0
        self.Rx = 0.0
        self.Ry = 0.0
        self.Ly = 0.0

    def parse(self, data):
        for bit, name in enumerate(self.BUTTONS_1):
            setattr(self, name, (data[2] >> bit) & 1)
        for bit, name in enumerate(self.BUTTONS_2):
            setattr(self, name, (data[3] >> bit) & 1)
        self.Lx = struct.unpack("<f", data[4:8])[0]
        self.Rx = struct.unpack("<f", data[8:12])[0]
        self.Ry = struct.unpack("<f", data[12:16])[0]
        self.Ly = struct.unpack("<f", data[20:24])[0]

    @staticmethod
    def pack(buttons=(), Lx=0.0, Rx=0.0, Ry=0.0, Ly=0.0):
        """Inverse of parse (tests / telemetry replay)."""
        data = bytearray(40)
        for bit, name in enumerate(RemoteControllerState.BUTTONS_1):
            if name in buttons:
                data[2] |= 1 << bit
        for bit, name in enumerate(RemoteControllerState.BUTTONS_2):
            if name in buttons:
                data[3] |= 1 << bit
        data[4:8] = struct.pack("<f", Lx)
        data[8:12] = struct.pack("<f", Rx)
        data[12:16] = struct.pack("<f", Ry)
        data[20:24] = struct.pack("<f", Ly)
        return bytes(data)


def gravity_vector_from_quat_wxyz(q):
    """World -z expressed in the body frame (the IMU's projected gravity),
    equal to R(q)^T [0,0,-1] for the body->world rotation R."""
    w, x, y, z = q
    # third row of R^T = third column of R
    return -np.array([
        2.0 * (x * z - w * y),
        2.0 * (y * z + w * x),
        1.0 - 2.0 * (x * x + y * y),
    ])


class Go2DeploymentRunner:
    def __init__(self, sdk: Go2SDK, model_path=None, policy_apply=None,
                 control_frequency=50.0, device="cuda"):
        """``policy_apply(observation [45]) -> action [12]`` — either built
        from a checkpoint (``model_path``, the policy on ``device``) or
        injected directly (tests)."""
        self.sdk = sdk
        self.control_frequency = control_frequency
        self.nominal_joint_positions = NOMINAL_JOINT_POSITIONS.copy()
        self.lying_joint_positions = LYING_JOINT_POSITIONS.copy()

        self.stand_and_lie_seconds = 1.0
        self.stand_and_lie_p_gain = 70.0
        self.stand_and_lie_d_gain = 3.0
        self.nn_p_gain = 20.0
        self.nn_d_gain = 0.5
        self.scaling_factor = 0.3

        self.trained_max_goal_velocity = 1.0
        self.goal_velocity_zero_clip_threshold_percentage = 0.1
        self.goal_velocity_max = 0.8
        self.velocity_safety_threshold = 25.0
        self.stand_up_when_velocity_exceeded = True

        self.remote = RemoteControllerState()
        self.control_mode = None
        self.last_seen_control_mode = None
        self.previous_action = np.zeros(NR_MOTORS)
        self._ramp_start = None
        self._ramp_counter = 0

        if policy_apply is not None:
            self.policy_apply = policy_apply
        elif model_path is not None:
            self.policy_apply = load_policy_apply(model_path, device)
        else:
            raise ValueError("provide model_path or policy_apply")

        self.sdk.release_factory_mode()

    # ---------------------------------------------------------------- modes

    def _switch_mode(self, mode):
        self.control_mode = mode

    def handle_remote(self, state):
        self.remote.parse(state.wireless_remote)
        if self.remote.Y == 1:
            self._switch_mode("stand_up")
        elif self.remote.B == 1:
            self._switch_mode("nn")
        elif self.remote.X == 1:
            self._switch_mode("lie_down")
        elif self.remote.A == 1:
            self._switch_mode("stop")

    def goal_velocities(self):
        """Stick mapping with zero-clipping, as trained
        (`run.py:202-204,288-289`)."""
        goals = np.array([
            np.clip(self.remote.Ly, -1.0, 1.0),
            np.clip(-self.remote.Lx, -1.0, 1.0),
            np.clip(-self.remote.Rx, -1.0, 1.0),
        ]) * self.goal_velocity_max
        threshold = (
            self.goal_velocity_zero_clip_threshold_percentage
            * self.trained_max_goal_velocity
        )
        return np.where(np.abs(goals) < threshold, 0.0, goals)

    def assemble_observation(self, state):
        """The training env's policy observation subset, 45 dims."""
        goals = self.goal_velocities()
        gravity = gravity_vector_from_quat_wxyz(state.orientation_wxyz)
        observation = np.concatenate([
            (state.joint_positions - self.nominal_joint_positions) / 3.14,
            state.joint_velocities / 100.0,
            self.previous_action / 10.0,
            np.clip(state.angular_velocity / 50.0, -1.0, 1.0),
            goals,
            gravity,
        ])
        observation = np.nan_to_num(observation, nan=0.0, posinf=0.0, neginf=0.0)
        return np.clip(observation, -10.0, 10.0)

    def _ramp_to(self, state, target):
        steps = max(int(self.stand_and_lie_seconds * self.control_frequency), 1)
        if self._ramp_start is None:
            self._ramp_start = state.joint_positions.copy()
            self._ramp_counter = 0
        self._ramp_counter = min(self._ramp_counter + 1, steps)
        alpha = self._ramp_counter / steps
        pose = (1.0 - alpha) * self._ramp_start + alpha * target
        self.sdk.publish_low_cmd(pose, self.stand_and_lie_p_gain, self.stand_and_lie_d_gain)

    def tick(self):
        """One 50 Hz control step: read state, safety check, run the mode."""
        state = self.sdk.read_low_state()
        self.handle_remote(state)

        if np.max(np.abs(state.joint_velocities)) > self.velocity_safety_threshold:
            if self.stand_up_when_velocity_exceeded:
                self._switch_mode("stand_up")

        mode = self.control_mode
        if mode != self.last_seen_control_mode:
            self._ramp_start = None  # new mode: restart any interpolation
            if mode == "nn":
                self.previous_action = np.zeros(NR_MOTORS)

        if mode == "stand_up":
            self._ramp_to(state, self.nominal_joint_positions)
        elif mode == "lie_down":
            self._ramp_to(state, self.lying_joint_positions)
        elif mode == "nn":
            # only engage the policy from standing (`run.py:280-283`)
            if self.last_seen_control_mode in ("nn", "stand_up"):
                observation = self.assemble_observation(state)
                action = np.asarray(self.policy_apply(observation), dtype=np.float64)
                targets = self.nominal_joint_positions + self.scaling_factor * action
                self.sdk.publish_low_cmd(targets, self.nn_p_gain, self.nn_d_gain)
                self.previous_action = action
            else:
                mode = self.last_seen_control_mode  # refuse the switch
                self.control_mode = mode
        # "stop" / None: publish nothing

        self.last_seen_control_mode = mode


def load_policy_apply(model_path, device="cuda"):
    """checkpoint -> mirror net on ``device``: observation [45] -> action [12].

    The training policy indexes its 45-dim subset out of the full env
    observation (``models/mlp.py::select_observations``, a forward pre-hook
    and a buffer outside ``state_dict()``); deployment assembles exactly
    that subset in the same order, so the mirror net is the same
    GaussianPolicy with no observation indices, under the same keys.  As
    in the JAX package, it is built without ``compute_dtype``: a policy
    trained with a bf16 trunk deploys in float32.
    """
    from rlx_tpu_torch.models.mlp import GaussianPolicy
    from rlx_tpu_torch.utils import checkpoint as ckpt

    tree, algorithm_config = ckpt.load_model_file(model_path)
    policy = GaussianPolicy(
        OBSERVATION_SIZE, NR_MOTORS,
        hidden_sizes=tuple(algorithm_config["policy_hidden_sizes"]),
        activation=algorithm_config["activation"],
        layer_norm=algorithm_config["layer_norm"],
        std_dev=algorithm_config["std_dev"],
    )
    policy.load_state_dict(ckpt.policy_params(tree))
    policy.to(device)

    @torch.no_grad()
    def policy_apply(observation):
        mean, _ = policy(torch.as_tensor(np.asarray(observation, np.float32), device=device)[None])
        return mean[0].cpu().numpy()

    return policy_apply


def main(argv=None):
    import argparse
    import time

    parser = argparse.ArgumentParser()
    parser.add_argument("--model", required=True, help="latest.model checkpoint")
    parser.add_argument("--fake", action="store_true", help="run against the fake SDK")
    parser.add_argument("--device", default="cuda", help="the policy's device (cuda, or cpu)")
    args = parser.parse_args(argv)

    if args.fake:
        sdk = FakeGo2SDK()
    else:
        from rlx_tpu_torch.environments.locomotion.robot.deployment.unitree_go2.sdk import (
            UnitreeGo2SDK,
        )

        sdk = UnitreeGo2SDK()
    runner = Go2DeploymentRunner(sdk, model_path=args.model, device=args.device)
    print("Robot ready.")
    period = 1.0 / runner.control_frequency
    while True:
        start = time.time()
        runner.tick()
        time.sleep(max(period - (time.time() - start), 0.0))


if __name__ == "__main__":
    main()
