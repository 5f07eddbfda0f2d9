"""Hardware abstraction for the Unitree Go2 low-level channel (the JAX
package's ``deployment/unitree_go2/sdk.py``, numpy on the host as there).

Capability parity with the SDK surface used by the reference deployment
runner (`rl_x/environments/custom_mujoco/robot_locomotion/deployment/
unitree_go2/run.py:141-183`): low-state subscription (motor q/dq, IMU
quaternion + gyroscope, wireless remote bytes), low-command publishing
(per-motor target position, kp, kd), and releasing the factory sport mode
before taking low-level control.

Design difference: the runner talks to a small ``Go2SDK`` interface instead
of importing ``unitree_sdk2py`` at module scope, so the whole state machine
is unit-testable without hardware (``FakeGo2SDK``) and the real SDK import
is gated to the one class that needs it.
"""

import time

import numpy as np

NR_MOTORS = 12


class LowState:
    """Snapshot of the robot's low-level state."""

    def __init__(self):
        self.joint_positions = np.zeros(NR_MOTORS)
        self.joint_velocities = np.zeros(NR_MOTORS)
        self.orientation_wxyz = np.array([1.0, 0.0, 0.0, 0.0])
        self.angular_velocity = np.zeros(3)
        self.wireless_remote = bytes(40)


class Go2SDK:
    """Interface the deployment runner drives."""

    def read_low_state(self) -> LowState:
        raise NotImplementedError

    def publish_low_cmd(self, target_positions, kp, kd):
        """target_positions [12], scalar kp / kd gains."""
        raise NotImplementedError

    def release_factory_mode(self):
        """Make the robot accept low-level commands (stand down + release
        the sport-mode controller)."""
        raise NotImplementedError


class FakeGo2SDK(Go2SDK):
    """Scriptable stand-in for tests: queue states, record commands."""

    def __init__(self):
        self.state = LowState()
        self.published = []          # list of (targets, kp, kd)
        self.released = False

    def read_low_state(self):
        return self.state

    def publish_low_cmd(self, target_positions, kp, kd):
        self.published.append((np.asarray(target_positions).copy(), float(kp), float(kd)))

    def release_factory_mode(self):
        self.released = True


class UnitreeGo2SDK(Go2SDK):
    """Real-hardware backend over unitree_sdk2py (import gated — absent in
    CI images; the runner is exercised through FakeGo2SDK there)."""

    def __init__(self):
        from unitree_sdk2py.comm.motion_switcher.motion_switcher_client import (
            MotionSwitcherClient,
        )
        from unitree_sdk2py.core.channel import ChannelPublisher, ChannelSubscriber
        from unitree_sdk2py.go2.sport.sport_client import SportClient
        from unitree_sdk2py.idl.default import unitree_go_msg_dds__LowCmd_
        from unitree_sdk2py.idl.unitree_go.msg.dds_ import LowCmd_, LowState_
        from unitree_sdk2py.utils.crc import CRC

        self._make_cmd = unitree_go_msg_dds__LowCmd_
        self._crc = CRC()
        self._state = LowState()

        self._publisher = ChannelPublisher("rt/lowcmd", LowCmd_)
        self._publisher.Init()
        self._subscriber = ChannelSubscriber("rt/lowstate", LowState_)
        self._subscriber.Init(self._on_low_state, 10)

        self._sport = SportClient()
        self._sport.SetTimeout(5.0)
        self._sport.Init()
        self._switcher = MotionSwitcherClient()
        self._switcher.SetTimeout(5.0)
        self._switcher.Init()

    def _on_low_state(self, msg):
        s = LowState()
        s.joint_positions = np.array([msg.motor_state[i].q for i in range(NR_MOTORS)])
        s.joint_velocities = np.array([msg.motor_state[i].dq for i in range(NR_MOTORS)])
        # SDK quaternion is wxyz
        s.orientation_wxyz = np.asarray(msg.imu_state.quaternion, dtype=np.float64)
        s.angular_velocity = np.asarray(msg.imu_state.gyroscope, dtype=np.float64)
        s.wireless_remote = bytes(msg.wireless_remote)
        self._state = s

    def read_low_state(self):
        return self._state

    def publish_low_cmd(self, target_positions, kp, kd):
        cmd = self._make_cmd()
        cmd.head[0] = 0xFE
        cmd.head[1] = 0xEF
        cmd.level_flag = 0xFF
        cmd.gpio = 0
        for i in range(20):
            cmd.motor_cmd[i].mode = 0x01  # PMSM servo mode
            cmd.motor_cmd[i].q = 0.0
            cmd.motor_cmd[i].dq = 0.0
            cmd.motor_cmd[i].kp = 0.0
            cmd.motor_cmd[i].kd = 0.0
            cmd.motor_cmd[i].tau = 0.0
        for i in range(NR_MOTORS):
            cmd.motor_cmd[i].q = float(target_positions[i])
            cmd.motor_cmd[i].kp = float(kp)
            cmd.motor_cmd[i].kd = float(kd)
        cmd.crc = self._crc.Crc(cmd)
        self._publisher.Write(cmd)

    def release_factory_mode(self):
        status, result = self._switcher.CheckMode()
        while result["name"]:
            self._sport.StandDown()
            self._switcher.ReleaseMode()
            status, result = self._switcher.CheckMode()
            time.sleep(1)
