"""TCP/JSON bridge for external simulators and real robots.

Wire-protocol parity with the reference
(`rl_x/environments/custom_interface/prototype/connection.py:5-46`), so
existing clients work unchanged:
- client connects and sends ``{"actionCount": A, "observationCount": O}``;
- server sends ``{"action": [...]}`` per step;
- client replies ``{"observation": [...], "reward": r, "terminated": b,
  "truncated": b, "extraValueNames": [...], "extraValues": [...]}``.
"""

import json
import socket

import numpy as np

from rlx_tpu_torch.environments.gym.host_bridge import HostEnv
from rlx_tpu_torch.environments.spaces import BoxSpace


class Connection:
    def __init__(self, port):
        self.port = port
        self.client = None

    def start(self, ip):
        server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        server.bind((ip, self.port))
        print(f"Waiting for client to connect on port {self.port}...", flush=True)
        server.listen(1)
        self.client, _ = server.accept()
        self._server = server

        init = json.loads(self.client.recv(2048).decode())
        self.action_count = init["actionCount"]
        self.observation_count = init["observationCount"]
        return self.action_count, self.observation_count

    def send(self, action):
        values = action.tolist() if hasattr(action, "tolist") else list(action)
        self.client.send(json.dumps({"action": values}).encode())

    def recv(self):
        try:
            reaction = json.loads(self.client.recv(4096).decode())
        except json.JSONDecodeError:
            reaction = {
                "observation": [0.0] * self.observation_count,
                "reward": 0.0,
                "terminated": False,
                "truncated": False,
            }
        return reaction

    def close(self):
        if self.client is not None:
            self.client.close()
            self._server.close()
            self.client = None


class SocketEnv(HostEnv):
    """One external env over TCP (``nr_envs == 1``) with the env protocol;
    its observation, reward and flags cross the host edge as batches of 1."""

    def __init__(self, ip, port, horizon=1000, device="cpu"):
        self.connection = Connection(port)
        action_count, observation_count = self.connection.start(ip)
        self.nr_envs = 1
        self.horizon = horizon
        self._obs_dim = observation_count
        self.single_action_space = BoxSpace(low=-1.0, high=1.0, shape=(action_count,), device=device)
        self.single_observation_space = BoxSpace(low=-1.0, high=1.0, shape=(observation_count,), device=device)
        self._episode_return = 0.0
        self._episode_length = 0
        self._last_stats = np.zeros(2, np.float32)
        self._init_edge((observation_count,), np.float32, device)

    def _host_reset_into(self, _seed, observation):
        reaction = self.connection.recv()
        self._episode_return = 0.0
        self._episode_length = 0
        observation[0] = np.asarray(reaction["observation"], np.float32)

    def _host_step_into(self, actions, out):
        self.connection.send(np.asarray(actions)[0])
        reaction = self.connection.recv()
        obs = np.asarray(reaction["observation"], np.float32)
        reward = float(reaction["reward"])
        terminated = bool(reaction["terminated"])
        truncated = bool(reaction["truncated"])
        self._episode_return += reward
        self._episode_length += 1
        if terminated or truncated:
            self._last_stats[:] = (self._episode_return, self._episode_length)
            self._episode_return = 0.0
            self._episode_length = 0
        out["observation"][0] = out["final_observation"][0] = obs
        out["reward"][0], out["terminated"][0], out["truncated"][0] = reward, terminated, truncated
        out["stats"][0] = self._last_stats

    def close(self):
        self.connection.close()
