"""Double DQN, the JAX package's ``ddqn.tpu``: DQN with the next action
chosen by the online network and evaluated by the target network."""

import torch

from rlx_tpu_torch.algorithms.ddqn.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.dqn.cuda.dqn import DQN


class DDQN(DQN):
    parallel_seeds = True

    def next_q_target(self, batch):
        best_action = torch.argmax(self.critic.module(batch["next_observation"]), dim=-1)
        next_q = self.critic.target(batch["next_observation"])
        return torch.gather(next_q, -1, best_action[:, None]).squeeze(-1)

    def general_properties():
        return GeneralProperties
