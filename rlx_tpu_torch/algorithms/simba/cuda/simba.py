"""SimBa: simplicity-bias scaled networks over SAC (the JAX package's
``simba.tpu``): pre-LN residual encoders for the policy and the critics, a
tanh-bounded state-dependent log-std; the update is SAC's, parallel seeds
included."""

import torch
from torch import nn

from rlx_tpu_torch.algorithms.sac.cuda.sac import SAC
from rlx_tpu_torch.models.layers import Linear, SimbaEncoder


def bounded_log_std(raw, log_std_min, log_std_max):
    return log_std_min + (log_std_max - log_std_min) * 0.5 * (1.0 + torch.tanh(raw))


class SimbaPolicy(nn.Module):
    """obs -> (mean, log_std): a SimBa encoder and orthogonal Dense heads."""

    def __init__(self, obs_dim, action_dim, hidden_dim, nr_blocks, log_std_min=-10.0, log_std_max=2.0):
        super().__init__()
        self.encoder = SimbaEncoder(obs_dim, hidden_dim, nr_blocks)
        self.mean = Linear(hidden_dim, action_dim, init="orthogonal")
        self.log_std = Linear(hidden_dim, action_dim, init="orthogonal")
        self.log_std_min, self.log_std_max = log_std_min, log_std_max

    def forward(self, x):
        x = self.encoder(x)
        return self.mean(x), bounded_log_std(self.log_std(x), self.log_std_min, self.log_std_max)


class SimbaVectorCritic(nn.Module):
    """(obs, action) -> ``[nr_critics, B, 1]``: per critic a SimBa encoder
    and an orthogonal Dense head, stacked on a leading axis."""

    def __init__(self, obs_dim, action_dim, hidden_dim, nr_blocks, nr_critics=2):
        super().__init__()
        self.encoder = SimbaEncoder(obs_dim + action_dim, hidden_dim, nr_blocks, nr_critics)
        self.head = Linear(hidden_dim, 1, nr_critics, init="orthogonal")

    def forward(self, obs, action):
        return self.head(self.encoder(torch.cat([obs, action], dim=-1)))


class SimBa(SAC):
    parallel_seeds = True

    def _build_policy(self, a):
        return SimbaPolicy(self.policy_obs_dim, self.action_dim, a.policy_hidden_dim, a.policy_nr_blocks,
                           a.log_std_min, a.log_std_max)

    def _build_critic(self, a):
        return SimbaVectorCritic(self.critic_obs_dim, self.action_dim, a.critic_hidden_dim, a.critic_nr_blocks,
                                 a.nr_critics)
