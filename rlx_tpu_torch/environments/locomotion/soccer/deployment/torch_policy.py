"""PyTorch policy for RCSSServerMJ: the port's copy of the JAX package's
``soccer/deployment/torch_policy.py`` (torch only, nothing of the port).

Deployment counterpart of the reference's rcssserver nn_client policy
(`robocup_soccer/rcssserver_deployment/convert.py` + torch_policy.py): the
RoboCup server side runs PyTorch, so a trained ppo_gru policy is converted
into this module's state_dict by ``convert.py``; the keys are the ones the
server's client loads.  Architecture matches
``rlx_tpu_torch/models/recurrent.py::RecurrentPolicy`` with cell_type="gru":
obs encoder (Dense+LN+ELU) -> GRUCell -> LN+ELU -> concat/FiLM combine ->
512(LN)/256/128 ELU torso -> mean head.  Its LayerNorms take the training
net's eps, flax's 1e-6 (the JAX package's copy keeps torch's default 1e-5,
which moves the action means of a policy with means of a few units by
~1e-4); eps is not in the state_dict.
"""

import torch
import torch.nn as nn

LAYER_NORM_EPS = 1e-6   # flax's LayerNorm default, as the training nets


class TorchPolicyGRU(nn.Module):
    def __init__(self, obs_dim, action_dim, obs_encoding_dim, hidden_dim,
                 combine_method="concat", share_encoder=False):
        super().__init__()
        self.combine_method = combine_method
        self.share_encoder = share_encoder
        self.hidden_dim = hidden_dim

        self.cell_obs_encoder = nn.Linear(obs_dim, obs_encoding_dim)
        self.cell_obs_ln = nn.LayerNorm(obs_encoding_dim, eps=LAYER_NORM_EPS)
        if not share_encoder:
            self.obs_encoder = nn.Linear(obs_dim, obs_encoding_dim)
            self.obs_ln = nn.LayerNorm(obs_encoding_dim, eps=LAYER_NORM_EPS)
        self.cell = nn.GRUCell(obs_encoding_dim, hidden_dim)
        self.cell_ln = nn.LayerNorm(hidden_dim, eps=LAYER_NORM_EPS)
        if combine_method == "film":
            self.film_gamma = nn.Linear(hidden_dim, obs_encoding_dim)
            self.film_beta = nn.Linear(hidden_dim, obs_encoding_dim)
            torso_in = obs_encoding_dim
        else:
            torso_in = obs_encoding_dim + hidden_dim
        self.torso_dense1 = nn.Linear(torso_in, 512)
        self.torso_ln1 = nn.LayerNorm(512, eps=LAYER_NORM_EPS)
        self.torso_dense2 = nn.Linear(512, 256)
        self.torso_dense3 = nn.Linear(256, 128)
        self.mean_head = nn.Linear(128, action_dim)

    def initial_carry(self, batch_size=1):
        """A zero carry on the module's device."""
        return torch.zeros(batch_size, self.hidden_dim, device=self.cell.weight_ih.device)

    @torch.no_grad()
    def forward(self, obs, carry):
        """obs [B, obs_dim] (already gathered to policy indices),
        carry [B, hidden] -> (action mean [B, A], next carry)."""
        cell_in = torch.nn.functional.elu(self.cell_obs_ln(self.cell_obs_encoder(obs)))
        carry = self.cell(cell_in, carry)
        h = torch.nn.functional.elu(self.cell_ln(carry))
        if self.share_encoder:
            obs_latent = cell_in
        else:
            obs_latent = torch.nn.functional.elu(self.obs_ln(self.obs_encoder(obs)))
        if self.combine_method == "film":
            torso_in = obs_latent * self.film_gamma(h) + self.film_beta(h)
        else:
            torso_in = torch.cat([obs_latent, h], dim=-1)
        x = torch.nn.functional.elu(self.torso_ln1(self.torso_dense1(torso_in)))
        x = torch.nn.functional.elu(self.torso_dense2(x))
        x = torch.nn.functional.elu(self.torso_dense3(x))
        return self.mean_head(x), carry
