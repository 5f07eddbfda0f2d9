"""SimbaV2: hypersphere-normalized networks over XQC's HL-Gauss update (the
JAX package's ``simbav2.tpu``): SimbaV2 encoders and hypersphere heads for
the policy and the critics, the running observation normalizer (updated
after each env step, applied when acting and to the batch) and the
discounted-return reward normalizer (applied to the batch's rewards, then
updated with the env step's rewards after the update, as the JAX
package's learning step does)."""

import torch
from torch import nn

from rlx_tpu_torch.algorithms.simba.cuda.simba import bounded_log_std
from rlx_tpu_torch.algorithms.xqc.cuda.xqc import XQC
from rlx_tpu_torch.models.layers import HyperDense, HyperHead, SimbaV2Encoder
from rlx_tpu_torch.ops import normalizers


def _hyper_dense_layers(module):
    return [m for m in module.modules() if isinstance(m, HyperDense)]


class SimbaV2Policy(nn.Module):
    def __init__(self, obs_dim, action_dim, hidden_dim, nr_blocks, log_std_min=-10.0, log_std_max=2.0):
        super().__init__()
        self.encoder = SimbaV2Encoder(obs_dim, hidden_dim, nr_blocks)
        self.mean = HyperHead(hidden_dim, action_dim)
        self.log_std = HyperHead(hidden_dim, action_dim)
        self.log_std_min, self.log_std_max = log_std_min, log_std_max

    def forward(self, x):
        x = self.encoder(x)
        return self.mean(x), bounded_log_std(self.log_std(x), self.log_std_min, self.log_std_max)

    def hidden_layers(self):
        # the JAX package's weight norm takes every HyperDense for a hidden
        # Dense (its name holds "Dense"); they have no bias
        return _hyper_dense_layers(self)

    def predictor_layers(self):
        return []


class SimbaV2VectorCritic(nn.Module):
    """(obs, action) -> logits ``[nr_critics, B, nr_atoms]``."""

    def __init__(self, obs_dim, action_dim, hidden_dim, nr_blocks, nr_atoms, nr_critics=2):
        super().__init__()
        self.encoder = SimbaV2Encoder(obs_dim + action_dim, hidden_dim, nr_blocks, nr=nr_critics)
        self.head = HyperHead(hidden_dim, nr_atoms, nr_critics)

    def forward(self, obs, action):
        return self.head(self.encoder(torch.cat([obs, action], dim=-1)))

    def hidden_layers(self):
        return _hyper_dense_layers(self)

    def predictor_layers(self):
        return []


class SimbaV2(XQC):
    parallel_seeds = True
    env_row_states = {"reward_normalizer": ("g",)}

    def _build_policy(self, a):
        return SimbaV2Policy(self.policy_obs_dim, self.action_dim, a.policy_hidden_dim, a.policy_nr_blocks)

    def _build_critic(self, a):
        return SimbaV2VectorCritic(self.critic_obs_dim, self.action_dim, a.critic_hidden_dim, a.critic_nr_blocks,
                                   a.nr_atoms, a.nr_critics)

    def setup_states(self):
        a = self.config.algorithm
        self.normalize_obs = a.enable_observation_normalization
        self.normalize_rewards = a.enable_reward_normalization
        super().setup_states()
        self.state_names = ("policy", "critic", "alpha") + (
            ("obs_normalizer",) if self.normalize_obs else ()) + (
            ("reward_normalizer",) if self.normalize_rewards else ())
        if self.normalize_obs:
            self.obs_normalizer = normalizers.obs_normalizer_init(self.os_shape, self.device)
        if self.normalize_rewards:
            self.reward_normalizer = normalizers.reward_normalizer_init(self.nr_envs // self.dp, self.device)

    def _norm(self, observation):
        if self.normalize_obs:
            return normalizers.obs_normalize(self.obs_normalizer, observation)
        return observation

    def observe_transition(self, observation, env_state):
        if self.normalize_obs:
            self.obs_normalizer = self.updated_obs_normalizer(observation)

    @torch.no_grad()
    def act(self, observation, step=0, noise=None):
        return super().act(self._norm(observation), step, noise)

    @torch.no_grad()
    def eval_act(self, observation):
        return super().eval_act(self._norm(observation))

    def _update(self, batch, step, target_noise, current_noise, call, norm):
        return super()._update(call(self._normalized, batch), step, target_noise, current_noise, call, norm)

    def _normalized(self, batch):
        """One seed's batch with its observations and rewards normalized."""
        batch = dict(batch)
        batch["observation"] = self._norm(batch["observation"])
        batch["next_observation"] = self._norm(batch["next_observation"])
        if self.normalize_rewards:
            batch["reward"] = normalizers.reward_normalize(self.reward_normalizer, batch["reward"])
        return batch

    def _learning_step(self, buffer, env_state, step):
        env_state, metrics = super()._learning_step(buffer, env_state, step)
        if self.normalize_rewards:
            with torch.no_grad():
                self.reward_normalizer = self.updated_reward_normalizer(env_state)
        return env_state, metrics
