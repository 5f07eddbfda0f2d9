"""FastMPO: MPO's E/M machinery on the FastSAC/FastTD3 recipe (the JAX
package's ``fastmpo.tpu``).

- Data is collected with the target policy unless
  ``collect_data_with_online_policy``, as raw Gaussian actions: the
  defaults ``action_clipping=False`` and ``action_rescaling="none"`` hand
  them to the env unclipped (the off-policy core's action pipeline).
- Per env step, one sample of ``nr_critic_updates_per_step * batch_size``
  transitions is cut into one slice per critic update.  The running
  observation normalizer is updated from the sample's states and next
  states together, then normalizes both.  Then ``nr_policy_updates_per_step``
  times: ``nr_critic_updates_per_policy_update`` critic steps, each on its
  slice and each followed by the critic target's Polyak update
  (``critic_tau``), then one policy and dual step on the last critic
  step's slice and the policy target's Polyak update (``policy_tau``).
  The metrics are the last critic step's and the last policy step's.
- FastSAC-scale networks: policy 512-256-128 and critic 768-384-192 with
  SiLU and a LayerNorm after every Dense (``"fastsac"``; ``"fasttd3"``:
  1024-512-256 critic, relu, no LayerNorm), zero-init heads and the scaled
  softplus std head; ``"mpo"`` builds MPO's nets from the config's sizes.
- The buffer holds ``buffer_size_per_env`` rows per env, and learning
  starts after ``learning_starts_per_env`` env steps.

Every draw is an argument that defaults to the generator: the acting
noise, the sample, and per update the critic's and the E-step's normals.
"""

import torch

from rlx_tpu_torch.algorithms.fastmpo.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.mpo.cuda.mpo import MPO, MPOGaussianPolicy
from rlx_tpu_torch.models.mlp import VectorQCritic
from rlx_tpu_torch.ops import normalizers
from rlx_tpu_torch.ops import replay_buffer as rb

NETWORK_SHAPES = {
    # network type -> (policy hidden sizes, critic hidden sizes, activation, LayerNorm after every Dense)
    "fastsac": ((512, 256, 128), (768, 384, 192), "silu", True),
    "fasttd3": ((512, 256, 128), (1024, 512, 256), "relu", False),
}


class FastMPO(MPO):
    parallel_seeds = True

    def setup_states(self):
        a = self.config.algorithm
        self.critic_tau = a.critic_tau
        self.policy_tau = a.policy_tau
        self.collect_online = a.collect_data_with_online_policy
        self.nr_critic_updates_per_policy_update = a.nr_critic_updates_per_policy_update
        self.nr_policy_updates_per_step = a.nr_policy_updates_per_step
        self.nr_critic_updates_per_step = self.nr_policy_updates_per_step * self.nr_critic_updates_per_policy_update
        super().setup_states()

    def _build_policy(self, a):
        if a.policy_network_type not in NETWORK_SHAPES:
            return super()._build_policy(a)
        hidden, _, activation, ln_all = NETWORK_SHAPES[a.policy_network_type]
        return MPOGaussianPolicy(self.policy_obs_dim, self.action_dim, hidden, activation, layer_norm=False,
                                 init_scale=a.policy_init_scale, min_scale=a.policy_min_scale, layer_norm_all=ln_all,
                                 zero_init_heads=True, scaled_std_head=True, orthogonal_init=False)

    def _build_critic(self, a):
        if a.critic_network_type not in NETWORK_SHAPES:
            return super()._build_critic(a)
        _, hidden, activation, ln_all = NETWORK_SHAPES[a.critic_network_type]
        return VectorQCritic(self.critic_obs_dim, self.action_dim, hidden, self.nr_critics, activation,
                             layer_norm=False, output_dim=self.nr_atoms, layer_norm_all=ln_all)

    def observe_transition(self, observation, env_state):
        """The normalizer learns from the sampled batches, not the rollout."""

    @torch.no_grad()
    def act(self, observation, step=0, noise=None):
        """``mean + std * noise`` of the target policy (of the online one
        with ``collect_data_with_online_policy``), unclipped; ``noise`` is
        drawn from the generator unless given."""
        module = self.policy.module if self.collect_online else self.policy.target
        mean, std = module(self._norm(observation))
        if noise is None:
            noise = self._noise(mean.shape)
        return mean + std * noise

    @torch.no_grad()
    def eval_act(self, observation):
        return self.policy.module(self._norm(observation))[0]

    def _sample(self, buffer):
        """One sample for every critic update of the env step."""
        total = self.nr_critic_updates_per_step * self.batch_size
        if self.parallel is not None:
            return self._sample_seeds(buffer, total)
        if self.dp > 1:
            return self._sample_dp(buffer, total, None, None)
        if self.n_step > 1:
            return rb.sample_nstep(buffer, self.generator, total, self.n_step, self.gamma)
        return rb.sample(buffer, self.generator, total)

    def _update_draws(self, generator):
        """One seed's normals of an env step's updates, in its one-seed
        order: each policy update's critic updates', then its own.  (critic
        normals per update, {index of the policy update's last critic
        update: its normals})."""
        critic_noises, policy_noises, idx = [], {}, 0
        for _ in range(self.nr_policy_updates_per_step):
            for _ in range(self.nr_critic_updates_per_policy_update):
                critic_noises.append(self._noise((self.action_samples, self.batch_size, self.action_dim), generator))
                idx += 1
            policy_noises[idx - 1] = self._noise((self.action_samples, 2 * self.batch_size, self.action_dim),
                                                 generator)
        return tuple(critic_noises), policy_noises

    def update_with_buffer(self, buffer, step, batch=None, critic_noises=None, policy_noises=None):
        """The env step's updates on one sample (``batch``, drawn unless
        given); ``critic_noises[i]`` ``[S, B, A]`` and ``policy_noises[i]``
        ``[S, 2B, A]`` are update i's normals, drawn unless given.  With
        parallel seeds every input has a leading seed axis and each seed's
        normals are drawn from its generator (``_update_draws``)."""
        if batch is None:
            batch = self.sample_batch(buffer)
        if self.parallel is not None and critic_noises is None:
            critic_noises, policy_noises = self.parallel.draw(self._update_draws)
        if self.dp > 1 and critic_noises is None:
            # this rank's batch rows of the dp = 1 run's normals
            critic_noises, policy_noises = self._update_draws(self.generator)
            B = self.batch_size
            critic_noises = [self.batch_rows(n, 1) for n in critic_noises]
            policy_noises = {i: torch.cat([self.batch_rows(n[:, :B], 1), self.batch_rows(n[:, B:], 1)], dim=1)
                             for i, n in policy_noises.items()}
        next_obs_all, reward_all, terminated_all, discount_all = self._targets(batch)
        obs_all, action_all = batch["observation"], batch["action"]
        if self.normalize_obs:
            self.obs_normalizer = self._call()(
                lambda state, o, n: normalizers.obs_normalizer_update(
                    state, torch.cat([o, n], dim=0), self.mesh if self.parallel is None else None),
                self.obs_normalizer, obs_all, next_obs_all)
            obs_all, next_obs_all = self._call()(lambda o, n: (self._norm(o), self._norm(n)), obs_all, next_obs_all)
        n_up = self.nr_critic_updates_per_step
        seed_axis = 0 if self.parallel is None else 1
        slices = [x.reshape(x.shape[:seed_axis] + (n_up, -1) + x.shape[seed_axis + 1:])
                  for x in (obs_all, next_obs_all, action_all, reward_all, terminated_all, discount_all)]
        critic_noises = critic_noises if critic_noises is not None else [None] * n_up
        policy_noises = policy_noises if policy_noises is not None else [None] * n_up

        idx = 0
        for _ in range(self.nr_policy_updates_per_step):
            for _ in range(self.nr_critic_updates_per_policy_update):
                obs, next_obs, action, reward, terminated, discount = (x.select(seed_axis, idx) for x in slices)
                critic_metrics = self._critic_step(obs, next_obs, action, reward, terminated, discount,
                                                   critic_noises[idx])
                self.critic.polyak_update(self.critic_tau)
                idx += 1
            policy_metrics = self._policy_dual_step(slices[0].select(seed_axis, idx - 1),
                                                    slices[1].select(seed_axis, idx - 1), policy_noises[idx - 1])
            self.policy.polyak_update(self.policy_tau)
        return {**critic_metrics, **policy_metrics}

    def general_properties():
        return GeneralProperties
