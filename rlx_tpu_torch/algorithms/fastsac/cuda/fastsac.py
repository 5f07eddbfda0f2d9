"""FastSAC: SAC with the FastTD3 recipe.

The same algorithm as the JAX package's ``fastsac.tpu``: SAC's
tanh-Gaussian policy and learned temperature over twin categorical critics
(``nr_atoms`` over [v_min, v_max]), n-step returns and the running
observation normalizer.  Per update:

- the target: the next action from the policy before this update; per
  sample the target critic with the LOWER expectation (ties to critic 0);
  its atoms shifted by the reward, the discount and the entropy bonus
  ``-alpha * log pi`` (``target_z``), then projected back onto the atoms
  (kernel B3 on the card);
- the critic steps on the cross-entropy to that target and its target
  moves by Polyak averaging;
- the policy and ``log_alpha`` step on the UPDATED critic's smaller
  expectation.

As SAC's, a learning step reads nothing back (the rate from Adam's device
count, the normalizer updated in place), so on one CUDA device a CUDA graph
captures it, B3 inside (``capturable``).
"""

import torch
import torch.nn.functional as F

from rlx_tpu_torch.algorithms.sac.cuda.sac import SAC
from rlx_tpu_torch.algorithms.train_state import global_norm, per_seed_global_norm
from rlx_tpu_torch.models import distributions as D
from rlx_tpu_torch.models.mlp import VectorQCritic
from rlx_tpu_torch.ops import normalizers
from rlx_tpu_torch.ops.distributional import categorical_projection_dense


class FastSAC(SAC):
    # the JAX package's state names: the checkpoint tree holds policy,
    # critic, critic_target, alpha and obs_normalizer
    state_names = ("policy", "critic", "alpha", "obs_normalizer")
    parallel_seeds = True
    capturable = True

    def _build_critic(self, a):
        return VectorQCritic(self.critic_obs_dim, self.action_dim, tuple(a.critic_hidden_sizes), a.nr_critics,
                             a.activation, a.layer_norm, output_dim=a.nr_atoms)

    def setup_states(self):
        a = self.config.algorithm
        self.v_min, self.v_max, self.nr_atoms = a.v_min, a.v_max, a.nr_atoms
        self.atoms = torch.linspace(self.v_min, self.v_max, self.nr_atoms, device=self.device)
        self.normalize_obs = a.enable_observation_normalization
        super().setup_states()
        self.obs_normalizer = normalizers.obs_normalizer_init(self.os_shape, self.device)

    def _norm(self, observation):
        if self.normalize_obs:
            return normalizers.obs_normalize(self.obs_normalizer, observation)
        return observation

    def observe_transition(self, observation, env_state):
        if self.normalize_obs:
            self.update_obs_normalizer_(observation)

    @torch.no_grad()
    def act(self, observation, step=0, noise=None):
        return super().act(self._norm(observation), step, noise)

    @torch.no_grad()
    def eval_act(self, observation):
        return super().eval_act(self._norm(observation))

    def expected_value(self, logits):
        return (torch.softmax(logits, dim=-1) * self.atoms).sum(-1)

    def update(self, batch, step, target_noise=None, current_noise=None):
        """One critic step, its Polyak update, then one step of the policy
        and ``log_alpha``.  ``target_noise`` / ``current_noise`` (standard
        normal, ``[batch, action_dim]``) are drawn from the generator unless
        given.  Returns the metrics as device scalars."""
        return self._update(batch, target_noise, current_noise, self.plain_call, global_norm)

    def update_seeds(self, batch, step, target_noise=None, current_noise=None):
        """``update`` for every seed (``[S, batch, ...]``), each seed's
        normals from its generator unless given; one projection for all
        seeds' targets (kernel B3 at ``[S * batch, atoms]``)."""
        draws = self.seed_noises(target_noise, current_noise)
        return self._update(batch, draws["target_noise"], draws["current_noise"], self.seed_map,
                            per_seed_global_norm)

    def _update(self, batch, target_noise, current_noise, call, norm):
        """The update through ``call`` (``plain_call`` or ``seed_map``,
        whose ``[S]`` losses are summed), the projection between the mapped
        target and loss; ``norm`` gives the grad norms."""
        learning_rate = self.learning_rate_tensor()
        with torch.no_grad():
            target_z, chosen_probs = call(self._target_inputs, batch, target_noise)
            projection = lambda z, p: categorical_projection_dense(z, p, self.v_min, self.v_max, self.nr_atoms)
            target_dist = self.fold_seeds(projection, target_z, chosen_probs)

        q_loss, q_value = call(self._critic_loss, batch, target_dist)
        critic_grads = torch.autograd.grad(q_loss.sum(), list(self.critic.module.parameters()))
        self.critic.apply_gradients(critic_grads, learning_rate)
        self.critic.polyak_update(self.tau)

        policy_loss, alpha_loss, entropy, alpha = call(self._policy_losses, batch, current_noise)
        policy_grads = torch.autograd.grad(policy_loss.sum(), list(self.policy.module.parameters()))
        alpha_grads = torch.autograd.grad(alpha_loss.sum(), list(self.alpha.module.parameters()))
        self.policy.apply_gradients(policy_grads, learning_rate)
        self.alpha.apply_gradients(alpha_grads, learning_rate)

        with torch.no_grad():
            return {
                "loss/q_loss": q_loss.detach(),
                "loss/policy_loss": policy_loss.detach(),
                "loss/entropy_loss": alpha_loss.detach(),
                "entropy/entropy": entropy,
                "entropy/alpha": alpha,
                "q_value/q_value": q_value,
                "lr/learning_rate": learning_rate.float(),
                "gradients/policy_grad_norm": norm(policy_grads),
                "gradients/critic_grad_norm": norm(critic_grads),
            }

    def _targets(self, batch):
        """(next observation, reward, terminated, discount) of a 1-step or
        n-step batch, the observation normalized."""
        if self.n_step > 1:
            return (self._norm(batch["n_step_next_observation"]), batch["n_step_reward"],
                    batch["n_step_terminated"], batch["n_step_gamma"])
        return (self._norm(batch["next_observation"]), batch["reward"], batch["terminated"],
                torch.full_like(batch["reward"], self.gamma))

    @torch.no_grad()
    def _target_inputs(self, batch, target_noise=None):
        """(target atoms ``[B, atoms]``, the chosen target critic's
        probabilities ``[B, atoms]``) of one seed's batch: what the
        projection takes.  The entropy bonus shifts the support."""
        next_obs, reward, terminated, discount = self._targets(batch)
        next_action, next_log_prob = D.tanh_gaussian_sample_and_log_prob(
            *self.policy.module(next_obs), generator=self.generator, noise=target_noise)
        alpha = self.alpha.module()
        next_probs = torch.softmax(self.critic.target(next_obs, next_action), dim=-1)   # [2, B, atoms]
        lower = torch.argmin((next_probs * self.atoms).sum(-1), dim=0)
        chosen_probs = torch.where(lower[:, None] == 0, next_probs[0], next_probs[1])
        target_z = reward[:, None] + discount[:, None] * (1.0 - terminated[:, None]) * (
            self.atoms[None] - alpha * next_log_prob[:, None])
        return target_z, chosen_probs

    def _critic_loss(self, batch, target_dist):
        """(cross-entropy loss, expected Q) of one seed's batch."""
        logits = self.critic.module(self._norm(batch["observation"]), batch["action"])
        q_loss = -(target_dist[None] * F.log_softmax(logits, dim=-1)).sum(-1).mean()
        return q_loss, self.expected_value(logits.detach()).mean()

    def _policy_losses(self, batch, current_noise=None):
        """(policy loss, alpha loss, entropy, alpha) of one seed's batch on
        the updated critic's smaller expectation."""
        obs = self._norm(batch["observation"])
        alpha_with_grad = self.alpha.module()
        alpha = alpha_with_grad.detach()
        current_action, current_log_prob = D.tanh_gaussian_sample_and_log_prob(
            *self.policy.module(obs), generator=self.generator, noise=current_noise)
        entropy = -current_log_prob.detach()
        q_pi = self.expected_value(self.critic.module(obs, current_action)).min(dim=0).values
        policy_loss = (alpha * current_log_prob - q_pi).mean()
        alpha_loss = (alpha_with_grad * (entropy - self.target_entropy)).mean()
        return policy_loss, alpha_loss, entropy.mean(), alpha
