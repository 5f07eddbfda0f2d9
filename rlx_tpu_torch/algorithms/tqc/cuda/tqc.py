"""TQC: truncated quantile critics (the JAX package's ``tqc.tpu``).

``nr_critics`` nets of ``nr_atoms_per_net`` quantile atoms each.  The
target pools the atoms of every target net, sorts them and drops the
``nr_dropped_atoms_per_net`` highest per net; the critic steps on the
quantile Huber loss against the kept atoms and its target moves by Polyak
averaging; the policy and ``log_alpha`` step on the UPDATED critic's mean
over every net and atom.  ``quantile_huber_loss`` is shared with BRO.
"""

import torch

from rlx_tpu_torch.algorithms.sac.cuda.sac import SAC
from rlx_tpu_torch.algorithms.train_state import global_norm, per_seed_global_norm
from rlx_tpu_torch.models import distributions as D
from rlx_tpu_torch.models.mlp import VectorQCritic


def quantile_huber_loss(pred, target, taus, kappa=1.0):
    """pred ``[n, B, m]`` atoms, target ``[B, k]`` atoms, taus ``[m]`` ->
    the mean of ``|tau - 1{u < 0}| * huber(u)`` over every (net, sample,
    atom, target) with ``u = target - pred``."""
    u = target[None, :, None, :] - pred[..., None]
    abs_u = torch.abs(u)
    huber = torch.where(abs_u <= kappa, 0.5 * u ** 2, kappa * (abs_u - 0.5 * kappa))
    weight = torch.abs(taus[None, None, :, None] - (u < 0.0).to(u.dtype))
    return (weight * huber).mean()


class TQC(SAC):
    parallel_seeds = True
    capturable = False   # SAC's captured learning step is not yet this family's

    def _build_critic(self, a):
        return VectorQCritic(self.critic_obs_dim, self.action_dim, tuple(a.critic_hidden_sizes), a.nr_critics,
                             a.activation, a.layer_norm, output_dim=a.nr_atoms_per_net)

    def setup_states(self):
        a = self.config.algorithm
        self.nr_atoms, self.nr_dropped = a.nr_atoms_per_net, a.nr_dropped_atoms_per_net
        self.taus = (2.0 * torch.arange(self.nr_atoms, device=self.device) + 1.0) / (2.0 * self.nr_atoms)
        super().setup_states()

    def update(self, batch, step, target_noise=None, current_noise=None):
        """One critic step, its Polyak update, then one step of the policy
        and ``log_alpha``; the normals are drawn from the generator unless
        given.  Returns the metrics as device scalars."""
        return self._update(batch, target_noise, current_noise, self.plain_call, global_norm)

    def update_seeds(self, batch, step, target_noise=None, current_noise=None):
        """``update`` for every seed (``[S, batch, ...]``), each seed's
        normals from its generator unless given."""
        draws = self.seed_noises(target_noise, current_noise)
        return self._update(batch, draws["target_noise"], draws["current_noise"], self.seed_map,
                            per_seed_global_norm)

    def _update(self, batch, target_noise, current_noise, call, norm):
        """The update through ``call`` (``plain_call`` or ``seed_map``,
        whose ``[S]`` losses are summed); ``norm`` gives the grad norms."""
        learning_rate = self.learning_rate_at(self.policy.step_count())
        q_loss, q_value = call(self._critic_loss, batch, target_noise)
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
                "lr/learning_rate": torch.tensor(learning_rate),
                "gradients/policy_grad_norm": norm(policy_grads),
                "gradients/critic_grad_norm": norm(critic_grads),
            }

    def _critic_loss(self, batch, target_noise=None):
        """(quantile Huber loss, mean atom) of one seed's batch against the
        truncated pooled target."""
        with torch.no_grad():
            next_action, next_log_prob = D.tanh_gaussian_sample_and_log_prob(
                *self.policy.module(batch["next_observation"]), generator=self.generator, noise=target_noise)
            alpha = self.alpha.module()
            next_z = self.critic.target(batch["next_observation"], next_action)      # [n, B, atoms]
            n, B, m = next_z.shape
            pooled = torch.sort(next_z.permute(1, 0, 2).reshape(B, n * m), dim=-1).values
            kept = pooled[:, :n * m - n * self.nr_dropped]                            # drop the top atoms
            y = batch["reward"][:, None] + self.gamma * (1.0 - batch["terminated"][:, None]) * (
                kept - alpha * next_log_prob[:, None])
        z = self.critic.module(batch["observation"], batch["action"])
        return quantile_huber_loss(z, y, self.taus), z.detach().mean()

    def _policy_losses(self, batch, current_noise=None):
        """(policy loss, alpha loss, entropy, alpha) of one seed's batch on
        the critic as it is now."""
        alpha_with_grad = self.alpha.module()
        alpha = alpha_with_grad.detach()
        current_action, current_log_prob = D.tanh_gaussian_sample_and_log_prob(
            *self.policy.module(batch["observation"]), generator=self.generator, noise=current_noise)
        entropy = -current_log_prob.detach()
        z_pi = self.critic.module(batch["observation"], current_action).mean(dim=(0, 2))
        policy_loss = (alpha * current_log_prob - z_pi).mean()
        alpha_loss = (alpha_with_grad * (entropy - self.target_entropy)).mean()
        return policy_loss, alpha_loss, entropy.mean(), alpha
