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
from rlx_tpu_torch.algorithms.train_state import global_norm
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
        obs = batch["observation"]
        learning_rate = self.learning_rate_at(self.policy.step_count())
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

        z = self.critic.module(obs, batch["action"])
        q_loss = quantile_huber_loss(z, y, self.taus)
        critic_grads = torch.autograd.grad(q_loss, list(self.critic.module.parameters()))
        self.critic.apply_gradients(critic_grads, learning_rate)
        self.critic.polyak_update(self.tau)

        alpha_with_grad = self.alpha.module()
        current_action, current_log_prob = D.tanh_gaussian_sample_and_log_prob(
            *self.policy.module(obs), generator=self.generator, noise=current_noise)
        entropy = -current_log_prob.detach()
        z_pi = self.critic.module(obs, current_action).mean(dim=(0, 2))
        policy_loss = (alpha * current_log_prob - z_pi).mean()
        alpha_loss = (alpha_with_grad * (entropy - self.target_entropy)).mean()
        policy_grads = torch.autograd.grad(policy_loss, list(self.policy.module.parameters()))
        alpha_grads = torch.autograd.grad(alpha_loss, list(self.alpha.module.parameters()))
        self.policy.apply_gradients(policy_grads, learning_rate)
        self.alpha.apply_gradients(alpha_grads, learning_rate)

        with torch.no_grad():
            return {
                "loss/q_loss": q_loss.detach(),
                "loss/policy_loss": policy_loss.detach(),
                "loss/entropy_loss": alpha_loss.detach(),
                "entropy/entropy": entropy.mean(),
                "entropy/alpha": alpha,
                "q_value/q_value": z.detach().mean(),
                "lr/learning_rate": torch.tensor(learning_rate),
                "gradients/policy_grad_norm": global_norm(policy_grads),
                "gradients/critic_grad_norm": global_norm(critic_grads),
            }
