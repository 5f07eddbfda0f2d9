"""SAC with an ensemble of critics and several critic updates per env step
(the JAX package's ``algorithms/sac_ensembles.py``): REDQ, DroQ and AQE.

``update_with_buffer`` replaces the core's sample + ``update``: per env
step, ``q_update_steps`` critic updates, each on a fresh batch, then one
policy and ``log_alpha`` update on one more batch; the critic metrics are
averaged over the loop.  Each critic update takes the target from the
policy and the Polyak-averaged target ensemble, aggregated by
``target_q_aggregate`` (the minimum here), steps the critic on the squared
error and moves its target.  The policy maximizes ``policy_q_aggregate``
of the ensemble.  A subclass sets ``q_update_steps`` and the two
aggregations.

Every draw is an argument that defaults to the generator: the batches
(through the buffer's sampler), the target and current normals, the
subset of critics in a target (REDQ) and the dropout keep-masks of the
target, online and policy forwards (DroQ), so a test can replay another
implementation's.
"""

import torch

from rlx_tpu_torch.algorithms.sac.cuda.sac import SAC
from rlx_tpu_torch.algorithms.train_state import global_norm
from rlx_tpu_torch.models import distributions as D


class EnsembleSAC(SAC):
    # the config key of the critic updates per env step (BRO: updates_per_step)
    q_update_steps_key = "q_update_steps"

    def setup_states(self):
        self.q_update_steps = int(self.config.algorithm[self.q_update_steps_key])
        super().setup_states()

    def target_q_aggregate(self, next_q, subset=None):
        """next_q [nr_critics, B] -> [B]."""
        return next_q.min(dim=0).values

    def policy_q_aggregate(self, q_pi):
        """q_pi [nr_critics, B] -> [B]."""
        return q_pi.min(dim=0).values

    def _q(self, module, obs, action, masks=None):
        if module.dropout_rate > 0.0:
            return module(obs, action, dropout_masks=masks, generator=self.generator).squeeze(-1)
        return module(obs, action).squeeze(-1)

    def critic_update(self, batch, target_noise=None, subset=None, target_masks=None, masks=None):
        """One critic step on ``batch`` and the target's Polyak update."""
        with torch.no_grad():
            next_action, next_log_prob = D.tanh_gaussian_sample_and_log_prob(
                *self.policy.module(batch["next_observation"]), generator=self.generator, noise=target_noise)
            alpha = self.alpha.module()
            next_q = self._q(self.critic.target, batch["next_observation"], next_action, target_masks)
            y = batch["reward"] + self.gamma * (1.0 - batch["terminated"]) * (
                self.target_q_aggregate(next_q, subset) - alpha * next_log_prob)
        q = self._q(self.critic.module, batch["observation"], batch["action"], masks)
        q_loss = ((q - y[None, :]) ** 2).mean()
        grads = torch.autograd.grad(q_loss, list(self.critic.module.parameters()))
        self.critic.apply_gradients(grads, self.learning_rate_at(self.critic.step_count()))
        self.critic.polyak_update(self.tau)
        return {"loss/q_loss": q_loss.detach(), "q_value/q_value": q.detach().mean(),
                "gradients/critic_grad_norm": global_norm(grads)}

    def policy_alpha_update(self, batch, current_noise=None, masks=None):
        """One step of the policy and ``log_alpha`` on ``batch``."""
        obs = batch["observation"]
        alpha_with_grad = self.alpha.module()
        alpha = alpha_with_grad.detach()
        current_action, current_log_prob = D.tanh_gaussian_sample_and_log_prob(
            *self.policy.module(obs), generator=self.generator, noise=current_noise)
        entropy = -current_log_prob.detach()
        q_pi = self.policy_q_aggregate(self._q(self.critic.module, obs, current_action, masks))
        policy_loss = (alpha * current_log_prob - q_pi).mean()
        alpha_loss = (alpha_with_grad * (entropy - self.target_entropy)).mean()
        policy_grads = torch.autograd.grad(policy_loss, list(self.policy.module.parameters()))
        alpha_grads = torch.autograd.grad(alpha_loss, list(self.alpha.module.parameters()))
        learning_rate = self.learning_rate_at(self.policy.step_count())
        self.policy.apply_gradients(policy_grads, learning_rate)
        self.alpha.apply_gradients(alpha_grads, self.learning_rate_at(self.alpha.step_count()))
        return {
            "loss/policy_loss": policy_loss.detach(),
            "loss/entropy_loss": alpha_loss.detach(),
            "entropy/entropy": entropy.mean(),
            "entropy/alpha": alpha,
            "gradients/policy_grad_norm": global_norm(policy_grads),
            "lr/learning_rate": torch.tensor(learning_rate),
        }

    def update_with_buffer(self, buffer, step):
        """``q_update_steps`` critic updates, each on a fresh batch, then
        one policy and ``log_alpha`` update on another."""
        critic_metrics = [self.critic_update(self.sample_batch(buffer)) for _ in range(self.q_update_steps)]
        metrics = {k: torch.stack([m[k] for m in critic_metrics]).mean() for k in critic_metrics[0]}
        metrics.update(self.policy_alpha_update(self.sample_batch(buffer)))
        return metrics
