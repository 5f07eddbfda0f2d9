"""PPO-DTRL: PPO with differentiable trust-region projection layers (the
JAX package's ``ppo_dtrl.tpu``).

PPO's rollout, GAE and minibatch epochs; in the loss the new Gaussian is
projected per state into a KL trust region around the policy as it was
at the start of the update (a frozen copy taken in ``_optimize``): the
mean and the covariance parts separately (``trust_region.kl_projection``),
optionally followed by the entropy projection.  The clipped surrogate and
the entropy are taken under the projected Gaussian, and
``trust_region_coef`` times a regularizer pulls the raw output towards the
detached projection.  The projection's diagnostics are logged under
``projection/*``.
"""

import copy
import math

import torch

from rlx_tpu_torch.algorithms.ppo.cuda.ppo import PPO
from rlx_tpu_torch.algorithms.ppo_dtrl.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.ppo_dtrl.cuda.trust_region import entropy_projection, kl_projection
from rlx_tpu_torch.models import distributions as D

HALF_LOG_2PI_E = 0.5 * math.log(2.0 * math.pi * math.e)


class PPODTRL(PPO):
    def __init__(self, config, train_env, eval_env, run_path=None, writer=None):
        super().__init__(config, train_env, eval_env, run_path, writer)
        a = config.algorithm
        self.mean_bound = a.mean_bound
        self.cov_bound = a.cov_bound
        self.trust_region_coef = a.trust_region_coef
        self.entropy_projection_active = a.entropy_projection_active
        self.min_entropy = a.min_entropy
        self.old_policy = None

    def _optimize(self, batch_arrays, epoch_indices=None):
        """PPO's minibatch epochs against the policy frozen as it is now."""
        self.old_policy = copy.deepcopy(self.policy.module).requires_grad_(False)
        try:
            return super()._optimize(batch_arrays, epoch_indices)
        finally:
            self.old_policy = None

    def _loss(self, obs_mb, action_mb, log_prob_mb, return_mb, advantage_mb):
        mean, logstd = self.policy.module(obs_mb)
        std = torch.exp(logstd.expand(mean.shape))
        with torch.no_grad():
            old_mean, old_logstd = self.old_policy(obs_mb)
            old_std = torch.exp(old_logstd.expand(old_mean.shape))

        proj = kl_projection(mean, std, old_mean, old_std, self.mean_bound, self.cov_bound)
        proj_mean, proj_std = proj["mean"], proj["std"]
        proj_logstd = torch.log(proj_std)
        if self.entropy_projection_active:
            proj_logstd = entropy_projection(proj_logstd, self.min_entropy)
            proj_std = torch.exp(proj_logstd)

        # the regularizer pulls the raw output towards the detached projection
        proj_mean_det, proj_std_det = proj_mean.detach(), proj_std.detach()
        tr_maha = 0.5 * (((proj_mean_det - mean) / proj_std_det) ** 2).sum(-1)
        tr_cov = 0.5 * (2.0 * (torch.log(proj_std_det) - torch.log(std)) + (std / proj_std_det) ** 2 - 1.0).sum(-1)
        trust_region_loss = (tr_maha + tr_cov).mean()

        new_log_prob = D.gaussian_log_prob(proj_mean, proj_logstd, action_mb)
        entropy = (proj_logstd + HALF_LOG_2PI_E).sum(-1)
        logratio = new_log_prob - log_prob_mb
        ratio = torch.exp(logratio)
        approx_kl = ((ratio - 1.0) - logratio).mean()
        clip_fraction = (torch.abs(ratio - 1.0) > self.clip_range).float().mean()
        pg_loss = torch.maximum(
            -advantage_mb * ratio,
            -advantage_mb * torch.clamp(ratio, 1.0 - self.clip_range, 1.0 + self.clip_range),
        ).mean()
        entropy_loss = entropy.mean()
        new_value = self.critic(obs_mb).squeeze(-1)
        critic_loss = (0.5 * (new_value - return_mb) ** 2).mean()

        loss = (pg_loss - self.entropy_coef * entropy_loss + self.critic_coef * critic_loss
                + self.trust_region_coef * trust_region_loss)
        return loss, {
            "loss/policy_gradient_loss": pg_loss,
            "loss/critic_loss": critic_loss,
            "loss/entropy_loss": entropy_loss,
            "loss/trust_region_loss": trust_region_loss,
            "policy_ratio/approx_kl": approx_kl,
            "policy_ratio/clip_fraction": clip_fraction,
            "projection/eta_cov": proj["eta_cov"].mean(),
            "projection/unprojected_kl_mean": proj["kl_mean_part"].mean(),
            "projection/unprojected_kl_cov": proj["kl_cov_part"].mean(),
            "projection/projected_kl_mean": proj["post_kl_mean_part"].mean(),
            "projection/projected_kl_cov": proj["post_kl_cov_part"].mean(),
        }

    def general_properties():
        return GeneralProperties
