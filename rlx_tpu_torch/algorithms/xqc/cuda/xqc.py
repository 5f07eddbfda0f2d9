"""XQC: cross-entropy Q-learning with HL-Gauss critics over SimBa trunks
(the JAX package's ``xqc.tpu``).

- twin categorical critics (``nr_atoms`` over [v_min, v_max]) on SimBa
  encoders, trained by cross-entropy against the HL-Gauss histogram of the
  clipped scalar target (``ops/distributional.hl_gauss_*``), the target
  from the minimum of the target critics' expectations;
- a SimBa policy with Dense ``mean`` / ``log_std`` heads;
- the weight-norm projection (``models/weight_norm``) of the policy, the
  critic and its target at init and of each net after its optimizer step:
  hidden Dense layers with their biases, heads kernel-only when
  ``normalize_last_layer``;
- per update the critic step, its projection and Polyak update, then the
  policy and ``log_alpha`` on the UPDATED critic, stepped only on
  ``step % policy_delay == 0`` (on the other steps neither moves, nor do
  their Adam states).
"""

import torch
import torch.nn.functional as F
from torch import nn

from rlx_tpu_torch.algorithms.sac.cuda.sac import SAC
from rlx_tpu_torch.algorithms.simba.cuda.simba import bounded_log_std
from rlx_tpu_torch.algorithms.train_state import global_norm, per_seed_global_norm
from rlx_tpu_torch.models import distributions as D
from rlx_tpu_torch.models.layers import Linear, SimbaEncoder
from rlx_tpu_torch.models.weight_norm import weight_norm_
from rlx_tpu_torch.ops.distributional import hl_gauss_expectation, hl_gauss_targets


class XQCPolicy(nn.Module):
    def __init__(self, obs_dim, action_dim, hidden_dim, nr_blocks, log_std_min=-10.0, log_std_max=2.0):
        super().__init__()
        self.encoder = SimbaEncoder(obs_dim, hidden_dim, nr_blocks)
        self.mean = Linear(hidden_dim, action_dim)
        self.log_std = Linear(hidden_dim, action_dim)
        self.log_std_min, self.log_std_max = log_std_min, log_std_max

    def forward(self, x):
        x = self.encoder(x)
        return self.mean(x), bounded_log_std(self.log_std(x), self.log_std_min, self.log_std_max)

    def hidden_layers(self):
        return self.encoder.dense_layers()

    def predictor_layers(self):
        return [self.mean, self.log_std]


class XQCVectorCritic(nn.Module):
    """(obs, action) -> logits ``[nr_critics, B, nr_atoms]``."""

    def __init__(self, obs_dim, action_dim, hidden_dim, nr_blocks, nr_atoms, nr_critics=2):
        super().__init__()
        self.encoder = SimbaEncoder(obs_dim + action_dim, hidden_dim, nr_blocks, nr_critics)
        self.value = Linear(hidden_dim, nr_atoms, nr_critics)

    def forward(self, obs, action):
        return self.value(self.encoder(torch.cat([obs, action], dim=-1)))

    def hidden_layers(self):
        return self.encoder.dense_layers()

    def predictor_layers(self):
        return [self.value]


class XQC(SAC):
    parallel_seeds = True
    capturable = False   # SAC's captured learning step is not yet this family's

    def _build_policy(self, a):
        return XQCPolicy(self.policy_obs_dim, self.action_dim, a.policy_hidden_dim, a.policy_nr_blocks)

    def _build_critic(self, a):
        return XQCVectorCritic(self.critic_obs_dim, self.action_dim, a.critic_hidden_dim, a.critic_nr_blocks,
                               a.nr_atoms, a.nr_critics)

    def setup_states(self):
        a = self.config.algorithm
        self.policy_delay = a.policy_delay
        self.v_min, self.v_max, self.nr_atoms = a.v_min, a.v_max, a.nr_atoms
        self.use_weight_norm, self.normalize_last_layer = a.use_weight_norm, a.normalize_last_layer
        super().setup_states()
        for module in (self.policy.module, self.critic.module, self.critic.target):
            self._weight_norm(module)

    def _weight_norm(self, module):
        if self.use_weight_norm:
            weight_norm_(module.hidden_layers(), module.predictor_layers(), self.normalize_last_layer)

    def _expectation(self, logits):
        return hl_gauss_expectation(logits, self.v_min, self.v_max)

    def update(self, batch, step, target_noise=None, current_noise=None):
        """One critic step, its projection and Polyak update, then on
        ``step % policy_delay == 0`` one step of the policy (and its
        projection) and ``log_alpha``; the normals are drawn from the
        generator unless given.  Returns the metrics as device scalars."""
        return self._update(batch, step, target_noise, current_noise, self.plain_call, global_norm)

    def update_seeds(self, batch, step, target_noise=None, current_noise=None):
        """``update`` for every seed (``[S, batch, ...]``), each seed's
        normals from its generator unless given.  The projection normalizes
        over the last axis, so the seed axis passes through it."""
        draws = self.seed_noises(target_noise, current_noise)
        return self._update(batch, step, draws["target_noise"], draws["current_noise"], self.seed_map,
                            per_seed_global_norm)

    def _update(self, batch, step, target_noise, current_noise, call, norm):
        """The update through ``call`` (``plain_call`` or ``seed_map``,
        whose ``[S]`` losses are summed); ``norm`` gives the grad norms."""
        q_loss, q_value, alpha = call(self._critic_loss, batch, target_noise)
        critic_grads = torch.autograd.grad(q_loss.sum(), list(self.critic.module.parameters()))
        self.critic.apply_gradients(critic_grads, self.learning_rate_at(self.critic.step_count()))
        self._weight_norm(self.critic.module)
        self.critic.polyak_update(self.tau)

        policy_loss, alpha_loss, entropy = call(self._policy_losses, batch, current_noise)
        policy_grads = torch.autograd.grad(policy_loss.sum(), list(self.policy.module.parameters()))
        alpha_grads = torch.autograd.grad(alpha_loss.sum(), list(self.alpha.module.parameters()))
        count = self.policy.step_count()
        if step % self.policy_delay == 0:
            learning_rate = self.learning_rate_at(count)
            self.policy.apply_gradients(policy_grads, learning_rate)
            self._weight_norm(self.policy.module)
            self.alpha.apply_gradients(alpha_grads, self.learning_rate_at(self.alpha.step_count()))
        else:
            # optax's rate of the last step taken (its initial one before any)
            learning_rate = self.learning_rate_at(max(count - 1, 0))

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
        """(cross-entropy loss, expected Q, alpha) of one seed's batch
        against the HL-Gauss histogram of its target."""
        with torch.no_grad():
            next_action, next_log_prob = D.tanh_gaussian_sample_and_log_prob(
                *self.policy.module(batch["next_observation"]), generator=self.generator, noise=target_noise)
            alpha = self.alpha.module()
            next_q = self._expectation(self.critic.target(batch["next_observation"], next_action))   # [n, B]
            y = batch["reward"] + self.gamma * (1.0 - batch["terminated"]) * (
                next_q.min(dim=0).values - alpha * next_log_prob)
            target_dist = hl_gauss_targets(torch.clamp(y, self.v_min, self.v_max), self.v_min, self.v_max,
                                           self.nr_atoms)
        logits = self.critic.module(batch["observation"], batch["action"])
        q_loss = -(target_dist[None] * F.log_softmax(logits, dim=-1)).sum(-1).mean()
        return q_loss, self._expectation(logits.detach()).mean(), alpha

    def _policy_losses(self, batch, current_noise=None):
        """(policy loss, alpha loss, entropy) of one seed's batch on the
        updated critic."""
        alpha_with_grad = self.alpha.module()
        alpha = alpha_with_grad.detach()
        current_action, current_log_prob = D.tanh_gaussian_sample_and_log_prob(
            *self.policy.module(batch["observation"]), generator=self.generator, noise=current_noise)
        entropy = -current_log_prob.detach()
        q_pi = self._expectation(self.critic.module(batch["observation"], current_action)).min(dim=0).values
        policy_loss = (alpha * current_log_prob - q_pi).mean()
        alpha_loss = (alpha_with_grad * (entropy - self.target_entropy)).mean()
        return policy_loss, alpha_loss, entropy.mean()
