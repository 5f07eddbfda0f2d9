"""CrossQ: SAC without target networks, stabilized by batch
renormalization (the JAX package's ``crossq.tpu``).

- twin critics with ``BatchRenorm`` before every Dense (the input's
  included), wide (2048) by default; Adam with beta1 0.5;
- the critic runs ONE train-mode forward over the joint (s, a | s', a')
  batch, so both halves share its batch statistics; the target is the
  second half's minimum without gradient (no target network);
- the policy and ``log_alpha`` step on the UPDATED critic in eval mode
  (running statistics), only on ``step % policy_delay == 0``;
- the critic's running statistics and renorm step counts are buffers, so
  the checkpoint carries them.  As flax's ``init`` in train mode does, the
  critic takes one train-mode forward of a zero batch of 2 at init.
"""

import torch
from torch import nn

from rlx_tpu_torch.algorithms.sac.cuda.sac import SAC
from rlx_tpu_torch.algorithms.train_state import TrainState, global_norm, per_seed_global_norm
from rlx_tpu_torch.models import distributions as D
from rlx_tpu_torch.models.layers import BatchRenorm, Linear, commit_batch_stats


class CrossQVectorCritic(nn.Module):
    """(obs, action, train) -> ``[nr_critics, B, 1]``: BatchRenorm -> [Dense
    -> BatchRenorm -> relu] per hidden size -> Dense, per critic."""

    def __init__(self, obs_dim, action_dim, hidden_sizes, nr_critics=2, momentum=0.99):
        super().__init__()
        sizes = [obs_dim + action_dim] + list(hidden_sizes)
        self.norms = nn.ModuleList(BatchRenorm(size, nr_critics, momentum) for size in sizes)
        self.layers = nn.ModuleList(Linear(a, b, nr_critics) for a, b in zip(sizes[:-1], sizes[1:]))
        self.head = Linear(sizes[-1], 1, nr_critics)

    def forward(self, obs, action, train):
        x = self.norms[0](torch.cat([obs, action], dim=-1), train)
        for layer, norm in zip(self.layers, self.norms[1:]):
            x = torch.relu(norm(layer(x), train))
        return self.head(x)


class CrossQ(SAC):
    parallel_seeds = True
    capturable = False   # SAC's captured learning step is not yet this family's

    def _build_critic(self, a):
        critic = CrossQVectorCritic(self.critic_obs_dim, self.action_dim, tuple(a.critic_hidden_sizes), a.nr_critics,
                                    a.batch_renorm_momentum)
        with torch.no_grad():
            critic(torch.zeros(2, self.critic_obs_dim), torch.zeros(2, self.action_dim), True)
        commit_batch_stats(critic)
        return critic

    def setup_states(self):
        self.policy_delay = self.config.algorithm.policy_delay
        super().setup_states()
        critic = self.critic.module
        self.critic = TrainState(critic, self._adam(critic, beta1=0.5), target=False)

    def update(self, batch, step, target_noise=None, current_noise=None):
        """One critic step on the joint batch, then on ``step %
        policy_delay == 0`` one step of the policy and ``log_alpha``; the
        normals are drawn from the generator unless given.  Returns the
        metrics as device scalars."""
        return self._update(batch, step, target_noise, current_noise, self.plain_call, global_norm)

    def update_seeds(self, batch, step, target_noise=None, current_noise=None):
        """``update`` for every seed (``[S, batch, ...]``), each seed's
        normals from its generator unless given.  Each seed's batch
        statistics are over its own joint batch; the map hands them out and
        they are committed into the seed-stacked running statistics."""
        draws = self.seed_noises(target_noise, current_noise)
        return self._update(batch, step, draws["target_noise"], draws["current_noise"], self.seed_map,
                            per_seed_global_norm)

    def _update(self, batch, step, target_noise, current_noise, call, norm):
        """The update through ``call`` (``plain_call`` or ``seed_map``,
        whose ``[S]`` losses are summed); ``norm`` gives the grad norms."""
        q_loss, q_value = call(self._critic_loss, batch, target_noise)
        critic_grads = torch.autograd.grad(q_loss.sum(), list(self.critic.module.parameters()))
        self.critic.apply_gradients(critic_grads, self.learning_rate_at(self.critic.step_count()))
        commit_batch_stats(self.critic.module)

        policy_loss, alpha_loss, entropy = call(self._policy_losses, batch, current_noise)
        policy_grads = torch.autograd.grad(policy_loss.sum(), list(self.policy.module.parameters()))
        alpha_grads = torch.autograd.grad(alpha_loss.sum(), list(self.alpha.module.parameters()))
        count = self.policy.step_count()
        if step % self.policy_delay == 0:
            learning_rate = self.learning_rate_at(count)
            self.policy.apply_gradients(policy_grads, learning_rate)
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
                "entropy/alpha": self.alpha.module(),
                "q_value/q_value": q_value,
                "lr/learning_rate": torch.tensor(learning_rate),
                "gradients/policy_grad_norm": norm(policy_grads),
                "gradients/critic_grad_norm": norm(critic_grads),
            }

    def _critic_loss(self, batch, target_noise=None):
        """(squared-error loss, mean Q) of one seed's batch from ONE
        train-mode critic forward over (s, a | s', a'), which leaves that
        batch's statistics pending."""
        obs = batch["observation"]
        B = obs.shape[0]
        with torch.no_grad():
            next_action, next_log_prob = D.tanh_gaussian_sample_and_log_prob(
                *self.policy.module(batch["next_observation"]), generator=self.generator, noise=target_noise)
            alpha = self.alpha.module()
        q_joint = self.critic.module(torch.cat([obs, batch["next_observation"]]),
                                     torch.cat([batch["action"], next_action]), True).squeeze(-1)   # [n, 2B]
        q = q_joint[:, :B]
        y = batch["reward"] + self.gamma * (1.0 - batch["terminated"]) * (
            q_joint[:, B:].min(dim=0).values.detach() - alpha * next_log_prob)
        q_loss = ((q - y.detach()[None, :]) ** 2).mean()
        return q_loss, q.detach().mean()

    def _policy_losses(self, batch, current_noise=None):
        """(policy loss, alpha loss, entropy) of one seed's batch on the
        updated critic in eval mode (its running statistics)."""
        obs = batch["observation"]
        alpha_with_grad = self.alpha.module()
        current_action, current_log_prob = D.tanh_gaussian_sample_and_log_prob(
            *self.policy.module(obs), generator=self.generator, noise=current_noise)
        entropy = -current_log_prob.detach()
        min_q_pi = self.critic.module(obs, current_action, False).squeeze(-1).min(dim=0).values
        policy_loss = (alpha_with_grad.detach() * current_log_prob - min_q_pi).mean()
        alpha_loss = (alpha_with_grad * (entropy - self.target_entropy)).mean()
        return policy_loss, alpha_loss, entropy.mean()
