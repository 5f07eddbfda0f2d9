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
implementation's.  With parallel seeds each seed samples its own batches
and takes these draws from its own generator in its one-seed order
(``critic_draws``, ``policy_draws``); the losses are mapped over the seeds
and each critic update steps every seed's ensemble at once.
"""

import torch

from rlx_tpu_torch.algorithms.sac.cuda.sac import SAC
from rlx_tpu_torch.algorithms.train_state import global_norm, per_seed_global_norm
from rlx_tpu_torch.models import distributions as D


class EnsembleSAC(SAC):
    capturable = False   # SAC's captured learning step is not yet the ensembles'
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

    # --- the draws of one seed, in its one-seed order -------------------------
    def _normal(self, generator):
        return torch.randn((self.batch_size, self.action_dim), generator=generator, device=self.device)

    def _dropout_masks(self, generator):
        """DroQ's keep-masks of one critic forward, ``[nr_critics, batch,
        size]`` per hidden layer (none without dropout)."""
        a = self.config.algorithm
        rate = a.get("dropout_rate", 0.0)
        if rate <= 0.0:
            return ()
        return tuple(torch.rand((a.nr_critics, self.batch_size, size), generator=generator, device=self.device)
                     < 1.0 - rate for size in a.critic_hidden_sizes)

    def aggregate_draws(self, generator):
        """The draws of ``target_q_aggregate`` (REDQ's subset)."""
        return {}

    def critic_draws(self, generator):
        """One critic update's draws: the next action's normal, the target
        forward's masks, the aggregate's draws, the online forward's masks."""
        draws = {"target_noise": self._normal(generator)}
        target_masks = self._dropout_masks(generator)
        if target_masks:
            draws["target_masks"] = target_masks
        draws.update(self.aggregate_draws(generator))
        if target_masks:
            draws["masks"] = self._dropout_masks(generator)
        return draws

    def policy_draws(self, generator):
        """One policy update's draws: the current action's normal, the
        critic forward's masks."""
        draws = {"current_noise": self._normal(generator)}
        masks = self._dropout_masks(generator)
        if masks:
            draws["masks"] = masks
        return draws

    def _seed_draws(self, draws, sample):
        """``(call, norm, draws)``: the plain call with the given draws (None
        drawn from the generator), or with parallel seeds ``seed_map`` with
        each seed's draws from ``sample`` unless given."""
        given = {k: v for k, v in draws.items() if v is not None}
        if self.parallel is None:
            if self.dp > 1 and not given:
                # this rank's batch rows of the dp = 1 run's draws
                # (normals [batch, ...], masks [nr_critics, batch, ...]; REDQ's subset whole)
                given = {k: (tuple(self.batch_rows(m, 1) for m in v) if k.endswith("masks")
                             else self.batch_rows(v) if k.endswith("_noise") else v)
                         for k, v in sample(self.generator).items()}
            return self.plain_call, global_norm, given
        return self.seed_map, per_seed_global_norm, given or self.parallel.draw(sample)

    # --- updates ---------------------------------------------------------------
    def critic_update(self, batch, target_noise=None, subset=None, target_masks=None, masks=None):
        """One critic step on ``batch`` and the target's Polyak update."""
        call, norm, draws = self._seed_draws(
            {"target_noise": target_noise, "subset": subset, "target_masks": target_masks, "masks": masks},
            self.critic_draws)
        q_loss, q_value = call(lambda b, d: self._critic_loss(b, **d), batch, draws)
        grads = torch.autograd.grad(q_loss.sum(), list(self.critic.module.parameters()))
        self.critic.apply_gradients(grads, self.learning_rate_at(self.critic.step_count()))
        self.critic.polyak_update(self.tau)
        return {"loss/q_loss": q_loss.detach(), "q_value/q_value": q_value, "gradients/critic_grad_norm": norm(grads)}

    def _critic_loss(self, batch, target_noise=None, subset=None, target_masks=None, masks=None):
        """(squared-error loss, mean Q) of one seed's batch."""
        with torch.no_grad():
            next_action, next_log_prob = D.tanh_gaussian_sample_and_log_prob(
                *self.policy.module(batch["next_observation"]), generator=self.generator, noise=target_noise)
            alpha = self.alpha.module()
            next_q = self._q(self.critic.target, batch["next_observation"], next_action, target_masks)
            y = batch["reward"] + self.gamma * (1.0 - batch["terminated"]) * (
                self.target_q_aggregate(next_q, subset) - alpha * next_log_prob)
        q = self._q(self.critic.module, batch["observation"], batch["action"], masks)
        return ((q - y[None, :]) ** 2).mean(), q.detach().mean()

    def policy_alpha_update(self, batch, current_noise=None, masks=None):
        """One step of the policy and ``log_alpha`` on ``batch``."""
        call, norm, draws = self._seed_draws({"current_noise": current_noise, "masks": masks}, self.policy_draws)
        policy_loss, alpha_loss, entropy, alpha = call(lambda b, d: self._policy_losses(b, **d), batch, draws)
        policy_grads = torch.autograd.grad(policy_loss.sum(), list(self.policy.module.parameters()))
        alpha_grads = torch.autograd.grad(alpha_loss.sum(), list(self.alpha.module.parameters()))
        learning_rate = self.learning_rate_at(self.policy.step_count())
        self.policy.apply_gradients(policy_grads, learning_rate)
        self.alpha.apply_gradients(alpha_grads, self.learning_rate_at(self.alpha.step_count()))
        return {
            "loss/policy_loss": policy_loss.detach(),
            "loss/entropy_loss": alpha_loss.detach(),
            "entropy/entropy": entropy,
            "entropy/alpha": alpha,
            "gradients/policy_grad_norm": norm(policy_grads),
            "lr/learning_rate": torch.tensor(learning_rate),
        }

    def _policy_losses(self, batch, current_noise=None, masks=None):
        """(policy loss, alpha loss, entropy, alpha) of one seed's batch."""
        obs = batch["observation"]
        alpha_with_grad = self.alpha.module()
        alpha = alpha_with_grad.detach()
        current_action, current_log_prob = D.tanh_gaussian_sample_and_log_prob(
            *self.policy.module(obs), generator=self.generator, noise=current_noise)
        entropy = -current_log_prob.detach()
        q_pi = self.policy_q_aggregate(self._q(self.critic.module, obs, current_action, masks))
        policy_loss = (alpha * current_log_prob - q_pi).mean()
        alpha_loss = (alpha_with_grad * (entropy - self.target_entropy)).mean()
        return policy_loss, alpha_loss, entropy.mean(), alpha

    def update_with_buffer(self, buffer, step):
        """``q_update_steps`` critic updates, each on a fresh batch, then
        one policy and ``log_alpha`` update on another (each seed's batches
        and draws its own)."""
        critic_metrics = [self.critic_update(self.sample_batch(buffer)) for _ in range(self.q_update_steps)]
        metrics = {k: torch.stack([m[k] for m in critic_metrics]).mean(dim=0) for k in critic_metrics[0]}
        metrics.update(self.policy_alpha_update(self.sample_batch(buffer)))
        return metrics
