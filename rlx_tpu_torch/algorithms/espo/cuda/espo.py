"""ESPO: early-stopping policy optimization (the JAX package's ``espo.tpu``).

PPO's rollout and GAE; the update takes ``nr_epochs`` epochs over the
whole batch (no minibatches, advantages normalized over the batch) and
stops stepping once ``delta_calc_operator`` (``"mean"`` or ``"median"``) of
``|ratio - 1|`` has passed ``max_ratio_delta``: the epoch where it passes
still steps, the epochs after it do not.  The JAX package selects the
whole train state there, optimizer state included, so a stopped epoch
neither steps Adam nor advances its count or the learning-rate schedule.
The port does the same without a branch: ``active`` is a device flag, and
the Adam step (``train_state.adam_step_``) selects the parameters, the
moments and the step counts by it, as the device step count adds it, so
the iteration reads nothing back and a CUDA graph captures it.  Stopped
epochs still compute their loss and gradient norms; the metrics are means
over all ``nr_epochs``, ``policy_ratio/nr_active_epochs`` counts the
epochs that stepped, and the learning rate is the last stepped epoch's.

``"median"`` is ``jnp.median``'s: the mean of the two middle values of an
even-length batch (``torch.median`` returns the lower one).

With parallel seeds each seed stops on its own: the loss and ``|ratio -
1|``'s mean or median are per seed, and a stopped seed's Adam does not step
(``parallel_seeds.masked_adam_step``: per-seed step counts and learning
rates) while the others go on.

On a dp mesh the batch is every rank's rows: the advantages are
normalized over all of them, and the mean or the median of ``|ratio - 1|``
is taken over all of them (the median of the rows gathered from every
rank, ``gather_rows``), so every rank stops at the same epoch.
"""

import torch

from rlx_tpu_torch.algorithms.espo.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.parallel_seeds import masked_adam_step
from rlx_tpu_torch.algorithms.ppo.cuda.ppo import PPO
from rlx_tpu_torch.algorithms.train_state import clip_by_global_norm_


def median(x):
    """``jnp.median`` of a flat tensor: the middle value, or the mean of the
    two middle values of an even count, ``(low + high) * 0.5``."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


class ESPO(PPO):
    def __init__(self, config, train_env, eval_env, run_path=None, writer=None):
        super().__init__(config, train_env, eval_env, run_path, writer)
        a = config.algorithm
        self.max_ratio_delta = a.max_ratio_delta
        if a.delta_calc_operator not in ("mean", "median"):
            raise ValueError(f"unknown delta_calc_operator {a.delta_calc_operator!r}")
        self.delta_calc_operator = torch.mean if a.delta_calc_operator == "mean" else median
        # each seed's optimizer steps (they stop apart)
        self.seed_optimizer_steps = None if self.parallel is None else [0] * self.parallel.nr_seeds

    def _espo_loss(self, observations, actions, log_probs, returns, advantages):
        new_log_prob, entropy = self.policy.log_prob_entropy(observations, actions)
        ratio = torch.exp(new_log_prob - log_probs)
        ratio_delta = self._ratio_delta(torch.abs(ratio - 1.0))
        pg_loss = torch.maximum(
            -advantages * ratio,
            -advantages * torch.clamp(ratio, 1.0 - self.clip_range, 1.0 + self.clip_range),
        ).mean()
        entropy_loss = entropy.mean()
        new_value = self.critic(observations).squeeze(-1)
        critic_loss = (0.5 * (new_value - returns) ** 2).mean()
        loss = pg_loss - self.entropy_coef * entropy_loss + self.critic_coef * critic_loss
        return loss, ratio_delta, {
            "loss/policy_gradient_loss": pg_loss,
            "loss/critic_loss": critic_loss,
            "loss/entropy_loss": entropy_loss,
            "policy_ratio/ratio_delta": ratio_delta,
        }

    def _ratio_delta(self, deviation):
        """``delta_calc_operator`` of ``|ratio - 1|`` over the global batch."""
        if self.dp == 1:
            return self.delta_calc_operator(deviation)
        if self.delta_calc_operator is torch.mean:
            return self.mesh.mean(deviation.mean())
        return median(self.mesh.gather_rows(deviation.detach()))

    def _optimize_seeds(self, batch_arrays, epoch_indices=None):
        """``_optimize`` for every seed at once, each seed stopping on its own."""
        P = self.parallel
        observations, actions, log_probs, returns, advantages = batch_arrays
        advantages = ((advantages - advantages.mean(dim=1, keepdim=True))
                      / (advantages.std(dim=1, unbiased=False, keepdim=True) + 1e-8))
        active = torch.ones(P.nr_seeds, dtype=torch.bool, device=self.device)
        history = []
        for _ in range(self.nr_epochs):
            self.policy_optimizer.zero_grad(set_to_none=False)
            self.critic_optimizer.zero_grad(set_to_none=False)
            loss, ratio_delta, metrics = P.map(self._espo_loss, self._nets(), observations, actions, log_probs,
                                               returns, advantages)
            loss.sum().backward()
            with torch.no_grad():
                for name, module in (("policy", self.policy.module), ("critic", self.critic)):
                    metrics[f"gradients/{name}_grad_norm"] = clip_by_global_norm_(
                        [p.grad for p in module.parameters()], self.max_grad_norm, per_seed=True)
            metrics["policy_ratio/nr_active_epochs"] = active.float()
            lrs = [self.learning_rate_at(count) for count in self.seed_optimizer_steps]
            for optimizer in (self.policy_optimizer, self.critic_optimizer):
                masked_adam_step(optimizer, active, lrs)
            stepped = active.tolist()
            self.seed_optimizer_steps = [c + int(a) for c, a in zip(self.seed_optimizer_steps, stepped)]
            self.nr_optimizer_steps = self.seed_optimizer_steps[0]
            # stop every FOLLOWING epoch of a seed once its ratio has deviated too far
            active = active & (ratio_delta <= self.max_ratio_delta)
            history.append({k: v.detach() for k, v in metrics.items()})
        out = {k: torch.stack([h[k] for h in history]).mean(dim=0) for k in history[0]}
        out["policy_ratio/nr_active_epochs"] = out["policy_ratio/nr_active_epochs"] * self.nr_epochs
        out["lr/learning_rate"] = torch.tensor(lrs)
        return out

    def _optimize(self, batch_arrays, epoch_indices=None):
        """``nr_epochs`` full-batch epochs with the early stop; no
        permutation is drawn (``epoch_indices`` is not read)."""
        if self.parallel is not None:
            return self._optimize_seeds(batch_arrays, epoch_indices)
        observations, actions, log_probs, returns, advantages = batch_arrays
        mean, var = self.mesh.global_mean_var(advantages)
        advantages = (advantages - mean) / (torch.sqrt(var) + 1e-8)
        history = []
        active = torch.ones((), dtype=torch.bool, device=self.device)
        lr = None
        for _ in range(self.nr_epochs):
            self.policy_optimizer.zero_grad(set_to_none=False)
            self.critic_optimizer.zero_grad(set_to_none=False)
            loss, ratio_delta, metrics = self._espo_loss(observations, actions, log_probs, returns, advantages)
            loss.backward()
            with torch.no_grad():
                self._clip_gradients(metrics)
            metrics["policy_ratio/nr_active_epochs"] = active.float()
            epoch_lr = self._step_optimizers(active)
            # the first epoch always steps
            lr = epoch_lr if lr is None else torch.where(active, epoch_lr, lr)
            # stop every FOLLOWING epoch once the ratio has deviated too far
            active = active & (ratio_delta.detach() <= self.max_ratio_delta)
            history.append({k: v.detach() for k, v in metrics.items()})
        out = {k: torch.stack([h[k] for h in history]).mean() for k in history[0]}
        out["policy_ratio/nr_active_epochs"] = out["policy_ratio/nr_active_epochs"] * self.nr_epochs
        out["lr/learning_rate"] = lr.float()
        return out

    def general_properties():
        return GeneralProperties
