"""SAC: soft actor-critic with a learned temperature.

The same algorithm as the JAX package's ``sac.tpu``:

- a tanh-squashed Gaussian policy with a clamped state-dependent log-std;
- ``nr_critics`` Q critics (twin by default) with a Polyak-averaged target;
  the target is the minimum over the target critics, minus ``alpha`` times
  the next action's log-probability;
- a learned ``alpha = exp(log_alpha)`` driven towards ``target_entropy``
  (``"auto"``: ``-action_dim``);
- Adam (eps 1e-8) on the policy, the critic and ``log_alpha``; with
  ``anneal_learning_rate`` the rate falls linearly with the optimizers'
  step count (``learning_rate_at``), computed on the device from Adam's
  own count (``learning_rate_tensor``), so a learning step reads nothing
  back and on one CUDA device a CUDA graph captures it (``capturable``;
  ``offpolicy.py``).  A subclass that does not capture declares
  ``capturable = False``.

The JAX package takes one gradient of ``q_loss + policy_loss + alpha_loss``
with ``stop_gradient`` on the other parameter sets, so each set gets the
gradient of its own term only: the critic of ``q_loss``, the policy of
``policy_loss``, ``log_alpha`` of ``alpha_loss``.  Here each is one
``torch.autograd.grad`` of its term with respect to its set, all taken at
the parameters before the update, then the three optimizers step and the
critic's target moves.

With parallel seeds every seed has its own policy, critic and temperature
(seed-stacked); one ``update_seeds`` maps the three losses over the seeds
and differentiates their sums, so each seed's parameters get the gradient
of its own losses.
"""

import torch

from rlx_tpu_torch.algorithms.offpolicy import OffPolicyAlgorithm
from rlx_tpu_torch.algorithms.sac.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.train_state import TrainState, global_norm, per_seed_global_norm
from rlx_tpu_torch.models import distributions as D
from rlx_tpu_torch.models.mlp import EntropyCoefficient, SquashedGaussianPolicy, VectorQCritic, select_observations


class SAC(OffPolicyAlgorithm):
    # the JAX package's state names: the checkpoint tree holds policy,
    # critic, critic_target and alpha
    state_names = ("policy", "critic", "alpha")
    parallel_seeds = True
    capturable = True

    def _build_policy(self, a):
        """The policy network; the SAC variants with other trunks override it."""
        return SquashedGaussianPolicy(self.policy_obs_dim, self.action_dim, tuple(a.policy_hidden_sizes),
                                      a.activation, a.layer_norm, a.log_std_min, a.log_std_max)

    def _build_critic(self, a):
        """The critic ensemble; the SAC variants with other heads override it."""
        return VectorQCritic(self.critic_obs_dim, self.action_dim, tuple(a.critic_hidden_sizes), a.nr_critics,
                             a.activation, a.layer_norm, dropout_rate=a.get("dropout_rate", 0.0))

    def setup_states(self):
        a = self.config.algorithm
        self.anneal_learning_rate = a.anneal_learning_rate
        self.target_entropy = (-float(self.action_dim) if a.target_entropy == "auto"
                               else float(a.target_entropy))
        # parameters are initialized on the CPU from the seed, then moved
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            policy = select_observations(self._build_policy(a), self.policy_observation_indices)
            critic = select_observations(self._build_critic(a), self.critic_observation_indices)
        alpha = EntropyCoefficient(1.0)
        for module in (policy, critic, alpha):
            module.to(self.device)
        self.policy = TrainState(policy, self._adam(policy), target=False)
        self.critic = TrainState(critic, self._adam(critic))
        self.alpha = TrainState(alpha, self._adam(alpha), target=False)

    def _adam(self, module, beta1=0.9):
        return torch.optim.Adam(module.parameters(), lr=self.learning_rate, betas=(beta1, 0.999), eps=1e-8)

    def learning_rate_at(self, count):
        """The rate of the optimizer step that follows ``count`` steps: with
        ``anneal_learning_rate``, ``lr * (1 - (count * nr_envs -
        learning_starts) / total_training_timesteps)``, as the JAX package's
        schedule."""
        if not self.anneal_learning_rate:
            return self.learning_rate
        step = count * self.nr_envs - self.learning_starts
        return self.learning_rate * (1.0 - step / max(self.total_training_timesteps, 1))

    def learning_rate_tensor(self):
        """``learning_rate_at`` of the policy's Adam count (the three
        optimizers step together) as a float64 0-dim tensor on the device,
        with the host's float64 arithmetic; nothing is read back."""
        count = self.policy.step_tensor()
        if not self.anneal_learning_rate:
            return torch.full((), self.learning_rate, dtype=torch.float64, device=count.device)
        step = count.double() * self.nr_envs - self.learning_starts
        return self.learning_rate * (1.0 - step / max(self.total_training_timesteps, 1))

    @torch.no_grad()
    def act(self, observation, step=0, noise=None):
        """``tanh(mean + std * noise)``; ``noise`` (standard normal,
        ``[nr_envs, action_dim]``) is drawn from the generator unless given."""
        mean, log_std = self.policy.module(observation)
        if noise is None:
            noise = torch.randn(mean.shape, generator=self.generator, device=self.device)
        return torch.tanh(mean + torch.exp(log_std) * noise)

    @torch.no_grad()
    def eval_act(self, observation):
        return D.tanh_gaussian_mode(self.policy.module(observation)[0])

    def act_draws(self, generator):
        return {"noise": torch.randn((self.nr_envs, self.action_dim), generator=generator, device=self.device)}

    def update(self, batch, step, target_noise=None, current_noise=None):
        """One step of the policy, the critic and ``log_alpha``, then the
        critic's Polyak update.  ``target_noise`` / ``current_noise``
        (standard normal, ``[batch, action_dim]``) sample the next and the
        current action; each is drawn from the generator unless given.
        Returns the metrics as device scalars."""
        return self._step(self._losses(batch, target_noise, current_noise), global_norm)

    def update_seeds(self, batch, step, target_noise=None, current_noise=None):
        """``update`` for every seed; the noises (``[S, batch, action_dim]``)
        are each seed's from its generator unless given."""
        draws = self.seed_noises(target_noise, current_noise)
        losses = self.seed_map(lambda b, d: self._losses(b, **d), batch, draws)
        return self._step(losses, per_seed_global_norm)

    def seed_noises(self, target_noise=None, current_noise=None):
        """``{"target_noise", "current_noise"}``, ``[S, batch, action_dim]``
        each: the given ones, else each seed's from its generator in its
        one-seed update's order (the next action's, then the current's)."""
        if target_noise is not None:
            return {"target_noise": target_noise, "current_noise": current_noise}
        return self.parallel.draw(self.update_draws)

    batch_draw_dims = {"target_noise": 0, "current_noise": 0}

    def update_draws(self, generator):
        """An update's draws in its order: the next action's noise, then the
        current action's (``[batch, action_dim]`` each)."""
        shape = (self.batch_size, self.action_dim)
        return {"target_noise": torch.randn(shape, generator=generator, device=self.device),
                "current_noise": torch.randn(shape, generator=generator, device=self.device)}

    def _losses(self, batch, target_noise=None, current_noise=None):
        """(q loss, policy loss, alpha loss, metrics) of one seed's batch."""
        obs, next_obs = batch["observation"], batch["next_observation"]
        alpha_with_grad = self.alpha.module()
        alpha = alpha_with_grad.detach()

        with torch.no_grad():
            next_action, next_log_prob = D.tanh_gaussian_sample_and_log_prob(
                *self.policy.module(next_obs), generator=self.generator, noise=target_noise)
            min_next_q_target = self.critic.target(next_obs, next_action).squeeze(-1).min(dim=0).values
            y = batch["reward"] + self.gamma * (1.0 - batch["terminated"]) * (
                min_next_q_target - alpha * next_log_prob)

        q = self.critic.module(obs, batch["action"]).squeeze(-1)
        q_loss = ((q - y[None, :]) ** 2).mean()

        current_action, current_log_prob = D.tanh_gaussian_sample_and_log_prob(
            *self.policy.module(obs), generator=self.generator, noise=current_noise)
        entropy = -current_log_prob.detach()
        # gradients of the policy loss go to the policy only (below), through
        # the critic's output but not into its parameters
        min_q_pi = self.critic.module(obs, current_action).squeeze(-1).min(dim=0).values
        policy_loss = (alpha * current_log_prob - min_q_pi).mean()
        alpha_loss = (alpha_with_grad * (entropy - self.target_entropy)).mean()
        return q_loss, policy_loss, alpha_loss, {
            "entropy/entropy": entropy.mean(), "entropy/alpha": alpha, "q_value/q_value": min_q_pi.detach().mean()}

    def _step(self, losses, norm):
        """The three optimizer steps and the Polyak update from ``_losses``'
        output (per-seed ``[S]`` losses are summed: each seed's parameters
        get its own gradient); ``norm`` gives the grad-norm metrics."""
        q_loss, policy_loss, alpha_loss, metrics = losses
        critic_grads = torch.autograd.grad(q_loss.sum(), list(self.critic.module.parameters()))
        policy_grads = torch.autograd.grad(policy_loss.sum(), list(self.policy.module.parameters()))
        alpha_grads = torch.autograd.grad(alpha_loss.sum(), list(self.alpha.module.parameters()))

        # the three optimizers step together, so their counts are equal
        learning_rate = self.learning_rate_tensor()
        for state, grads in ((self.policy, policy_grads), (self.critic, critic_grads),
                             (self.alpha, alpha_grads)):
            state.apply_gradients(grads, learning_rate)
        self.critic.polyak_update(self.tau)

        with torch.no_grad():
            return {
                "loss/q_loss": q_loss.detach(),
                "loss/policy_loss": policy_loss.detach(),
                "loss/entropy_loss": alpha_loss.detach(),
                **metrics,
                "lr/learning_rate": learning_rate.float(),
                "gradients/policy_grad_norm": norm(policy_grads),
                "gradients/critic_grad_norm": norm(critic_grads),
                "gradients/entropy_grad_norm": norm(alpha_grads),
            }

    def general_properties():
        return GeneralProperties
