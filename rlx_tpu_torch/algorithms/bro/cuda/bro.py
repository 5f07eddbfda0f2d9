"""BRO: bigger, regularized, optimistic (the JAX package's ``bro.tpu``).

SAC with an ensemble of critics over BroNet residual trunks:

- ``nr_critics`` quantile critics of ``nr_quantiles`` atoms each, trained
  on the quantile Huber loss (TQC's ``quantile_huber_loss``) against a
  target that aggregates the target critics as ``mean - pessimism *
  |z_0 - z_1| / 2``; ``updates_per_step`` critic updates per env step,
  each on a fresh batch (``EnsembleSAC.update_with_buffer``);
- the policy and ``log_alpha`` step on the same aggregate of the updated
  critic, on one more batch;
- with ``use_optimistic_exploration``, an optimistic actor shifts the
  policy's mean (its input is the observation and that mean) and scales
  its std by ``std_multiplier``; it acts during training and steps on the
  upper bound ``mean + optimism * |z_0 - z_1| / 2`` less ``regularizer``
  times its KL to the policy.  ``optimism`` and ``regularizer`` are learned
  scalars (``Adjustment``, Adam with b1 0.5) driven by the KL per action
  dimension against ``kl_target``;
- periodic resets: on learning step ``first_reset_step // nr_envs`` and
  every ``reset_interval // nr_envs`` after it, the parameters of the
  policy, the critic and the optimistic actor return to ``init_copy``,
  the copy taken when the model was made.  Adam's state and the critic's
  target stay as they were.  ``init_copy`` is a state of the checkpoint.

Evaluation acts with the policy's tanh mean.  Every draw is an argument
that defaults to the generator: the target, current and optimistic
normals and the acting noise.
"""

import math

import torch
from torch import nn

from rlx_tpu_torch.algorithms.bro.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.sac_ensembles import EnsembleSAC
from rlx_tpu_torch.algorithms.simba.cuda.simba import bounded_log_std
from rlx_tpu_torch.algorithms.tqc.cuda.tqc import quantile_huber_loss
from rlx_tpu_torch.algorithms.train_state import TrainState
from rlx_tpu_torch.models import distributions as D
from rlx_tpu_torch.models.layers import BroNetEncoder, Linear, orthogonal_
from rlx_tpu_torch.models.mlp import select_observations


class BroPolicy(nn.Module):
    """obs -> (mean, log_std): a BroNet encoder and two Dense heads, the
    log-std bounded to [-10, 2] through a tanh."""

    def __init__(self, obs_dim, action_dim, hidden_dim, nr_blocks, log_std_min=-10.0, log_std_max=2.0):
        super().__init__()
        self.encoder = BroNetEncoder(obs_dim, hidden_dim, nr_blocks)
        self.mean = Linear(hidden_dim, action_dim)
        self.log_std = Linear(hidden_dim, action_dim)
        self.log_std_min, self.log_std_max = log_std_min, log_std_max

    def forward(self, x):
        x = self.encoder(x)
        return self.mean(x), bounded_log_std(self.log_std(x), self.log_std_min, self.log_std_max)


class BroDualPolicy(nn.Module):
    """The optimistic actor: (obs, base mean, base std) -> (base mean + a
    learned shift, base std * std_multiplier); the shift is a bias-free
    Dense with orthogonal(``scale_means``) init on a BroNet encoder of
    [obs, base mean]."""

    def __init__(self, obs_dim, action_dim, hidden_dim, nr_blocks, scale_means=0.01):
        super().__init__()
        self.encoder = BroNetEncoder(obs_dim + action_dim, hidden_dim, nr_blocks)
        self.shift = Linear(hidden_dim, action_dim, bias=False)
        with torch.no_grad():
            orthogonal_(self.shift.weight, scale_means)

    def forward(self, obs, base_mean, base_std, std_multiplier):
        shift = self.shift(self.encoder(torch.cat([obs, base_mean], dim=-1)))
        return base_mean + shift, base_std * std_multiplier


class Adjustment(nn.Module):
    """A positive learned scalar ``exp(log_val_min + (log_val_max -
    log_val_min) (1 + tanh(raw)) / 2)``, starting at ``init_value``."""

    def __init__(self, init_value=1.0, log_val_min=-10.0, log_val_max=7.5):
        super().__init__()
        self.log_val_min, self.log_val_max = log_val_min, log_val_max
        ratio = (math.log(init_value) - log_val_min) / ((log_val_max - log_val_min) * 0.5) - 1.0
        self.raw = nn.Parameter(torch.full((), math.atanh(ratio)))

    def forward(self):
        return torch.exp(self.log_val_min + (self.log_val_max - self.log_val_min) * 0.5 * (1.0 + torch.tanh(self.raw)))


class BroVectorCritic(nn.Module):
    """(obs, action) -> ``[nr_critics, B, nr_quantiles]``: per critic a
    BroNet encoder and a Dense head, stacked on a leading axis."""

    def __init__(self, obs_dim, action_dim, hidden_dim, nr_blocks, nr_quantiles, nr_critics=2):
        super().__init__()
        self.encoder = BroNetEncoder(obs_dim + action_dim, hidden_dim, nr_blocks, nr_critics)
        self.head = Linear(hidden_dim, nr_quantiles, nr_critics)

    def forward(self, obs, action):
        return self.head(self.encoder(torch.cat([obs, action], dim=-1)))


RESET_NETS = ("policy", "critic", "optimistic_policy")


class BRO(EnsembleSAC):
    # the JAX package's state names: the checkpoint tree holds these, the
    # critic's target and ``init_copy`` (the three nets' initial parameters,
    # flat as ``<net>.<parameter>``)
    state_names = ("policy", "critic", "alpha", "optimistic_policy", "optimism", "regularizer", "init_copy")
    q_update_steps_key = "updates_per_step"
    parallel_seeds = True

    def _build_policy(self, a):
        return BroPolicy(self.policy_obs_dim, self.action_dim, a.policy_hidden_dim, a.policy_nr_blocks)

    def _build_critic(self, a):
        return BroVectorCritic(self.critic_obs_dim, self.action_dim, a.critic_hidden_dim, a.critic_nr_blocks,
                               a.nr_quantiles, a.nr_critics)

    def setup_states(self):
        a = self.config.algorithm
        self.std_multiplier = a.std_multiplier
        self.use_optimism = a.use_optimistic_exploration
        self.pessimism = a.pessimism
        self.kl_target = a.kl_target
        self.first_reset_step = max(int(a.first_reset_step) // self.nr_envs, 1)
        self.reset_interval = max(int(a.reset_interval) // self.nr_envs, 1)
        self.taus = (torch.arange(a.nr_quantiles, device=self.device) + 0.5) / a.nr_quantiles
        super().setup_states()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed + 1)
            optimistic_policy = select_observations(
                BroDualPolicy(self.policy_obs_dim, self.action_dim, a.policy_hidden_dim, a.policy_nr_blocks),
                self.policy_observation_indices,
            )
        optimism, regularizer = Adjustment(a.init_optimism), Adjustment(a.init_regularizer)
        for module in (optimistic_policy, optimism, regularizer):
            module.to(self.device)
        adjustment_adam = lambda module: torch.optim.Adam(module.parameters(), lr=a.adjustment_learning_rate,
                                                          betas=(0.5, 0.999), eps=1e-8)
        self.optimistic_policy = TrainState(optimistic_policy, self._adam(optimistic_policy), target=False)
        self.optimism = TrainState(optimism, adjustment_adam(optimism), target=False)
        self.regularizer = TrainState(regularizer, adjustment_adam(regularizer), target=False)
        self.init_copy = {f"{name}.{k}": v.detach().clone()
                          for name in RESET_NETS for k, v in getattr(self, name).module.state_dict().items()}

    @torch.no_grad()
    def act(self, observation, step=0, noise=None):
        """``tanh(mean + std * noise)`` of the optimistic actor (of the
        policy without optimism); ``noise`` is drawn from the generator
        unless given."""
        mean, log_std = self.policy.module(observation)
        std = torch.exp(log_std)
        if self.use_optimism:
            mean, std = self.optimistic_policy.module(observation, mean, std, self.std_multiplier)
        if noise is None:
            noise = torch.randn(mean.shape, generator=self.generator, device=self.device)
        return torch.tanh(mean + std * noise)

    def _aggregate(self, z, spread_coeff):
        """Twin quantile stacks ``[2, B, q]`` -> ``[B, q]``: their mean plus
        ``spread_coeff`` times half their absolute difference."""
        return z.mean(dim=0) + spread_coeff * torch.abs(z[0] - z[1]) / 2.0

    def _q(self, module, obs, action, masks=None):
        return module(obs, action)

    def policy_q_aggregate(self, z):
        """The pessimistic aggregate's mean over the quantiles, ``[B]``."""
        return self._aggregate(z, -self.pessimism).mean(dim=-1)

    def policy_draws(self, generator):
        """The current action's normal, then the optimistic actor's."""
        draws = {"current_noise": self._normal(generator)}
        if self.use_optimism:
            draws["optimistic_noise"] = self._normal(generator)
        return draws

    def _critic_loss(self, batch, target_noise=None):
        """(quantile Huber loss, mean quantile) of one seed's batch."""
        with torch.no_grad():
            next_action, next_log_prob = D.tanh_gaussian_sample_and_log_prob(
                *self.policy.module(batch["next_observation"]), generator=self.generator, noise=target_noise)
            alpha = self.alpha.module()
            agg = self._aggregate(self.critic.target(batch["next_observation"], next_action), -self.pessimism)
            y = batch["reward"][:, None] + self.gamma * (1.0 - batch["terminated"][:, None]) * (
                agg - alpha * next_log_prob[:, None])
        z = self.critic.module(batch["observation"], batch["action"])
        return quantile_huber_loss(z, y, self.taus), z.detach().mean()

    def policy_alpha_update(self, batch, current_noise=None, optimistic_noise=None):
        """One step of the policy and ``log_alpha`` on ``batch``, then (with
        optimism) the optimistic actor's and the two adjustments'."""
        _, _, draws = self._seed_draws({"current_noise": current_noise, "optimistic_noise": optimistic_noise},
                                       self.policy_draws)
        optimistic_noise = draws.pop("optimistic_noise", None)
        metrics = super().policy_alpha_update(batch, **draws)
        if self.use_optimism:
            metrics.update(self.optimistic_update(batch, optimistic_noise))
        return metrics

    def optimistic_update(self, batch, noise=None):
        """The optimistic actor's step against the upper bound less the
        regularized KL to the (updated) policy, then one step of each
        adjustment towards ``kl_target``; their values before the step.
        With parallel seeds ``noise`` (``[S, batch, action_dim]``) is given."""
        call = self.plain_call if self.parallel is None else self.seed_map
        opt_loss, kl_mean = call(self._optimistic_loss, batch, noise)
        grads = torch.autograd.grad(opt_loss.sum(), list(self.optimistic_policy.module.parameters()))
        self.optimistic_policy.apply_gradients(grads)

        # the adjustments are elementwise in their (seed-stacked) scalar
        empirical_kl = kl_mean.detach() / self.action_dim
        optimism_value = self.optimism.module()
        (optimism_grad,) = torch.autograd.grad(
            ((optimism_value - self.pessimism) * (empirical_kl - self.kl_target)).sum(), [self.optimism.module.raw])
        self.optimism.apply_gradients([optimism_grad])
        regularizer_value = self.regularizer.module()
        (regularizer_grad,) = torch.autograd.grad((-regularizer_value * (empirical_kl - self.kl_target)).sum(),
                                                  [self.regularizer.module.raw])
        self.regularizer.apply_gradients([regularizer_grad])
        return {
            "loss/optimistic_policy_loss": opt_loss.detach(),
            "optimism/value": optimism_value.detach(),
            "regularizer/value": regularizer_value.detach(),
            "kl/empirical_kl": empirical_kl,
        }

    def _optimistic_loss(self, batch, noise=None):
        """(the optimistic actor's loss, its mean KL to the policy) of one
        seed's batch; ``noise`` is drawn from the generator unless given."""
        obs = batch["observation"]
        with torch.no_grad():
            pessimistic_mean, pessimistic_log_std = self.policy.module(obs)
            pessimistic_std = torch.exp(pessimistic_log_std)
            optimism = self.optimism.module()
            regularizer = self.regularizer.module()
        opt_mean, opt_std = self.optimistic_policy.module(obs, pessimistic_mean, pessimistic_std,
                                                          self.std_multiplier)
        if noise is None:
            noise = torch.randn(opt_mean.shape, generator=self.generator, device=self.device)
        action = torch.tanh(opt_mean + opt_std * noise)
        q_ub = self._aggregate(self.critic.module(obs, action), optimism).mean(dim=-1)
        effective_std = opt_std / self.std_multiplier
        kl = (torch.log(pessimistic_std / effective_std)
              + (effective_std ** 2 + (opt_mean - pessimistic_mean) ** 2) / (2.0 * pessimistic_std ** 2)
              - 0.5).sum(dim=-1)
        kl_mean = kl.mean()
        return (-q_ub).mean() + regularizer * kl_mean, kl_mean

    def update_with_buffer(self, buffer, step):
        """``EnsembleSAC``'s critic and policy updates, then the periodic
        reset of the three nets' parameters to ``init_copy`` (the same step
        for every seed; each seed resets to its own copy)."""
        metrics = super().update_with_buffer(buffer, step)
        do_reset = step >= self.first_reset_step and (step - self.first_reset_step) % self.reset_interval == 0
        if do_reset:
            with torch.no_grad():
                for name in RESET_NETS:
                    prefix = f"{name}."
                    getattr(self, name).module.load_state_dict(
                        {k[len(prefix):]: v for k, v in self.init_copy.items() if k.startswith(prefix)})
        metrics["bro/reset"] = torch.tensor(float(do_reset), device=self.device)
        return metrics

    def general_properties():
        return GeneralProperties
