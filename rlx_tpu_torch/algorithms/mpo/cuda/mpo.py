"""MPO: maximum a-posteriori policy optimization (the JAX package's
``mpo.tpu``).

- A categorical critic (``nr_atoms`` over [v_min, v_max]; two with
  ``dual_critic``) trained by cross-entropy against the soft projection of
  its n-step target.  The target pmf is the softmax of the target critic,
  averaged over ``action_sampling_number`` actions of the target policy;
  its atoms are shifted by the reward and discount, clipped to the support
  and spread onto their two neighbours by the weights ``clip(1 - |z_src -
  z_tgt| / delta_z, 0, 1)`` ``[B, atoms_tgt, atoms_src]``, contracted by an
  einsum.  With ``clipped_double_q_learning`` both critics take the pmf of
  the one with the lower expectation.  The projection is plain torch, as
  the JAX package computes it outside any Pallas kernel.
- The E-step: the improvement distribution ``softmax(Q / eta)`` over the
  sampled actions of the stacked (s, s') states, the temperature ``eta``
  learned through its dual loss (logsumexp form), and with
  ``action_penalization`` a second dual for the actions outside [-1, 1].
- The decoupled M-step: a mean term (std frozen at the target policy's)
  and a std term (mean frozen), each with per-dimension KL constraints and
  their learned ``alpha`` duals; the duals' logs are floored
  (``min_log_temperature``, ``min_log_alpha``) after every step.
- Global-norm clipping then Adam, or AdamW with a weight decay (torch's
  ``AdamW`` decouples the decay as ``optax.adamw`` does).
- Hard target refreshes: the critic's every
  ``target_network_update_period`` updates, the policy's every
  ``actor_update_period``.

Every draw is an argument that defaults to the generator: the acting
noise, the critic's target samples ``[S, B, A]`` and the E-step's samples
``[S, 2B, A]``.  With parallel seeds the losses are mapped over the seeds,
each with its own samples and duals, and each seed's gradients are clipped
by its own norm; the soft projection stays plain torch inside the map.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from rlx_tpu_torch.algorithms.mpo.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.offpolicy import OffPolicyAlgorithm
from rlx_tpu_torch.algorithms.train_state import TrainState, clip_by_global_norm_
from rlx_tpu_torch.models.mlp import MLP, VectorQCritic, _lecun_linear, select_observations
from rlx_tpu_torch.ops import normalizers

LOG_2PI = math.log(2.0 * math.pi)


class MPOGaussianPolicy(nn.Module):
    """obs -> (mean, std).  The std head is ``softplus(raw + shift) +
    min_scale`` with ``std == init_scale`` at ``raw == 0``, or with
    ``scaled_std_head`` (FastSAC's) ``min_scale + softplus(raw) *
    init_scale / log 2``; ``zero_init_heads`` starts both heads at zero."""

    def __init__(self, obs_dim, action_dim, hidden_sizes, activation="elu", layer_norm=True, init_scale=0.5,
                 min_scale=1e-6, layer_norm_all=False, zero_init_heads=False, scaled_std_head=False,
                 orthogonal_init=True):
        super().__init__()
        self.trunk = MLP(obs_dim, hidden_sizes, activation, layer_norm, orthogonal_init=orthogonal_init,
                         layer_norm_all=layer_norm_all)
        self.mean = _lecun_linear(hidden_sizes[-1], action_dim)
        self.std = _lecun_linear(hidden_sizes[-1], action_dim)
        if zero_init_heads:
            for head in (self.mean, self.std):
                nn.init.zeros_(head.weight)
        self.init_scale, self.min_scale, self.scaled_std_head = init_scale, min_scale, scaled_std_head
        self.shift = math.log(math.expm1(init_scale))

    def forward(self, x):
        x = self.trunk(x)
        raw_std = self.std(x)
        if self.scaled_std_head:
            std = self.min_scale + F.softplus(raw_std) * (self.init_scale / math.log(2.0))
        else:
            std = F.softplus(raw_std + self.shift) + self.min_scale
        return self.mean(x), std


class DualVariables(nn.Module):
    """The E- and M-step duals: ``log_eta`` (), ``log_alpha_mean`` and
    ``log_alpha_stddev`` (per action dim) and ``log_penalty_temperature``."""

    def __init__(self, action_dim, init_log_eta=10.0, init_log_alpha_mean=10.0, init_log_alpha_stddev=1000.0,
                 init_log_penalty_temperature=10.0):
        super().__init__()
        self.log_eta = nn.Parameter(torch.full((), float(init_log_eta)))
        self.log_alpha_mean = nn.Parameter(torch.full((action_dim,), float(init_log_alpha_mean)))
        self.log_alpha_stddev = nn.Parameter(torch.full((action_dim,), float(init_log_alpha_stddev)))
        self.log_penalty_temperature = nn.Parameter(torch.full((), float(init_log_penalty_temperature)))

    def forward(self):
        return self.log_eta, self.log_alpha_mean, self.log_alpha_stddev, self.log_penalty_temperature


class MPO(OffPolicyAlgorithm):
    EPS = 1e-8
    parallel_seeds = True

    def _build_policy(self, a):
        return MPOGaussianPolicy(self.policy_obs_dim, self.action_dim, tuple(a.policy_hidden_sizes), a.activation,
                                 a.layer_norm, a.policy_init_scale, a.policy_min_scale)

    def _build_critic(self, a):
        return VectorQCritic(self.critic_obs_dim, self.action_dim, tuple(a.critic_hidden_sizes), self.nr_critics,
                             a.activation, a.layer_norm, output_dim=self.nr_atoms)

    def _optimizer(self, module, learning_rate, weight_decay, betas):
        if weight_decay > 0.0:
            return torch.optim.AdamW(module.parameters(), lr=learning_rate, betas=betas, eps=1e-8,
                                     weight_decay=weight_decay)
        return torch.optim.Adam(module.parameters(), lr=learning_rate, betas=betas, eps=1e-8)

    def setup_states(self):
        a = self.config.algorithm
        self.v_min, self.v_max, self.nr_atoms = a.v_min, a.v_max, a.nr_atoms
        self.atoms = torch.linspace(self.v_min, self.v_max, self.nr_atoms, device=self.device)
        self.action_samples = a.action_sampling_number
        self.eps_nonparametric = a.epsilon_non_parametric
        self.eps_mu = a.epsilon_parametric_mu
        self.eps_sigma = a.epsilon_parametric_sigma
        self.eps_penalty = a.epsilon_penalty
        self.action_penalty = a.action_penalization
        self.max_grad_norm = a.max_grad_norm
        self.actor_update_period = a.get("actor_update_period", 1)
        self.target_update_period = a.get("target_network_update_period", 1)
        self.normalize_obs = a.enable_observation_normalization
        self.nr_critics = 2 if a.get("dual_critic", False) else 1
        self.clipped_double_q = a.get("clipped_double_q_learning", False)
        self.min_log_temperature = a.get("min_log_temperature", -18.0)
        self.min_log_alpha = a.get("min_log_alpha", -18.0)

        # parameters are initialized on the CPU from the seed, then moved
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            policy = select_observations(self._build_policy(a), self.policy_observation_indices)
            critic = select_observations(self._build_critic(a), self.critic_observation_indices)
        duals = DualVariables(self.action_dim, a.init_log_eta, a.init_log_alpha_mean, a.init_log_alpha_stddev,
                              a.init_log_penalty_temperature)
        betas = (a.get("adam_beta1", 0.9), a.get("adam_beta2", 0.999))
        for module in (policy, critic, duals):
            module.to(self.device)
        self.policy = TrainState(policy, self._optimizer(
            policy, a.get("policy_learning_rate") or a.learning_rate, a.get("policy_weight_decay", 0.0), betas))
        self.critic = TrainState(critic, self._optimizer(
            critic, a.get("critic_learning_rate") or a.learning_rate, a.get("critic_weight_decay", 0.0), betas))
        self.duals = TrainState(duals, self._optimizer(duals, a.dual_learning_rate, a.get("dual_weight_decay", 0.0),
                                                       betas), target=False)
        # the JAX package's state names: the checkpoint tree holds policy,
        # policy_target, critic, critic_target, duals and, with observation
        # normalization, obs_normalizer
        self.state_names = ("policy", "critic", "duals") + (("obs_normalizer",) if self.normalize_obs else ())
        if self.normalize_obs:
            self.obs_normalizer = normalizers.obs_normalizer_init(self.os_shape, self.device)

    def _norm(self, observation):
        if self.normalize_obs:
            return normalizers.obs_normalize(self.obs_normalizer, observation)
        return observation

    def observe_transition(self, observation, env_state):
        if self.normalize_obs:
            self.obs_normalizer = self.updated_obs_normalizer(observation)

    def _noise(self, shape, generator=None):
        return torch.randn(shape, generator=self.generator if generator is None else generator, device=self.device)

    @torch.no_grad()
    def act(self, observation, step=0, noise=None):
        """``clip(mean + std * noise, -1, 1)``; ``noise`` is drawn from the
        generator unless given."""
        mean, std = self.policy.module(self._norm(observation))
        if noise is None:
            noise = self._noise(mean.shape)
        return torch.clamp(mean + std * noise, -1.0, 1.0)

    def act_draws(self, generator):
        return {"noise": self._noise((self.nr_envs, self.action_dim), generator)}

    @torch.no_grad()
    def eval_act(self, observation):
        return torch.clamp(self.policy.module(self._norm(observation))[0], -1.0, 1.0)

    def _step(self, state, grads):
        """Global-norm clip (each seed's by its own norm with parallel
        seeds), then the optimizer's step; returns the norm before the clip."""
        self.mesh.all_reduce_mean_(list(grads))   # averaged over dp before the clip
        norm = clip_by_global_norm_(list(grads), self.max_grad_norm, per_seed=self.parallel is not None)
        state.apply_gradients(grads, reduced=True)
        return norm

    def _call(self):
        """``plain_call``, or ``seed_map`` with parallel seeds: the losses of
        ``_critic_step`` and ``_policy_dual_step`` are mapped over the seeds
        (their inputs ``[S, ...]``, every draw given) and summed."""
        return self.plain_call if self.parallel is None else self.seed_map

    def soft_projection(self, next_pmf, reward, terminated, discount):
        """The target pmf ``[N, B, atoms]`` of the shifted atoms
        ``clip(reward + discount (1 - terminated) atoms, v_min, v_max)``,
        spread onto the atoms by the hat weights ``[B, atoms_tgt, atoms_src]``."""
        target_z = torch.clamp(reward[:, None] + discount[:, None] * (1.0 - terminated)[:, None] * self.atoms[None],
                               self.v_min, self.v_max)
        delta_z = float((self.v_max - self.v_min) / (self.nr_atoms - 1))
        weights = torch.clamp(1.0 - torch.abs(target_z[:, None, :] - self.atoms[None, :, None]) / delta_z, 0.0, 1.0)
        return torch.einsum("bts,nbs->nbt", weights, next_pmf)

    def _critic_step(self, obs, next_obs, action, reward, terminated, discount, noise=None):
        """One categorical critic step (its target is not refreshed here);
        ``noise`` ``[S, B, A]`` samples the target policy's actions."""
        q_loss, q_mean = self._call()(self._critic_loss, obs, next_obs, action, reward, terminated, discount, noise)
        grads = torch.autograd.grad(q_loss.sum(), list(self.critic.module.parameters()))
        norm = self._step(self.critic, grads)
        return {"loss/critic_loss": q_loss.detach(), "q_value/q_value": q_mean, "gradients/critic_grad_norm": norm}

    def _critic_loss(self, obs, next_obs, action, reward, terminated, discount, noise=None):
        """(cross-entropy loss, expected Q) of one seed's batch."""
        B, S, N = obs.shape[0], self.action_samples, self.nr_critics
        with torch.no_grad():
            t_mean, t_std = self.policy.target(next_obs)
            if noise is None:
                noise = self._noise((S, B, self.action_dim))
            next_actions = t_mean[None] + t_std[None] * noise
            flat_next_obs = next_obs[None].expand(S, *next_obs.shape).reshape(S * B, -1)
            next_logits = self.critic.target(flat_next_obs, next_actions.reshape(S * B, -1))
            next_pmf = torch.softmax(next_logits.reshape(N, S, B, self.nr_atoms), dim=-1).mean(dim=1)
            target_pmf = self.soft_projection(next_pmf, reward, terminated, discount)
            if self.clipped_double_q and N == 2:
                target_q = (target_pmf * self.atoms).sum(-1)                   # [N, B]
                use_first = (target_q[0] <= target_q[1])[None, :, None]
                target_pmf = torch.where(use_first, target_pmf[0][None], target_pmf[1][None]).expand_as(target_pmf)
        logits = self.critic.module(obs, action)                                  # [N, B, atoms]
        q_loss = -(target_pmf * F.log_softmax(logits, dim=-1)).sum(-1).sum(0).mean()
        with torch.no_grad():
            q_mean = (torch.softmax(logits, dim=-1) * self.atoms).sum(-1).mean()
        return q_loss, q_mean

    def _policy_dual_step(self, obs, next_obs, noise=None):
        """One decoupled E/M step of the policy and the duals against the
        critic's target; ``noise`` ``[S, 2B, A]`` samples the target
        policy's actions on the stacked (s, s') states."""
        actor_loss, dual_loss, metrics = self._call()(self._policy_dual_losses, obs, next_obs, noise)
        policy_params, dual_params = list(self.policy.module.parameters()), list(self.duals.module.parameters())
        # without action_penalization log_penalty_temperature takes no part:
        # its gradient is zero, as jax.grad gives it
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            policy_params + dual_params,
            torch.autograd.grad((actor_loss + dual_loss).sum(), policy_params + dual_params, allow_unused=True))]
        policy_norm = self._step(self.policy, grads[:len(policy_params)])
        dual_norm = self._step(self.duals, grads[len(policy_params):])
        self._clamp_duals()
        return {"loss/actor_loss": actor_loss.detach(), "loss/dual_loss": dual_loss.detach(), **metrics,
                "gradients/policy_grad_norm": policy_norm, "gradients/dual_grad_norm": dual_norm}

    def _policy_dual_losses(self, obs, next_obs, noise=None):
        """(actor loss, dual loss, metrics) of one seed's E-step over its
        sampled actions and M-step against its target policy."""
        stacked = torch.cat([obs, next_obs], dim=0)                              # [2B, obs]
        S = self.action_samples
        with torch.no_grad():
            t_mean2, t_std2 = self.policy.target(stacked)
            if noise is None:
                noise = self._noise((S,) + t_mean2.shape)
            sampled = t_mean2[None] + t_std2[None] * noise                         # [S, 2B, A]
            flat_stacked = stacked[None].expand(S, *stacked.shape).reshape(S * stacked.shape[0], -1)
            q_logits = self.critic.target(flat_stacked, sampled.reshape(flat_stacked.shape[0], -1))
            q_logits = q_logits.reshape(self.nr_critics, S, stacked.shape[0], self.nr_atoms)
            per_critic_q = (torch.softmax(q_logits, dim=-1) * self.atoms).sum(-1)  # [N, S, 2B]
            if self.clipped_double_q and self.nr_critics > 1:
                sampled_q = per_critic_q.min(dim=0).values
            else:
                sampled_q = per_critic_q.mean(dim=0)                               # [S, 2B]

        log_eta, log_alpha_mean, log_alpha_stddev, log_penalty_temperature = self.duals.module()
        eta = F.softplus(log_eta) + self.EPS
        improvement = torch.softmax(sampled_q / eta.detach(), dim=0)
        q_logsumexp = torch.logsumexp(sampled_q / eta, dim=0)
        loss_eta = eta * (self.eps_nonparametric + q_logsumexp.mean() - math.log(S))
        penalty_temperature = F.softplus(log_penalty_temperature) + self.EPS
        if self.action_penalty:
            cost_oob = -torch.linalg.vector_norm(sampled - torch.clamp(sampled, -1.0, 1.0), dim=-1)
            penalty_improvement = torch.softmax(cost_oob / penalty_temperature.detach(), dim=0)
            penalty_logsumexp = torch.logsumexp(cost_oob / penalty_temperature, dim=0)
            loss_eta = loss_eta + penalty_temperature * (self.eps_penalty + penalty_logsumexp.mean() - math.log(S))
            improvement = improvement + penalty_improvement

        online_mean, online_std = self.policy.module(stacked)
        alpha_mean = F.softplus(log_alpha_mean) + self.EPS
        alpha_std = F.softplus(log_alpha_stddev) + self.EPS
        # decoupled mean term (std frozen at the target's)
        logprob_mean = (-0.5 * (((sampled - online_mean[None]) / t_std2[None]) ** 2 + LOG_2PI)
                        - torch.log(t_std2[None])).sum(-1)
        loss_pg_mean = -(logprob_mean * improvement).sum(0).mean()
        mean_kl_mean = (((t_mean2 - online_mean) ** 2) / (2.0 * t_std2 ** 2)).mean(dim=0)     # [A]
        loss_kl_mean = (alpha_mean.detach() * mean_kl_mean).sum()
        loss_alpha_mean = (alpha_mean * (self.eps_mu - mean_kl_mean.detach())).sum()
        # decoupled std term (mean frozen at the target's)
        logprob_std = (-0.5 * (((sampled - t_mean2[None]) / online_std[None]) ** 2 + LOG_2PI)
                       - torch.log(online_std[None])).sum(-1)
        loss_pg_std = -(logprob_std * improvement).sum(0).mean()
        mean_kl_std = (torch.log(online_std / t_std2) + t_std2 ** 2 / (2.0 * online_std ** 2) - 0.5).mean(dim=0)
        loss_kl_std = (alpha_std.detach() * mean_kl_std).sum()
        loss_alpha_std = (alpha_std * (self.eps_sigma - mean_kl_std.detach())).sum()

        actor_loss = loss_pg_mean + loss_pg_std + loss_kl_mean + loss_kl_std
        dual_loss = loss_alpha_mean + loss_alpha_std + loss_eta
        return actor_loss, dual_loss, {
            "dual/eta": eta.detach(),
            "dual/alpha_mean": alpha_mean.detach().mean(),
            "dual/alpha_std": alpha_std.detach().mean(),
            "kl/mean_kl_mean": mean_kl_mean.detach().mean(),
            "kl/mean_kl_std": mean_kl_std.detach().mean(),
            "policy/std_mean": online_std.detach().mean(),
        }

    @torch.no_grad()
    def _clamp_duals(self):
        """Floor the log duals so the softplus temperatures cannot collapse."""
        duals = self.duals.module
        duals.log_eta.clamp_(min=self.min_log_temperature)
        duals.log_alpha_mean.clamp_(min=self.min_log_alpha)
        duals.log_alpha_stddev.clamp_(min=self.min_log_alpha)

    def _targets(self, batch):
        """(next observation, reward, terminated, discount) of a 1-step or
        n-step batch."""
        if self.n_step > 1:
            return (batch["n_step_next_observation"], batch["n_step_reward"], batch["n_step_terminated"],
                    batch["n_step_gamma"])
        return (batch["next_observation"], batch["reward"], batch["terminated"],
                torch.full_like(batch["reward"], self.gamma))

    def update(self, batch, step, critic_noise=None, estep_noise=None):
        """One critic step, one policy and dual step, then the periodic hard
        target refreshes.  Returns the metrics as device scalars."""
        next_obs, reward, terminated, discount = self._targets(batch)
        obs, next_obs = self._call()(lambda o, n: (self._norm(o), self._norm(n)), batch["observation"], next_obs)
        critic_metrics = self._critic_step(obs, next_obs, batch["action"], reward, terminated, discount, critic_noise)
        metrics = self._policy_dual_step(obs, next_obs, estep_noise)
        if step % self.target_update_period == 0:
            self.critic.hard_update()
        if step % self.actor_update_period == 0:
            self.policy.hard_update()
        metrics.update(critic_metrics)
        return metrics

    def update_seeds(self, batch, step, critic_noise=None, estep_noise=None):
        """``update`` for every seed (``[S, batch, ...]``); the critic's and
        the E-step's samples are each seed's from its generator, in that
        order, unless given."""
        if critic_noise is None:
            draws = self.parallel.draw(self.update_draws)
            critic_noise, estep_noise = draws["critic_noise"], draws["estep_noise"]
        return self.update(batch, step, critic_noise, estep_noise)

    def update_draws(self, generator):
        """The critic's samples ``[S, B, A]``, then the E-step's ``[S, 2B,
        A]`` (the batch's states, then its next states)."""
        return {"critic_noise": self._noise((self.action_samples, self.batch_size, self.action_dim), generator),
                "estep_noise": self._noise((self.action_samples, 2 * self.batch_size, self.action_dim), generator)}

    def local_update_draws(self, draws):
        """This rank's batch rows: of the critic's samples, and of each half
        of the E-step's."""
        estep = draws["estep_noise"]
        halves = (estep[:, :self.batch_size], estep[:, self.batch_size:])
        return {"critic_noise": self.batch_rows(draws["critic_noise"], 1),
                "estep_noise": torch.cat([self.batch_rows(h, 1) for h in halves], dim=1)}

    def general_properties():
        return GeneralProperties
