"""REPPO: on-policy pathwise policy optimization with an HL-Gauss Q-critic
(the JAX package's ``reppo.tpu``).

Per learning iteration, from the policy frozen at its start:

- rollout: ``nr_steps`` env steps of tanh-Gaussian actions on normalized
  observations; the running observation normalizer learns from each step's
  observations; the next value is the critic's HL-Gauss expectation at the
  ``final_observation`` and a fresh policy action there, and the critic's
  features there are the auxiliary head's target;
- TD(lambda) targets from a reverse loop over the rollout (plain torch, as
  the JAX package's ``lax.scan``; not GAE, so not kernel B1);
- ``nr_epochs`` epochs of ``nr_minibatches`` minibatches, each a critic
  step (cross-entropy to the HL-Gauss targets of the clipped TD targets,
  plus the next-feature regression; both masked at truncations, the
  auxiliary term at terminations too), then a policy step on the UPDATED
  critic: maximize Q(s, a_reparam) with a learned entropy coefficient
  while a KL to the frozen policy, estimated from ``nr_kl_samples`` of its
  actions, stays under ``kl_bound``; past the bound the loss is the KL
  alone, and a learned KL coefficient weighs it.  Global-norm clipping and
  Adam on both nets.

Evaluation, test mode and the checkpoint (``policy``, ``critic``,
``obs_normalizer``; ``latest.model`` only) follow the JAX package's.  The
env gets the tanh action as it is (no rescaling).  Every draw can be given
to ``learning_iteration``: the rollout's normals, the epochs'
permutations, and per minibatch the reparameterized action's normals and
the KL samples' normals.  The mesh keys of the runner are ignored on one
device, as PPO ignores them.

With parallel seeds (``parallel_seeds.py``) the nets and the observation
normalizer are seed-stacked; every draw of a seed comes from its own
generator in its one-seed order, the rollout's net calls and the losses
are mapped over the seeds, and the gradients are clipped per seed.

The phases run under ``record_function`` spans ``reppo/rollout``,
``reppo/targets``, ``reppo/update`` and ``reppo/eval``.
"""

import copy
import math
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from rlx_tpu_torch.algorithms.evaluation import collect_test_returns
from rlx_tpu_torch.algorithms.parallel_seeds import (
    NoGenerator, ParallelSeeds, check_config, finish, nr_parallel_seeds, stack_modules,
)
from rlx_tpu_torch.algorithms.reppo.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.train_state import clip_by_global_norm_
from rlx_tpu_torch.algorithms.training_program import (
    eval_reset_seed, run_training_program, train_reset_seed,
)
from rlx_tpu_torch.models import distributions as D
from rlx_tpu_torch.models.mlp import MLP, _lecun_linear, observation_width, select_observations
from rlx_tpu_torch.ops import normalizers
from rlx_tpu_torch.ops.distributional import hl_gauss_expectation, hl_gauss_targets
from rlx_tpu_torch.utils import checkpoint as ckpt
from rlx_tpu_torch.utils.logging import MetricsLogger, rlx_logger


class ReppoPolicy(nn.Module):
    """obs -> (loc, log_std clipped to [-10, 2], log entropy coefficient,
    log KL coefficient): a 2-layer ELU trunk with a LayerNorm after its
    first Dense (orthogonal sqrt(2) init) and two Dense heads; the two log
    coefficients are parameters of the policy."""

    def __init__(self, obs_dim, action_dim, hidden_dim, init_entropy_coefficient=0.01, init_kl_coefficient=0.01):
        super().__init__()
        self.trunk = MLP(obs_dim, (hidden_dim, hidden_dim), "elu", layer_norm=True)
        self.loc = _lecun_linear(hidden_dim, action_dim)
        self.log_std = _lecun_linear(hidden_dim, action_dim)
        self.log_entropy_coefficient = nn.Parameter(torch.full((), math.log(init_entropy_coefficient)))
        self.log_kl_coefficient = nn.Parameter(torch.full((), math.log(init_kl_coefficient)))

    def forward(self, x):
        h = self.trunk(x)
        return (self.loc(h), torch.clamp(self.log_std(h), -10.0, 2.0), self.log_entropy_coefficient,
                self.log_kl_coefficient)


class ReppoCritic(nn.Module):
    """(obs, action) -> (features, HL-Gauss logits ``[B, nr_bins]``,
    predicted next features ``[B, hidden_dim]``)."""

    def __init__(self, obs_dim, action_dim, hidden_dim, nr_bins):
        super().__init__()
        self.trunk = MLP(obs_dim + action_dim, (hidden_dim, hidden_dim), "elu", layer_norm=True)
        self.logits = _lecun_linear(hidden_dim, nr_bins)
        self.predicted_next = _lecun_linear(hidden_dim, hidden_dim)

    def forward(self, obs, action):
        features = self.trunk(torch.cat([obs, action], dim=-1))
        return features, self.logits(features), self.predicted_next(features)


def td_lambda_targets(rewards, terminations, next_values, gamma, gae_lambda):
    """TD(lambda) targets ``[T, N]`` by a reverse loop from the last next value:
    ``target_t = r_t + gamma (1 - d_t) ((1 - lambda) v'_t + lambda target_{t+1})``."""
    targets = torch.empty_like(rewards)
    next_target = next_values[-1]
    for t in reversed(range(rewards.shape[0])):
        next_target = rewards[t] + gamma * (1.0 - terminations[t]) * (
            (1.0 - gae_lambda) * next_values[t] + gae_lambda * next_target)
        targets[t] = next_target
    return targets


def log_prob_at(loc, log_std, action):
    """The tanh-Gaussian log-probability of ``action``, taken back through
    ``arctanh(clip(action, -1 + 1e-6, 1 - 1e-6))``."""
    pre = torch.atanh(torch.clamp(action, -1.0 + 1e-6, 1.0 - 1e-6))
    std = torch.exp(log_std)
    log_prob = -0.5 * ((pre - loc) / std) ** 2 - 0.5 * D.LOG_2PI - log_std
    log_prob = log_prob - 2.0 * (D.LOG_2 - pre - F.softplus(-2.0 * pre))
    return log_prob.sum(-1)


class REPPO:
    def __init__(self, config, train_env, eval_env, run_path=None, writer=None):
        self.config = config
        self.train_env = train_env
        self.eval_env = eval_env
        self.device = train_env.device

        a = config.algorithm
        check_config(config)
        self.save_model = config.runner.save_model
        self.save_path = ckpt.save_path_for(config, run_path)
        self.seed = config.environment.seed
        nr_seeds = nr_parallel_seeds(config)
        self.parallel = ParallelSeeds(self.seed, nr_seeds, self.device) if nr_seeds > 1 else None
        self.total_timesteps = int(a.total_timesteps)
        self.nr_envs = config.environment.nr_envs
        self.nr_steps = a.nr_steps
        self.nr_epochs = a.nr_epochs
        self.nr_minibatches = a.nr_minibatches
        self.gamma = a.gamma
        self.gae_lambda = a.gae_lambda
        self.kl_bound = a.kl_bound
        self.aux_coef = a.auxiliary_loss_coefficient
        self.nr_kl_samples = a.nr_kl_samples
        self.v_min, self.v_max = a.v_min, a.v_max
        self.nr_bins = a.nr_bins
        self.max_grad_norm = a.max_grad_norm
        self.normalize_obs = a.normalize_observation
        self.logging_active = a.logging_active
        self.evaluation_active = a.evaluation_active

        self.batch_size = self.nr_envs * self.nr_steps
        self.minibatch_size = self.batch_size // self.nr_minibatches
        if self.minibatch_size * self.nr_minibatches != self.batch_size:
            raise ValueError("nr_minibatches must divide nr_envs * nr_steps")
        self.nr_updates = max(self.total_timesteps // self.batch_size, 1)
        self.eval_save_frequency = a.evaluation_and_save_frequency
        if self.eval_save_frequency == -1:
            self.eval_save_frequency = self.batch_size * self.nr_updates
        self.nr_eval_save_iterations = max(self.total_timesteps // self.eval_save_frequency, 1)
        self.nr_updates_per_eval_save_iteration = self.eval_save_frequency // self.batch_size

        self.horizon = train_env.horizon
        self.os_shape = tuple(train_env.single_observation_space.shape)
        policy_indices = getattr(train_env, "policy_observation_indices", None)
        critic_indices = getattr(train_env, "critic_observation_indices", None)
        self.action_dim = math.prod(train_env.single_action_space.shape)
        self.target_entropy = -0.5 * a.target_entropy_multiplier * self.action_dim * 2

        self.logger = MetricsLogger(config.runner.track_console, writer)
        rlx_logger.info(f"Using device: {self.device}")

        # parameters are initialized on the CPU from the seed, then moved
        def build():
            policy = select_observations(
                ReppoPolicy(observation_width(self.os_shape, policy_indices), self.action_dim, a.policy_hidden_dim,
                            a.init_entropy_coefficient, a.init_kl_coefficient),
                policy_indices,
            )
            critic = select_observations(
                ReppoCritic(observation_width(self.os_shape, critic_indices), self.action_dim, a.critic_hidden_dim,
                            self.nr_bins),
                critic_indices,
            )
            return policy, critic

        if self.parallel is None:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(self.seed)
                self.policy, self.critic = build()
        else:
            built = self.parallel.init(build)
            self.policy, self.critic = (stack_modules([b[i] for b in built]) for i in range(2))
        self.policy.to(self.device)
        self.critic.to(self.device)
        self.policy_optimizer = torch.optim.Adam(self.policy.parameters(), lr=a.learning_rate, eps=1e-8)
        self.critic_optimizer = torch.optim.Adam(self.critic.parameters(), lr=a.learning_rate, eps=1e-8)
        self.obs_normalizer = normalizers.obs_normalizer_init(self.os_shape, self.device)
        if self.parallel is None:
            self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
            # seeds of the eval and test resets
            self.host_generator = torch.Generator().manual_seed(self.seed)
        else:
            self.obs_normalizer = {k: torch.stack([v] * nr_seeds) for k, v in self.obs_normalizer.items()}
            self.generator = self.host_generator = NoGenerator()
        self.env_state = None
        self.nr_train_resets = 0
        self.metrics_history = []
        self.eval_history = None

    def _norm(self, observation, normalizer=None):
        if self.normalize_obs:
            return normalizers.obs_normalize(self.obs_normalizer if normalizer is None else normalizer, observation)
        return observation

    def _normal(self, shape):
        return torch.randn(shape, generator=self.generator, device=self.device)

    # ------------------------------------------------------------------ train

    @torch.no_grad()
    def _rollout(self, env_state, act_noise=None, next_noise=None):
        shape = (self.nr_envs, self.action_dim)
        steps, info_sums = [], None
        for t in range(self.nr_steps):
            observation = self._norm(env_state.observation)
            loc, log_std, _, _ = self.policy(observation)
            action, _ = D.tanh_gaussian_sample_and_log_prob(
                loc, log_std, noise=self._normal(shape) if act_noise is None else act_noise[t])
            env_state = self.train_env.step(env_state, action)
            if self.normalize_obs:
                self.obs_normalizer = normalizers.obs_normalizer_update(self.obs_normalizer, env_state.observation)
            next_observation = self._norm(env_state.final_observation)
            n_loc, n_log_std, _, _ = self.policy(next_observation)
            next_action, _ = D.tanh_gaussian_sample_and_log_prob(
                n_loc, n_log_std, noise=self._normal(shape) if next_noise is None else next_noise[t])
            next_features, next_logits, _ = self.critic(next_observation, next_action)
            next_value = hl_gauss_expectation(next_logits, self.v_min, self.v_max)
            steps.append((observation, action, env_state.reward, next_value, next_features,
                          env_state.terminated.float(), env_state.truncated.float()))
            if info_sums is None:
                info_sums = {k: v.float().sum() for k, v in env_state.info.items()}
            else:
                for k, v in env_state.info.items():
                    info_sums[k] = info_sums[k] + v.float().sum()
        batch = tuple(torch.stack(x) for x in zip(*steps))
        infos = {k: v / (self.nr_steps * self.nr_envs) for k, v in info_sums.items()}
        return env_state, batch, infos

    def _critic_loss(self, obs, action, target, next_features, terminated, truncated):
        _, logits, predicted_next = self.critic(obs, action)
        target_dist = hl_gauss_targets(torch.clamp(target, self.v_min, self.v_max), self.v_min, self.v_max,
                                       self.nr_bins)
        ce = -(target_dist * F.log_softmax(logits, dim=-1)).sum(-1)
        aux = ((predicted_next - next_features) ** 2).mean(-1)
        loss = ((1.0 - truncated) * ce).mean() + self.aux_coef * ((1.0 - truncated) * (1.0 - terminated) * aux).mean()
        value = hl_gauss_expectation(logits.detach(), self.v_min, self.v_max)
        return loss, {"loss/critic_loss": ce.detach().mean(), "loss/auxiliary_loss": aux.detach().mean(),
                      "v_value/value": value.mean()}

    def _policy_loss(self, obs, old_policy, sample_noise, kl_noise):
        loc, log_std, log_ent, log_kl = self.policy(obs)
        new_action, new_log_prob = D.tanh_gaussian_sample_and_log_prob(loc, log_std, noise=sample_noise)
        _, logits, _ = self.critic(obs, new_action)
        value = hl_gauss_expectation(logits, self.v_min, self.v_max)
        with torch.no_grad():
            old_loc, old_log_std, _, _ = old_policy(obs)
            shape = (self.nr_kl_samples,) + old_loc.shape
            old_actions, old_log_probs = D.tanh_gaussian_sample_and_log_prob(
                old_loc.expand(shape), old_log_std.expand(shape), noise=kl_noise)
        kl = (old_log_probs - log_prob_at(loc.expand(shape), log_std.expand(shape), old_actions)).mean(dim=0)
        ent_coef, kl_coef = torch.exp(log_ent), torch.exp(log_kl)
        clipped_loss = torch.where(kl < self.kl_bound, new_log_prob * ent_coef.detach() - value,
                                   kl * kl_coef.detach())
        entropy = -new_log_prob
        ent_coef_loss = ent_coef * (self.target_entropy + entropy).detach()
        kl_coef_loss = -kl_coef * (kl - self.kl_bound).detach()
        loss = clipped_loss.mean() + ent_coef_loss.mean() + kl_coef_loss.mean()
        return loss, {
            "loss/policy_loss": clipped_loss.detach().mean(),
            "entropy/entropy": entropy.detach().mean(),
            "entropy/entropy_coefficient": ent_coef.detach(),
            "kl/kl_divergence": kl.detach().mean(),
            "kl/kl_coefficient": kl_coef.detach(),
            "q_value/policy_q": value.detach().mean(),
        }

    def _step(self, module, optimizer, loss):
        """One clipped Adam step; per-seed ``[S]`` losses are summed and
        clipped per seed."""
        params = list(module.parameters())
        grads = torch.autograd.grad(loss.sum(), params)
        clip_by_global_norm_(list(grads), self.max_grad_norm, per_seed=self.parallel is not None)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()

    def _update(self, batch, old_policy, permutations=None, sample_noise=None, kl_noise=None):
        """The epochs of minibatch critic and policy steps; the metrics are
        means over every minibatch."""
        observations, actions, targets, next_features, terminations, truncations = batch
        mb = self.minibatch_size
        history = []
        for e in range(self.nr_epochs):
            perm = (torch.randperm(self.batch_size, generator=self.generator, device=self.device)
                    if permutations is None else permutations[e].to(self.device))
            for m in range(self.nr_minibatches):
                idx = perm[m * mb:(m + 1) * mb]
                critic_loss, critic_metrics = self._critic_loss(observations[idx], actions[idx], targets[idx],
                                                                next_features[idx], terminations[idx], truncations[idx])
                self._step(self.critic, self.critic_optimizer, critic_loss)
                noise = self._normal((mb, self.action_dim)) if sample_noise is None else sample_noise[e][m]
                samples = (self._normal((self.nr_kl_samples, mb, self.action_dim)) if kl_noise is None
                           else kl_noise[e][m])
                policy_loss, policy_metrics = self._policy_loss(observations[idx], old_policy, noise, samples)
                self._step(self.policy, self.policy_optimizer, policy_loss)
                history.append({**critic_metrics, **policy_metrics})
        return {k: torch.stack([h[k] for h in history]).mean() for k in history[0]}

    def learning_iteration(self, env_state, draws=None):
        """One rollout, its TD(lambda) targets and the epochs of updates;
        returns the new env state and the iteration's metrics (device
        scalars).  ``draws`` may hold ``act_noise`` / ``next_noise`` ``[T,
        N, A]``, ``permutations`` ``[E, batch]``, ``sample_noise`` ``[E, M,
        mb, A]`` and ``kl_noise`` ``[E, M, nr_kl_samples, mb, A]``; what it
        does not hold is drawn from the generator."""
        draws = draws or {}
        old_policy = copy.deepcopy(self.policy).requires_grad_(False)
        if self.parallel is not None:
            return self._learning_iteration_seeds(env_state, old_policy)
        with record_function("reppo/rollout"):
            env_state, batch, infos = self._rollout(env_state, draws.get("act_noise"), draws.get("next_noise"))
        observations, actions, rewards, next_values, next_features, terminations, truncations = batch
        with torch.no_grad(), record_function("reppo/targets"):
            targets = td_lambda_targets(rewards, terminations, next_values, self.gamma, self.gae_lambda)
        flat = lambda x: x.reshape((self.batch_size,) + x.shape[2:])
        with record_function("reppo/update"):
            metrics = self._update(tuple(flat(x) for x in (observations, actions, targets, next_features,
                                                           terminations, truncations)),
                                   old_policy, draws.get("permutations"), draws.get("sample_noise"),
                                   draws.get("kl_noise"))
        return env_state, {**infos, **metrics}

    # ----------------------------------------------------------- parallel seeds

    def _nets(self, old_policy=None):
        nets = {"policy": self.policy, "critic": self.critic}
        if old_policy is not None:
            nets["old_policy"] = old_policy
        return nets

    def _seed_map(self, fn, *xs, old_policy=None):
        """``fn(normalizer, *xs_s)`` per seed over ``[S, ...]`` inputs, with
        that seed's nets and observation normalizer."""
        return self.parallel.map(fn, self._nets(old_policy), self.obs_normalizer, *xs)

    def _normals(self, shape):
        """``[S, *shape]`` standard normals, each seed's from its generator."""
        return self.parallel.draw(lambda g: torch.randn(shape, generator=g, device=self.device))

    @torch.no_grad()
    def _rollout_seeds(self, env_state):
        P = self.parallel
        shape = (self.nr_envs, self.action_dim)

        def act(normalizer, obs, noise):
            observation = self._norm(obs, normalizer)
            loc, log_std, _, _ = self.policy(observation)
            return observation, D.tanh_gaussian_sample_and_log_prob(loc, log_std, noise=noise)[0]

        def bootstrap(normalizer, final_obs, noise):
            next_observation = self._norm(final_obs, normalizer)
            n_loc, n_log_std, _, _ = self.policy(next_observation)
            next_action, _ = D.tanh_gaussian_sample_and_log_prob(n_loc, n_log_std, noise=noise)
            next_features, next_logits, _ = self.critic(next_observation, next_action)
            return hl_gauss_expectation(next_logits, self.v_min, self.v_max), next_features

        steps, info_sums = [], None
        for t in range(self.nr_steps):
            act_noise = self._normals(shape)
            observation, action = self._seed_map(act, P.split(env_state.observation), act_noise)
            env_state = self.train_env.step(env_state, P.merge(action))
            if self.normalize_obs:
                self.obs_normalizer = P.map(normalizers.obs_normalizer_update, {}, self.obs_normalizer,
                                            P.split(env_state.observation))
            next_value, next_features = self._seed_map(bootstrap, P.split(env_state.final_observation),
                                                       self._normals(shape))
            steps.append((P.merge(observation), P.merge(action), env_state.reward, P.merge(next_value),
                          P.merge(next_features), env_state.terminated.float(), env_state.truncated.float()))
            sums = {k: v.float().sum() for k, v in env_state.info.items()}
            info_sums = sums if info_sums is None else {k: info_sums[k] + v for k, v in sums.items()}
        batch = tuple(torch.stack(x) for x in zip(*steps))
        infos = {k: v / (self.nr_steps * self.train_env.nr_envs) for k, v in info_sums.items()}
        return env_state, batch, infos

    def _update_seeds(self, batch, old_policy):
        """``_update`` for every seed at once: ``batch`` ``[S, batch, ...]``,
        each seed's permutations and normals from its own generator."""
        P = self.parallel
        mb = self.minibatch_size
        history = []
        for e in range(self.nr_epochs):
            perm = P.draw(lambda g: torch.randperm(self.batch_size, generator=g, device=self.device))
            for m in range(self.nr_minibatches):
                observations, actions, targets, next_features, terminations, truncations = (
                    P.take(x, perm[:, m * mb:(m + 1) * mb]) for x in batch)
                critic_loss, critic_metrics = self._seed_map(
                    lambda n, *xs: self._critic_loss(*xs), observations, actions, targets, next_features,
                    terminations, truncations)
                self._step(self.critic, self.critic_optimizer, critic_loss)
                draws = P.draw(lambda g: {
                    "noise": torch.randn((mb, self.action_dim), generator=g, device=self.device),
                    "samples": torch.randn((self.nr_kl_samples, mb, self.action_dim), generator=g,
                                           device=self.device)})
                policy_loss, policy_metrics = self._seed_map(
                    lambda n, obs, d: self._policy_loss(obs, old_policy, d["noise"], d["samples"]),
                    observations, draws, old_policy=old_policy)
                self._step(self.policy, self.policy_optimizer, policy_loss)
                history.append({**critic_metrics, **policy_metrics})
        return {k: torch.stack([h[k] for h in history]).mean(dim=0) for k in history[0]}

    def _learning_iteration_seeds(self, env_state, old_policy):
        P = self.parallel
        with record_function("reppo/rollout"):
            env_state, batch, infos = self._rollout_seeds(env_state)
        observations, actions, rewards, next_values, next_features, terminations, truncations = batch
        with torch.no_grad(), record_function("reppo/targets"):
            targets = td_lambda_targets(rewards, terminations, next_values, self.gamma, self.gae_lambda)
        with record_function("reppo/update"):
            metrics = self._update_seeds(tuple(P.split_time(x) for x in (
                observations, actions, targets, next_features, terminations, truncations)), old_policy)
        return env_state, {**infos, **metrics}

    # ------------------------------------------------------- eval/save loop

    def _deterministic_action(self, observation):
        if self.parallel is not None:
            P = self.parallel
            return P.merge(self._seed_map(lambda n, o: torch.tanh(self.policy(self._norm(o, n))[0]),
                                          P.split(observation)))
        return torch.tanh(self.policy(self._norm(observation))[0])

    @torch.no_grad()
    def _eval_iteration(self, eval_save_iteration):
        """``horizon`` steps of the tanh mean from a fresh eval reset."""
        seed = eval_reset_seed(self)
        with record_function("reppo/eval"):
            eval_env_state = self.eval_env.reset(seed, eval_mode=True)
            for _ in range(self.horizon):
                eval_env_state = self.eval_env.step(eval_env_state,
                                                    self._deterministic_action(eval_env_state.observation))
        if self.parallel is None:
            eval_metrics = {k: float(eval_env_state.info[f"rollout/{k.split('/')[1]}"].float().mean())
                            for k in ("eval/episode_return", "eval/episode_length")}
        else:
            eval_metrics = {k: self.parallel.split(eval_env_state.info[f"rollout/{k.split('/')[1]}"].float())
                            .mean(dim=1).cpu().numpy() for k in ("eval/episode_return", "eval/episode_length")}
        if self.logging_active:
            self.logger.log_dict(eval_metrics, (eval_save_iteration + 1) * self.eval_save_frequency)
        return eval_metrics

    def _init_train_carry(self):
        self.env_state = self.train_env.reset(train_reset_seed(self))
        return self.env_state

    def _eval_save_iteration(self, env_state, eval_save_iteration):
        for j in range(self.nr_updates_per_eval_save_iteration):
            env_state, metrics = self.learning_iteration(env_state)
            if self.logging_active:
                iteration = eval_save_iteration * self.nr_updates_per_eval_save_iteration + j + 1
                values = {k: float(v) for k, v in metrics.items()}
                now = time.time()
                values["time/sps"] = int(self.batch_size / max(now - self._last_log_time, 1e-9))
                self._last_log_time = now
                values["steps/nr_env_steps"] = iteration * self.batch_size
                self.metrics_history.append(values)
                self.logger.log_dict(values, iteration * self.batch_size)
        self.env_state = env_state
        eval_metrics = self._eval_iteration(eval_save_iteration) if self.evaluation_active else None
        if self.save_model:
            self.save()
        return env_state, eval_metrics

    def train(self):
        start = self._last_log_time = time.time()
        self.env_state, eval_history = run_training_program(self)
        if self.parallel is not None:
            finish(self, (self.policy, self.policy_optimizer), (self.critic, self.critic_optimizer))
            self.obs_normalizer = {k: v[0].clone() for k, v in self.obs_normalizer.items()}
        self.eval_history = None
        if eval_history is not None:
            per_eval = self.nr_updates_per_eval_save_iteration * self.batch_size
            steps = (np.arange(self.nr_eval_save_iterations) + 1) * per_eval
            self.eval_history = {"steps": steps, **eval_history}
        rlx_logger.info(f"Average time: {time.time() - start:.2f} s")

    # ----------------------------------------------------- save / load / test

    def checkpoint_tree(self):
        return {"policy": self.policy.state_dict(), "critic": self.critic.state_dict(),
                "obs_normalizer": dict(self.obs_normalizer)}

    def restore_from_tree(self, tree):
        self.policy.load_state_dict(tree["policy"])
        self.critic.load_state_dict(tree["critic"])
        self.obs_normalizer = {k: v.to(self.device) for k, v in tree["obs_normalizer"].items()}

    def save(self, file_name="latest.model"):
        ckpt.save_model_file(self.save_path, file_name, self.checkpoint_tree(), self.config.algorithm.to_dict())

    @classmethod
    def load(cls, config, train_env, eval_env, run_path, writer, explicitly_set_algorithm_params):
        return ckpt.load_model(cls, config, train_env, eval_env, run_path, writer, explicitly_set_algorithm_params)

    @torch.no_grad()
    def test(self, episodes):
        """Deterministic rollouts until ``episodes`` episodes are done."""
        def step(env_state):
            return self.eval_env.step(env_state, self._deterministic_action(env_state.observation))

        seed = int(torch.randint(2**31 - 1, (), generator=self.host_generator))
        env_state = self.eval_env.reset(seed, eval_mode=True)
        return collect_test_returns(step, env_state, episodes, self.horizon)

    def general_properties():
        return GeneralProperties
