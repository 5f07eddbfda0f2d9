"""FlashSAC: SAC over unit-norm BatchNorm networks with categorical twin
critics, repeated exploration noise and reward normalization.

The same algorithm as the JAX package's ``flashsac.tpu``:

- the networks of ``layers.py``, projected by ``project_params`` at init
  and after every optimizer step;
- the target entropy from a Gaussian of std ``target_entropy_sigma`` per
  action dimension, ``0.5 * d * log(2 pi e sigma^2)``;
- exploration noise held for a zeta-distributed number of steps
  (``pre_act``: a fresh normal and a fresh length once the last is used);
- rewards scaled by the discounted-return normalizer with its ``G_max``
  floor (``ops/normalizers.reward_normalizer_*``), updated after each env
  step;
- a warmup-cosine learning rate on each optimizer's OWN step count;
- per update, in this order: the policy loss over one train-mode forward
  of the joint (s, s') batch on the critic BEFORE this step's critic
  update; on ``step % policy_delay == 0`` the policy and ``log_alpha``
  step (on the other steps neither they, their Adam states nor the
  policy's statistics move); then the critic's target from the policy
  AFTER its (possibly skipped) update: the target critic's train-mode
  forward over the joint (s|s', a|a') batch, per sample the critic with
  the lower expectation, its log-probabilities' support shifted by the
  reward, the discount and ``-alpha * log pi`` and projected back onto the
  atoms (kernel B3 on the card); the online critic's train-mode forward
  over the same joint batch and its cross-entropy step.  The three
  BatchNorm streams (policy, online and target critic) each advance their
  own statistics;
- the Polyak update averages the online critic's parameters as Adam left
  them, BEFORE ``project_params``, into the target, then projects the
  online critic: the JAX package's order.  RL-X projects first; the port
  follows the JAX package it is held against.

The running statistics are buffers of the networks, so the checkpoint
carries the policy's, the critic's and the target's.
"""

import math

import torch

from rlx_tpu_torch.algorithms.flashsac.cuda.layers import FlashSACDoubleCritic, FlashSACPolicy, project_params
from rlx_tpu_torch.algorithms.sac.cuda.sac import SAC
from rlx_tpu_torch.algorithms.train_state import TrainState, global_norm, per_seed_global_norm
from rlx_tpu_torch.models.layers import commit_batch_stats, discard_batch_stats
from rlx_tpu_torch.models.mlp import EntropyCoefficient, select_observations
from rlx_tpu_torch.ops import normalizers
from rlx_tpu_torch.ops.distributional import categorical_projection_dense

LOG_2 = math.log(2.0)
LOG_2PI = math.log(2.0 * math.pi)


def build_zeta_cdf(mu, max_n):
    """The CDF of a zeta(mu) law truncated to 1..max_n, in float32."""
    ns = torch.arange(1, max_n + 1, dtype=torch.float32)
    pmf = ns ** (-mu)
    return torch.cumsum(pmf / pmf.sum(), dim=0)


def sample_and_log_prob(mean, std, noise):
    """The squashed-Gaussian sample ``tanh(mean + std * noise)`` and its
    log-probability (the softplus-stable ``log(1 - tanh^2)``)."""
    base = mean + std * noise
    gaussian = -0.5 * noise ** 2 - 0.5 * LOG_2PI - torch.log(std)
    correction = 2.0 * (LOG_2 - base - torch.nn.functional.softplus(-2.0 * base))
    return torch.tanh(base), (gaussian - correction).sum(-1)


class FlashSAC(SAC):
    parallel_seeds = True
    capturable = False   # SAC's captured learning step is not yet this family's

    def setup_states(self):
        a = self.config.algorithm
        self.policy_delay = a.policy_delay
        self.nr_atoms, self.v_min, self.v_max = a.nr_atoms, a.v_min, a.v_max
        self.normalized_g_max = a.normalized_g_max
        self.normalize_rewards = a.enable_reward_normalization
        sigma = a.target_entropy_sigma
        self.target_entropy = 0.5 * self.action_dim * math.log(2.0 * math.pi * math.e * sigma * sigma)
        self.zeta_cdf = build_zeta_cdf(a.noise_zeta_mu, a.noise_zeta_max_repeat).to(self.device)
        self.bins = torch.linspace(self.v_min, self.v_max, self.nr_atoms, device=self.device)
        self.schedule = (a.learning_rate_init, a.learning_rate_peak, a.learning_rate_end,
                         a.learning_rate_warmup_steps,
                         max(int(math.ceil(self.total_training_timesteps / self.nr_envs)), 1))
        self.state_names = ("policy", "critic", "alpha", "noise") + (
            ("reward_normalizer",) if self.normalize_rewards else ())

        # parameters are initialized on the CPU from the seed, moved, then projected
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            policy = select_observations(
                FlashSACPolicy(self.policy_obs_dim, self.action_dim, a.policy_hidden_dim, a.policy_nr_blocks),
                self.policy_observation_indices,
            )
            critic = select_observations(
                FlashSACDoubleCritic(self.critic_obs_dim, self.action_dim, a.critic_hidden_dim, a.critic_nr_blocks,
                                     a.nr_atoms, a.v_min, a.v_max, a.nr_critics),
                self.critic_observation_indices,
            )
        alpha = EntropyCoefficient(a.init_entropy_coefficient)
        for module in (policy, critic, alpha):
            module.to(self.device)
        project_params(policy)
        project_params(critic)
        self.policy = TrainState(policy, self._adam(policy), target=False)
        self.critic = TrainState(critic, self._adam(critic))
        self.alpha = TrainState(alpha, self._adam(alpha), target=False)
        self.noise = {
            # a dp rank's rows of every env's
            "noise": self.mesh.rows(torch.randn((self.nr_envs, self.action_dim), generator=self.generator,
                                                device=self.device)),
            "count": torch.zeros((), dtype=torch.int32, device=self.device),
            "n": torch.ones((), dtype=torch.int32, device=self.device),
        }
        if self.normalize_rewards:
            self.reward_normalizer = normalizers.reward_normalizer_init(self.nr_envs // self.dp, self.device)

    def learning_rate_at(self, count):
        """optax's ``warmup_cosine_decay_schedule`` at an optimizer's step
        count: linear from ``init`` to ``peak`` over the warmup, then a
        cosine from ``peak`` to ``end`` over the rest of the updates."""
        init, peak, end, warmup, total = self.schedule
        if count < warmup:
            return init + (peak - init) * count / warmup
        decay = total - warmup
        fraction = min(count - warmup, decay) / decay
        alpha = 0.0 if peak == 0.0 else end / peak
        return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * fraction)) + alpha)

    # --- acting ------------------------------------------------------------
    @torch.no_grad()
    def pre_act(self, step, fresh_noise=None, uniform=None):
        """Advance the repeated-noise stream: once the held noise has served
        its ``n`` steps, a fresh normal (``fresh_noise``, ``[nr_envs,
        action_dim]``) and a fresh zeta-distributed ``n`` (from ``uniform``
        in [0, 1)); each is drawn from the generator unless given (with
        parallel seeds, each seed's from its own)."""
        if self.parallel is not None:
            P = self.parallel
            draws = P.draw(self._pre_act_draws) if fresh_noise is None else {
                "fresh_noise": fresh_noise, "uniform": uniform}
            self.noise = P.map(self._next_noise, {}, self.noise, draws["fresh_noise"], draws["uniform"])
            return
        if fresh_noise is None:
            draws = self._pre_act_draws(self.generator)
            fresh_noise, uniform = self.mesh.rows(draws["fresh_noise"]), draws["uniform"]
        self.noise = self._next_noise(self.noise, fresh_noise, uniform)

    def _pre_act_draws(self, generator):
        """One seed's draws of a ``pre_act``: the normal, then the uniform."""
        return {"fresh_noise": torch.randn((self.nr_envs, self.action_dim), generator=generator, device=self.device),
                "uniform": torch.rand((), generator=generator, device=self.device)}

    def _next_noise(self, noise, fresh_noise, uniform):
        """One seed's noise state after a ``pre_act``."""
        fresh_n = (torch.argmax((uniform < self.zeta_cdf).to(torch.int32)) + 1).to(torch.int32)
        reinit = (noise["count"] == 0) | (noise["count"] >= noise["n"])
        return {
            "noise": torch.where(reinit, fresh_noise, noise["noise"]),
            "n": torch.where(reinit, fresh_n, noise["n"]),
            "count": torch.where(reinit, torch.zeros_like(noise["count"]), noise["count"]) + 1,
        }

    @torch.no_grad()
    def act(self, observation, step=0):
        mean, std = self.policy.module(observation, False)
        return torch.tanh(mean + std * self.noise["noise"])

    def act_draws(self, generator):
        """None: the exploration noise is ``pre_act``'s."""
        return {}

    @torch.no_grad()
    def eval_act(self, observation):
        return torch.tanh(self.policy.module(observation, False)[0])

    def observe_transition(self, observation, env_state):
        if self.normalize_rewards:
            self.reward_normalizer = self.updated_reward_normalizer(env_state)

    # --- update ------------------------------------------------------------
    def update(self, batch, step, policy_noise=None, target_noise=None):
        """One update in the order above.  ``policy_noise`` samples the
        policy loss's actions, ``target_noise`` the next actions (standard
        normal, ``[batch, action_dim]``); each is drawn from the generator
        unless given.  Returns the metrics as device scalars."""
        shape = (batch["observation"].shape[0], self.action_dim)
        draw = lambda: torch.randn(shape, generator=self.generator, device=self.device)
        policy_noise = draw() if policy_noise is None else policy_noise
        target_noise = draw() if target_noise is None else target_noise
        return self._update(batch, step, policy_noise, target_noise, self.plain_call, global_norm)

    def update_seeds(self, batch, step, policy_noise=None, target_noise=None):
        """``update`` for every seed (``[S, batch, ...]``), each seed's
        normals from its generator unless given.  The three BatchNorm
        streams take each seed's statistics over its own rows; one
        projection for all seeds' targets (kernel B3 at ``[S * batch,
        atoms]``)."""
        if policy_noise is None:
            draws = self.parallel.draw(self.update_draws)
            policy_noise, target_noise = draws["policy_noise"], draws["target_noise"]
        return self._update(batch, step, policy_noise, target_noise, self.seed_map, per_seed_global_norm)

    batch_draw_dims = {"policy_noise": 0, "target_noise": 0}
    env_row_states = {"noise": ("noise",), "reward_normalizer": ("g",)}

    def update_draws(self, generator):
        shape = (self.batch_size, self.action_dim)
        return {"policy_noise": torch.randn(shape, generator=generator, device=self.device),
                "target_noise": torch.randn(shape, generator=generator, device=self.device)}

    def _update(self, batch, step, policy_noise, target_noise, call, norm):
        """The update through ``call`` (``plain_call`` or ``seed_map``,
        whose ``[S]`` losses are summed), the batch statistics committed
        between the mapped parts; ``norm`` gives the grad norms."""
        # policy and log_alpha (delayed)
        policy_loss, alpha_loss, entropy, alpha, policy_q = call(self._policy_losses, batch, policy_noise)
        policy_grads = torch.autograd.grad(policy_loss.sum(), list(self.policy.module.parameters()))
        alpha_grads = torch.autograd.grad(alpha_loss.sum(), list(self.alpha.module.parameters()))
        if step % self.policy_delay == 0:
            self.policy.apply_gradients(policy_grads, self.learning_rate_at(self.policy.step_count()))
            project_params(self.policy.module)
            commit_batch_stats(self.policy.module)
            self.alpha.apply_gradients(alpha_grads, self.learning_rate_at(self.alpha.step_count()))
        else:
            discard_batch_stats(self.policy.module)

        # the critic's target from the policy after its (possibly skipped) update
        with torch.no_grad():
            target_bins, selected, target_q, next_action = call(self._target_inputs, batch, target_noise)
            projection = lambda z, p: categorical_projection_dense(z, p, self.v_min, self.v_max, self.nr_atoms)
            target_probs = self.fold_seeds(projection, target_bins, selected)
        q_loss = call(self._critic_loss, batch, next_action, target_probs)
        critic_grads = torch.autograd.grad(q_loss.sum(), list(self.critic.module.parameters()))
        critic_learning_rate = self.learning_rate_at(self.critic.step_count())
        self.critic.apply_gradients(critic_grads, critic_learning_rate)
        self.critic.polyak_update(self.tau)     # the unprojected parameters, as the JAX package
        project_params(self.critic.module)
        commit_batch_stats(self.critic.module)
        commit_batch_stats(self.critic.target)

        with torch.no_grad():
            return {
                "loss/policy_loss": policy_loss.detach(),
                "loss/q_loss": q_loss.detach(),
                "loss/entropy_loss": alpha_loss.detach(),
                "entropy/entropy": entropy,
                "entropy/alpha": alpha,
                "q_value/policy_q_mean": policy_q,
                "q_value/target_q_mean": target_q,
                "lr/learning_rate": torch.tensor(critic_learning_rate),
                "gradients/policy_grad_norm": norm(policy_grads),
                "gradients/critic_grad_norm": norm(critic_grads),
            }

    def _targets(self, batch):
        """(next observation, reward, discount) of one seed's 1-step or
        n-step batch, the reward normalized."""
        if self.n_step > 1:
            next_obs, reward = batch["n_step_next_observation"], batch["n_step_reward"]
            discount = batch["n_step_gamma"] * (1.0 - batch["n_step_terminated"])
        else:
            next_obs, reward = batch["next_observation"], batch["reward"]
            discount = self.gamma * (1.0 - batch["terminated"])
        if self.normalize_rewards:
            reward = normalizers.reward_normalize(self.reward_normalizer, reward, self.normalized_g_max)
        return next_obs, reward, discount

    def _policy_losses(self, batch, policy_noise):
        """(policy loss, alpha loss, entropy, alpha, mean policy Q) of one
        seed's batch: one train-mode policy forward of (s, s'), whose
        statistics stay pending, on the critic before its step."""
        obs, (next_obs, _, _) = batch["observation"], self._targets(batch)
        B = obs.shape[0]
        mean_all, std_all = self.policy.module(torch.cat([obs, next_obs]), True)
        action, log_prob = sample_and_log_prob(mean_all[:B], std_all[:B], policy_noise)
        q = self.critic.module(obs, action, False)[0].min(dim=0).values
        alpha = self.alpha.module().detach()
        policy_loss = (alpha * log_prob - q).mean()
        entropy = -log_prob.mean().detach()
        alpha_loss = self.alpha.module() * (entropy - self.target_entropy)
        return policy_loss, alpha_loss, entropy, alpha, q.detach().mean()

    @torch.no_grad()
    def _target_inputs(self, batch, target_noise):
        """(target atoms ``[B, atoms]``, the lower target critic's
        probabilities ``[B, atoms]``, the target's mean value, the next
        action) of one seed's batch: what the projection takes.  The target critic's train-mode
        forward over the joint batch leaves its statistics pending."""
        obs = batch["observation"]
        next_obs, reward, discount = self._targets(batch)
        B = obs.shape[0]
        next_action, next_log_prob = sample_and_log_prob(*self.policy.module(next_obs, False), target_noise)
        new_alpha = self.alpha.module()
        joint_action = torch.cat([batch["action"], next_action])
        next_log_probs = self.critic.target(torch.cat([obs, next_obs]), joint_action, True)[1][:, B:]  # [n, B, atoms]
        next_values = (torch.exp(next_log_probs) * self.bins).sum(-1)                                # [n, B]
        lower = torch.argmin(next_values, dim=0)
        selected = torch.take_along_dim(next_log_probs, lower[None, :, None], dim=0)[0]
        target_bins = reward[:, None] + discount[:, None] * (self.bins[None, :] - (new_alpha * next_log_prob)[:, None])
        return target_bins, torch.exp(selected), next_values.mean(), next_action

    def _critic_loss(self, batch, next_action, target_probs):
        """The cross-entropy of one seed's batch from the online critic's
        train-mode forward over the joint (s|s', a|a') batch, whose
        statistics stay pending."""
        obs = batch["observation"]
        next_obs, _, _ = self._targets(batch)
        joint_action = torch.cat([batch["action"], next_action])
        predicted = self.critic.module(torch.cat([obs, next_obs]), joint_action, True)[1][:, :obs.shape[0]]
        return -(target_probs[None] * predicted).sum(-1).mean()
