"""FastTD3: massively parallel TD3 with distributional categorical critics.

The same algorithm as the JAX package's ``fasttd3.tpu``:

- twin categorical critics over a fixed [v_min, v_max] support, trained by
  cross-entropy against the projected target distribution (the projection
  runs kernel B3 on the card);
- clipped double-Q on distributions: per sample, the target uses the
  target critic with the LOWER expected value (ties go to critic 0);
- n-step returns from the replay buffer (``ops/replay_buffer.sample_nstep``);
- per-env exploration noise scales, linearly spaced in
  [noise_std_min, noise_std_max];
- a running observation normalizer, fed with each learning step's
  pre-step observations and applied to the batch at update time;
- AdamW (weight decay 0.1) on both nets.  The critic steps every update;
  every ``nr_critic_updates_per_policy_update``-th update the policy steps
  on the UPDATED critic, and both targets move by Polyak averaging.  On the
  other updates the policy loss is still computed for the metrics, but the
  policy's optimizer (and so its Adam moments and step count) and both
  targets stay as they were.  Where ``train()`` captures the learning step
  (``capturable``; ``offpolicy.py``) the count is on the device and the
  delay is a select, as the JAX package's ``jnp.where(step % delay == 0,
  new, old)``: the policy's Adam step and both Polyak updates run every
  update under the device flag ``step % delay == 0``, so the step reads
  nothing back and a CUDA graph captures it, B3 inside.  The eager loop
  counts on the host and branches, with the same result bit for bit.

With parallel seeds each seed has its own nets, its own running
normalizer (fed with its own envs' observations) and its own n-step
batches; the targets of all seeds go through one projection (kernel B3 at
``[S * batch, atoms]``).
"""

import torch
import torch.nn.functional as F

from rlx_tpu_torch.algorithms.fasttd3.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.offpolicy import OffPolicyAlgorithm
from rlx_tpu_torch.algorithms.train_state import TrainState, global_norm, per_seed_global_norm
from rlx_tpu_torch.models.mlp import DeterministicTanhPolicy, VectorQCritic, select_observations
from rlx_tpu_torch.ops import normalizers
from rlx_tpu_torch.ops.distributional import categorical_projection_dense


class FastTD3(OffPolicyAlgorithm):
    # the JAX package's state names: the checkpoint tree holds policy,
    # policy_target, critic, critic_target and obs_normalizer
    state_names = ("policy", "critic", "obs_normalizer")
    parallel_seeds = True
    capturable = True

    def setup_states(self):
        a = self.config.algorithm
        self.v_min, self.v_max = a.v_min, a.v_max
        self.nr_atoms = a.nr_atoms
        self.atoms = torch.linspace(self.v_min, self.v_max, self.nr_atoms, device=self.device)
        self.smoothing_epsilon = a.smoothing_epsilon
        self.smoothing_clip_value = a.smoothing_clip_value
        self.policy_delay = a.nr_critic_updates_per_policy_update
        self.clipped_double_q = a.clipped_double_q_learning
        self.normalize_obs = a.enable_observation_normalization
        # each env's exploration scale (a dp rank's rows of them)
        self.noise_scales = self.mesh.rows(
            torch.linspace(a.noise_std_min, a.noise_std_max, self.nr_envs, device=self.device))

        self.learning_rate_tensor = torch.tensor(self.learning_rate, device=self.device)
        # parameters are initialized on the CPU from the seed, then moved
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            policy = DeterministicTanhPolicy(self.policy_obs_dim, self.action_dim, tuple(a.policy_hidden_sizes),
                                             a.activation, a.layer_norm)
            critic = VectorQCritic(self.critic_obs_dim, self.action_dim, tuple(a.critic_hidden_sizes), 2,
                                   a.activation, a.layer_norm, self.nr_atoms)
        adamw = lambda module: torch.optim.AdamW(
            module.parameters(), lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=a.weight_decay,
        )
        policy = select_observations(policy, self.policy_observation_indices).to(self.device)
        critic = select_observations(critic, self.critic_observation_indices).to(self.device)
        self.policy = TrainState(policy, adamw(policy))
        self.critic = TrainState(critic, adamw(critic))
        self.obs_normalizer = normalizers.obs_normalizer_init(self.os_shape, self.device)

    def _norm(self, observation):
        if self.normalize_obs:
            return normalizers.obs_normalize(self.obs_normalizer, observation)
        return observation

    def observe_transition(self, observation, env_state):
        if self.normalize_obs:
            self.update_obs_normalizer_(observation)

    def act_draws(self, generator):
        return {"noise": torch.randn((self.nr_envs, self.action_dim), generator=generator, device=self.device)}

    @torch.no_grad()
    def act(self, observation, step=0, noise=None):
        """Policy action plus per-env Gaussian noise, clipped to [-1, 1];
        ``noise`` (standard normal, ``[nr_envs, action_dim]``) is drawn from
        the generator unless given."""
        action = self.policy.module(self._norm(observation))
        if noise is None:
            noise = torch.randn(action.shape, generator=self.generator, device=self.device)
        return torch.clamp(action + self.noise_scales[:, None] * noise, -1.0, 1.0)

    @torch.no_grad()
    def eval_act(self, observation):
        return self.policy.module(self._norm(observation))

    def expected_value(self, logits):
        """[..., atoms] logits -> [...] expected value."""
        return (torch.softmax(logits, dim=-1) * self.atoms).sum(-1)

    def update(self, batch, step, smoothing_noise=None):
        """One critic step and, where ``step % policy_delay == 0`` (``step`` a
        host int or a 0-dim device tensor), one policy step and both Polyak
        updates.  ``smoothing_noise`` (standard normal,
        ``[batch, action_dim]``) is drawn from the generator unless given.
        Returns the metrics as device scalars."""
        with torch.no_grad():
            target_dist = categorical_projection_dense(*self._target_inputs(batch, smoothing_noise), self.v_min,
                                                       self.v_max, self.nr_atoms)
        return self._step(batch, step, target_dist, lambda fn, *xs: fn(*xs), global_norm)

    batch_draw_dims = {"smoothing_noise": 0}

    def update_draws(self, generator):
        return {"smoothing_noise": torch.randn((self.batch_size, self.action_dim), generator=generator,
                                               device=self.device)}

    def update_seeds(self, batch, step):
        """``update`` for every seed; one projection for all seeds' targets."""
        P = self.parallel
        noise = P.draw(lambda g: self.update_draws(g)["smoothing_noise"])
        with torch.no_grad():
            target_z, chosen_probs = self.seed_map(self._target_inputs, batch, noise)
            target_dist = P.split(categorical_projection_dense(P.merge(target_z), P.merge(chosen_probs), self.v_min,
                                                               self.v_max, self.nr_atoms))
        return self._step(batch, step, target_dist, self.seed_map, per_seed_global_norm)

    def _target_inputs(self, batch, smoothing_noise=None):
        """(target atoms ``[B, atoms]``, the chosen target critic's
        probabilities ``[B, atoms]``) of one seed's batch: what the
        projection takes."""
        obs = self._norm(batch["observation"])
        if self.n_step > 1:
            next_obs = self._norm(batch["n_step_next_observation"])
            reward, terminated = batch["n_step_reward"], batch["n_step_terminated"]
            discount = batch["n_step_gamma"]
        else:
            next_obs = self._norm(batch["next_observation"])
            reward, terminated = batch["reward"], batch["terminated"]
            discount = torch.full_like(reward, self.gamma)

        with torch.no_grad():
            if smoothing_noise is None:
                smoothing_noise = torch.randn((obs.shape[0], self.action_dim), generator=self.generator,
                                              device=self.device)
            smoothing = torch.clamp(self.smoothing_epsilon * smoothing_noise,
                                    -self.smoothing_clip_value, self.smoothing_clip_value)
            next_action = torch.clamp(self.policy.target(next_obs) + smoothing, -1.0, 1.0)
            next_probs = torch.softmax(self.critic.target(next_obs, next_action), dim=-1)  # [2, B, atoms]
            if self.clipped_double_q:
                lower = torch.argmin((next_probs * self.atoms).sum(-1), dim=0)             # [B]
                chosen_probs = torch.where(lower[:, None] == 0, next_probs[0], next_probs[1])
            else:
                chosen_probs = next_probs.mean(dim=0)
            target_z = reward[:, None] + discount[:, None] * (1.0 - terminated[:, None]) * self.atoms[None]
        return target_z, chosen_probs

    def _critic_loss(self, batch, target_dist):
        """(cross-entropy loss, expected value of the batch's Q) of one seed."""
        logits = self.critic.module(self._norm(batch["observation"]), batch["action"])     # [2, B, atoms]
        q_loss = -(target_dist[None] * F.log_softmax(logits, dim=-1)).sum(-1).mean()
        return q_loss, self.expected_value(logits.detach()).mean()

    def _policy_loss(self, batch):
        obs = self._norm(batch["observation"])
        return -self.expected_value(self.critic.module(obs, self.policy.module(obs))).mean(-1).mean()

    def _step(self, batch, step, target_dist, call, norm):
        """The critic step, then the policy loss on the updated critic and,
        where ``step % policy_delay == 0``, the policy step and both Polyak
        updates; ``call(fn, *xs)`` runs a loss (``seed_map`` with parallel
        seeds, whose ``[S]`` losses are summed)."""
        critic_params = list(self.critic.module.parameters())
        q_loss, q_value = call(self._critic_loss, batch, target_dist)
        critic_grads = torch.autograd.grad(q_loss.sum(), critic_params)
        self.critic.apply_gradients(critic_grads)

        # the policy loss on the updated critic; gradients to the policy only
        policy_params = list(self.policy.module.parameters())
        policy_loss = call(self._policy_loss, batch)
        policy_grads = torch.autograd.grad(policy_loss.sum(), policy_params)
        # a host bool from the eager loop's count (a branch), a device flag
        # from a captured step's (a select)
        active = step % self.policy_delay == 0
        self.policy.apply_gradients(policy_grads, active=active)
        self.policy.polyak_update(self.tau, active)
        self.critic.polyak_update(self.tau, active)

        with torch.no_grad():
            return {
                "loss/q_loss": q_loss.detach(),
                "loss/policy_loss": policy_loss.detach(),
                "q_value/q_value": q_value,
                "lr/learning_rate": self.learning_rate_tensor,
                "gradients/policy_grad_norm": norm(policy_grads),
                "gradients/critic_grad_norm": norm(critic_grads),
            }

    def general_properties():
        return GeneralProperties
