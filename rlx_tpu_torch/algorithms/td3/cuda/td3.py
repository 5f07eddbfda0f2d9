"""TD3: twin delayed deep deterministic policy gradient.

The same algorithm as the JAX package's ``td3.tpu``:

- a deterministic tanh policy; exploration adds ``epsilon`` times a
  standard normal to every action, clipped to [-1, 1];
- twin Q critics; the target takes the minimum of the two target critics at
  the target policy's action plus ``smoothing_epsilon`` times a standard
  normal clipped to ``smoothing_clip_value``;
- Adam (eps 1e-8) on both nets at a constant rate (the JAX config's
  ``anneal_learning_rate`` key is accepted and, as there, not read).  The
  critic steps every update; on every ``policy_delay``-th update the policy
  steps on ``-q[0].mean()`` (the first critic only) of the UPDATED critic,
  and both targets move by Polyak averaging.  On the other updates the
  policy loss is still computed for the metrics, but the policy's optimizer
  (its Adam moments and step count) and both targets stay as they were.  As
  FastTD3's, the delay is a select on the device flag ``step % policy_delay
  == 0`` where the learning step is captured (``capturable``), a branch on
  the host count in the eager loop.

With parallel seeds the two losses are mapped over the seeds
(``update_seeds``); each seed's smoothing noise comes from its generator.
"""

import torch

from rlx_tpu_torch.algorithms.offpolicy import OffPolicyAlgorithm
from rlx_tpu_torch.algorithms.td3.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.train_state import TrainState, global_norm, per_seed_global_norm
from rlx_tpu_torch.models.mlp import DeterministicTanhPolicy, VectorQCritic, select_observations


class TD3(OffPolicyAlgorithm):
    # the checkpoint tree holds policy, policy_target, critic, critic_target
    state_names = ("policy", "critic")
    parallel_seeds = True
    capturable = True

    def setup_states(self):
        a = self.config.algorithm
        self.epsilon = a.epsilon
        self.smoothing_epsilon = a.smoothing_epsilon
        self.smoothing_clip_value = a.smoothing_clip_value
        self.policy_delay = a.policy_delay
        # parameters are initialized on the CPU from the seed, then moved
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            policy = DeterministicTanhPolicy(self.policy_obs_dim, self.action_dim, tuple(a.policy_hidden_sizes),
                                             a.activation, a.layer_norm)
            critic = VectorQCritic(self.critic_obs_dim, self.action_dim, tuple(a.critic_hidden_sizes), 2,
                                   a.activation, a.layer_norm)
        policy = select_observations(policy, self.policy_observation_indices).to(self.device)
        critic = select_observations(critic, self.critic_observation_indices).to(self.device)
        adam = lambda module: torch.optim.Adam(module.parameters(), lr=self.learning_rate,
                                               betas=(0.9, 0.999), eps=1e-8)
        self.policy = TrainState(policy, adam(policy))
        self.critic = TrainState(critic, adam(critic))

    @torch.no_grad()
    def act(self, observation, step=0, noise=None):
        """Policy action plus ``epsilon`` times ``noise`` (standard normal,
        ``[nr_envs, action_dim]``, drawn from the generator unless given),
        clipped to [-1, 1]."""
        action = self.policy.module(observation)
        if noise is None:
            noise = torch.randn(action.shape, generator=self.generator, device=self.device)
        return torch.clamp(action + self.epsilon * noise, -1.0, 1.0)

    def act_draws(self, generator):
        return {"noise": torch.randn((self.nr_envs, self.action_dim), generator=generator, device=self.device)}

    @torch.no_grad()
    def eval_act(self, observation):
        return self.policy.module(observation)

    def update(self, batch, step, smoothing_noise=None):
        """One critic step and, where ``step % policy_delay == 0`` (``step`` a
        host int or a 0-dim device tensor), one policy step and both Polyak
        updates.  ``smoothing_noise`` (standard normal,
        ``[batch, action_dim]``) is drawn from the generator unless given.
        Returns the metrics as device scalars."""
        return self._step(batch, step, smoothing_noise, lambda fn, *xs: fn(*xs), global_norm)

    batch_draw_dims = {"smoothing_noise": 0}

    def update_draws(self, generator):
        return {"smoothing_noise": torch.randn((self.batch_size, self.action_dim), generator=generator,
                                               device=self.device)}

    def update_seeds(self, batch, step):
        noise = self.parallel.draw(lambda g: self.update_draws(g)["smoothing_noise"])
        return self._step(batch, step, noise, self.seed_map, per_seed_global_norm)

    def _critic_loss(self, batch, smoothing_noise=None):
        """(loss, mean Q) of one seed's batch against its clipped double-Q target."""
        obs, next_obs = batch["observation"], batch["next_observation"]
        with torch.no_grad():
            if smoothing_noise is None:
                smoothing_noise = torch.randn(batch["action"].shape, generator=self.generator,
                                              device=self.device)
            smoothing = torch.clamp(self.smoothing_epsilon * smoothing_noise,
                                    -self.smoothing_clip_value, self.smoothing_clip_value)
            next_action = torch.clamp(self.policy.target(next_obs) + smoothing, -1.0, 1.0)
            next_q = self.critic.target(next_obs, next_action).squeeze(-1).min(dim=0).values
            y = batch["reward"] + self.gamma * (1.0 - batch["terminated"]) * next_q

        q = self.critic.module(obs, batch["action"]).squeeze(-1)
        return ((q - y[None, :]) ** 2).mean(), q.detach().mean()

    def _policy_loss(self, batch):
        obs = batch["observation"]
        return -self.critic.module(obs, self.policy.module(obs))[0].mean()

    def _step(self, batch, step, smoothing_noise, call, norm):
        """The critic step, then the policy's on the updated critic;
        ``call(fn, *xs)`` runs a loss (``seed_map`` with parallel seeds,
        whose ``[S]`` losses are summed)."""
        q_loss, q_value = call(self._critic_loss, batch, smoothing_noise)
        critic_grads = torch.autograd.grad(q_loss.sum(), list(self.critic.module.parameters()))
        self.critic.apply_gradients(critic_grads)

        # the policy loss on the updated critic; gradients to the policy only
        policy_loss = call(self._policy_loss, batch)
        policy_grads = torch.autograd.grad(policy_loss.sum(), list(self.policy.module.parameters()))
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
                "gradients/policy_grad_norm": norm(policy_grads),
                "gradients/critic_grad_norm": norm(critic_grads),
            }

    def general_properties():
        return GeneralProperties
