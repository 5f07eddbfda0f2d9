"""DDPG: deep deterministic policy gradient.

The same algorithm as the JAX package's ``ddpg.tpu``:

- a deterministic tanh policy; exploration adds ``epsilon`` times a
  standard normal to every action, clipped to [-1, 1];
- one Q critic; the target is the target critic at the target policy's
  action;
- Adam (eps 1e-8) on both nets at a constant rate (the JAX config's
  ``anneal_learning_rate`` key is accepted and, as there, not read).  Every
  update steps the critic, then the policy on ``-q.mean()`` of the UPDATED
  critic, then moves both targets by Polyak averaging.

A learning step reads nothing back, so on one CUDA device a CUDA graph
captures it (``capturable``; ``offpolicy.py``).
"""

import torch

from rlx_tpu_torch.algorithms.ddpg.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.offpolicy import OffPolicyAlgorithm
from rlx_tpu_torch.algorithms.train_state import TrainState, global_norm, per_seed_global_norm
from rlx_tpu_torch.models.mlp import DeterministicTanhPolicy, QCritic, select_observations


class DDPG(OffPolicyAlgorithm):
    # the checkpoint tree holds policy, policy_target, critic, critic_target
    state_names = ("policy", "critic")
    parallel_seeds = True
    capturable = True

    def setup_states(self):
        a = self.config.algorithm
        self.epsilon = a.epsilon
        # parameters are initialized on the CPU from the seed, then moved
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            policy = DeterministicTanhPolicy(self.policy_obs_dim, self.action_dim, tuple(a.policy_hidden_sizes),
                                             a.activation, a.layer_norm)
            critic = QCritic(self.critic_obs_dim, self.action_dim, tuple(a.critic_hidden_sizes), a.activation,
                             a.layer_norm)
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

    def update(self, batch, step):
        """One critic step, one policy step on the updated critic, and both
        Polyak updates.  Returns the metrics as device scalars."""
        return self._step(batch, lambda fn, *xs: fn(*xs), global_norm)

    def update_seeds(self, batch, step):
        return self._step(batch, self.seed_map, per_seed_global_norm)

    def _critic_loss(self, batch):
        obs, next_obs = batch["observation"], batch["next_observation"]
        with torch.no_grad():
            next_q = self.critic.target(next_obs, self.policy.target(next_obs)).squeeze(-1)
            y = batch["reward"] + self.gamma * (1.0 - batch["terminated"]) * next_q

        q = self.critic.module(obs, batch["action"]).squeeze(-1)
        return ((q - y) ** 2).mean(), q.detach().mean()

    def _policy_loss(self, batch):
        obs = batch["observation"]
        return -self.critic.module(obs, self.policy.module(obs)).mean()

    def _step(self, batch, call, norm):
        """The critic step, then the policy's on the updated critic, then both
        Polyak updates; ``call(fn, *xs)`` runs a loss (``seed_map`` with
        parallel seeds, whose ``[S]`` losses are summed)."""
        q_loss, q_value = call(self._critic_loss, batch)
        critic_grads = torch.autograd.grad(q_loss.sum(), list(self.critic.module.parameters()))
        self.critic.apply_gradients(critic_grads)

        # the policy loss on the updated critic; gradients to the policy only
        policy_loss = call(self._policy_loss, batch)
        policy_grads = torch.autograd.grad(policy_loss.sum(), list(self.policy.module.parameters()))
        self.policy.apply_gradients(policy_grads)
        self.policy.polyak_update(self.tau)
        self.critic.polyak_update(self.tau)

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
