"""DQN on the off-policy core, the JAX package's ``dqn.tpu``:

- epsilon-greedy acting with a linear schedule from ``epsilon_start`` to
  ``epsilon_end`` over ``epsilon_decay_steps // nr_envs`` learning steps;
- TD(0) targets from the target network, a squared TD error;
- ``update_frequency`` and ``target_update_frequency`` are in env steps and
  divided by ``nr_envs``: a learning step whose ``step`` is a multiple of
  ``update_every`` takes an Adam step (the loss, the gradients and their
  norm are computed on every step, for the metrics), and one whose ``step``
  is a multiple of ``target_update_every`` then copies the parameters into
  the target network;
- Adam (eps 1e-8) at a constant rate; the target starts equal to the
  parameters;
- on an IMAGES env the Q-network's trunk is ``NatureCNN`` and the replay
  holds uint8 observations (``offpolicy.py``).

DDQN, C51 and DQN-HL-Gauss subclass it and override the Q-values, the
target and the loss.  With parallel seeds (``offpolicy.py``) the target and
the loss are mapped over the seeds (``update_seeds``), C51's projection
taking all seeds' targets in one call.
"""

import math

import torch

from rlx_tpu_torch.algorithms.dqn.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.offpolicy import OffPolicyAlgorithm
from rlx_tpu_torch.algorithms.train_state import TrainState, global_norm, per_seed_global_norm
from rlx_tpu_torch.models.mlp import DiscreteQNet


class DQN(OffPolicyAlgorithm):
    # the checkpoint tree holds critic and critic_target
    state_names = ("critic",)
    parallel_seeds = True

    def setup_states(self, output_dim_per_action=1):
        a = self.config.algorithm
        self.epsilon_start = a.epsilon_start
        self.epsilon_end = a.epsilon_end
        self.epsilon_decay_iterations = max(int(a.epsilon_decay_steps) // self.nr_envs, 1)
        self.update_every = max(int(a.update_frequency) // self.nr_envs, 1)
        self.target_update_every = max(int(a.target_update_frequency) // self.nr_envs, 1)
        # parameters are initialized on the CPU from the seed, then moved
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            q_net = DiscreteQNet(math.prod(self.os_shape), self.nr_actions, tuple(a.critic_hidden_sizes),
                                 a.activation, output_dim_per_action=output_dim_per_action,
                                 image_shape=self.image_shape)
        q_net.to(self.device)
        self.critic = TrainState(q_net, torch.optim.Adam(q_net.parameters(), lr=self.learning_rate, eps=1e-8))

    def epsilon(self, step):
        fraction = min(step / self.epsilon_decay_iterations, 1.0)
        return self.epsilon_start + fraction * (self.epsilon_end - self.epsilon_start)

    def q_values(self, module, observation):
        """``[B, nr_actions]`` values the greedy action maximizes."""
        return module(observation)

    @torch.no_grad()
    def act(self, observation, step=0, random_action=None, draw=None):
        """The greedy action, or with probability ``epsilon(step)`` a uniform
        one: ``random_action`` (int32 in [0, nr_actions)) where ``draw``
        (uniform in [0, 1)) is below epsilon; both ``[nr_envs]``, drawn from
        the generator unless given."""
        greedy = self.eval_act(observation)
        if random_action is None:
            random_action = torch.randint(0, self.nr_actions, greedy.shape, generator=self.generator,
                                          device=self.device, dtype=torch.int32)
        if draw is None:
            draw = torch.rand(greedy.shape, generator=self.generator, device=self.device)
        return torch.where(draw < self.epsilon(step), random_action, greedy)

    def act_draws(self, generator):
        return {
            "random_action": torch.randint(0, self.nr_actions, (self.nr_envs,), generator=generator,
                                           device=self.device, dtype=torch.int32),
            "draw": torch.rand((self.nr_envs,), generator=generator, device=self.device),
        }

    @torch.no_grad()
    def eval_act(self, observation):
        return torch.argmax(self.q_values(self.critic.module, observation), dim=-1).to(torch.int32)

    def next_q_target(self, batch):
        return self.critic.target(batch["next_observation"]).max(dim=-1).values

    def target(self, batch):
        return batch["reward"] + self.gamma * (1.0 - batch["terminated"]) * self.next_q_target(batch)

    def loss(self, batch, target):
        """(loss, mean Q of the taken actions) on the online network."""
        q = self.critic.module(batch["observation"])
        q_action = torch.gather(q, -1, batch["action"].long()[:, None]).squeeze(-1)
        return ((q_action - target) ** 2).mean(), q_action.mean()

    def update(self, batch, step):
        """The loss and its gradients; an Adam step where ``step`` is a
        multiple of ``update_every``, then the target copy where it is a
        multiple of ``target_update_every``.  Returns the metrics as
        scalars."""
        with torch.no_grad():
            target = self.target(batch)
        return self._step(self.loss(batch, target), step, global_norm)

    def update_seeds(self, batch, step):
        with torch.no_grad():
            target = self._target_seeds(batch)
        return self._step(self.seed_map(self.loss, batch, target), step, per_seed_global_norm)

    def _target_seeds(self, batch):
        """Every seed's ``target`` ``[S, B, ...]``."""
        return self.seed_map(self.target, batch)

    def _step(self, losses, step, norm):
        """Gradients of the loss (summed over seeds), the Adam step and the
        target copy as ``step`` says; returns the metrics."""
        q_loss, q_mean = losses
        grads = torch.autograd.grad(q_loss.sum(), list(self.critic.module.parameters()))
        if step % self.update_every == 0:
            self.critic.apply_gradients(grads)
        if step % self.target_update_every == 0:
            self.critic.hard_update()
        with torch.no_grad():
            return {
                "loss/q_loss": q_loss.detach(),
                "q_value/q_value": q_mean.detach(),
                "epsilon/epsilon": torch.tensor(self.epsilon(step)),
                "gradients/critic_grad_norm": norm(grads),
            }

    def general_properties():
        return GeneralProperties
