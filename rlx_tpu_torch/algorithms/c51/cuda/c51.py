"""C51, the JAX package's ``c51.tpu``: DQN with ``nr_atoms`` atom logits
per action over the fixed support [v_min, v_max], the greedy action by
expected value, the target distribution projected onto the support by
``ops.distributional.categorical_projection_dense`` (kernel B3 on a CUDA
tensor, its plain version on the CPU) and a cross-entropy loss.  The target
is computed without gradients (JAX's ``stop_gradient``; the B3 wrapper
refuses inputs that require grad).  With parallel seeds all seeds' targets
go through one projection, ``[S * B, atoms]``."""

import torch
import torch.nn.functional as F

from rlx_tpu_torch.algorithms.c51.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.dqn.cuda.dqn import DQN
from rlx_tpu_torch.ops.distributional import categorical_projection_dense


class C51(DQN):
    parallel_seeds = True

    def setup_states(self):
        a = self.config.algorithm
        self.v_min = a.v_min
        self.v_max = a.v_max
        self.nr_atoms = a.nr_atoms
        self.atoms = torch.linspace(self.v_min, self.v_max, self.nr_atoms, device=self.device)
        super().setup_states(output_dim_per_action=self.nr_atoms)

    def expectation(self, logits):
        """Expected value of each ``[..., atoms]`` head."""
        return (F.softmax(logits, dim=-1) * self.atoms).sum(-1)

    def q_values(self, module, observation):
        return self.expectation(module(observation))

    def target(self, batch):
        return categorical_projection_dense(*self._target_inputs(batch), self.v_min, self.v_max, self.nr_atoms)

    def _target_seeds(self, batch):
        P = self.parallel
        target_z, best_probs = self.seed_map(self._target_inputs, batch)
        return P.split(categorical_projection_dense(P.merge(target_z), P.merge(best_probs), self.v_min, self.v_max,
                                                    self.nr_atoms))

    def _target_inputs(self, batch):
        """(target atoms, the best next action's probabilities), each ``[B,
        atoms]``: what the projection takes."""
        next_probs = F.softmax(self.critic.target(batch["next_observation"]), dim=-1)   # [B, A, atoms]
        best_action = torch.argmax((next_probs * self.atoms).sum(-1), dim=-1)
        best_probs = next_probs[torch.arange(next_probs.shape[0], device=self.device), best_action]
        target_z = batch["reward"][:, None] + self.gamma * (1.0 - batch["terminated"][:, None]) * self.atoms[None]
        return target_z, best_probs

    def loss(self, batch, target_dist):
        logits = self.critic.module(batch["observation"])   # [B, A, atoms]
        action_logits = logits[torch.arange(logits.shape[0], device=self.device), batch["action"].long()]
        loss = -(target_dist * F.log_softmax(action_logits, dim=-1)).sum(-1).mean()
        return loss, self.expectation(action_logits).mean()

    def general_properties():
        return GeneralProperties
