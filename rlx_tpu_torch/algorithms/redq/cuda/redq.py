"""REDQ: randomized ensemble double Q-learning (the JAX package's
``redq.tpu``): 10 critics, 20 critic updates per env step, the target the
minimum over a random subset of ``in_target_minimization`` target critics
(drawn without replacement for each critic update), the policy trained on
the ensemble's mean."""

import torch

from rlx_tpu_torch.algorithms.sac_ensembles import EnsembleSAC


class REDQ(EnsembleSAC):
    parallel_seeds = True

    def setup_states(self):
        self.in_target_minimization = int(self.config.algorithm.in_target_minimization)
        super().setup_states()

    def aggregate_draws(self, generator):
        return {"subset": self._subset(generator)}

    def _subset(self, generator):
        """``in_target_minimization`` critic indices, without replacement."""
        nr_critics = self.config.algorithm.nr_critics
        return torch.randperm(nr_critics, generator=generator, device=self.device)[:self.in_target_minimization]

    def target_q_aggregate(self, next_q, subset=None):
        """The minimum over ``subset`` (critic indices), drawn from the
        generator unless given."""
        if subset is None:
            subset = self._subset(self.generator)
        return torch.index_select(next_q, 0, subset).min(dim=0).values

    def policy_q_aggregate(self, q_pi):
        return q_pi.mean(dim=0)
