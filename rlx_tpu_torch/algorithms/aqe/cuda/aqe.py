"""AQE: aggressive Q-value ensembles (the JAX package's ``aqe.tpu``): 10
critics, 5 critic updates per env step; the target and the policy's
objective drop the ``nr_dropped_q_values`` highest values per sample and
average the rest."""

import torch

from rlx_tpu_torch.algorithms.sac_ensembles import EnsembleSAC


class AQE(EnsembleSAC):
    parallel_seeds = True

    def setup_states(self):
        self.nr_dropped = int(self.config.algorithm.nr_dropped_q_values)
        super().setup_states()

    def _drop_highest_mean(self, q):
        return torch.sort(q, dim=0).values[:q.shape[0] - self.nr_dropped].mean(dim=0)

    def target_q_aggregate(self, next_q, subset=None):
        return self._drop_highest_mean(next_q)

    def policy_q_aggregate(self, q_pi):
        return self._drop_highest_mean(q_pi)
