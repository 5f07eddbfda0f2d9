"""DroQ: dropout Q-functions (the JAX package's ``droq.tpu``): 2 critics
with Dropout(``dropout_rate``) and LayerNorm in every hidden layer
(``VectorQCritic(dropout_rate=...)``), the minimum as target and as the
policy's objective, 20 critic updates per env step."""

from rlx_tpu_torch.algorithms.sac_ensembles import EnsembleSAC


class DroQ(EnsembleSAC):
    parallel_seeds = True
