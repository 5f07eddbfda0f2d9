"""PPO with a GRU memory (the JAX package's ``ppo_gru.tpu``; the
mechanics are in ``algorithms/recurrent_ppo.py``, the cell in
``models/recurrent.py``)."""

from rlx_tpu_torch.algorithms.ppo_gru.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.recurrent_ppo import RecurrentPPO


class PPOGRU(RecurrentPPO):
    cell_type = "gru"

    def general_properties():
        return GeneralProperties
