"""PPO with a LSTM memory (the JAX package's ``ppo_lstm.tpu``; the
mechanics are in ``algorithms/recurrent_ppo.py``, the cell in
``models/recurrent.py``)."""

from rlx_tpu_torch.algorithms.ppo_lstm.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.recurrent_ppo import RecurrentPPO


class PPOLSTM(RecurrentPPO):
    cell_type = "lstm"

    def general_properties():
        return GeneralProperties
