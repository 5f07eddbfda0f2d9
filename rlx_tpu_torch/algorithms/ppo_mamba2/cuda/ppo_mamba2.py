"""PPO with a Mamba-2 memory (the JAX package's ``ppo_mamba2.tpu``; the
mechanics are in ``algorithms/recurrent_ppo.py``, the cell in
``models/recurrent.py``)."""

from rlx_tpu_torch.algorithms.ppo_mamba2.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.recurrent_ppo import RecurrentPPO


class PPOMamba2(RecurrentPPO):
    cell_type = "mamba2"

    def general_properties():
        return GeneralProperties
