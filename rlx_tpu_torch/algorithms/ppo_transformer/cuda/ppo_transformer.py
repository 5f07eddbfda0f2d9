"""PPO with a sliding-window transformer memory (the JAX package's ``ppo_transformer.tpu``; the
mechanics are in ``algorithms/recurrent_ppo.py``, the cell in
``models/recurrent.py``)."""

from rlx_tpu_torch.algorithms.ppo_transformer.cuda.general_properties import GeneralProperties
from rlx_tpu_torch.algorithms.recurrent_ppo import RecurrentPPO


class PPOTransformer(RecurrentPPO):
    cell_type = "transformer"

    def general_properties():
        return GeneralProperties
