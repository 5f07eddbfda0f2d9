"""Batched rigid-body physics in PyTorch (batch-last ``[comp..., B]``).

``model.py`` holds the static ``PhysicsModel`` (MJCF compiled through the
MuJoCo bindings, or read from a saved ``.npz``); ``engine.py`` steps it.
"""

from rlx_tpu_torch.physics.model import PhysicsModel, load_mjcf, load_model, save_model  # noqa: F401
from rlx_tpu_torch.physics.engine import DomainParams, Terrain, forward_dynamics, step, step_reference  # noqa: F401
