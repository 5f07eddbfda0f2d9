"""Capability typing enums for algorithm/environment matching."""

from enum import Enum


class ActionSpaceType(Enum):
    CONTINUOUS = 0
    DISCRETE = 1


class ObservationSpaceType(Enum):
    FLAT_VALUES = 0
    IMAGES = 1


class DataInterfaceType(Enum):
    """How observations/actions cross the algorithm<->environment boundary.

    TORCH  — tensors on the env's device (``runner.device``), whether the
             env steps there or on the host behind a numpy<->torch edge.
    """

    TORCH = 0


class SimulationType(Enum):
    """Where the simulation runs.

    DEVICE — a torch env stepped on the training device.
    HOST   — stepped on the host CPU (C++, Gymnasium, dm_control, a socket);
             ``environments/gym/host_bridge.py`` carries each step's results
             to the training device.
    """

    DEVICE = 0
    HOST = 1


class DeepLearningFrameworkType(Enum):
    TORCH = 0
