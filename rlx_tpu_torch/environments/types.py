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

    TORCH  — tensors on the env's device; the env is stepped in-process.
    """

    TORCH = 0


class SimulationType(Enum):
    DEVICE = 0  # stepped on the training device


class DeepLearningFrameworkType(Enum):
    TORCH = 0
