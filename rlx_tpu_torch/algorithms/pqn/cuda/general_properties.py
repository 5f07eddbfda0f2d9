from rlx_tpu_torch.environments.types import (
    ActionSpaceType,
    DataInterfaceType,
    DeepLearningFrameworkType,
    ObservationSpaceType,
)


class GeneralProperties:
    observation_space_types = [ObservationSpaceType.FLAT_VALUES, ObservationSpaceType.IMAGES]
    action_space_types = [ActionSpaceType.DISCRETE]
    data_interface_types = [DataInterfaceType.TORCH]

    deep_learning_framework_type = DeepLearningFrameworkType.TORCH
