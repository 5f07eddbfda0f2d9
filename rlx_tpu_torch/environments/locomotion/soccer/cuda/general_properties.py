from rlx_tpu_torch.environments.types import (
    ActionSpaceType,
    DataInterfaceType,
    ObservationSpaceType,
    SimulationType,
)


class GeneralProperties:
    action_space_type = ActionSpaceType.CONTINUOUS
    observation_space_type = ObservationSpaceType.FLAT_VALUES
    data_interface_type = DataInterfaceType.TORCH
    simulation_type = SimulationType.DEVICE
