"""Soccer env defaults: every key and value of the JAX package's
``locomotion.soccer.tpu``, the robot locomotion defaults with the soccer
deltas: the Booster T1, a gait-manager block, the plane, reduced
randomization, noise and perturbation ranges, the soccer reward's foot
coefficients, and a fixed one-control-step (20 ms) action delay
(``min_delay_s == max_delay_s``)."""

from rlx_tpu_torch.environments.locomotion.robot.cuda.default_config import get_config as get_base_config
from rlx_tpu_torch.environments.locomotion.robot.cuda.default_config import nested_config


def get_config(environment_name):
    config = get_base_config(environment_name).to_dict()
    config["name"] = environment_name
    config["robot"] = "booster_t1"

    config["gait_manager"] = {
        "type": "default",
        "gait_period": 1.0,
        "gait_period_randomization_width": 0.1,
    }

    dr = config["domain_randomization"]
    dr["action_delay"]["min_delay_s"] = 0.02   # fixed 20 ms (1 control step)
    dr["action_delay"]["max_delay_s"] = 0.02
    dr["initial_state"]["joint_velocity_max_factor"] = 0.1
    dr["joint_dropout"]["dropout_open_chance"] = 0.0
    dr["joint_dropout"]["dropout_lock_chance"] = 0.0
    dr["observation_noise"].update({
        "joint_velocity": 0.5,
        "imu_angular_velocity": 0.1,
        "gravity_vector": 0.02,
        "exteroception": 0.01,
    })
    dr["perturbation"]["max_joint_velocity"] = 0.1
    dr["seen_robot"].update({
        "torque_limit_factor": 0.05,
        "add_actuator_joint_nominal_position": 0.001,
        "joint_velocity_max_factor": 0.05,
        "add_joint_range": 0.01,
        "joint_damping_factor": 0.1,
        "joint_armature_factor": 0.1,
        "joint_friction_loss_factor": 0.1,
    })
    dr["unseen_robot"].update({
        "joint_damping_factor": 0.0,
        "position_offset": 0.02,
    })

    config["reward"].update({
        "type": "soccer",
        "feet_flat_coeff": 3.0,
        "feet_phase_coeff": 1.0,
        "feet_phase_swing_height": 0.12,
        "feet_phase_tracking_sigma": 0.1,
        "feet_height_on_flat_ground": 0.01,
        "feet_yaw_coeff": 5.0,
    })

    config["terrain"] = {"type": "plane"}

    return nested_config(config)
