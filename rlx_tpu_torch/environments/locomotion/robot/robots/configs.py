"""Robot definition records for the locomotion env family (the JAX
package's ``robots/configs.py``, with this package's paths).

Each robot is an MJCF authored for the engine subset plus the metadata the
env needs (action scaling, joints that should stay near nominal, velocity
limits).  ``model_path`` is the MJCF compiled with
``physics.model.load_mjcf(xml, keyframe="home")`` and saved with
``save_model``: the env reads only that file, so it needs no MuJoCo
bindings.  After editing an XML, regenerate its ``.npz`` with
``python -m rlx_tpu_torch.environments.locomotion.robot.robots.configs``.
"""

import os

_HERE = os.path.dirname(os.path.abspath(__file__))

ROBOT_CONFIGS = {
    "quadruped": {
        "xml_path": os.path.join(_HERE, "quadruped.xml"),
        "model_path": os.path.join(_HERE, "quadruped_model.npz"),
        "scaling_factor": 0.45,
        # hip-roll (abduction) joints stay near nominal (reference:
        # `robots/unitree_go2` actuator_joints_to_stay_near_nominal)
        "actuator_joints_to_stay_near_nominal": [0, 3, 6, 9],
        "actuator_joint_max_velocities": [25.0] * 12,
        "control_frequency_hz": 50,
        # mean of characteristic robot dimensions; scales command velocity
        # and terrain roughness (reference hardcodes 0.5,
        # `robot_locomotion/mjx/environment.py:145`)
        "robot_dimensions_mean": 0.5,
    },
    "biped": {
        "xml_path": os.path.join(_HERE, "biped.xml"),
        "model_path": os.path.join(_HERE, "biped_model.npz"),
        "scaling_factor": 0.35,
        "actuator_joints_to_stay_near_nominal": [0, 5],  # hip-roll joints
        "actuator_joint_max_velocities": [20.0] * 10,
        "control_frequency_hz": 50,
        "robot_dimensions_mean": 0.7,
        # heel+toe spheres form ONE logical foot for gait timers (foot
        # discovery order: L_heel, L_toe, R_heel, R_toe)
        "foot_groups": [[0, 1], [2, 3]],
    },
    "go2": {
        # Unitree Go2: published actuator envelope and metadata from the
        # reference's `robot_locomotion/robots/unitree_go2/robot_config.py`;
        # MJCF authored for the rlx_tpu engine subset.
        "xml_path": os.path.join(_HERE, "unitree_go2.xml"),
        "model_path": os.path.join(_HERE, "unitree_go2_model.npz"),
        "scaling_factor": 0.3,
        "actuator_joints_to_stay_near_nominal": [],
        "actuator_joint_max_velocities": [30.1, 30.1, 15.7] * 4,
        "control_frequency_hz": 50,
        "robot_dimensions_mean": 0.5,
    },
    "g1": {
        # Unitree G1: published actuator envelope and metadata from the
        # reference's `robot_locomotion/robots/unitree_g1/robot_config.py`
        # (ankle-roll, waist and arm joints stay near nominal); MJCF
        # authored for the rlx_tpu engine subset.
        "xml_path": os.path.join(_HERE, "unitree_g1.xml"),
        "model_path": os.path.join(_HERE, "unitree_g1_model.npz"),
        "scaling_factor": 0.5,
        "actuator_joints_to_stay_near_nominal": [
            5, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
            23, 24, 25, 26, 27, 28,
        ],
        "actuator_joint_max_velocities": [
            32.0, 32.0, 32.0, 20.0, 37.0, 37.0,
            32.0, 32.0, 32.0, 20.0, 37.0, 37.0,
            32.0, 37.0, 37.0,
            37.0, 37.0, 37.0, 37.0, 37.0, 22.0, 22.0,
            37.0, 37.0, 37.0, 37.0, 37.0, 22.0, 22.0,
        ],
        "control_frequency_hz": 50,
        "robot_dimensions_mean": 0.7,
        "foot_groups": [[0, 1], [2, 3]],
    },
    "booster_t1": {
        # 23-DoF humanoid in the Booster T1's joint topology and published
        # actuator envelope (reference `robocup_soccer/robots/booster_t1/
        # robot_config.py`: head 2, arms 2x4, waist 1, legs 2x6); the MJCF
        # itself is authored for the rlx_tpu engine subset, not a port of
        # the vendor model.
        "xml_path": os.path.join(_HERE, "booster_t1.xml"),
        "model_path": os.path.join(_HERE, "booster_t1_model.npz"),
        "scaling_factor": 0.5,
        "actuator_joints_to_stay_near_nominal": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
        "actuator_joint_max_velocities": [
            12.56, 12.56,
            18.84, 18.84, 18.84, 18.84,
            18.84, 18.84, 18.84, 18.84,
            10.88,
            12.5, 10.9, 10.9, 11.7, 18.8, 12.4,
            12.5, 10.9, 10.9, 11.7, 18.8, 12.4,
        ],
        "control_frequency_hz": 50,
        "robot_dimensions_mean": 0.7,
        "foot_groups": [[0, 1], [2, 3]],
    },
}


def compile_models():
    """Compile every robot's XML into its ``.npz`` (needs ``mujoco``)."""
    from rlx_tpu_torch.physics.model import load_mjcf, save_model

    for config in ROBOT_CONFIGS.values():
        save_model(load_mjcf(config["xml_path"], keyframe="home"), config["model_path"])


if __name__ == "__main__":
    compile_models()
