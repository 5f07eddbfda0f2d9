"""RoboCup soccer locomotion (the JAX package's ``soccer/tpu/environment.py``):
the robot locomotion env with four deltas, carried by ``LocomotionEnv``'s
variant hooks:

- a sinusoidal gait-phase manager (``gait.py``): two foot oscillators in
  the internal state, advanced once a control step and resampled (offset
  and frequency) per episode under the curriculum;
- 4 phase features (sin / cos of both foot phases) appended to both the
  policy's and the critic's observation index sets;
- the soccer reward's feet_flat / feet_phase / feet_yaw terms
  (``rewards.py``);
- the soccer profile (``default_config.py``): the Booster T1 on the plane,
  reduced randomization ranges and a fixed one-control-step action delay.
"""

from rlx_tpu_torch.environments.locomotion.robot.cuda.environment import LocomotionEnv
from rlx_tpu_torch.environments.locomotion.robot.cuda.rewards import REWARD_FUNCTIONS
from rlx_tpu_torch.environments.locomotion.soccer.cuda.gait import GaitManager
from rlx_tpu_torch.environments.locomotion.soccer.cuda.rewards import SoccerReward

REWARD_FUNCTIONS.setdefault("soccer", SoccerReward)


class SoccerEnv(LocomotionEnv):
    def __init__(self, env_config, nr_envs, device="cuda"):
        # the base constructor builds the observation layout, which only
        # counts the gait features; the manager itself needs env.dt
        self.gait_manager = None
        super().__init__(env_config, nr_envs, device=device)
        self.gait_manager = GaitManager(self, env_config["gait_manager"])

    def nr_extra_observations(self):
        return 4  # sin / cos of two foot phases

    def extra_observation(self, internal):
        return self.gait_manager.phase_features(internal)

    def extra_internal_init(self, nr_envs):
        return self.gait_manager.init_state(nr_envs)

    def extra_episode_start(self, internal, mask, draws, eval_mode):
        return self.gait_manager.episode_start(internal, mask, draws, eval_mode)

    def internal_step_update(self, internal):
        return self.gait_manager.step(internal)

    def reward_function_info_keys(self):
        return super().reward_function_info_keys() + ["reward/feet_flat", "reward/feet_phase", "reward/feet_yaw"]
