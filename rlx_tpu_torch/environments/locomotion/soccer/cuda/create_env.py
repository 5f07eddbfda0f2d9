from rlx_tpu_torch.environments.locomotion.robot.cuda.create_env import create_train_and_eval_env as create_robot_env
from rlx_tpu_torch.environments.locomotion.soccer.cuda.environment import SoccerEnv
from rlx_tpu_torch.environments.locomotion.soccer.cuda.general_properties import GeneralProperties


def create_train_and_eval_env(config):
    return create_robot_env(config, SoccerEnv, GeneralProperties)
