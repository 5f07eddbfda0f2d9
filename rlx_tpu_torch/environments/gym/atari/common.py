"""Registration helper for ALE Atari host environments.

Each game registers a ``HostGymEnv`` built from the wrapped Atari stack
(``wrappers.wrap_atari``), emitting ``[84, 84, 4]`` uint8 observations
across the host edge (the reference's per-game layout,
`rl_x/environments/gym/atari/pong_v5/create_env.py:1-51`).

``ale_py`` is on neither machine this port runs on, so env CREATION is
gated: the config and the registration always work, and
``create_train_and_eval_env`` raises an ``ImportError`` naming ``ale_py``
when it is missing.  The wrapper stack is tested with a fake ALE env.
"""

from rlx_tpu_torch.environments.gym.host_bridge import HostGymEnv
from rlx_tpu_torch.environments.types import (
    ActionSpaceType,
    DataInterfaceType,
    ObservationSpaceType,
    SimulationType,
)
from rlx_tpu_torch.utils.config_dict import ConfigDict


def make_atari_registration(game_type, nr_envs=8):
    def get_config(environment_name):
        return ConfigDict(
            name=environment_name,
            type=game_type,  # ALE suffix, e.g. "Pong-v5"
            seed=1,
            nr_envs=nr_envs,
            async_workers=0,
            async_skip_percentage=0.0,
            noop_max=30,
            frame_skip=4,
            frame_stack=4,
            screen_size=84,
            episodic_life=True,
            clip_reward=True,
            render=False,  # the JAX package's key; nothing reads it
        )

    def _make_env_fn(cfg):
        def thunk():
            import gymnasium as gym

            try:
                import ale_py
            except ImportError as e:
                raise ImportError(
                    "Atari environments need ale_py, which is not installed. The wrapper "
                    "stack is ready; install ale_py to enable ALE games."
                ) from e
            gym.register_envs(ale_py)

            from rlx_tpu_torch.environments.gym.atari.wrappers import wrap_atari

            return wrap_atari(
                gym.make(f"ALE/{cfg.type}"),
                noop_max=cfg.noop_max,
                skip=cfg.frame_skip,
                screen_size=cfg.screen_size,
                nr_frames=cfg.frame_stack,
                clip_reward=cfg.clip_reward,
                episodic_life=cfg.episodic_life,
            )
        return thunk

    def create_train_and_eval_env(config):
        cfg, device = config.environment, config.runner.device
        train_env = HostGymEnv(
            f"ALE/{cfg.type}", cfg.nr_envs, seed=cfg.seed,
            env_fns=[_make_env_fn(cfg)] * cfg.nr_envs,
            async_workers=cfg.async_workers,
            async_skip_percentage=cfg.async_skip_percentage, device=device,
            first_env=cfg.get("first_env", 0),
        )
        eval_env = HostGymEnv(
            f"ALE/{cfg.type}", cfg.nr_envs, seed=cfg.seed + 10_000,
            env_fns=[_make_env_fn(cfg)] * cfg.nr_envs, device=device,
            first_env=cfg.get("first_env", 0),
        )
        for env in (train_env, eval_env):
            env.general_properties = general_properties
            env.horizon = 108_000 // max(cfg.frame_skip, 1)  # ALE cap
        return train_env, eval_env

    class general_properties:  # noqa: N801 - instance-like class record
        action_space_type = ActionSpaceType.DISCRETE
        observation_space_type = ObservationSpaceType.IMAGES
        data_interface_type = DataInterfaceType.TORCH
        simulation_type = SimulationType.HOST

    return get_config, create_train_and_eval_env, general_properties
