"""Atari preprocessing stack for host-bridged ALE environments.

The reference's SB3-derived wrapper semantics
(`rl_x/environments/gym/atari/pong_v5/wrappers.py:66-171`) against the
Gymnasium 1.x API, with the JAX package's layout: frames are stacked
CHANNELS-LAST into an ``[84, 84, 4]`` uint8 observation (the reference
emits channels-first ``[4, 84, 84]`` LazyFrames).  That is the layout of
the port's pixel envs, which NatureCNN reads (``models/mlp.py``), and uint8
over the host edge quarters the bytes of the copy up; the network turns
the frames into floats on the device.

The stack (outermost last), mirroring the reference's ``create_env.py``:
raw ALE -> EpisodeStatistics -> NoopReset -> MaxAndSkip(4) -> EpisodicLife
-> FireReset (if FIRE in action meanings) -> ClipReward -> Resize(84)
-> Grayscale -> ChannelsLastFrameStack(4).

ale_py is not required to import this module; only the env factory of
``atari/common.py`` needs it, so the wrappers stay testable with a fake
ALE env.
"""

import collections

import gymnasium as gym
import numpy as np


class EpisodeStatistics(gym.Wrapper):
    """Track RAW episode return/length (before reward clipping, frame
    skipping, and episodic-life terminations) and surface them in ``info``
    on real episode end — the reference applies RecordEpisodeStatistics at
    the same (innermost) level (`create_env.py:14`) for the same reason.
    """

    def reset(self, **kwargs):
        self._episode_return = 0.0
        self._episode_length = 0
        return self.env.reset(**kwargs)

    def step(self, action):
        observation, reward, terminated, truncated, info = self.env.step(action)
        self._episode_return += float(reward)
        self._episode_length += 1
        if terminated or truncated:
            info["episode_return"] = self._episode_return
            info["episode_length"] = self._episode_length
            self._episode_return = 0.0
            self._episode_length = 0
        return observation, reward, terminated, truncated, info


class NoopResetEnv(gym.Wrapper):
    """Randomize the initial state with 1..noop_max NOOP steps on reset
    (semantics of the reference `wrappers.py:66-88`)."""

    def __init__(self, env, noop_max=30):
        super().__init__(env)
        self.noop_max = noop_max
        self.noop_action = 0
        assert env.unwrapped.get_action_meanings()[0] == "NOOP"

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        noops = int(self.unwrapped.np_random.integers(1, self.noop_max + 1))
        for _ in range(noops):
            obs, _, terminated, truncated, info = self.env.step(self.noop_action)
            if terminated or truncated:
                obs, info = self.env.reset(**kwargs)
        return obs, info


class FireResetEnv(gym.Wrapper):
    """Press FIRE (and action 2) after reset for games that need it to start
    (semantics of the reference `wrappers.py:91-103`)."""

    def __init__(self, env):
        super().__init__(env)
        meanings = env.unwrapped.get_action_meanings()
        assert meanings[1] == "FIRE" and len(meanings) >= 3

    def reset(self, **kwargs):
        self.env.reset(**kwargs)
        obs, _, terminated, truncated, _ = self.env.step(1)
        if terminated or truncated:
            self.env.reset(**kwargs)
        obs, _, terminated, truncated, _ = self.env.step(2)
        if terminated or truncated:
            obs, _ = self.env.reset(**kwargs)
        return obs, {}


class EpisodicLifeEnv(gym.Wrapper):
    """Signal termination on each life loss (value bootstrapping sees
    per-life episodes) but only truly reset when the game is over
    (semantics of the reference `wrappers.py:106-135`)."""

    def __init__(self, env):
        super().__init__(env)
        self.lives = 0
        self.was_real_done = True

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.was_real_done = terminated or truncated
        lives = self.env.unwrapped.ale.lives()
        if 0 < lives < self.lives:
            terminated = True
        self.lives = lives
        return obs, reward, terminated, truncated, info

    def reset(self, **kwargs):
        if self.was_real_done:
            obs, info = self.env.reset(**kwargs)
        else:
            # continue from the current state; a NOOP advances past the
            # life-loss frame
            obs, _, terminated, truncated, info = self.env.step(0)
            if terminated or truncated:
                obs, info = self.env.reset(**kwargs)
        self.lives = self.env.unwrapped.ale.lives()
        return obs, info


class MaxAndSkipEnv(gym.Wrapper):
    """Repeat each action ``skip`` frames, sum the rewards, and return the
    pixelwise max of the last two frames (ALE flicker removal; semantics of
    the reference `wrappers.py:138-160`)."""

    def __init__(self, env, skip=4):
        super().__init__(env)
        shape = env.observation_space.shape
        dtype = env.observation_space.dtype
        self._frame_pair = np.zeros((2,) + tuple(shape), dtype=dtype)
        self._skip = skip

    def step(self, action):
        total_reward = 0.0
        terminated = truncated = False
        info = {}
        for i in range(self._skip):
            obs, reward, terminated, truncated, info = self.env.step(action)
            if i >= self._skip - 2:
                self._frame_pair[i - (self._skip - 2)] = obs
            total_reward += float(reward)
            if terminated or truncated:
                break
        return self._frame_pair.max(axis=0), total_reward, terminated, truncated, info


class ClipRewardEnv(gym.RewardWrapper):
    """sign(reward) clipping (reference `wrappers.py:163-171`)."""

    def reward(self, reward):
        return float(np.sign(float(reward)))


class ChannelsLastFrameStack(gym.ObservationWrapper):
    """Stack the last ``nr_frames`` grayscale frames into the CHANNEL axis:
    [H, W] or [H, W, 1] frames -> [H, W, nr_frames] uint8.

    Replacement for the reference's channels-first LazyFrames stack
    (`create_env.py:21`): NHWC is the pixel track's layout, and a dense
    uint8 copy beats lazy views when the whole batch crosses the host edge
    in one copy anyway.
    """

    def __init__(self, env, nr_frames=4):
        super().__init__(env)
        self.nr_frames = nr_frames
        shape = env.observation_space.shape
        if len(shape) == 3 and shape[-1] == 1:
            shape = shape[:2]
        assert len(shape) == 2, f"expected grayscale frames, got shape {shape}"
        self._frame_shape = shape
        self._frames = collections.deque(maxlen=nr_frames)
        self.observation_space = gym.spaces.Box(
            low=0, high=255, shape=shape + (nr_frames,), dtype=np.uint8
        )

    def reset(self, **kwargs):
        obs, info = self.env.reset(**kwargs)
        frame = self._squeeze(obs)
        for _ in range(self.nr_frames):
            self._frames.append(frame)
        return self.observation(obs), info

    def observation(self, obs):
        return np.stack(list(self._frames), axis=-1)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self._frames.append(self._squeeze(obs))
        return self.observation(obs), reward, terminated, truncated, info

    def _squeeze(self, obs):
        obs = np.asarray(obs, dtype=np.uint8)
        if obs.ndim == 3 and obs.shape[-1] == 1:
            obs = obs[..., 0]
        return obs


def wrap_atari(env, noop_max=30, skip=4, screen_size=84, nr_frames=4,
               clip_reward=True, episodic_life=True):
    """Compose the full Atari preprocessing stack on a raw ALE env
    (reference `create_env.py:11-24`).  Returns an env emitting
    [screen_size, screen_size, nr_frames] uint8 observations.
    """
    env = EpisodeStatistics(env)
    env = NoopResetEnv(env, noop_max=noop_max)
    if skip > 1:
        env = MaxAndSkipEnv(env, skip=skip)
    if episodic_life:
        env = EpisodicLifeEnv(env)
    if "FIRE" in env.unwrapped.get_action_meanings():
        env = FireResetEnv(env)
    if clip_reward:
        env = ClipRewardEnv(env)
    env = gym.wrappers.ResizeObservation(env, (screen_size, screen_size))
    env = gym.wrappers.GrayscaleObservation(env)
    env = ChannelsLastFrameStack(env, nr_frames=nr_frames)
    return env
