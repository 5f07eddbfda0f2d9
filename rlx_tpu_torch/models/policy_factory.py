"""Policy adapter: one actor-critic codepath for continuous and discrete
actions over flat or image observations (an IMAGES env gets ``NatureCNN``
encoders, as the JAX package's ``vision`` nets)."""

import math
from typing import Callable, NamedTuple

import torch

from rlx_tpu_torch.environments.types import ActionSpaceType, ObservationSpaceType
from rlx_tpu_torch.models import distributions as D
from rlx_tpu_torch.models.mlp import (
    CategoricalPolicy,
    GaussianPolicy,
    VCritic,
    observation_width,
    select_observations,
)


def compute_dtype(config):
    """Trunk compute dtype from ``algorithm.compute_dtype`` (None = f32; as
    in the JAX package, a config without the key, such as the PPO variants',
    runs in f32)."""
    return torch.bfloat16 if config.algorithm.get("compute_dtype") == "bfloat16" else None


class PolicyAdapter(NamedTuple):
    module: torch.nn.Module
    sample_and_log_prob: Callable  # (obs, generator=None, noise=None) -> (action, log_prob)
    log_prob_entropy: Callable     # (obs, action) -> (log_prob, entropy)
    mode: Callable                 # obs -> deterministic action
    process_action: Callable       # raw action -> env action


def image_shape(env):
    """The ``[H, W, C]`` shape of an IMAGES env's observations, else None."""
    if env.general_properties.observation_space_type == ObservationSpaceType.IMAGES:
        return tuple(env.single_observation_space.shape)
    return None


def make_policy(config, env, device):
    """The env's ``policy_observation_indices``, where it has them, pick the
    columns the policy reads."""
    a = config.algorithm
    indices = getattr(env, "policy_observation_indices", None)
    obs_dim = observation_width(env.single_observation_space.shape, indices)
    if env.general_properties.action_space_type == ActionSpaceType.DISCRETE:
        return _categorical_policy(config, env, obs_dim, indices, device)
    action_dim = math.prod(env.single_action_space.shape)
    module = select_observations(GaussianPolicy(
        obs_dim, action_dim, tuple(a.policy_hidden_sizes), a.activation, a.layer_norm,
        a.std_dev, compute_dtype(config), image_shape(env),
    ), indices).to(device)

    if a.action_clipping_and_rescaling:
        low, high = env.single_action_space.low, env.single_action_space.high

        def process_action(action):
            clipped = torch.clamp(action, -1.0, 1.0)
            return low + 0.5 * (clipped + 1.0) * (high - low)
    else:
        def process_action(action):
            return action

    def sample_and_log_prob(obs, generator=None, noise=None):
        mean, logstd = module(obs)
        action = D.gaussian_sample(mean, logstd, generator, noise)
        return action, D.gaussian_log_prob(mean, logstd, action)

    def log_prob_entropy(obs, action):
        mean, logstd = module(obs)
        log_prob = D.gaussian_log_prob(mean, logstd, action)
        return log_prob, D.gaussian_entropy(logstd).expand(log_prob.shape)

    def mode(obs):
        return module(obs)[0]

    return PolicyAdapter(module, sample_and_log_prob, log_prob_entropy, mode, process_action)


def _categorical_policy(config, env, obs_dim, indices, device):
    """Logits over the env's discrete actions; actions go to the env as they
    are and the deterministic action is the argmax."""
    a = config.algorithm
    module = select_observations(CategoricalPolicy(
        obs_dim, env.single_action_space.n, tuple(a.policy_hidden_sizes), a.activation, a.layer_norm,
        compute_dtype(config), image_shape(env),
    ), indices).to(device)

    def sample_and_log_prob(obs, generator=None, noise=None):
        logits = module(obs)
        action = D.categorical_sample(logits, generator, noise)
        return action, D.categorical_log_prob(logits, action)

    def log_prob_entropy(obs, action):
        logits = module(obs)
        return D.categorical_log_prob(logits, action), D.categorical_entropy(logits)

    def mode(obs):
        return torch.argmax(module(obs), dim=-1).to(torch.int32)

    return PolicyAdapter(module, sample_and_log_prob, log_prob_entropy, mode, lambda action: action)


def make_critic(config, env, device):
    """The env's ``critic_observation_indices``, where it has them, pick the
    columns the critic reads."""
    a = config.algorithm
    indices = getattr(env, "critic_observation_indices", None)
    return select_observations(VCritic(
        observation_width(env.single_observation_space.shape, indices), tuple(a.critic_hidden_sizes),
        a.activation, a.layer_norm, compute_dtype(config), image_shape(env),
    ), indices).to(device)
