"""Carry weights from the JAX package's flax parameters to the port.

The input is a flax parameter tree as nested dicts of numpy arrays
(``policy_state.params`` / ``critic_state.params``, with or without the
outer ``"params"`` key).  Dense kernels are stored ``[in, out]`` by flax and
``[out, in]`` by ``nn.Linear``, so they are transposed; LayerNorm
``scale``/``bias`` become ``weight``/``bias``.  The ``nn.vmap``-ed critic
ensemble keeps every leaf stacked on a leading critic axis, which the
port's ``VectorQCritic`` keeps too; the single ``QCritic`` of DDPG is not
vmapped in flax, and its leaves gain a leading axis of 1 here.

``checkpoint_tree_from_jax`` turns the parameter tree of a JAX
``latest.model`` / ``best.model`` (as the JAX package's
``utils/checkpoint.load_model_file`` returns it) into the port's checkpoint
tree.  Optimizer state is not carried across: a JAX checkpoint written with
``save_optimizer_state`` raises.
"""

from collections.abc import Mapping

import numpy as np
import torch


def _unwrap(params):
    return params["params"] if "params" in params else params


def _dense(prefix, p):
    return {
        f"{prefix}.weight": torch.as_tensor(np.asarray(p["kernel"], np.float32).T.copy()),
        f"{prefix}.bias": torch.as_tensor(np.asarray(p["bias"], np.float32).copy()),
    }


def _layer_norm(prefix, p):
    return {
        f"{prefix}.weight": torch.as_tensor(np.asarray(p["scale"], np.float32).copy()),
        f"{prefix}.bias": torch.as_tensor(np.asarray(p["bias"], np.float32).copy()),
    }


def _mlp(p, layer_norm_all=False):
    """``MLP`` trunk: ``trunk.norm`` for the first Dense's LayerNorm, or with
    ``layer_norm_all`` ``trunk.norms.<i>`` for every Dense's."""
    out = {}
    n_dense = sum(1 for k in p if k.startswith("Dense_"))
    for i in range(n_dense):
        out.update(_dense(f"trunk.layers.{i}", p[f"Dense_{i}"]))
        if layer_norm_all:
            out.update(_layer_norm(f"trunk.norms.{i}", p[f"LayerNorm_{i}"]))
    if not layer_norm_all and "LayerNorm_0" in p:
        out.update(_layer_norm("trunk.norm", p["LayerNorm_0"]))
    return out


def policy_state_dict(flax_params):
    """``GaussianPolicy`` state_dict from flax ``GaussianPolicy`` params."""
    p = _unwrap(flax_params)
    out = _mlp(p["MLP_0"])
    out.update(_dense("mean", p["Dense_0"]))
    out["policy_logstd"] = torch.as_tensor(np.asarray(p["policy_logstd"], np.float32).copy())
    return out


def categorical_policy_state_dict(flax_params):
    """``CategoricalPolicy`` state_dict from flax ``CategoricalPolicy`` params."""
    p = _unwrap(flax_params)
    out = _mlp(p["MLP_0"])
    out.update(_dense("logits", p["Dense_0"]))
    return out


def discrete_q_net_state_dict(flax_params, layer_norm_all=False):
    """``DiscreteQNet`` state_dict from flax ``DiscreteQNet`` params (flat
    observations; any number of outputs per action; ``layer_norm_all`` as
    the net was built, PQN's)."""
    p = _unwrap(flax_params)
    out = _mlp(p["MLP_0"], layer_norm_all)
    out.update(_dense("head", p["Dense_0"]))
    return out


def critic_state_dict(flax_params):
    """``VCritic`` state_dict from flax ``VCritic`` params."""
    p = _unwrap(flax_params)
    out = _mlp(p["MLP_0"])
    out.update(_dense("value", p["Dense_0"]))
    return out


def deterministic_policy_state_dict(flax_params):
    """``DeterministicTanhPolicy`` state_dict from flax ``DeterministicTanhPolicy`` params."""
    p = _unwrap(flax_params)
    out = _mlp(p["MLP_0"])
    out.update(_dense("head", p["Dense_0"]))
    return out


def squashed_gaussian_policy_state_dict(flax_params):
    """``SquashedGaussianPolicy`` state_dict from flax ``SquashedGaussianPolicy``
    params (``Dense_0`` the mean head, ``Dense_1`` the log-std head)."""
    p = _unwrap(flax_params)
    out = _mlp(p["MLP_0"])
    out.update(_dense("mean", p["Dense_0"]))
    out.update(_dense("log_std", p["Dense_1"]))
    return out


def entropy_coefficient_state_dict(flax_params):
    """``EntropyCoefficient`` state_dict from flax ``EntropyCoefficient`` params."""
    return {"log_alpha": torch.as_tensor(np.asarray(_unwrap(flax_params)["log_alpha"], np.float32).copy())}


def _batched_dense(prefix, p):
    return {
        f"{prefix}.weight": torch.as_tensor(np.swapaxes(np.asarray(p["kernel"], np.float32), 1, 2).copy()),
        f"{prefix}.bias": torch.as_tensor(np.asarray(p["bias"], np.float32).copy()),
    }


def _q_critic_ensemble(p):
    mlp = p["MLP_0"]
    out = {}
    for i in range(sum(1 for k in mlp if k.startswith("Dense_"))):
        out.update(_batched_dense(f"layers.{i}", mlp[f"Dense_{i}"]))
    if "LayerNorm_0" in mlp:
        out["norm_weight"] = torch.as_tensor(np.asarray(mlp["LayerNorm_0"]["scale"], np.float32).copy())
        out["norm_bias"] = torch.as_tensor(np.asarray(mlp["LayerNorm_0"]["bias"], np.float32).copy())
    out.update(_batched_dense("head", p["Dense_0"]))
    return out


def vector_q_critic_state_dict(flax_params):
    """``VectorQCritic`` state_dict from flax ``VectorQCritic`` params
    (``VmapQCritic_0`` with leaves ``[nr_critics, ...]``)."""
    return _q_critic_ensemble(_unwrap(flax_params)["VmapQCritic_0"])


def _add_leading_axis(tree):
    return {k: _add_leading_axis(v) if isinstance(v, Mapping) else np.asarray(v)[None]
            for k, v in tree.items()}


def q_critic_state_dict(flax_params):
    """``QCritic`` state_dict from flax ``QCritic`` params (``MLP_0`` and
    ``Dense_0`` with kernels ``[in, out]``, no critic axis): the port's
    ``QCritic`` is an ensemble of one."""
    return _q_critic_ensemble(_add_leading_axis(_unwrap(flax_params)))


def checkpoint_tree_from_jax(algorithm, restored):
    """The port's checkpoint tree (``utils/checkpoint.py``) for ``"ppo"``
    (a ``GaussianPolicy``, or without ``policy_logstd`` a
    ``CategoricalPolicy``), ``"fasttd3"``,
    ``"sac"``, ``"td3"``, ``"ddpg"``, ``"dqn"``, ``"ddqn"``, ``"c51"``,
    ``"dqn_hl_gauss"`` or ``"pqn"`` from a JAX checkpoint's parameter tree."""
    if "full" in restored:
        raise ValueError("a JAX checkpoint with optimizer state: only parameters are carried across")
    if algorithm == "ppo":
        continuous = "policy_logstd" in _unwrap(restored["policy"])
        policy = policy_state_dict if continuous else categorical_policy_state_dict
        return {"policy": policy(restored["policy"]),
                "critic": critic_state_dict(restored["critic"])}
    if algorithm in ("dqn", "ddqn", "c51", "dqn_hl_gauss"):
        return {"critic": discrete_q_net_state_dict(restored["critic"]),
                "critic_target": discrete_q_net_state_dict(restored["critic_target"])}
    if algorithm == "pqn":
        return {"critic": discrete_q_net_state_dict(restored["critic"], layer_norm_all=True)}
    if algorithm == "fasttd3":
        return {
            "policy": deterministic_policy_state_dict(restored["policy"]),
            "policy_target": deterministic_policy_state_dict(restored["policy_target"]),
            "critic": vector_q_critic_state_dict(restored["critic"]),
            "critic_target": vector_q_critic_state_dict(restored["critic_target"]),
            "obs_normalizer": {k: torch.as_tensor(np.asarray(v, np.float32).copy())
                               for k, v in restored["obs_normalizer"].items()},
        }
    if algorithm == "sac":
        return {
            "policy": squashed_gaussian_policy_state_dict(restored["policy"]),
            "critic": vector_q_critic_state_dict(restored["critic"]),
            "critic_target": vector_q_critic_state_dict(restored["critic_target"]),
            "alpha": entropy_coefficient_state_dict(restored["alpha"]),
        }
    if algorithm in ("td3", "ddpg"):
        critic = vector_q_critic_state_dict if algorithm == "td3" else q_critic_state_dict
        return {
            "policy": deterministic_policy_state_dict(restored["policy"]),
            "policy_target": deterministic_policy_state_dict(restored["policy_target"]),
            "critic": critic(restored["critic"]),
            "critic_target": critic(restored["critic_target"]),
        }
    raise ValueError(f"no checkpoint conversion for {algorithm!r}")
