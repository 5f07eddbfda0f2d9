"""Carry weights from the JAX package's flax parameters to the port.

The input is a flax parameter tree as nested dicts of numpy arrays
(``policy_state.params`` / ``critic_state.params``, with or without the
outer ``"params"`` key).  Dense kernels are stored ``[in, out]`` by flax and
``[out, in]`` by ``nn.Linear``, so they are transposed; LayerNorm
``scale``/``bias`` become ``weight``/``bias``.  The ``nn.vmap``-ed critic
ensemble keeps every leaf stacked on a leading critic axis, which the
port's ``VectorQCritic`` keeps too; the single ``QCritic`` of DDPG is not
vmapped in flax, and its leaves gain a leading axis of 1 here.  The nets
with running statistics (FlashSAC's BatchNorm, CrossQ's BatchRenorm) take
flax's ``batch_stats`` beside the params: ``mean``, ``var`` (and
``steps``) become buffers of the same names.

``checkpoint_tree_from_jax`` turns the parameter tree of a JAX
``latest.model`` / ``best.model`` (as the JAX package's
``utils/checkpoint.load_model_file`` returns it) into the port's checkpoint
tree.  Optimizer state is not carried across: a JAX checkpoint written with
``save_optimizer_state`` raises.

flax ``Conv`` kernels ``[kh, kw, in, out]`` become conv2d weights ``[out,
in, kh, kw]``.  The port's ``NatureCNN`` flattens its last feature map in
flax's (H, W, C) order, so ``Dense_0`` after it is a plain transpose too.
An image net (``vision``) has ``NatureCNN_0`` where a flat one has
``MLP_0``; the converters below take either.

A net that reads an env's ``policy_observation_indices`` or
``critic_observation_indices`` has a first kernel of ``[len(indices),
hidden]`` on both sides, so its parameters map as any other's.

``env_state_from_jax`` turns a JAX env state with a dict physics (the robot
and soccer envs) into the port's ``EnvState``.
"""

from collections.abc import Mapping

import numpy as np
import torch


def _unwrap(params):
    return params["params"] if "params" in params else params


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32).copy())


def _weight(kernel):
    """A flax kernel ``[..., in, out]`` as a weight ``[..., out, in]``."""
    return _f32(np.swapaxes(np.asarray(kernel, np.float32), -1, -2))


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


def nature_cnn_state_dict(flax_params, prefix=""):
    """``NatureCNN`` state_dict from flax ``NatureCNN`` params (``Conv_0..2``
    and ``Dense_0``), its keys under ``prefix``."""
    p = _unwrap(flax_params)
    out = {}
    for i in range(3):
        kernel = np.asarray(p[f"Conv_{i}"]["kernel"], np.float32)
        out[f"{prefix}convs.{i}.weight"] = _f32(kernel.transpose(3, 2, 0, 1))
        out[f"{prefix}convs.{i}.bias"] = _f32(p[f"Conv_{i}"]["bias"])
    out.update(_dense(f"{prefix}dense", p["Dense_0"]))
    return out


def _trunk(p, layer_norm_all=False):
    """The trunk's state: ``NatureCNN_0`` of an image net, else ``MLP_0``."""
    if "NatureCNN_0" in p:
        return nature_cnn_state_dict(p["NatureCNN_0"], "trunk.")
    return _mlp(p["MLP_0"], layer_norm_all)


def policy_state_dict(flax_params):
    """``GaussianPolicy`` state_dict from flax ``GaussianPolicy`` params."""
    p = _unwrap(flax_params)
    out = _trunk(p)
    out.update(_dense("mean", p["Dense_0"]))
    out["policy_logstd"] = torch.as_tensor(np.asarray(p["policy_logstd"], np.float32).copy())
    return out


def categorical_policy_state_dict(flax_params):
    """``CategoricalPolicy`` state_dict from flax ``CategoricalPolicy`` params."""
    p = _unwrap(flax_params)
    out = _trunk(p)
    out.update(_dense("logits", p["Dense_0"]))
    return out


def discrete_q_net_state_dict(flax_params, layer_norm_all=False):
    """``DiscreteQNet`` state_dict from flax ``DiscreteQNet`` params (flat
    or image observations; any number of outputs per action;
    ``layer_norm_all`` as the net was built, PQN's, read by a flat net
    only)."""
    p = _unwrap(flax_params)
    out = _trunk(p, layer_norm_all)
    out.update(_dense("head", p["Dense_0"]))
    return out


def critic_state_dict(flax_params):
    """``VCritic`` state_dict from flax ``VCritic`` params."""
    p = _unwrap(flax_params)
    out = _trunk(p)
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


def _q_critic_ensemble(p, layer_norm_all=False):
    if "MLP_0" not in p:
        return _dropout_q_critic_ensemble(p)
    mlp = p["MLP_0"]
    out = {}
    for i in range(sum(1 for k in mlp if k.startswith("Dense_"))):
        out.update(_batched_dense(f"layers.{i}", mlp[f"Dense_{i}"]))
        if layer_norm_all:
            out[f"norm_weights.{i}"] = _f32(mlp[f"LayerNorm_{i}"]["scale"])
            out[f"norm_biases.{i}"] = _f32(mlp[f"LayerNorm_{i}"]["bias"])
    if not layer_norm_all and "LayerNorm_0" in mlp:
        out["norm_weight"] = torch.as_tensor(np.asarray(mlp["LayerNorm_0"]["scale"], np.float32).copy())
        out["norm_bias"] = torch.as_tensor(np.asarray(mlp["LayerNorm_0"]["bias"], np.float32).copy())
    out.update(_batched_dense("head", p["Dense_0"]))
    return out


def _dropout_q_critic_ensemble(p):
    """DroQ's branch of flax's ``QCritic``: ``Dense_i`` and ``LayerNorm_i``
    per hidden layer, the head the last ``Dense``."""
    n_hidden = sum(1 for k in p if k.startswith("LayerNorm_"))
    out = {}
    for i in range(n_hidden):
        out.update(_batched_dense(f"layers.{i}", p[f"Dense_{i}"]))
        out[f"norm_weights.{i}"] = _f32(p[f"LayerNorm_{i}"]["scale"])
        out[f"norm_biases.{i}"] = _f32(p[f"LayerNorm_{i}"]["bias"])
    out.update(_batched_dense("head", p[f"Dense_{n_hidden}"]))
    return out


def vector_q_critic_state_dict(flax_params, layer_norm_all=False):
    """``VectorQCritic`` state_dict from flax ``VectorQCritic`` params
    (``VmapQCritic_0`` with leaves ``[nr_critics, ...]``); ``layer_norm_all``
    as the net was built (FastMPO's)."""
    return _q_critic_ensemble(_unwrap(flax_params)["VmapQCritic_0"], layer_norm_all)


def _add_leading_axis(tree):
    return {k: _add_leading_axis(v) if isinstance(v, Mapping) else np.asarray(v)[None]
            for k, v in tree.items()}


def q_critic_state_dict(flax_params):
    """``QCritic`` state_dict from flax ``QCritic`` params (``MLP_0`` and
    ``Dense_0`` with kernels ``[in, out]``, no critic axis): the port's
    ``QCritic`` is an ensemble of one."""
    return _q_critic_ensemble(_add_leading_axis(_unwrap(flax_params)))


def _norm_with_stats(prefix, p, stats=None):
    """A BatchNorm / BatchRenorm: ``scale``/``bias`` as ``weight``/``bias``
    and, given its ``batch_stats``, ``mean``, ``var`` (and ``steps``)."""
    out = {f"{prefix}.weight": _f32(p["scale"]), f"{prefix}.bias": _f32(p["bias"])}
    for name, value in (stats or {}).items():
        out[f"{prefix}.{name}"] = torch.as_tensor(np.asarray(value).copy())
    return out


def _flashsac_trunk(prefix, p, stats):
    embedder = p["FlashSACEmbedder_0"]
    out = _norm_with_stats(f"{prefix}.embedder.norm", embedder["BatchNorm_0"],
                           stats["FlashSACEmbedder_0"]["BatchNorm_0"])
    out[f"{prefix}.embedder.linear.weight"] = _weight(embedder["UnitLinear_0"]["kernel"])
    for i in range(sum(1 for k in p if k.startswith("FlashSACBlock_"))):
        block, block_stats = p[f"FlashSACBlock_{i}"], stats[f"FlashSACBlock_{i}"]
        for j in (0, 1):
            out[f"{prefix}.blocks.{i}.linear{j + 1}.weight"] = _weight(block[f"UnitLinear_{j}"]["kernel"])
            out.update(_norm_with_stats(f"{prefix}.blocks.{i}.norm{j + 1}", block[f"BatchNorm_{j}"],
                                        block_stats[f"BatchNorm_{j}"]))
    out[f"{prefix}.norm.weight"] = _f32(p["RMSNorm_0"]["scale"])
    return out


def flashsac_policy_state_dict(flax_params, batch_stats):
    """``FlashSACPolicy`` state_dict (parameters and running statistics)
    from flax ``FlashSACPolicy`` params and ``batch_stats``."""
    p, stats = _unwrap(flax_params), _unwrap_stats(batch_stats)
    out = _flashsac_trunk("trunk", p["FlashSACTrunk_0"], stats["FlashSACTrunk_0"])
    head = p["NormalTanhPolicy_0"]
    for name in ("mean", "std"):
        out[f"head.{name}_weight"] = _weight(head[f"{name}_kernel"])
        out[f"head.{name}_bias"] = _f32(head[f"{name}_bias"])
    return out


def flashsac_critic_state_dict(flax_params, batch_stats):
    """``FlashSACDoubleCritic`` state_dict from flax ``FlashSACDoubleCritic``
    params and ``batch_stats`` (``VmapFlashSACCritic_0``, leaves stacked on
    the critic axis)."""
    p = _unwrap(flax_params)["VmapFlashSACCritic_0"]
    stats = _unwrap_stats(batch_stats)["VmapFlashSACCritic_0"]
    out = _flashsac_trunk("trunk", p["FlashSACTrunk_0"], stats["FlashSACTrunk_0"])
    out["head.weight"] = _weight(p["CategoricalValueHead_0"]["kernel"])
    out["head.bias"] = _f32(p["CategoricalValueHead_0"]["bias"])
    return out


def _linear(prefix, p):
    """A flax ``Dense`` (one, or stacked on a critic axis) as the port's
    ``models.layers.Linear``."""
    return {f"{prefix}.weight": _weight(p["kernel"]), f"{prefix}.bias": _f32(p["bias"])}


def _simba_encoder(prefix, p):
    out = _linear(f"{prefix}.embed", p["Dense_0"])
    for i in range(sum(1 for k in p if k.startswith("PreLNResidualBlock_"))):
        block = p[f"PreLNResidualBlock_{i}"]
        out.update(_layer_norm(f"{prefix}.blocks.{i}.norm", block["LayerNorm_0"]))
        out.update(_linear(f"{prefix}.blocks.{i}.fc1", block["Dense_0"]))
        out.update(_linear(f"{prefix}.blocks.{i}.fc2", block["Dense_1"]))
    out.update(_layer_norm(f"{prefix}.norm", p["LayerNorm_0"]))
    return out


def simba_policy_state_dict(flax_params):
    """``SimbaPolicy`` (``Dense_0`` the mean head, ``Dense_1`` the log-std
    head) or, with heads named ``mean`` / ``log_std``, ``XQCPolicy``."""
    p = _unwrap(flax_params)
    out = _simba_encoder("encoder", p["SimbaEncoder_0"])
    named = "mean" in p
    out.update(_linear("mean", p["mean" if named else "Dense_0"]))
    out.update(_linear("log_std", p["log_std" if named else "Dense_1"]))
    return out


def simba_critic_state_dict(flax_params):
    """``SimbaVectorCritic`` from ``VmapSimbaCritic_0``, or
    ``XQCVectorCritic`` from ``VmapXQCCritic_0`` (its head ``value``)."""
    p = _unwrap(flax_params)
    if "VmapXQCCritic_0" in p:
        p = p["VmapXQCCritic_0"]
        return {**_simba_encoder("encoder", p["SimbaEncoder_0"]), **_linear("value", p["value"])}
    p = p["VmapSimbaCritic_0"]
    return {**_simba_encoder("encoder", p["SimbaEncoder_0"]), **_linear("head", p["Dense_0"])}


def _hyper(prefix, p, dense, scalers):
    out = {f"{prefix}.{name}.weight": _weight(p[key]["kernel"]) for name, key in dense.items()}
    out.update({f"{prefix}.{name}.scaler": _f32(p[key]["scaler"]) for name, key in scalers.items()})
    return out


def _simbav2_encoder(prefix, p):
    out = _hyper(f"{prefix}.embedder", p["HyperEmbedder_0"], {"dense": "HyperDense_0"}, {"scaler": "Scaler_0"})
    for i in range(sum(1 for k in p if k.startswith("HyperLERPBlock_"))):
        out.update(_hyper(f"{prefix}.blocks.{i}", p[f"HyperLERPBlock_{i}"],
                          {"fc1": "HyperDense_0", "fc2": "HyperDense_1"}, {"scaler": "Scaler_0", "alpha": "Scaler_1"}))
    return out


def _hyper_head(prefix, p):
    out = _hyper(prefix, p, {"fc1": "HyperDense_0", "fc2": "HyperDense_1"}, {"scaler": "Scaler_0"})
    out[f"{prefix}.bias"] = _f32(p["bias"])
    return out


def simbav2_policy_state_dict(flax_params):
    """``SimbaV2Policy`` (``HyperHead_0`` the mean, ``HyperHead_1`` the
    log-std) from flax ``SimbaV2Policy`` params."""
    p = _unwrap(flax_params)
    return {**_simbav2_encoder("encoder", p["SimbaV2Encoder_0"]), **_hyper_head("mean", p["HyperHead_0"]),
            **_hyper_head("log_std", p["HyperHead_1"])}


def simbav2_critic_state_dict(flax_params):
    p = _unwrap(flax_params)["VmapSimbaV2Critic_0"]
    return {**_simbav2_encoder("encoder", p["SimbaV2Encoder_0"]), **_hyper_head("head", p["HyperHead_0"])}


def crossq_critic_state_dict(flax_params, batch_stats):
    """``CrossQVectorCritic`` (parameters, running statistics and renorm
    step counts) from flax ``CrossQVectorCritic`` params and ``batch_stats``."""
    p = _unwrap(flax_params)["VmapCrossQCritic_0"]
    stats = _unwrap_stats(batch_stats)["VmapCrossQCritic_0"]
    n_dense = sum(1 for k in p if k.startswith("Dense_"))
    out = {}
    for i in range(n_dense):
        out.update(_norm_with_stats(f"norms.{i}", p[f"BatchRenorm_{i}"], stats[f"BatchRenorm_{i}"]))
    for i in range(n_dense - 1):
        out.update(_linear(f"layers.{i}", p[f"Dense_{i}"]))
    out.update(_linear("head", p[f"Dense_{n_dense - 1}"]))
    return out


def _bronet(prefix, p):
    """A flax ``BroNetEncoder`` (one, or stacked on a critic axis) as the
    port's ``models.layers.BroNetEncoder``."""
    out = {**_linear(f"{prefix}.embed", p["Dense_0"]), **_layer_norm(f"{prefix}.norm", p["LayerNorm_0"])}
    for i in range(sum(1 for k in p if k.startswith("BroNetBlock_"))):
        block = p[f"BroNetBlock_{i}"]
        for j in (0, 1):
            out.update(_linear(f"{prefix}.blocks.{i}.fc{j + 1}", block[f"Dense_{j}"]))
            out.update(_layer_norm(f"{prefix}.blocks.{i}.norm{j + 1}", block[f"LayerNorm_{j}"]))
    return out


def bro_policy_state_dict(flax_params):
    """``BroPolicy`` (``Dense_0`` the mean head, ``Dense_1`` the log-std
    head) from flax ``BroPolicy`` params."""
    p = _unwrap(flax_params)
    return {**_bronet("encoder", p["BroNetEncoder_0"]), **_linear("mean", p["Dense_0"]),
            **_linear("log_std", p["Dense_1"])}


def bro_dual_policy_state_dict(flax_params):
    """``BroDualPolicy`` (the bias-free shift ``Dense_0``) from flax
    ``BroDualPolicy`` params."""
    p = _unwrap(flax_params)
    return {**_bronet("encoder", p["BroNetEncoder_0"]), "shift.weight": _weight(p["Dense_0"]["kernel"])}


def bro_critic_state_dict(flax_params):
    """``BroVectorCritic`` from flax ``BroVectorCritic`` params
    (``VmapBroQuantileCritic_0``, leaves stacked on the critic axis)."""
    p = _unwrap(flax_params)["VmapBroQuantileCritic_0"]
    return {**_bronet("encoder", p["BroNetEncoder_0"]), **_linear("head", p["Dense_0"])}


def adjustment_state_dict(flax_params):
    """BRO's ``Adjustment`` (``raw``) from flax ``Adjustment`` params."""
    return {"raw": _f32(_unwrap(flax_params)["raw"])}


def mpo_policy_state_dict(flax_params, layer_norm_all=False):
    """``MPOGaussianPolicy`` (``Dense_0`` the mean head, ``Dense_1`` the
    std head) from flax ``MPOGaussianPolicy`` params; ``layer_norm_all`` as
    the trunk was built (FastMPO's)."""
    p = _unwrap(flax_params)
    return {**_mlp(p["MLP_0"], layer_norm_all), **_dense("mean", p["Dense_0"]), **_dense("std", p["Dense_1"])}


def dual_variables_state_dict(flax_params):
    """MPO's ``DualVariables`` from flax ``DualVariables`` params."""
    p = _unwrap(flax_params)
    return {name: _f32(p[name]) for name in ("log_eta", "log_alpha_mean", "log_alpha_stddev",
                                             "log_penalty_temperature")}


def reppo_policy_state_dict(flax_params):
    """``ReppoPolicy`` (``Dense_0`` the loc head, ``Dense_1`` the log-std
    head, the two log coefficients) from flax ``ReppoPolicy`` params."""
    p = _unwrap(flax_params)
    return {**_mlp(p["MLP_0"]), **_dense("loc", p["Dense_0"]), **_dense("log_std", p["Dense_1"]),
            "log_entropy_coefficient": _f32(p["log_entropy_coefficient"]),
            "log_kl_coefficient": _f32(p["log_kl_coefficient"])}


def reppo_critic_state_dict(flax_params):
    """``ReppoCritic`` (``Dense_0`` the HL-Gauss logits, ``Dense_1`` the
    next-feature head) from flax ``ReppoCritic`` params."""
    p = _unwrap(flax_params)
    return {**_mlp(p["MLP_0"]), **_dense("logits", p["Dense_0"]), **_dense("predicted_next", p["Dense_1"])}


def _recurrent_cell(p):
    """A flax LSTM (``ii``.. ``ho``), GRU (``ir``.. ``hn``), ``Mamba2Cell``
    or ``TransformerCell`` as the port's cell of ``models/recurrent.py``:
    the per-gate kernels stacked in gate order."""
    gates = lambda names: torch.cat([_weight(p[n]["kernel"]) for n in names])
    if "ii" in p:
        return {"cell.weight_ih": gates(("ii", "if", "ig", "io")), "cell.weight_hh": gates(("hi", "hf", "hg", "ho")),
                "cell.bias_hh": torch.cat([_f32(p[n]["bias"]) for n in ("hi", "hf", "hg", "ho")])}
    if "ir" in p:
        return {"cell.weight_ih": gates(("ir", "iz", "in")),
                "cell.bias_ih": torch.cat([_f32(p[n]["bias"]) for n in ("ir", "iz", "in")]),
                "cell.weight_hh": gates(("hr", "hz", "hn")), "cell.bias_hn": _f32(p["hn"]["bias"])}
    if "A_log" in p:
        out = {**_layer_norm("cell.norm", p["LayerNorm_0"]), **_dense("cell.in_proj", p["Dense_0"]),
               **_dense("cell.x_proj", p["Dense_1"]), **_dense("cell.out_proj", p["Dense_2"])}
        out.update({f"cell.{k}": _f32(p[k]) for k in ("conv_kernel", "conv_bias", "dt_bias", "A_log", "D")})
        return out
    out = {}
    for b in range(len(p)):
        block = p[f"block{b}"]
        for name in ("wq", "wk", "wv", "wo", "mlp1", "mlp2"):
            out.update(_dense(f"cell.blocks.{b}.{name}", block[name]))
        for name in ("ln1", "ln2"):
            out.update(_layer_norm(f"cell.blocks.{b}.{name}", block[name]))
        out[f"cell.blocks.{b}.age_bias"] = _f32(block["age_bias"])
    return out


def recurrent_policy_state_dict(flax_params):
    """``RecurrentPolicy`` state_dict from flax ``RecurrentPolicy`` params
    (any cell, ``concat`` or ``film``, with or without a separate obs
    encoder)."""
    p = _unwrap(flax_params)
    out = _recurrent_cell(p["cell"])
    for name in ("cell_obs_encoder", "obs_encoder", "film_gamma", "film_beta", "torso_dense1", "torso_dense2",
                 "torso_dense3", "mean_head"):
        if name in p:
            out.update(_dense(name, p[name]))
    for name in ("cell_obs_ln", "obs_ln", "cell_ln", "torso_ln1"):
        if name in p:
            out.update(_layer_norm(name, p[name]))
    out["policy_logstd"] = _f32(p["policy_logstd"])
    return out


def _layer_norm_all(flax_params, mlp_path):
    """Whether a flax ``MLP`` has a LayerNorm after more than its first
    Dense (FastMPO's trunks)."""
    p = _unwrap(flax_params)
    for key in mlp_path:
        p = p[key]
    return sum(1 for k in p if k.startswith("LayerNorm_")) > 1


def _unwrap_stats(stats):
    return stats["batch_stats"] if "batch_stats" in stats else stats


def _tensors(tree):
    """A flat dict of arrays (a normalizer's or the noise state) as tensors
    of the arrays' own types."""
    return {k: torch.as_tensor(np.asarray(v).copy()) for k, v in tree.items()}


def checkpoint_tree_from_jax(algorithm, restored):
    """The port's checkpoint tree (``utils/checkpoint.py``) for ``"ppo"``
    (a ``GaussianPolicy``, or without ``policy_logstd`` a
    ``CategoricalPolicy``), ``"fasttd3"``, ``"sac"``, ``"td3"``,
    ``"ddpg"``, ``"dqn"``, ``"ddqn"``, ``"c51"``, ``"dqn_hl_gauss"``,
    ``"pqn"``, ``"fastsac"``, ``"flashsac"``, ``"redq"``, ``"droq"``,
    ``"aqe"``, ``"tqc"``, ``"simba"``, ``"xqc"``, ``"simbav2"``,
    ``"crossq"``, ``"bro"``, ``"mpo"``, ``"fastmpo"``, ``"reppo"`` or the
    recurrent family (``"ppo_lstm"``, ``"ppo_gru"``, ``"ppo_mamba2"``,
    ``"ppo_transformer"``) from a JAX checkpoint's parameter tree.  The JAX checkpoint's
    ``*_batch_stats`` entries go into the nets' state dicts; BRO's
    ``init_copy`` becomes one flat dict ``<net>.<parameter>``; MPO's and
    FastMPO's trunks count as LayerNorm-after-every-Dense when their
    flax ``MLP`` has more than one LayerNorm."""
    if "full" in restored:
        raise ValueError("a JAX checkpoint with optimizer state: only parameters are carried across")
    if algorithm in ("ppo_lstm", "ppo_gru", "ppo_mamba2", "ppo_transformer"):
        return {"policy": recurrent_policy_state_dict(restored["policy"]),
                "critic": critic_state_dict(restored["critic"])}
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
            "obs_normalizer": _tensors(restored["obs_normalizer"]),
        }
    if algorithm in ("sac", "fastsac", "redq", "droq", "aqe", "tqc"):
        tree = {
            "policy": squashed_gaussian_policy_state_dict(restored["policy"]),
            "critic": vector_q_critic_state_dict(restored["critic"]),
            "critic_target": vector_q_critic_state_dict(restored["critic_target"]),
            "alpha": entropy_coefficient_state_dict(restored["alpha"]),
        }
        if algorithm == "fastsac":
            tree["obs_normalizer"] = _tensors(restored["obs_normalizer"])
        return tree
    if algorithm == "flashsac":
        tree = {
            "policy": flashsac_policy_state_dict(restored["policy"], restored["policy_batch_stats"]),
            "critic": flashsac_critic_state_dict(restored["critic"], restored["critic_batch_stats"]),
            "critic_target": flashsac_critic_state_dict(restored["critic_target"],
                                                        restored["critic_target_batch_stats"]),
            "alpha": entropy_coefficient_state_dict(restored["alpha"]),
            "noise": _tensors(restored["noise"]),
        }
        if "reward_normalizer" in restored:
            tree["reward_normalizer"] = _tensors(restored["reward_normalizer"])
        return tree
    if algorithm in ("simba", "xqc", "simbav2"):
        policy, critic = ((simbav2_policy_state_dict, simbav2_critic_state_dict) if algorithm == "simbav2"
                          else (simba_policy_state_dict, simba_critic_state_dict))
        tree = {"policy": policy(restored["policy"]), "critic": critic(restored["critic"]),
                "critic_target": critic(restored["critic_target"]),
                "alpha": entropy_coefficient_state_dict(restored["alpha"])}
        for name in ("obs_normalizer", "reward_normalizer"):
            if name in restored:
                tree[name] = _tensors(restored[name])
        return tree
    if algorithm == "crossq":
        return {"policy": squashed_gaussian_policy_state_dict(restored["policy"]),
                "critic": crossq_critic_state_dict(restored["critic"], restored["critic_batch_stats"]),
                "alpha": entropy_coefficient_state_dict(restored["alpha"])}
    if algorithm == "bro":
        converters = {"policy": bro_policy_state_dict, "critic": bro_critic_state_dict,
                      "optimistic_policy": bro_dual_policy_state_dict}
        return {
            "policy": bro_policy_state_dict(restored["policy"]),
            "critic": bro_critic_state_dict(restored["critic"]),
            "critic_target": bro_critic_state_dict(restored["critic_target"]),
            "alpha": entropy_coefficient_state_dict(restored["alpha"]),
            "optimistic_policy": bro_dual_policy_state_dict(restored["optimistic_policy"]),
            "optimism": adjustment_state_dict(restored["optimism"]),
            "regularizer": adjustment_state_dict(restored["regularizer"]),
            "init_copy": {f"{net}.{k}": v for net, convert in converters.items()
                          for k, v in convert(restored["init_copy"][net]).items()},
        }
    if algorithm in ("mpo", "fastmpo"):
        policy_ln_all = _layer_norm_all(restored["policy"], ("MLP_0",))
        critic_ln_all = _layer_norm_all(restored["critic"], ("VmapQCritic_0", "MLP_0"))
        tree = {
            "policy": mpo_policy_state_dict(restored["policy"], policy_ln_all),
            "policy_target": mpo_policy_state_dict(restored["policy_target"], policy_ln_all),
            "critic": vector_q_critic_state_dict(restored["critic"], critic_ln_all),
            "critic_target": vector_q_critic_state_dict(restored["critic_target"], critic_ln_all),
            "duals": dual_variables_state_dict(restored["duals"]),
        }
        if "obs_normalizer" in restored:
            tree["obs_normalizer"] = _tensors(restored["obs_normalizer"])
        return tree
    if algorithm == "reppo":
        return {"policy": reppo_policy_state_dict(restored["policy"]),
                "critic": reppo_critic_state_dict(restored["critic"]),
                "obs_normalizer": _tensors(restored["obs_normalizer"])}
    if algorithm in ("td3", "ddpg"):
        critic = vector_q_critic_state_dict if algorithm == "td3" else q_critic_state_dict
        return {
            "policy": deterministic_policy_state_dict(restored["policy"]),
            "policy_target": deterministic_policy_state_dict(restored["policy_target"]),
            "critic": critic(restored["critic"]),
            "critic_target": critic(restored["critic_target"]),
        }
    raise ValueError(f"no checkpoint conversion for {algorithm!r}")


def _tensor_tree(tree, device):
    if isinstance(tree, Mapping):
        return {k: _tensor_tree(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree), device=device)


def env_state_from_jax(state, device="cpu", seed=0):
    """The port's ``EnvState`` from a JAX package env state whose physics is
    a dict of arrays (the robot and soccer envs): every array leaf as a
    tensor of its type, ``eval_mode`` as it is, and a fresh generator
    seeded with ``seed`` in place of the JAX key."""
    from rlx_tpu_torch.environments.env import EnvState

    return EnvState(
        physics=_tensor_tree(state.physics, device),
        observation=_tensor_tree(state.observation, device),
        final_observation=_tensor_tree(state.final_observation, device),
        reward=_tensor_tree(state.reward, device),
        terminated=_tensor_tree(state.terminated, device),
        truncated=_tensor_tree(state.truncated, device),
        info=_tensor_tree(state.info, device),
        episode_store=_tensor_tree(state.episode_store, device),
        generator=torch.Generator(device=device).manual_seed(seed),
        eval_mode=bool(state.eval_mode),
    )


# --------------------------------------------------- tensor-parallel shards


def _tp_gather(tensor, dim, mesh):
    """The whole of a tp-split tensor from every tp rank's slice along
    ``dim`` (``Mesh.gather_rows`` over the tp group)."""
    moved = tensor.movedim(dim, 0).contiguous()
    return mesh.gather_rows(moved, group="tp").movedim(0, dim).contiguous()


def _tp_slice(tensor, dim, mesh):
    width = tensor.shape[dim] // mesh.tp
    return tensor.narrow(dim, mesh.tp_rank * width, width).clone()


def tp_unshard_state_dict(module, state_dict=None):
    """``module.state_dict()`` (or ``state_dict``, keyed as it) of a net split
    over tp (``parallel/partition.shard_module_``) with every split
    parameter whole: what a checkpoint holds.  Collective: every tp rank
    calls it."""
    state_dict = module.state_dict() if state_dict is None else state_dict
    axes = getattr(module, "tp_axes", {})
    return {k: _tp_gather(v, axes[k], module.tp_mesh) if k in axes else v for k, v in state_dict.items()}


def tp_shard_state_dict(module, state_dict):
    """This tp rank's slices of a whole ``state_dict`` (the inverse of
    ``tp_unshard_state_dict``)."""
    axes = getattr(module, "tp_axes", {})
    return {k: _tp_slice(v, axes[k], module.tp_mesh) if k in axes else v for k, v in state_dict.items()}


def _optimizer_state_map(module, optimizer_state, fn):
    """``optimizer_state`` (an optimizer's ``state_dict()``) with ``fn(name,
    tensor)`` applied to each moment of a parameter (Adam's moments split
    as their parameters)."""
    names = [name for name, _ in module.named_parameters()]
    state = {}
    for index, moments in optimizer_state["state"].items():
        name = names[index]
        state[index] = {k: fn(name, v) if isinstance(v, torch.Tensor) and v.ndim > 0 else v
                        for k, v in moments.items()}
    return {**optimizer_state, "state": state}


def tp_unshard_optimizer_state(module, optimizer_state):
    axes = getattr(module, "tp_axes", {})
    return _optimizer_state_map(module, optimizer_state,
                                lambda name, v: _tp_gather(v, axes[name], module.tp_mesh) if name in axes else v)


def tp_shard_optimizer_state(module, optimizer_state):
    axes = getattr(module, "tp_axes", {})
    return _optimizer_state_map(module, optimizer_state,
                                lambda name, v: _tp_slice(v, axes[name], module.tp_mesh) if name in axes else v)
