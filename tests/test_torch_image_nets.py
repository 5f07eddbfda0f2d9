"""The port's ``NatureCNN`` and the image branch of its four nets
(``DiscreteQNet``, ``GaussianPolicy``, ``CategoricalPolicy``, ``VCritic``)
against flax's, from converted parameters, at batch 4: outputs and, for
NatureCNN and the Q-network, the gradients of every parameter.  f32 on both
sides: rtol = atol = 1e-5.

The inputs are random frames (no symmetry between rows, columns and
channels) and the converted parameters random, so a port that fed conv2d
the NHWC tensor as it is, or flattened its last feature map in (C, H, W)
order instead of flax's (H, W, C), fails; a non-square frame checks the
same at shapes where height and width differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlx_tpu.models import mlp as jax_mlp
from rlx_tpu_torch import convert
from rlx_tpu_torch.models.mlp import CategoricalPolicy, DiscreteQNet, GaussianPolicy, NatureCNN, VCritic
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

B, TOL = 4, 1e-5
SHAPE = (84, 84, 4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _frames(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).integers(0, 256, size=(B,) + shape).astype(dtype)


def _close(ours, ref, what):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=TOL, atol=TOL, err_msg=what)


@pytest.fixture(scope="module")
def flax_nets():
    """Each flax net with random parameters (every leaf drawn anew, so no
    bias is zero and no kernel has the init's symmetry), built once."""
    frames = _frames(SHAPE, 0)
    rng = np.random.default_rng(1)
    nets = {
        "nature_cnn": jax_mlp.NatureCNN(),
        "q": jax_mlp.DiscreteQNet(nr_actions=4, hidden_sizes=(64,)),
        "q_atoms": jax_mlp.DiscreteQNet(nr_actions=4, hidden_sizes=(64,), output_dim_per_action=11),
        "gaussian": jax_mlp.GaussianPolicy(action_dim=3, hidden_sizes=(64,), vision=True),
        "categorical": jax_mlp.CategoricalPolicy(nr_actions=4, hidden_sizes=(64,), vision=True),
        "critic": jax_mlp.VCritic(hidden_sizes=(64,), vision=True),
    }
    out = {}
    for name, net in nets.items():
        params = net.init(jax.random.PRNGKey(0), frames)
        params = jax.tree.map(lambda a: (0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
        out[name] = (net, params)
    return out


def test_nature_cnn_matches_flax(flax_nets):
    net, params = flax_nets["nature_cnn"]
    ours = NatureCNN(SHAPE)
    state = convert.nature_cnn_state_dict(_np_tree(params))
    assert set(state) == set(ours.state_dict())
    ours.load_state_dict(state)
    frames = _frames(SHAPE, 2)
    x = torch.tensor(frames)
    out = ours(x)
    assert out.shape == (B, 512) and out.dtype == torch.float32
    _close(out, net.apply(params, frames), "features")
    # uint8 frames (the replay's rows) give the same features as float32 ones
    torch.testing.assert_close(ours(x.to(torch.uint8)), out, rtol=0.0, atol=0.0)
    # gradients of every parameter (through the two permutations)
    out.square().mean().backward()
    grads = jax.grad(lambda p: jnp.mean(jnp.square(net.apply(p, frames))))(params)
    for name, ref in convert.nature_cnn_state_dict(_np_tree(grads)).items():
        grad = dict(ours.named_parameters())[name].grad
        np.testing.assert_allclose(grad.numpy(), ref.numpy(), rtol=TOL, atol=TOL, err_msg=name)


def test_nature_cnn_layout_on_a_non_square_frame():
    """84 x 76 x 3 frames: 20 x 18, 9 x 8, 7 x 6 feature maps, a 2,688-wide
    flatten, and extra leading batch axes kept."""
    shape = (84, 76, 3)
    frames = _frames(shape, 3)
    net = jax_mlp.NatureCNN(features=32)
    rng = np.random.default_rng(4)
    params = net.init(jax.random.PRNGKey(1), frames)
    params = jax.tree.map(lambda a: (0.05 * rng.normal(size=a.shape)).astype(np.float32), params)
    ours = NatureCNN(shape, features=32)
    assert ours.dense.in_features == 7 * 6 * 64
    ours.load_state_dict(convert.nature_cnn_state_dict(_np_tree(params)))
    _close(ours(torch.tensor(frames)), net.apply(params, frames), "features")
    stacked = frames.reshape((2, 2) + shape)
    _close(ours(torch.tensor(stacked)), net.apply(params, stacked), "features over [2, 2, H, W, C]")


def test_discrete_q_net_on_images_matches_flax(flax_nets):
    frames = _frames(SHAPE, 5)
    for name, atoms in (("q", 1), ("q_atoms", 11)):
        net, params = flax_nets[name]
        ours = DiscreteQNet(None, 4, (64,), output_dim_per_action=atoms, image_shape=SHAPE)
        ours.load_state_dict(convert.discrete_q_net_state_dict(_np_tree(params)))
        out = ours(torch.tensor(frames))
        assert out.shape == ((B, 4) if atoms == 1 else (B, 4, atoms))
        _close(out, net.apply(params, frames), name)
        out.square().sum().backward()
        grads = jax.grad(lambda p: jnp.sum(jnp.square(net.apply(p, frames))))(params)
        for key, ref in convert.discrete_q_net_state_dict(_np_tree(grads)).items():
            np.testing.assert_allclose(dict(ours.named_parameters())[key].grad.numpy(), ref.numpy(),
                                       rtol=TOL, atol=TOL, err_msg=f"{name} {key}")


def test_policies_and_critic_on_images_match_flax(flax_nets):
    """The ``vision`` nets: a NatureCNN trunk (float32 even with a bfloat16
    trunk type, as JAX's) under the same heads."""
    frames = _frames(SHAPE, 6)
    x = torch.tensor(frames)
    net, params = flax_nets["gaussian"]
    ours = GaussianPolicy(None, 3, (64,), image_shape=SHAPE, compute_dtype=torch.bfloat16)
    ours.load_state_dict(convert.policy_state_dict(_np_tree(params)))
    mean, logstd = ours(x)
    ref_mean, ref_logstd = net.apply(params, frames)
    _close(mean, ref_mean, "mean")
    _close(logstd, ref_logstd, "logstd")
    net, params = flax_nets["categorical"]
    ours = CategoricalPolicy(None, 4, (64,), image_shape=SHAPE)
    ours.load_state_dict(convert.categorical_policy_state_dict(_np_tree(params)))
    _close(ours(x), net.apply(params, frames), "logits")
    net, params = flax_nets["critic"]
    ours = VCritic(None, (64,), image_shape=SHAPE)
    ours.load_state_dict(convert.critic_state_dict(_np_tree(params)))
    _close(ours(x), net.apply(params, frames), "value")


def test_nature_cnn_init_follows_flax():
    """flax's default conv and Dense init: lecun normal (truncated at two
    standard deviations) over the fan-in, zero biases."""
    torch.manual_seed(0)
    net = NatureCNN(SHAPE)
    for layer, fan_in in zip([*net.convs, net.dense], (8 * 8 * 4, 4 * 4 * 32, 3 * 3 * 64, 3136)):
        w = layer.weight.detach()
        assert (layer.bias == 0).all()
        np.testing.assert_allclose(float(w.std()), (1.0 / fan_in) ** 0.5, rtol=0.1)
        assert float(w.abs().max()) <= 2.0 * (1.0 / fan_in) ** 0.5 / 0.87962566103423978 + 1e-6
