"""The port's policies and critics against the JAX package's flax modules,
with the weights carried across by rlx_tpu_torch.convert."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rlx_tpu.models import distributions as jax_D
from rlx_tpu.models.mlp import GaussianPolicy as JaxGaussianPolicy
from rlx_tpu.models.mlp import VCritic as JaxVCritic
from rlx_tpu_torch import convert
from rlx_tpu_torch.models import distributions as D
from rlx_tpu_torch.models.mlp import DeterministicTanhPolicy, GaussianPolicy, QCritic, VCritic, VectorQCritic
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)

HIDDEN = (32, 16)
OBS, ACT = 34, 8


def _jax_modules(dtype, seed=0):
    policy = JaxGaussianPolicy(action_dim=ACT, hidden_sizes=HIDDEN, activation="elu",
                               layer_norm=True, std_dev=0.7, dtype=dtype)
    critic = JaxVCritic(hidden_sizes=HIDDEN, activation="elu", layer_norm=True, dtype=dtype)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    obs = jnp.zeros((1, OBS))
    return policy, policy.init(k1, obs), critic, critic.init(k2, obs)


def _torch_modules(jp, jc, compute_dtype):
    policy = GaussianPolicy(OBS, ACT, HIDDEN, "elu", True, std_dev=1.0, compute_dtype=compute_dtype)
    critic = VCritic(OBS, HIDDEN, "elu", True, compute_dtype=compute_dtype)
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    policy.load_state_dict(convert.policy_state_dict(np_tree(jp)))
    critic.load_state_dict(convert.critic_state_dict(np_tree(jc)))
    return policy, critic


# f32: same math, other summation order; bf16: the trunk rounds to bf16
# (8 bits of mantissa) at other places in the two frameworks.
@pytest.mark.parametrize("jax_dtype,torch_dtype,tol", [
    (None, None, 1e-5),
    (jnp.bfloat16, torch.bfloat16, 5e-2),
])
def test_forward_log_prob_entropy_mode_match(jax_dtype, torch_dtype, tol):
    jpolicy, jp, jcritic, jc = _jax_modules(jax_dtype)
    policy, critic = _torch_modules(jp, jc, torch_dtype)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(64, OBS)).astype(np.float32)
    action = rng.normal(size=(64, ACT)).astype(np.float32)

    jmean, jlogstd = jpolicy.apply(jp, obs)
    mean, logstd = policy(torch.tensor(obs))
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(jmean), rtol=tol, atol=tol)
    np.testing.assert_allclose(logstd.detach().numpy(), np.asarray(jlogstd), rtol=0, atol=0)
    np.testing.assert_allclose(critic(torch.tensor(obs)).detach().numpy(),
                               np.asarray(jcritic.apply(jc, obs)), rtol=tol, atol=tol)

    lp = D.gaussian_log_prob(mean, logstd, torch.tensor(action)).detach().numpy()
    jlp = np.asarray(jax_D.gaussian_log_prob(jmean, jlogstd, action))
    np.testing.assert_allclose(lp, jlp, rtol=tol, atol=tol)
    np.testing.assert_allclose(D.gaussian_entropy(logstd).detach().numpy(),
                               np.asarray(jax_D.gaussian_entropy(jlogstd)), rtol=1e-6, atol=1e-6)
    noise = rng.normal(size=(64, ACT)).astype(np.float32)
    sample = D.gaussian_sample(mean, logstd, noise=torch.tensor(noise)).detach().numpy()
    np.testing.assert_allclose(sample, np.asarray(jmean) + np.exp(np.asarray(jlogstd)) * noise,
                               rtol=tol, atol=tol)


def test_layer_norm_eps_and_init():
    """LayerNorm eps is flax's 1e-6; orthogonal init gains match the JAX
    package (trunk sqrt(2), policy head 0.01, value head 1.0)."""
    policy = GaussianPolicy(OBS, ACT, (64, 64), "elu", True, std_dev=0.5)
    critic = VCritic(OBS, (64, 64), "elu", True)
    assert policy.trunk.norm.eps == 1e-6
    w = policy.trunk.layers[1].weight.detach()
    torch.testing.assert_close(w @ w.T, 2.0 * torch.eye(64), rtol=1e-4, atol=1e-4)
    head = policy.mean.weight.detach()
    torch.testing.assert_close(head @ head.T, 1e-4 * torch.eye(ACT), rtol=1e-3, atol=1e-7)
    value = critic.value.weight.detach()
    assert value.norm().item() == pytest.approx(1.0, rel=1e-5)
    assert tuple(policy.policy_logstd.shape) == (1, ACT)
    torch.testing.assert_close(policy.policy_logstd.detach(), torch.full((1, ACT), float(np.log(0.5))))
    for layer in list(policy.trunk.layers) + [policy.mean, critic.value]:
        assert (layer.bias == 0).all()


def test_bf16_trunk_keeps_f32_params_and_outputs():
    policy = GaussianPolicy(OBS, ACT, HIDDEN, "elu", True, compute_dtype=torch.bfloat16)
    mean, logstd = policy(torch.randn(4, OBS))
    assert mean.dtype == logstd.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in policy.parameters())
    mean.sum().backward()
    assert all(p.grad is None or p.grad.dtype == torch.float32 for p in policy.parameters())


OFF_HIDDEN, NR_ATOMS = (32, 16), 11


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(ours, ref, tol, what):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol, err_msg=what)


def test_off_policy_networks_match_flax():
    """FastTD3's nets; f32 on both sides, other summation orders: 1e-5."""
    from rlx_tpu.models.mlp import DeterministicTanhPolicy as JaxPolicy
    from rlx_tpu.models.mlp import QCritic as JaxQCritic
    from rlx_tpu.models.mlp import VectorQCritic as JaxVectorQCritic

    rng = np.random.default_rng(0)
    obs = rng.normal(size=(64, OBS)).astype(np.float32)
    action = rng.uniform(-1, 1, size=(64, ACT)).astype(np.float32)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)

    jpolicy = JaxPolicy(action_dim=ACT, hidden_sizes=OFF_HIDDEN, activation="elu", layer_norm=True)
    jp = jpolicy.init(k1, jnp.zeros((1, OBS)))
    policy = DeterministicTanhPolicy(OBS, ACT, OFF_HIDDEN, "elu", True)
    policy.load_state_dict(convert.deterministic_policy_state_dict(np_tree(jp)))
    close(policy(torch.tensor(obs)), jpolicy.apply(jp, obs), 1e-5, "policy")

    jcritic = JaxVectorQCritic(hidden_sizes=OFF_HIDDEN, nr_critics=2, activation="elu", layer_norm=True,
                               output_dim=NR_ATOMS)
    jc = jcritic.init(k2, jnp.zeros((1, OBS)), jnp.zeros((1, ACT)))
    critic = VectorQCritic(OBS, ACT, OFF_HIDDEN, 2, "elu", True, NR_ATOMS)
    critic.load_state_dict(convert.vector_q_critic_state_dict(np_tree(jc)))
    out = critic(torch.tensor(obs), torch.tensor(action))
    assert out.shape == (2, 64, NR_ATOMS)
    close(out, jcritic.apply(jc, obs, action), 1e-5, "vector critic")

    jsingle = JaxQCritic(hidden_sizes=OFF_HIDDEN, activation="relu", output_dim=3)
    js = np_tree(jsingle.init(k3, jnp.zeros((1, OBS)), jnp.zeros((1, ACT))))
    single = QCritic(OBS, ACT, OFF_HIDDEN, "relu", output_dim=3)
    single.load_state_dict(convert.vector_q_critic_state_dict(
        {"VmapQCritic_0": jax.tree.map(lambda x: x[None], js["params"])}))
    close(single(torch.tensor(obs), torch.tensor(action)), jsingle.apply(js, obs, action), 1e-5, "critic")


def test_flax_default_init_statistics():
    """lecun normal: truncated at 2 std, variance 1/fan_in; zero biases."""
    critic = VectorQCritic(OBS, ACT, (512, 256), 2, "elu", True, 101)
    w = critic.layers[1].weight.detach()
    assert w.shape == (2, 256, 512)
    assert abs(float(w.var()) * 512 - 1.0) < 0.02
    assert float(w.abs().max()) <= 2.0 * np.sqrt(1 / 512) / 0.87962566103423978 + 1e-6
    assert not torch.equal(w[0], w[1])
    assert float(critic.layers[1].bias.detach().abs().max()) == 0.0
