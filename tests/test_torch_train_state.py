"""The optimizer step a captured learning step takes, on the CPU:
``train_state.adam_step_`` (Adam in tensor ops, its rate a device tensor)
against ``torch.optim.Adam`` / ``AdamW``'s own step, bit for bit, with
decoupled (AdamW) and L2 (Adam) weight decay and an annealed rate; its
``active`` select; ``TrainState.apply_gradients`` and ``polyak_update``
under ``torch_parity.NoHostRead``."""

import copy

import pytest
import torch

from rlx_tpu_torch.algorithms.train_state import TrainState, adam_step_
from torch_parity import NoHostRead
from torch_parity import one_torch_thread  # noqa: F401 (autouse: one torch thread a test)


def _net(dtype):
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(12, 64), torch.nn.ELU(), torch.nn.LayerNorm(64),
                               torch.nn.Linear(64, 3)).to(dtype)


def _gradients(net, x):
    net.zero_grad()
    net(x).pow(2).mean().backward()


OPTIMIZERS = {   # name: (class, weight decay)
    "Adam": (torch.optim.Adam, 0.0),
    "AdamW": (torch.optim.AdamW, 0.1),
    "Adam with L2 weight decay": (torch.optim.Adam, 0.01),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_adam_step_is_torch_adam_on_the_cpu(name, dtype):
    """Six steps, the rate annealed each step: the parameters, both moments
    and the count equal torch's optimizer's bit for bit."""
    cls, weight_decay = OPTIMIZERS[name]
    ours = _net(dtype)
    ref = copy.deepcopy(ours)
    settings = dict(lr=3e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    optimizer, reference = cls(ours.parameters(), **settings), cls(ref.parameters(), **settings)
    generator = torch.Generator().manual_seed(1)
    for step in range(6):
        rate = 3e-4 * (1.0 - step / 8)
        x = torch.randn(32, 12, generator=generator, dtype=dtype)
        _gradients(ours, x)
        _gradients(ref, x)
        reference.param_groups[0]["lr"] = rate
        reference.step()
        adam_step_(optimizer, torch.tensor(rate, dtype=torch.float64))
        for p, q in zip(ours.parameters(), ref.parameters()):
            assert torch.equal(p, q), (step, name)
            for key in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(optimizer.state[p][key], reference.state[q][key]), (step, key)


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_adam_step_active_selects_the_whole_step(name):
    """``active`` false leaves parameters, moments and count as they were;
    true gives the step without ``active`` bit for bit."""
    cls, weight_decay = OPTIMIZERS[name]
    ours = _net(torch.float32)
    ref = copy.deepcopy(ours)
    settings = dict(lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    optimizer, reference = cls(ours.parameters(), **settings), cls(ref.parameters(), **settings)
    rate = torch.tensor(1e-2, dtype=torch.float64)
    generator = torch.Generator().manual_seed(2)
    for step, active in enumerate((True, False, True, False, False, True)):
        x = torch.randn(16, 12, generator=generator)
        _gradients(ours, x)
        _gradients(ref, x)
        before = {k: v.clone() for p in ours.parameters() for k, v in
                  [(f"{id(p)}", p.detach()), *((f"{id(p)}{k}", t) for k, t in optimizer.state[p].items())]}
        flag = torch.tensor(active)
        with NoHostRead():
            adam_step_(optimizer, rate, flag)
        if active:
            adam_step_(reference, rate)
        for p, q in zip(ours.parameters(), ref.parameters()):
            assert torch.equal(p, q), step
            for key, value in optimizer.state[p].items():
                assert torch.equal(value, reference.state[q][key]), (step, key)
                if not active:
                    assert torch.equal(value, before[f"{id(p)}{key}"]), (step, key)
    assert int(optimizer.state[next(ours.parameters())]["step"]) == 3


def test_train_state_steps_and_moves_its_target_on_the_device():
    """``apply_gradients`` at a device rate and ``polyak_update`` with an
    ``active`` flag read nothing back; inactive, nothing moves; active, the
    target is ``tau * p + (1 - tau) * target`` as ``optax.incremental_update``,
    and ``step_tensor`` is Adam's own count."""
    state = TrainState(_net(torch.float32), None)
    state.optimizer = torch.optim.AdamW(state.module.parameters(), lr=3e-4, weight_decay=0.1)
    assert float(state.step_tensor()) == 0.0 and state.step_count() == 0
    x = torch.randn(8, 12, generator=torch.Generator().manual_seed(3))
    targets = [t.clone() for t in state.target.parameters()]
    for active in (False, True):
        grads = torch.autograd.grad(state.module(x).pow(2).mean(), list(state.module.parameters()))
        params = [p.detach().clone() for p in state.module.parameters()]
        flag = torch.tensor(active)
        with NoHostRead():
            state.apply_gradients(grads, torch.full((), 3e-4, dtype=torch.float64), active=flag)
            state.polyak_update(0.005, flag)
        moved = [not torch.equal(p, q) for p, q in zip(state.module.parameters(), params)]
        assert all(moved) == active and any(moved) == active
        for target, before, p in zip(state.target.parameters(), targets, state.module.parameters()):
            expected = before * (1.0 - 0.005) + p * 0.005 if active else before
            assert torch.equal(target, expected)
    assert state.step_count() == 1 and state.step_tensor() is state.optimizer.state[
        next(state.module.parameters())]["step"]
