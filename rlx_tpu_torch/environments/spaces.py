"""Spaces for device-resident environments: a continuous box and a discrete
set of actions."""

import torch


class BoxSpace:
    """Continuous box space.  ``center`` is the nominal joint position and
    ``scale`` the action scaling (robot-locomotion convention)."""

    def __init__(self, low, high, shape, center=None, scale=None, device="cpu"):
        self.low = torch.as_tensor(low, dtype=torch.float32, device=device)
        self.high = torch.as_tensor(high, dtype=torch.float32, device=device)
        self.shape = tuple(shape)
        self.dtype = torch.float32
        self.center = (torch.zeros(shape, device=device) if center is None
                       else torch.as_tensor(center, dtype=torch.float32, device=device))
        self.scale = (torch.ones(shape, device=device) if scale is None
                      else torch.as_tensor(scale, dtype=torch.float32, device=device))


class DiscreteSpace:
    """Discrete space with ``n`` actions; ``shape`` is ``()`` as in Gymnasium,
    and actions are int32."""

    def __init__(self, n, device="cpu"):
        self.n = int(n)
        self.shape = ()
        self.dtype = torch.int32
        self.device = torch.device(device)

    def sample(self, generator, batch_shape=()):
        """Uniform actions in ``[0, n)`` of shape ``batch_shape``, drawn from
        ``generator`` (on the space's device)."""
        return torch.randint(0, self.n, tuple(batch_shape), generator=generator, device=self.device,
                             dtype=torch.int32)
