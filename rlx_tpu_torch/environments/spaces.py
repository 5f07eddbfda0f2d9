"""Spaces for device-resident environments."""

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
