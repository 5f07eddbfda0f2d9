"""The robot env's random draws.

Every draw of the env (terrain, commands, domain randomization, noise,
initial state, gait) goes through one ``Draws`` object in program order:
``uniform``, ``randint`` and ``bernoulli``, each shaped as the JAX package's
``jax.random`` call at the same place.  ``GeneratorDraws`` takes them from
the env state's ``torch.Generator``; ``reset`` and ``step`` take any other
``Draws`` in its place (``ReplayDraws`` hands out given values in order,
for instance the JAX package's draws for the same calls).
"""

import torch


class GeneratorDraws:
    def __init__(self, generator, device):
        self.generator = generator
        self.device = device

    def uniform(self, shape, low=0.0, high=1.0):
        """Uniform in [low, high); ``low`` and ``high`` broadcast to ``shape``."""
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return u * (high - low) + low

    def randint(self, shape, low, high):
        """Integers in [low, high), int32."""
        return torch.randint(low, high, shape, generator=self.generator, device=self.device, dtype=torch.int32)

    def bernoulli(self, p, shape):
        return torch.rand(shape, generator=self.generator, device=self.device) < p


class ReplayDraws:
    """Hands out ``values`` in order; each call checks the shape it asks for."""

    def __init__(self, values, device):
        self.values = list(values)
        self.device = device

    def _next(self, shape):
        value = torch.as_tensor(self.values.pop(0), device=self.device)
        if tuple(value.shape) != tuple(shape):
            raise ValueError(f"replayed draw of shape {tuple(value.shape)} where {tuple(shape)} is drawn")
        return value

    def uniform(self, shape, low=0.0, high=1.0):
        return self._next(shape)

    def randint(self, shape, low, high):
        return self._next(shape).to(torch.int32)

    def bernoulli(self, p, shape):
        return self._next(shape).to(torch.bool)
