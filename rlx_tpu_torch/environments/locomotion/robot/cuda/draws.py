"""The robot env's random draws.

Every draw of the env (terrain, commands, domain randomization, noise,
initial state, gait) goes through one ``Draws`` object in program order:
``uniform``, ``randint`` and ``bernoulli``, each shaped as the JAX package's
``jax.random`` call at the same place, with the env axis first.
``GeneratorDraws`` takes them from the env state's ``torch.Generator``, or
with parallel seeds from its list of S generators: each seed's rows from
its own, as its one-seed env would (``environments/env.py::draw``).
``reset`` and ``step`` take any other ``Draws`` in its place
(``ReplayDraws`` hands out given values in order, for instance the JAX
package's draws for the same calls; ``SeedDraws`` joins S one-seed
``Draws`` into the draws of an env of S seeds).
"""

import torch

from rlx_tpu_torch.environments.env import draw


class GeneratorDraws:
    def __init__(self, generator, device):
        self.generator = generator
        self.device = device

    def _rand(self, shape):
        return draw(self.generator, torch.rand, tuple(shape), device=self.device)

    def uniform(self, shape, low=0.0, high=1.0):
        """Uniform in [low, high); ``low`` and ``high`` broadcast to ``shape``
        (scaled over all rows at once: each seed's raw draws are its own)."""
        return self._rand(shape) * (high - low) + low

    def randint(self, shape, low, high):
        """Integers in [low, high), int32."""
        sample = lambda rows, generator: torch.randint(low, high, rows, generator=generator, device=self.device,
                                                       dtype=torch.int32)
        return draw(self.generator, sample, tuple(shape))

    def bernoulli(self, p, shape):
        return self._rand(shape) < p


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


class SeedDraws:
    """The draws of an env of ``S * N`` envs from S one-seed ``Draws``: each
    call takes rows ``s * N .. (s + 1) * N`` of ``shape[0]`` from
    ``draws[s]``, in one-seed program order, with seed s's rows of ``low``
    and ``high``, and concatenates them seed-major."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _call(self, method, shape, *bounds):
        S = len(self.draws)
        n = shape[0] // S
        rows = (n,) + tuple(shape[1:])

        def bound(value, s):
            # a bound of all rows, broadcast to the draw, gives seed s its rows
            if torch.is_tensor(value) and value.ndim > 0:
                return torch.broadcast_to(value, tuple(shape))[s * n:(s + 1) * n]
            return value

        return torch.cat([getattr(d, method)(rows, *(bound(b, s) for b in bounds))
                          for s, d in enumerate(self.draws)])

    def uniform(self, shape, low=0.0, high=1.0):
        return self._call("uniform", shape, low, high)

    def randint(self, shape, low, high):
        return self._call("randint", shape, low, high)

    def bernoulli(self, p, shape):
        S = len(self.draws)
        rows = (shape[0] // S,) + tuple(shape[1:])
        return torch.cat([d.bernoulli(p, rows) for d in self.draws])
