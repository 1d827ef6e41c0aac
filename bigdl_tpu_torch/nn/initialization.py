"""Weight initialisation (counterpart of ``bigdl_tpu/nn/initialization.py``).

Each method is a callable ``(generator, shape, fan_in, fan_out, dtype) ->
tensor`` drawing on the CPU from a ``torch.Generator``; the module moves the
result to its device. The draws are not ``jax.random``'s: weights are
compared across packages only after copying them over.
"""

from __future__ import annotations

import math

import torch


class InitializationMethod:
    def __call__(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        raise NotImplementedError


class Zeros(InitializationMethod):
    def __call__(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)


class Xavier(InitializationMethod):
    """Glorot uniform: U(±sqrt(6/(fanIn+fanOut)))."""

    def __call__(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        bound = math.sqrt(6.0 / max(1, fan_in + fan_out))
        return torch.empty(shape, dtype=dtype).uniform_(-bound, bound,
                                                        generator=generator)
