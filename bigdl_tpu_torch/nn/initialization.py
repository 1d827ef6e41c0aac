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


class Ones(InitializationMethod):
    def __call__(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        return torch.ones(shape, dtype=dtype)


class ConstInitMethod(InitializationMethod):
    """Every entry ``value``."""

    def __init__(self, value: float):
        self.value = value

    def __call__(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        return torch.full(shape, self.value, dtype=dtype)


class Xavier(InitializationMethod):
    """Glorot uniform: U(±sqrt(6/(fanIn+fanOut)))."""

    def __call__(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        bound = math.sqrt(6.0 / max(1, fan_in + fan_out))
        return torch.empty(shape, dtype=dtype).uniform_(-bound, bound,
                                                        generator=generator)


class RandomUniform(InitializationMethod):
    """U(lower, upper); by default U(±1/sqrt(fanIn)) (``Linear``'s default)."""

    def __init__(self, lower=None, upper=None):
        self.lower, self.upper = lower, upper

    def __call__(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        if self.lower is None:
            bound = 1.0 / math.sqrt(max(1, fan_in))
            lo, hi = -bound, bound
        else:
            lo, hi = self.lower, self.upper
        return torch.empty(shape, dtype=dtype).uniform_(lo, hi, generator=generator)


class RandomNormal(InitializationMethod):
    """N(mean, stdv²) (``LookupTable``'s default, N(0, 1))."""

    def __init__(self, mean: float = 0.0, stdv: float = 1.0):
        self.mean, self.stdv = mean, stdv

    def __call__(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        return self.mean + self.stdv * torch.randn(shape, generator=generator, dtype=dtype)


class MsraFiller(InitializationMethod):
    """He normal: N(0, 2/n) with n = fanIn, or (fanIn + fanOut)/2 when
    ``variance_norm_average``."""

    def __init__(self, variance_norm_average: bool = True):
        self.variance_norm_average = variance_norm_average

    def __call__(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        n = (fan_in + fan_out) / 2.0 if self.variance_norm_average else float(fan_in)
        std = math.sqrt(2.0 / max(1.0, n))
        return std * torch.randn(shape, generator=generator, dtype=dtype)


class BilinearFiller(InitializationMethod):
    """The bilinear upsampling kernel, a transposed convolution's weight
    (reference: ``BilinearFiller``): over the trailing (kH, kW) of
    ``shape``, ``(1 - |i/f_h - c_h|)·(1 - |j/f_w - c_w|)`` with ``f =
    ceil(k/2)`` and ``c = (2f - 1 - f mod 2) / (2f)``, the same filter at
    every leading index. It draws nothing."""

    def __call__(self, generator, shape, fan_in, fan_out, dtype=torch.float32):
        kh, kw = shape[-2], shape[-1]
        f_h, f_w = math.ceil(kh / 2.0), math.ceil(kw / 2.0)
        c_h, c_w = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h), (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        ih = torch.arange(kh, dtype=dtype)
        iw = torch.arange(kw, dtype=dtype)
        filt = ((1 - torch.abs(ih[:, None] / f_h - c_h))
                * (1 - torch.abs(iw[None, :] / f_w - c_w)))
        return filt.expand(tuple(shape)).to(dtype).clone()
