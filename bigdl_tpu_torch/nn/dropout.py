"""Dropout and noise layers (counterpart of ``bigdl_tpu/nn/dropout.py``):
``Dropout`` (inverted dropout), ``SpatialDropout1D/2D/3D`` (whole feature
maps or channels), ``GaussianNoise`` (additive) and ``GaussianDropout``
(multiplicative). Each acts at train time only and is the identity in eval
mode or when no generator is given.

Masks and noise are drawn on the input's device, from a generator there
seeded by one draw of the host generator ``rng`` (no host-sized tensor, no
copy). The draws differ from ``jax.random``'s, so parity tests compare
statistics, or run with dropout off.
"""

from __future__ import annotations

from typing import Optional

import torch

from .module import AbstractModule


def _device_generator(rng: torch.Generator, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded by one draw of the host generator."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=rng))
    return torch.Generator(device=device).manual_seed(seed)


def dropout(rng: Optional[torch.Generator], p: float, x: torch.Tensor,
            scale: bool = True, shape=None) -> torch.Tensor:
    """Zero each element (or, with ``shape``, each cell of a mask of that
    shape broadcast over ``x``) with probability ``p`` and, with ``scale``,
    divide the kept ones by ``1 - p``; identity when ``rng`` is None or
    p <= 0."""
    if p <= 0.0 or rng is None:
        return x
    keep = 1.0 - p
    gen = _device_generator(rng, x.device)
    y = x * (torch.rand(x.shape if shape is None else shape, generator=gen,
                        device=x.device) < keep)
    return y / keep if scale else y


class Dropout(AbstractModule):
    """Inverted dropout: kept units scaled by 1/(1-p) at train time
    (``scale=True``, the reference's default). ``inplace`` is accepted and
    ignored."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less, identity at eval

    def __init__(self, init_p: float = 0.5, inplace: bool = False, scale: bool = True,
                 device=None):
        super().__init__(device)
        self.p = init_p
        self.scale = scale

    def _apply_params(self, params, state, x, training, rng):
        if not training:
            return x, state
        return dropout(rng, self.p, x, self.scale), state


class _SpatialDropout(AbstractModule):
    """Drops whole slices: the mask has ``x``'s size on the dims in ``_kept``
    and 1 elsewhere; kept slices are scaled by 1/(1-p)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less, identity at eval

    _kept = ()

    def __init__(self, init_p: float = 0.5, device=None):
        super().__init__(device)
        self.p = init_p

    def _apply_params(self, params, state, x, training, rng):
        if not training:
            return x, state
        shape = tuple(n if d in self._kept else 1 for d, n in enumerate(x.shape))
        return dropout(rng, self.p, x, shape=shape), state


class SpatialDropout1D(_SpatialDropout):
    """Drops whole feature maps of (N, T, C): mask (N, 1, C)."""

    _kept = (0, 2)


class SpatialDropout2D(_SpatialDropout):
    """Drops whole channels of NCHW: mask (N, C, 1, 1)."""

    _kept = (0, 1)


class SpatialDropout3D(_SpatialDropout):
    """Drops whole channels of NCDHW: mask (N, C, 1, 1, 1)."""

    _kept = (0, 1)


class GaussianNoise(AbstractModule):
    """Additive zero-mean Gaussian noise of std ``stddev`` at train time, in
    ``x``'s dtype."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less, identity at eval

    def __init__(self, stddev: float, device=None):
        super().__init__(device)
        self.stddev = stddev

    def _apply_params(self, params, state, x, training, rng):
        if not training or rng is None:
            return x, state
        gen = _device_generator(rng, x.device)
        noise = torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)
        return x + self.stddev * noise, state


class GaussianDropout(AbstractModule):
    """Multiplicative N(1, rate/(1-rate)) noise at train time, in ``x``'s
    dtype."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less, identity at eval

    def __init__(self, rate: float, device=None):
        super().__init__(device)
        self.rate = rate

    def _apply_params(self, params, state, x, training, rng):
        if not training or rng is None:
            return x, state
        std = (self.rate / (1.0 - self.rate)) ** 0.5
        gen = _device_generator(rng, x.device)
        noise = torch.randn(x.shape, generator=gen, device=x.device, dtype=x.dtype)
        return x * (1.0 + std * noise), state
