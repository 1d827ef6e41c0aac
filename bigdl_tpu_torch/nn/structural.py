"""Structural layers of the flagship (counterpart of ``Reshape`` and
``SpaceToDepth`` in ``bigdl_tpu/nn/structural.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

from .module import AbstractModule


class Reshape(AbstractModule):
    """Reshape, keeping the batch dim when ``batch_mode``."""

    def __init__(self, size: Sequence[int], batch_mode: Optional[bool] = True, device=None):
        super().__init__(device)
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def _apply_params(self, params, state, x, training, rng):
        if self.batch_mode:
            return x.reshape((x.shape[0],) + self.size), state
        return x.reshape(self.size), state


class SpaceToDepth(AbstractModule):
    """(N, C, H, W) -> (N, C·b², H/b, W/b), each b×b spatial block folded into
    channels in (C, row offset, column offset) order."""

    def __init__(self, block_size: int = 2, device=None):
        super().__init__(device)
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = block_size

    def _apply_params(self, params, state, x, training, rng):
        b = self.block_size
        n, c, h, w = x.shape
        if h % b or w % b:
            raise ValueError(f"SpaceToDepth({b}): spatial dims ({h},{w}) not divisible")
        y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 1, 3, 5, 2, 4)
        return y.reshape(n, c * b * b, h // b, w // b), state
