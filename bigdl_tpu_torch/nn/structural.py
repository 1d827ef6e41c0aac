"""Structural layers (counterpart of ``Reshape``, ``SpaceToDepth`` and
``Select`` in ``bigdl_tpu/nn/structural.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .module import AbstractModule, spec


class Reshape(AbstractModule):
    """Reshape, keeping the batch dim when ``batch_mode``."""

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        want = int(np.prod(self.size, dtype=np.int64))
        if self.batch_mode:
            have, out = int(np.prod(shape[1:], dtype=np.int64)), (shape[0],) + self.size
        else:
            have, out = int(np.prod(shape, dtype=np.int64)), self.size
        if have != want:
            per_row = " per row" if self.batch_mode else ""
            raise ValueError(f"{self.name()}: cannot reshape {have} elements{per_row} "
                             f"(input shape {shape}) into {self.size} ({want} elements)")
        return spec(tuple(out), in_spec.dtype)

    def __init__(self, size: Sequence[int], batch_mode: Optional[bool] = True, device=None):
        super().__init__(device)
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def _apply_params(self, params, state, x, training, rng):
        if self.batch_mode:
            return x.reshape((x.shape[0],) + self.size), state
        return x.reshape(self.size), state


class Select(AbstractModule):
    """Select ``index`` along ``dimension``, dropping that dimension; both
    1-based, a negative value counting from the end (-1 is the last).
    Reference: $DL/nn/Select.scala."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, dimension: int, index: int, device=None):
        super().__init__(device)
        self.dimension = dimension
        self.index = index

    def _apply_params(self, params, state, x, training, rng):
        d = self.dimension - 1 if self.dimension > 0 else x.dim() + self.dimension
        i = self.index - 1 if self.index > 0 else x.shape[d] + self.index
        return x.select(d, i), state


class SpaceToDepth(AbstractModule):
    """(N, C, H, W) -> (N, C·b², H/b, W/b), each b×b spatial block folded into
    channels in (C, row offset, column offset) order."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

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
