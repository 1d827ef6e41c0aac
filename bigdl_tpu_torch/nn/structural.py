"""Structural layers (counterpart of ``bigdl_tpu/nn/structural.py``):
reshapes, squeezes, transposes, slices, gathers, pads, crops, repeats and
upsamplings, all parameter-less, their gradients torch autograd's.

Dims and indices follow the JAX package: Torch's 1-based dims counting the
batch (``Transpose``, ``Narrow``, ``Select``, ``Index``, ``Padding``),
``Squeeze``/``Unsqueeze``'s positions, and ``Replicate``'s 0-based axis.
Two differences, both of the eager port against a traced JAX program:

* ``Index`` follows ``jnp.take``: a 1-based index 0 (or any negative one)
  wraps from the end, and an index past either end gives the fill value
  (NaN for floats) with a zero gradient, where ``torch.index_select``
  raises.
* ``MaskedSelect``'s output length depends on the mask. The JAX package
  refuses it under tracing (and so under ``jax.grad``); the port runs it
  eagerly and its gradient flows back to the selected entries.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.table import Table
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


class View(AbstractModule):
    """Reshape each row to ``sizes`` (one -1 inferred), keeping the batch
    dim (reference: ``$DL/nn/View.scala``)."""

    def __init__(self, *sizes: int, device=None):
        super().__init__(device)
        self.sizes = (tuple(sizes[0]) if len(sizes) == 1 and isinstance(sizes[0], (tuple, list))
                      else tuple(sizes))
        self.num_input_dims = 0

    def set_num_input_dims(self, n: int) -> "View":
        self.num_input_dims = n
        return self

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        have = int(np.prod(shape[1:], dtype=np.int64))
        known = int(np.prod([s for s in self.sizes if s != -1], dtype=np.int64))
        n_infer = sum(1 for s in self.sizes if s == -1)
        if n_infer > 1:
            raise ValueError(f"{self.name()}: at most one -1 in sizes {self.sizes}")
        if n_infer == 1:
            if known == 0 or have % known:
                raise ValueError(f"{self.name()}: {have} elements per row (input shape "
                                 f"{shape}) do not divide into sizes {self.sizes}")
            out = tuple(have // known if s == -1 else s for s in self.sizes)
        else:
            if have != known:
                raise ValueError(f"{self.name()}: cannot view {have} elements per row "
                                 f"(input shape {shape}) as {self.sizes} ({known} elements)")
            out = self.sizes
        return spec((shape[0],) + out, in_spec.dtype)

    def _apply_params(self, params, state, x, training, rng):
        return x.reshape((x.shape[0],) + self.sizes), state


class Squeeze(AbstractModule):
    """Drop the singleton dims, or the 1-based ``dim`` (one past it when
    ``batch_mode``), which must have size 1 as ``jnp.squeeze`` requires
    (reference: ``$DL/nn/Squeeze.scala``)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, dim: Optional[int] = None, batch_mode: bool = False, device=None):
        super().__init__(device)
        self.dim = dim
        self.batch_mode = batch_mode

    def _apply_params(self, params, state, x, training, rng):
        if self.dim is None:
            return x.squeeze(), state
        d = self.dim - 1 + (1 if self.batch_mode else 0)
        if x.shape[d] != 1:
            raise ValueError(f"{self.name()}: cannot squeeze dim {d} of size {x.shape[d]} "
                             f"(input shape {tuple(x.shape)})")
        return x.squeeze(d), state


class Unsqueeze(AbstractModule):
    """Insert a singleton dim at 1-based ``pos`` past the batch dim
    (reference: ``$DL/nn/Unsqueeze.scala``)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, pos: int, num_input_dims: int = 0, device=None):
        super().__init__(device)
        self.pos = pos

    def _apply_params(self, params, state, x, training, rng):
        return x.unsqueeze(self.pos), state


class Transpose(AbstractModule):
    """Swap each listed pair of 1-based dims of the whole tensor, batch
    included, in order (reference: ``$DL/nn/Transpose.scala``)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, permutations: Sequence[Tuple[int, int]], device=None):
        super().__init__(device)
        self.permutations = [tuple(p) for p in permutations]

    def _apply_params(self, params, state, x, training, rng):
        for d1, d2 in self.permutations:
            x = x.transpose(d1 - 1, d2 - 1)
        return x, state


class Contiguous(AbstractModule):
    """The input in contiguous memory (reference: ``$DL/nn/Contiguous.scala``;
    a no-op in the JAX package, the same values here)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def _apply_params(self, params, state, x, training, rng):
        return x.contiguous(), state


class Narrow(AbstractModule):
    """``length`` entries from 1-based ``offset`` along 1-based
    ``dimension``; a negative length counts from the end, -1 keeping all
    from the offset (reference: ``$DL/nn/Narrow.scala``)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, dimension: int, offset: int, length: int = 1, device=None):
        super().__init__(device)
        self.dimension = dimension
        self.offset = offset
        self.length = length

    def _apply_params(self, params, state, x, training, rng):
        d = self.dimension - 1
        length = self.length
        if length < 0:
            length = x.shape[d] - self.offset + 1 + length + 1
        start = self.offset - 1
        idx = [slice(None)] * x.dim()
        idx[d] = slice(start, start + length)
        return x[tuple(idx)], state


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


class Index(AbstractModule):
    """``Table(src, indices)``: ``src`` gathered at the 1-based ``indices``
    along 1-based ``dimension``, as ``jnp.take`` gathers (reference:
    ``$DL/nn/Index.scala``): the output's shape is ``src``'s with that dim
    replaced by the indices' shape; an index of 0 or below wraps from the
    end, one past either end gives NaN for a float ``src`` (the dtype's
    smallest value for a signed integer one) and passes no gradient."""

    accepts_table_input = True
    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, dimension: int, device=None):
        super().__init__(device)
        self.dimension = dimension

    def _apply_params(self, params, state, x, training, rng):
        src, idx = list(x)[:2]
        d = self.dimension - 1
        d = d if d >= 0 else src.dim() + d
        n = src.shape[d]
        i = idx.to(torch.int64) - 1
        valid = (i >= -n) & (i < n)
        j = torch.where(i < 0, i + n, i).clamp(0, max(n - 1, 0))
        out = src.index_select(d, j.reshape(-1))
        out = out.reshape(src.shape[:d] + idx.shape + src.shape[d + 1:])
        fill = (float("nan") if src.is_floating_point()
                else torch.iinfo(src.dtype).min if src.dtype != torch.bool else True)
        mask = valid.reshape((1,) * d + tuple(idx.shape) + (1,) * (src.dim() - d - 1))
        return torch.where(mask, out, torch.full((), fill, dtype=src.dtype,
                                                 device=src.device)), state


class Padding(AbstractModule):
    """Pad ``|pad|`` entries of ``value`` along 1-based ``dim``, before it
    when ``pad`` is negative, after it otherwise; the dim shifts past the
    batch when the input has more than ``n_input_dim`` dims (reference:
    ``$DL/nn/Padding.scala``)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, dim: int, pad: int, n_input_dim: int, value: float = 0.0,
                 n_index: int = 1, device=None):
        super().__init__(device)
        self.dim = dim
        self.pad = pad
        self.n_input_dim = n_input_dim
        self.value = value

    def _apply_params(self, params, state, x, training, rng):
        d = self.dim - 1
        if x.dim() > self.n_input_dim:
            d += 1
        d = d % x.dim()
        widths = [0] * (2 * x.dim())  # F.pad's order: last dim first, (before, after)
        k = 2 * (x.dim() - 1 - d)
        widths[k:k + 2] = (abs(self.pad), 0) if self.pad < 0 else (0, self.pad)
        return F.pad(x, widths, value=self.value), state


class SpatialZeroPadding(AbstractModule):
    """Zeros around the H and W of NCHW input (reference:
    ``$DL/nn/SpatialZeroPadding.scala``)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, pad_left: int, pad_right: Optional[int] = None,
                 pad_top: Optional[int] = None, pad_bottom: Optional[int] = None, device=None):
        super().__init__(device)
        self.pl = pad_left
        self.pr = pad_right if pad_right is not None else pad_left
        self.pt = pad_top if pad_top is not None else pad_left
        self.pb = pad_bottom if pad_bottom is not None else pad_left

    def _apply_params(self, params, state, x, training, rng):
        if x.dim() != 4:
            raise ValueError(f"{self.name()}: expects NCHW input, got shape {tuple(x.shape)}")
        if min(self.pl, self.pr, self.pt, self.pb) < 0:
            raise ValueError(f"{self.name()}: negative padding "
                             f"{(self.pl, self.pr, self.pt, self.pb)}")
        return F.pad(x, (self.pl, self.pr, self.pt, self.pb)), state


class ZeroPadding2D(SpatialZeroPadding):
    """The keras spelling: ``padding`` (rows, columns) on both sides."""

    def __init__(self, padding: Tuple[int, int] = (1, 1), device=None):
        super().__init__(padding[1], padding[1], padding[0], padding[0], device=device)


class Masking(AbstractModule):
    """Zero each time step (last-dim vector) equal to ``mask_value`` in
    every entry (reference: ``$DL/nn/Masking.scala``)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, mask_value: float = 0.0, device=None):
        super().__init__(device)
        self.mask_value = mask_value

    def _apply_params(self, params, state, x, training, rng):
        keep = torch.any(x != self.mask_value, dim=-1, keepdim=True)
        return x * keep.to(x.dtype), state


class InferReshape(AbstractModule):
    """Reshape to ``size``, where 0 copies the input's dim at that place and
    one -1 is inferred; past the batch dim when ``batch_mode`` (reference:
    ``$DL/nn/InferReshape.scala``)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, size: Sequence[int], batch_mode: bool = False, device=None):
        super().__init__(device)
        self.size = tuple(size)
        self.batch_mode = batch_mode

    def _apply_params(self, params, state, x, training, rng):
        base = 1 if self.batch_mode else 0
        out = tuple(x.shape[base + i] if s == 0 else s for i, s in enumerate(self.size))
        if self.batch_mode:
            return x.reshape((x.shape[0],) + out), state
        return x.reshape(out), state


class Flatten(AbstractModule):
    """Collapse every dim past the batch's."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def _apply_params(self, params, state, x, training, rng):
        return x.reshape(x.shape[0], -1), state


class MaskedSelect(AbstractModule):
    """``Table(input, mask)``: the entries of ``input`` where the mask (of
    the same shape) is nonzero, as a 1-D tensor (reference:
    ``$DL/nn/MaskedSelect.scala``). Its length depends on the data, so it
    has no static shape: ``infer_shape`` raises, as the JAX package's does.
    It runs eagerly and passes its gradient back to the selected entries
    (the JAX one refuses to trace, so it has none)."""

    accepts_table_input = True

    def infer_shape(self, in_spec):
        raise ValueError(f"{self.name()}: MaskedSelect has a data-dependent output shape; "
                         "it cannot be statically inferred (eager only)")

    def _apply_params(self, params, state, x, training, rng):
        inp, mask = list(x)[:2]
        if inp.device.type == "meta":
            raise ValueError(f"{self.name()}: MaskedSelect has a data-dependent output "
                             "shape; it cannot run on a spec")
        return inp[mask.to(torch.bool)], state


class UpSampling1D(AbstractModule):
    """Repeat each time step ``length`` times over (N, T, C) (reference:
    ``$DL/nn/UpSampling1D.scala``)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, length: int = 2, device=None):
        super().__init__(device)
        self.length = length

    def _apply_params(self, params, state, x, training, rng):
        return x.repeat_interleave(self.length, dim=1), state


class UpSampling2D(AbstractModule):
    """Nearest-neighbour upsampling of (N, C, H, W) by ``size`` (rows,
    columns) (reference: ``$DL/nn/UpSampling2D.scala``)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, size: Tuple[int, int] = (2, 2), device=None):
        super().__init__(device)
        self.size = tuple(size)

    def _apply_params(self, params, state, x, training, rng):
        y = x.repeat_interleave(self.size[0], dim=2)
        return y.repeat_interleave(self.size[1], dim=3), state


class UpSampling3D(AbstractModule):
    """Nearest-neighbour upsampling of (N, C, D, H, W) by ``size``
    (reference: ``$DL/nn/UpSampling3D.scala``)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, size: Tuple[int, int, int] = (2, 2, 2), device=None):
        super().__init__(device)
        self.size = tuple(size)

    def _apply_params(self, params, state, x, training, rng):
        for axis, rep in zip((2, 3, 4), self.size):
            x = x.repeat_interleave(rep, dim=axis)
        return x, state


class Cropping1D(AbstractModule):
    """Trim (start, end) time steps off (N, T, C)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, cropping: Tuple[int, int] = (1, 1), device=None):
        super().__init__(device)
        self.cropping = tuple(cropping)

    def _apply_params(self, params, state, x, training, rng):
        lo, hi = self.cropping
        return x[:, lo:x.shape[1] - hi], state


class Cropping2D(AbstractModule):
    """Trim ((top, bottom), (left, right)) off (N, C, H, W)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, cropping=((0, 0), (0, 0)), device=None):
        super().__init__(device)
        (self.top, self.bottom), (self.left, self.right) = cropping

    def _apply_params(self, params, state, x, training, rng):
        return x[:, :, self.top:x.shape[2] - self.bottom,
                 self.left:x.shape[3] - self.right], state


class Cropping3D(AbstractModule):
    """Trim a (start, end) pair off each of D, H and W of (N, C, D, H, W)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)), device=None):
        super().__init__(device)
        self.cropping = tuple(tuple(c) for c in cropping)

    def _apply_params(self, params, state, x, training, rng):
        (d0, d1), (h0, h1), (w0, w1) = self.cropping
        return x[:, :, d0:x.shape[2] - d1, h0:x.shape[3] - h1, w0:x.shape[4] - w1], state


class Replicate(AbstractModule):
    """``n_features`` copies of the input along a new axis ``dim`` (0-based,
    as the JAX package's ``expand_dims``; keras ``RepeatVector`` is dim 1:
    (N, F) -> (N, n, F)) (reference: ``$DL/nn/Replicate.scala``)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, n_features: int, dim: int = 1, device=None):
        super().__init__(device)
        self.n_features = n_features
        self.dim = dim

    def _apply_params(self, params, state, x, training, rng):
        y = x.unsqueeze(self.dim)
        reps = [1] * y.dim()
        reps[self.dim] = self.n_features
        return y.repeat(reps), state
