"""Per-channel quantized tensors (counterpart of
``bigdl_tpu/tensor/quantized.py``; reference: ``$DL/tensor/QuantizedTensor.scala``).

A quantized tensor is the pair (codes, float32 scales per channel):
``quantize_symmetric`` gives int8 codes on the amax/127 grid (the bigquant
recipe), ``quantize_fp8`` float8_e4m3fn codes scaled so each channel's amax
maps to the format's max. Both are the JAX package's functions bit for bit:
the scale is a true division by the constant (``precision.true_div``: on the
card ATen would divide through the reciprocal), and ``torch.round`` rounds
half to even as ``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..utils.precision import true_div


@dataclasses.dataclass
class QuantizedTensor:
    """Symmetric per-channel quantization: ``dense ≈ values * scales`` with
    ``scales`` broadcast over ``channel_axis``."""

    values: torch.Tensor  # int8 or float8 codes
    scales: torch.Tensor  # float32, shape (values.shape[channel_axis],)
    channel_axis: int = 0

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.values.shape)

    def to_dense(self) -> torch.Tensor:
        bshape = [1] * self.values.dim()
        bshape[self.channel_axis] = -1
        return self.values.to(torch.float32) * self.scales.reshape(bshape)


def _channel_scales(w: torch.Tensor, channel_axis: int, fmax: float):
    """Per-channel ``amax / fmax`` (1 where a channel is all zeros), float32,
    and its shape broadcast over ``w``."""
    reduce_dims = tuple(i for i in range(w.dim()) if i != channel_axis)
    amax = torch.amax(torch.abs(w), dim=reduce_dims) if reduce_dims else torch.abs(w)
    scales = torch.where(amax > 0, true_div(amax, fmax), torch.ones_like(amax))
    bshape = [1] * w.dim()
    bshape[channel_axis] = -1
    return scales.to(torch.float32), bshape


def quantize_symmetric(w: torch.Tensor, channel_axis: int = 0) -> QuantizedTensor:
    """amax/127 per-channel symmetric int8 quantization."""
    scales, bshape = _channel_scales(w, channel_axis, 127.0)
    q = torch.clamp(torch.round(w / scales.reshape(bshape)), -127, 127).to(torch.int8)
    return QuantizedTensor(q, scales, channel_axis)


def quantize_fp8(w: torch.Tensor, channel_axis: int = 0, dtype=None) -> QuantizedTensor:
    """Per-channel symmetric float8 quantization: each channel's amax maps
    to the format's max (448 for e4m3fn), and the codes keep fp8's relative
    grid. ``dtype`` defaults to ``float8_e4m3fn``; a build without float8
    raises ``ValueError`` with :func:`~bigdl_tpu_torch.utils.compat.probe_float8`'s
    reason."""
    from ..utils.compat import probe_float8

    support = probe_float8()
    if not support.available:
        raise ValueError("fp8 weight quantization requires float8 support, which this "
                         f"torch build lacks ({support.reason})")
    if dtype is None:
        dtype = support.dtypes["float8_e4m3fn"]
    elif isinstance(dtype, str):
        name = {"float8_e4m3": "float8_e4m3fn"}.get(dtype, dtype)
        if name not in support.dtypes:
            raise ValueError(f"quantize_fp8 stores float8 codes; dtype {dtype!r} is not a "
                             "float8 format (use quantize_symmetric for int8)")
        dtype = support.dtypes[name]
    elif dtype not in support.dtypes.values():
        raise ValueError(f"quantize_fp8 stores float8 codes; dtype {dtype} is not a float8 "
                         "format (use quantize_symmetric for int8)")
    scales, bshape = _channel_scales(w, channel_axis, float(torch.finfo(dtype).max))
    q = (w / scales.reshape(bshape)).to(dtype)
    return QuantizedTensor(q, scales, channel_axis)
