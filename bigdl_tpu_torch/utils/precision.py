"""Mixed-precision policy (counterpart of ``bigdl_tpu/utils/precision.py``).

* compute dtype (``Engine.compute_dtype()``, bf16 on the card): each matmul
  casts its OPERANDS to it; the tensor cores accumulate in fp32. Master
  parameters stay float32.
* activation dtype (``Engine.activation_dtype()``, default ``None``): what
  matmul OUTPUTS keep; ``None`` upcasts them back to float32.

With ``compute_dtype == float32`` every helper is a pass-through.
The bias/activation epilogues (``bias_act``, ``channel_bias_act``) run
``act(y + b)`` in torch ops; under the fused-kernel switch
(``Engine.set_fused_kernels(True)`` or ``BIGDL_FUSED_KERNELS=1``), an
epilogue with a bias and an activation runs
:func:`bigdl_tpu_torch.ops.fused_epilogue.fused_bias_act` instead (the CUDA
kernels on the card, their plain versions on the CPU).
"""

from __future__ import annotations

import torch

from ..ops.fused_common import fused_kernels_active
from ..ops.fused_epilogue import act_reference, fused_bias_act
from .engine import Engine, torch_dtype


def compute_dtype() -> torch.dtype:
    return torch_dtype(Engine.compute_dtype())


def is_mixed() -> bool:
    return compute_dtype() != torch.float32


def out_dtype() -> torch.dtype:
    """The dtype matmul outputs keep: float32 unless the activation policy is on."""
    act = Engine.activation_dtype()
    return torch.float32 if act is None else torch_dtype(act)


def _cast(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return x.to(dt) if x.is_floating_point() else x


def cast_compute(x: torch.Tensor) -> torch.Tensor:
    """Cast a float tensor to the compute dtype (identity when policy is fp32)."""
    dt = compute_dtype()
    return x if dt == torch.float32 else _cast(x, dt)


def to_float(x: torch.Tensor) -> torch.Tensor:
    """Upcast at a numerical head (softmax/log/loss): identity for fp32."""
    return _cast(x, torch.float32)


def result_dtype(x_dtype: torch.dtype) -> torch.dtype:
    """The dtype a policy-routed matmul returns for an ``x_dtype`` operand
    against fp32 master weights."""
    if is_mixed():
        return out_dtype()
    return torch.promote_types(x_dtype, torch.float32)


def einsum(subscripts: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` under the policy: compute-dtype operands, result in
    ``out_dtype()`` (the product itself is rounded to the compute dtype
    first, as the JAX package's bf16 output is)."""
    dt = compute_dtype()
    if dt == torch.float32:
        return torch.einsum(subscripts, *operands)
    return torch.einsum(subscripts, *(_cast(o, dt) for o in operands)).to(out_dtype())


def conv2d(x: torch.Tensor, w: torch.Tensor, stride, padding, groups: int = 1) -> torch.Tensor:
    """NCHW × OIHW convolution under the policy (counterpart of the JAX
    package's ``conv_general_dilated``): compute-dtype operands, the product
    rounded to the compute dtype and returned in ``out_dtype()``; a
    pass-through in float32. ``padding`` is ((h_lo, h_hi), (w_lo, w_hi))
    zeros. The convolution is cuDNN's on the card (XLA's work in JAX, not a
    Pallas kernel)."""
    (h_lo, h_hi), (w_lo, w_hi) = padding
    mixed = is_mixed()
    dt = compute_dtype() if mixed else torch.promote_types(x.dtype, w.dtype)
    x, w = _cast(x, dt), _cast(w, dt)
    if h_lo == h_hi and w_lo == w_hi:
        y = torch.nn.functional.conv2d(x, w, None, stride, (h_lo, w_lo), 1, groups)
    else:
        y = torch.nn.functional.conv2d(
            torch.nn.functional.pad(x, (w_lo, w_hi, h_lo, h_hi)), w, None, stride, 0, 1, groups)
    return y.to(out_dtype()) if mixed else y


def bias_add(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``y + b`` with the fp32 master bias cast to ``y``'s dtype, so a
    reduced-precision activation is not promoted."""
    return y + _cast(b, y.dtype)


def _act_fn(act):
    """The torch spelling of an epilogue activation name: one mapping, owned
    by ``ops.fused_epilogue`` (the kernels' parity oracle)."""
    try:
        return act_reference(act)
    except KeyError:
        raise ValueError(f"unsupported epilogue activation {act!r} "
                         "(expected relu|gelu|tanh|None)") from None


def bias_act(y: torch.Tensor, b, act=None) -> torch.Tensor:
    """Bias + activation over the trailing feature dim (``Linear``): ``b=None``
    means no bias. With ``act=None``, no bias or the fused-kernel switch off
    this is ``act(bias_add(y, b))`` in torch ops; under the switch the whole
    epilogue is one ``fused_bias_act`` (fp32 master bias, fp32 activation,
    one rounding to ``y``'s dtype)."""
    fn = _act_fn(act)  # validates the name even on the bias-less paths
    if b is None:
        return fn(y)
    if act is None:
        return bias_add(y, b)
    if fused_kernels_active():
        return fused_bias_act(y, b, act, -1)
    return fn(bias_add(y, b))


def channel_bias_act(y: torch.Tensor, b, act=None) -> torch.Tensor:
    """Bias + activation over the channel dim of an NCHW tensor
    (``SpatialConvolution``); ``b`` is the (C,) master bias or ``None``.
    Same contract as :func:`bias_act` (the switch route is ``fused_bias_act``
    with ``axis=1``)."""
    fn = _act_fn(act)
    if b is None:
        return fn(y)
    plain_b = b.reshape((1, -1) + (1,) * (y.dim() - 2))
    if act is None:
        return bias_add(y, plain_b)
    if fused_kernels_active():
        return fused_bias_act(y, b, act, 1)
    return fn(bias_add(y, plain_b))
