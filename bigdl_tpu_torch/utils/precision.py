"""Mixed-precision policy (counterpart of ``bigdl_tpu/utils/precision.py``).

* compute dtype (``Engine.compute_dtype()``, bf16 on the card): each matmul
  casts its OPERANDS to it; the tensor cores accumulate in fp32. Master
  parameters stay float32.
* activation dtype (``Engine.activation_dtype()``, default ``None``): what
  matmul OUTPUTS keep; ``None`` upcasts them back to float32.

With ``compute_dtype == float32`` every helper is a pass-through.
"""

from __future__ import annotations

import torch

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

