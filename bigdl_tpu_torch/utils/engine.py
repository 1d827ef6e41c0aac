"""Engine: the process-wide numeric policy and the default device.

Counterpart of ``bigdl_tpu/utils/engine.py`` reduced to what the port uses:
the compute/activation dtype policy (``compute_dtype`` / ``set_compute_dtype``
/ ``activation_dtype`` / ``set_activation_dtype``), the fused-kernel switch
(``fused_kernels`` / ``set_fused_kernels``) and device resolution. There is
no mesh and no topology here.

Entry points run on the card: ``Engine.device(None)`` is ``cuda`` and raises
when no CUDA device is present; the CPU is used only when asked for
(``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        for name, dt in _DTYPES.items():
            if dt == dtype:
                return name
    elif str(dtype) in _DTYPES:
        return str(dtype)
    raise ValueError(f"unsupported dtype {dtype!r}; expected one of {sorted(_DTYPES)}")


class Engine:
    _lock = threading.Lock()
    _compute_dtype: Optional[str] = None
    _activation_dtype: Optional[str] = None
    _fused_kernels: Optional[bool] = None

    @classmethod
    def device(cls, device: Union[str, torch.device, None] = None) -> torch.device:
        """Resolve an entry point's ``device`` argument: ``None`` means the
        card (``cuda``), which must exist; anything else is taken as asked."""
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return dev

    @classmethod
    def compute_dtype(cls) -> str:
        """Dtype of matmul OPERANDS in the hot paths (accumulation is fp32).
        Default: bfloat16 where a card is present, float32 otherwise — the
        JAX package's backend rule (bf16 on the accelerator, exact f32 on
        the CPU)."""
        if cls._compute_dtype is not None:
            return cls._compute_dtype
        return "bfloat16" if torch.cuda.is_available() else "float32"

    @classmethod
    def set_compute_dtype(cls, dtype) -> None:
        with cls._lock:
            cls._compute_dtype = None if dtype is None else _dtype_name(dtype)

    @classmethod
    def activation_dtype(cls) -> Optional[str]:
        """Dtype hot-op OUTPUTS keep (None = upcast to float32, the default)."""
        return cls._activation_dtype

    @classmethod
    def set_activation_dtype(cls, dtype) -> None:
        with cls._lock:
            cls._activation_dtype = None if dtype is None else _dtype_name(dtype)

    @classmethod
    def set_fused_kernels(cls, enabled: Optional[bool]) -> None:
        """Opt into (``True``) or out of (``False``) the fused-kernel paths:
        the ``Linear``/``SpatialConvolution`` bias+activation epilogues run
        :func:`bigdl_tpu_torch.ops.fused_epilogue.fused_bias_act` (a CUDA
        kernel on the card, its plain version on the CPU). ``None`` goes back
        to the ``BIGDL_FUSED_KERNELS`` default. The JAX package reads its
        switch at trace time; the port reads it at every call, so a flip
        takes effect at the next forward."""
        with cls._lock:
            cls._fused_kernels = None if enabled is None else bool(enabled)

    @classmethod
    def fused_kernels(cls) -> bool:
        """The fused-kernel switch (default: the ``BIGDL_FUSED_KERNELS`` env
        flag, i.e. off)."""
        if cls._fused_kernels is not None:
            return cls._fused_kernels
        return env_flag("BIGDL_FUSED_KERNELS")


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def env_flag(name: str) -> bool:
    """An on/off environment flag: "1", "true", "yes" or "on" (any case) is
    on; anything else, or unset, is off."""
    return os.environ.get(name, "").lower() in ("1", "true", "yes", "on")
