"""Capability probes (counterpart of the float8 part of
``bigdl_tpu/utils/compat.py``).

:func:`probe_float8` answers once per process whether this torch has the
float8 formats and converts to them: every fp8 knob (``quantize_fp8``,
``quantize(dtype="fp8")``, ``ModelServer.register(quantize="fp8")``) takes
its decision from it, so a build without float8 gives one typed answer, a
``ValueError`` with the probe's reason. :func:`float8_matmul_reason` adds the
card's side: the fp8 product (``torch._scaled_mm``) needs a card of compute
capability 8.9 or higher.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


class Float8Support:
    """The probe's answer: ``available`` and either the dtypes by name
    (``"float8_e4m3fn"``, ``"float8_e5m2"``) or the ``reason`` they are
    missing. The probe is behavioural: a cast must round-trip."""

    __slots__ = ("available", "dtypes", "reason")

    def __init__(self, available: bool, dtypes: Optional[Dict[str, torch.dtype]] = None,
                 reason: Optional[str] = None):
        self.available = bool(available)
        self.dtypes = dict(dtypes or {})
        self.reason = reason


_float8_probe_cache: Optional[Float8Support] = None


def probe_float8(refresh: bool = False) -> Float8Support:
    """Whether ``torch.float8_e4m3fn`` and ``torch.float8_e5m2`` exist and
    a host cast to each round-trips (probed once per process)."""
    global _float8_probe_cache
    if _float8_probe_cache is not None and not refresh:
        return _float8_probe_cache
    dtypes = {}
    try:
        for name in ("float8_e4m3fn", "float8_e5m2"):
            dt = getattr(torch, name, None)
            if dt is None:
                raise AttributeError(f"torch lacks {name}")
            back = torch.tensor([0.5, -2.0]).to(dt).to(torch.float32)
            if back.tolist() != [0.5, -2.0]:
                raise ValueError(f"{name} cast does not round-trip: {back.tolist()}")
            dtypes[name] = dt
        support = Float8Support(True, dtypes=dtypes)
    except Exception as e:  # the reason travels to the ValueError of the knob
        support = Float8Support(False, reason=f"{type(e).__name__}: {e}")
    _float8_probe_cache = support
    return support


def float8_matmul_reason(device: torch.device) -> Optional[str]:
    """Why fp8 products cannot run on ``device`` (None when they can): on a
    card, ``torch._scaled_mm`` needs compute capability 8.9 or higher."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    cap = torch.cuda.get_device_capability(device)
    if cap < (8, 9):
        return f"fp8 products need compute capability 8.9 or higher; this card is sm_{cap[0]}{cap[1]}"
    return None
