"""``Metrics`` (counterpart of ``bigdl_tpu/optim/metrics.py``): the
host-side averager lives in :mod:`bigdl_tpu_torch.obs.telemetry`; this path
is kept for ``from bigdl_tpu_torch.optim.metrics import Metrics``."""

from __future__ import annotations

from ..obs.telemetry import Metrics

__all__ = ["Metrics"]
