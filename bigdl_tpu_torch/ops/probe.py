"""Runtime probe: do the port's CUDA kernels load and run on this card?

Counterpart of ``bigdl_tpu/ops/pallas_probe.py``. The kernel, ``y = x + 1``
on an (8, 128) float32 block, lives in ``bigdl_tpu_torch/csrc/probe.cu``;
:func:`add_one` launches it and :func:`probe_reference` is its plain version.

:func:`bigdl_tpu_torch.ops._build.load` runs the probe once, on the current
CUDA device, right after it loads a freshly built library, so the first
kernel launch of every path goes through it. Where the JAX package's gate
answers False and its callers degrade to XLA, this probe raises: the port
has no plain route on the card to degrade to. A CPU device is simply not a
place the kernels run, and gets ``False`` with a reason naming it. The
verdict is cached per device; :func:`reset_probe_cache` is the test hook.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

SHAPE = (8, 128)

launches = 0  # kernel launches (never the plain version)
_count_lock = threading.Lock()
_cache: Dict[str, bool] = {}
_reason: Dict[str, str] = {}
_last: Optional[str] = None  # the device of the last verdict


def probe_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the probe kernel: ``x + 1``."""
    return x + 1.0


def _launch(lib, x: torch.Tensor, y: torch.Tensor) -> int:
    return lib.bigdl_probe_add_one(x.data_ptr(), y.data_ptr(), x.numel(),
                                   torch.cuda.current_stream(x.device).cuda_stream)


def add_one(x: torch.Tensor, lib=None) -> torch.Tensor:
    """``x + 1`` for a contiguous float32 tensor: the kernel on a CUDA tensor
    (``lib``: the loaded library, by default :func:`_build.load`'s), the
    plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return probe_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"add_one: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"add_one: needs a contiguous float32 tensor, got {x.dtype} "
                         f"with strides {x.stride()}")
    if lib is None:
        from . import _build

        lib = _build.load()
    y = torch.empty_like(x)
    rc = _launch(lib, x, y)
    if rc != 0:
        raise RuntimeError(f"add_one: kernel launch failed with CUDA error {rc}")
    global launches
    with _count_lock:
        launches += 1
    return y


def _probe_once(lib, device: torch.device) -> None:
    """Launch the probe kernel on zeros, wait for it, and check that every
    element is 1.0; raises on any failure."""
    with torch.cuda.device(device):
        y = add_one(torch.zeros(SHAPE, dtype=torch.float32, device=device), lib)
        torch.cuda.synchronize(device)
    if not bool((y == 1.0).all()):
        bad = int((y != 1.0).sum())
        raise RuntimeError(f"the probe kernel wrote {bad} of {y.numel()} elements "
                           "other than 1.0")


def _key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def run(lib, device) -> bool:
    """The probe on ``device`` with the loaded library ``lib`` (what
    :func:`_build.load` calls): True, or raises ``RuntimeError`` with the
    reason and the path of nvcc's log. A failure is cached and raised again."""
    global _last
    dev = _key(device)
    key = _last = str(dev)
    if key not in _cache:
        try:
            _probe_once(lib, dev)
            _cache[key] = True
            _reason.pop(key, None)
        except Exception as e:  # a launch error, a fault at the sync, a wrong value
            _cache[key] = False
            _reason[key] = f"{type(e).__name__}: {e}"
    if not _cache[key]:
        from . import _build

        raise RuntimeError(f"the port's CUDA kernels do not run on {key}: {_reason[key]} "
                           f"(nvcc's output: {_build.build_dir() / 'build.log'})")
    return True


def kernels_available(device="cuda") -> bool:
    """True iff the port's kernels run on ``device``. A CPU device gives
    False (the kernels run on CUDA devices only); on a CUDA device the
    library is loaded (built on first use) and probed, and a failure raises
    ``RuntimeError``: this never answers False for a CUDA device."""
    global _last
    dev = _key(device)
    key = str(dev)
    if dev.type != "cuda":
        _last = key
        _cache[key] = False
        _reason[key] = f"device is {key}: the kernels run on CUDA devices only"
        return False
    if _cache.get(key):
        _last = key
        return True
    from . import _build

    return run(_build.load(), dev)


def unavailable_reason(device=None) -> Optional[str]:
    """Why the probe said no on ``device`` (default: the device of the last
    verdict); None if it said yes or never ran."""
    key = _last if device is None else str(_key(device))
    if key is None or _cache.get(key):
        return None
    return _reason.get(key)


def reset_probe_cache() -> None:
    """Test hook."""
    global _last
    _cache.clear()
    _reason.clear()
    _last = None
