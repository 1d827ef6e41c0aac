"""Capability probes and the compile cache's files (counterpart of the
float8 and compile-cache parts of ``bigdl_tpu/utils/compat.py``).

:func:`probe_float8` answers once per process whether this torch has the
float8 formats and converts to them: every fp8 knob (``quantize_fp8``,
``quantize(dtype="fp8")``, ``ModelServer.register(quantize="fp8")``) takes
its decision from it, so a build without float8 gives one typed answer, a
``ValueError`` with the probe's reason. :func:`float8_matmul_reason` adds the
card's side: the fp8 product (``torch._scaled_mm``) needs a card of compute
capability 8.9 or higher.

The port's compile cache is the directory of the kernel library
(``ops/_build.py`` :func:`~bigdl_tpu_torch.ops._build.build_dir`): the
``nvcc``-built ``libbigdl_tpu_torch.so`` and its source-hash stamp.
:func:`harvest_compile_cache` copies those two files out of it (an artifact
bundle's ``cache/``), :func:`seed_compile_cache` copies them into a
configured directory (never over files already there),
:func:`prune_compile_cache` bounds a directory by age and size, and
:class:`CacheDirWatch` tells which files appeared between two looks.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, List, Optional, Set

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


# ------------------------------------------------------------ compile cache
def _library_files():
    from ..ops import _build

    return (_build.LIB_NAME, _build.STAMP_NAME)


def compilation_cache_entries() -> Optional[Set[str]]:
    """Names of the files in the active cache directory (the LRU's
    ``-atime`` markers left out), or None when it does not exist."""
    from ..ops import _build

    d = _build.build_dir()
    if not d.is_dir():
        return None
    return {f.name for f in d.iterdir() if f.is_file() and not f.name.endswith("-atime")}


class CacheDirWatch:
    """Snapshot of the active cache directory: :meth:`delta` names the
    files added since the last look, :meth:`observe` answers whether
    nothing fresh was written (True), something was (False) or no
    directory exists (None), :meth:`fresh_count` counts the fresh files."""

    def __init__(self):
        self._snap = compilation_cache_entries()

    def delta(self) -> Optional[Set[str]]:
        now = compilation_cache_entries()
        if now is None or self._snap is None:
            self._snap = now
            return None
        new = now - self._snap
        self._snap = now
        return new

    def observe(self) -> Optional[bool]:
        new = self.delta()
        return None if new is None else not new

    def fresh_count(self) -> Optional[int]:
        new = self.delta()
        return None if new is None else len(new)


def _copy_atomic(src: str, target: str) -> None:
    """Copy through a temporary name: a concurrent loader sees the old
    file or the whole new one."""
    tmp = f"{target}.tmp{os.getpid()}"
    shutil.copy2(src, tmp)
    os.replace(tmp, target)


def harvest_compile_cache(dest_dir: str) -> int:
    """Copy the library and its stamp from the active cache directory into
    ``dest_dir``; returns the files copied (0 where nothing is built yet)."""
    from ..ops import _build

    src = _build.build_dir()
    names = [n for n in _library_files() if (src / n).is_file()]
    if not names:
        return 0
    os.makedirs(dest_dir, exist_ok=True)
    for name in names:
        _copy_atomic(str(src / name), os.path.join(dest_dir, name))
    return len(names)


def seed_compile_cache(src_dir: str) -> int:
    """Copy the library's files from ``src_dir`` into the configured cache
    directory (the library before its stamp; a file already there is left
    as it is); returns the files copied. Raises ``RuntimeError`` when no
    directory is configured: there is nowhere to put the library, and a
    warm boot that pretended otherwise would build it cold."""
    from .engine import Engine

    dest = Engine.ensure_compilation_cache()
    if not dest:
        raise RuntimeError(
            "seed_compile_cache: no compile cache configured; set "
            "BIGDL_COMPILE_CACHE_DIR (or Engine.set_compilation_cache_dir) before "
            "warm-starting from an artifact bundle")
    n = 0
    for name in _library_files():
        src = os.path.join(src_dir, name)
        target = os.path.join(dest, name)
        if not os.path.isfile(src) or os.path.exists(target):
            continue
        _copy_atomic(src, target)
        n += 1
    return n


def prune_compile_cache(cache_dir: str, max_bytes=None, max_age_days=None) -> List[str]:
    """Drop the entries of ``cache_dir`` last used (the ``-atime`` marker's
    mtime, else the entry's own) more than ``max_age_days`` ago, then the
    least recently used until the rest fit in ``max_bytes``; returns the
    names dropped."""
    if not os.path.isdir(cache_dir):
        return []
    entries = {}
    for name in os.listdir(cache_dir):
        path = os.path.join(cache_dir, name)
        if name.endswith("-atime") or not os.path.isfile(path):
            continue
        try:
            st = os.stat(path)
        except OSError:  # raced with another pruner
            continue
        try:
            used = os.stat(path + "-atime").st_mtime
        except OSError:
            used = st.st_mtime
        entries[name] = (used, st.st_size)
    doomed: List[str] = []
    if max_age_days is not None:
        cutoff = time.time() - float(max_age_days) * 86400.0
        doomed.extend(n for n, (used, _) in entries.items() if used < cutoff)
    if max_bytes is not None:
        kept = sorted((used, n) for n, (used, _) in entries.items() if n not in doomed)
        total = sum(entries[n][1] for _, n in kept)
        for _, n in kept:
            if total <= int(max_bytes):
                break
            doomed.append(n)
            total -= entries[n][1]
    for name in doomed:
        for victim in (name, name + "-atime"):
            try:
                os.remove(os.path.join(cache_dir, victim))
            except OSError:  # already gone
                pass
    return doomed
