"""Build and load the port's CUDA kernels.

At first use, every ``bigdl_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source started together, and linked into
one shared library with a plain C interface, ``build/kernels/libbigdl_tpu_torch.so``
under the checkout root, which is then loaded with ``ctypes`` and probed
once (``ops/probe.py``: one launch of the probe kernel, checked). The build
is keyed on a hash of the sources (and the flags): a library whose stamp
differs is rebuilt. Nothing here falls back: a missing ``nvcc``, a failed
build or a failed probe raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libbigdl_tpu_torch.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output (ptxas register/spill report) of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the port's CUDA kernels cannot be built")


def sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def source_hash() -> str:
    h = hashlib.sha256()
    for f in [*ARCH, *FLAGS]:
        h.update(f.encode())
    for s in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def _run(cmd):
    r = subprocess.run(cmd, capture_output=True, text=True)
    out = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}\n{out}")
    return out


def build(force: bool = False) -> Path:
    """Compile the sources into the shared library unless an up-to-date one
    (same source hash) is already there; returns its path."""
    global build_log
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()
    if not force and lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources()]
        cmds = [[nvcc, *ARCH, *FLAGS, "-c", str(s), "-o", str(o)]
                for s, o in zip(sources(), objs)]
        with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
            logs = list(pool.map(_run, cmds))
        tmp_lib = Path(tmp) / LIB_NAME
        logs.append(_run([nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
                          *map(str, objs)]))
        os.replace(tmp_lib, lib)  # atomic: a concurrent loader sees old or new
    stamp.write_text(digest)
    build_log = "".join(logs)
    (BUILD_DIR / "build.log").write_text(build_log)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn = lib.bigdl_flash_attention_fwd
    fn.argtypes = ([vp] * 6 + [i] * 6 + [ll] * 9 + [f, i, i, vp])
    fn.restype = ctypes.c_int
    # q, k, v, dO, lse, delta, outputs (dq, dk, dv | dq | dk, dv), lengths; then as
    # the forward
    for fn, n_out in ((lib.bigdl_flash_attention_bwd, 3),
                      (lib.bigdl_flash_attention_bwd_dq, 1),
                      (lib.bigdl_flash_attention_bwd_dkv, 2)):
        fn.argtypes = ([vp] * (7 + n_out) + [i] * 6 + [ll] * 12 + [f, i, i, vp])
        fn.restype = ctypes.c_int
    # x, dy, dx, dtype, planes, h, w, ho, wo, kh, kw, sh, sw, ph, pw, stream
    fn = lib.bigdl_maxpool2d_bwd
    fn.argtypes = [vp] * 3 + [i, ll] + [i] * 10 + [vp]
    fn.restype = ctypes.c_int
    # x, b, y, dtype, act, row_mode, rows, cols, channels, stream
    fn = lib.bigdl_bias_act_fwd
    fn.argtypes = [vp] * 3 + [i] * 3 + [ll] * 3 + [vp]
    fn.restype = ctypes.c_int
    # x, b, dy, dx, partial, db, dtype, act, rows, cols, row_tile, stream
    fn = lib.bigdl_bias_act_bwd_feature
    fn.argtypes = [vp] * 6 + [i] * 2 + [ll] * 2 + [i, vp]
    fn.restype = ctypes.c_int
    # x, b, dy, dx, db_rows, dtype, act, rows, cols, channels, stream
    fn = lib.bigdl_bias_act_bwd_row
    fn.argtypes = [vp] * 5 + [i] * 2 + [ll] * 3 + [vp]
    fn.restype = ctypes.c_int
    # x, w, b, y, dtype, rows, h, eps, stream
    fn = lib.bigdl_layer_norm_fwd
    fn.argtypes = [vp] * 4 + [i, ll, i, f, vp]
    fn.restype = ctypes.c_int
    # x, w, dy, dx, partial, dwdb, dtype, rows, h, row_tile, eps, stream
    fn = lib.bigdl_layer_norm_bwd
    fn.argtypes = [vp] * 6 + [i, ll, i, i, f, vp]
    fn.restype = ctypes.c_int
    # x, w, y, dtype, rows, h, eps, stream
    fn = lib.bigdl_rms_norm_fwd
    fn.argtypes = [vp] * 3 + [i, ll, i, f, vp]
    fn.restype = ctypes.c_int
    # x, w, dy, dx, partial, dw, dtype, rows, h, row_tile, eps, stream
    fn = lib.bigdl_rms_norm_bwd
    fn.argtypes = [vp] * 6 + [i, ll, i, i, f, vp]
    fn.restype = ctypes.c_int
    # x, y, n, stream
    fn = lib.bigdl_probe_add_one
    fn.argtypes = [vp, vp, ll, vp]
    fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), probed once on the
    current CUDA device before it is first returned."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _bind(ctypes.CDLL(str(build())))
            from . import probe

            # Where the JAX package's gate (pallas_probe.pallas_available)
            # answers False and its callers degrade to XLA, this raises: the
            # port has no plain route on the card.
            probe.run(lib, "cuda")
            _lib = lib
        return _lib
