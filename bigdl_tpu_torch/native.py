"""ctypes bindings of the port's native host library (counterpart of
``bigdl_tpu/native.py``; source ``bigdl_tpu_torch/csrc/bigdl_host.cpp``, a
copy of the JAX package's ``csrc/bigdl_host.cpp``).

The library is built at first use with ``g++ -O3 -std=c++17 -fPIC -pthread
-shared`` into ``build/host/libbigdl_tpu_torch_host.so`` under the checkout
root, keyed on a hash of the source and the flags (a library whose stamp
differs is rebuilt), and loaded with ``ctypes``, as ``ops/_build.py`` builds
and binds the CUDA kernels. Several processes may build at once (the test
runner's workers): the build runs under an exclusive file lock into a
temporary name that ``os.replace`` puts in place, so a loader sees the old
library or the new one, never half of one.

Unlike the JAX package, nothing here falls back to numpy in silence: a
missing compiler, a failed build or a library that does not load raises
with the compiler's output. What stays on numpy is what the JAX package
routes there on purpose: ``gather_rows`` of a non-float32 or non-contiguous
source, or of less than ``_GATHER_NATIVE_MIN_BYTES`` (1 MiB) of rows, where
the thread pool's spawn and join cost more than the copy. That threshold is
the JAX package's number, taken on a host it does not name. The plain
versions (``_py_crc32c``, ``u8hwc_to_f32chw_plain``, ``gather_rows_plain``)
are what the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "bigdl_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "host"
LIB_NAME = "libbigdl_tpu_torch_host.so"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_s: Optional[float] = None  # wall seconds of this process's last build (None: none)


def _compiler() -> str:
    return os.environ.get("CXX", "g++")


def source_hash() -> str:
    h = hashlib.sha256()
    for f in [_compiler(), *FLAGS]:
        h.update(f.encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> Path:
    """Compile the library unless an up-to-date one (same source hash) is
    there; returns its path. Raises ``RuntimeError`` with the compiler's
    output when the build fails."""
    import time

    global build_s
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = source_hash()

    def fresh() -> bool:
        return lib.exists() and stamp.exists() and stamp.read_text() == digest

    if not force and fresh():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / (LIB_NAME + ".lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)  # one builder at a time across processes
        try:
            if not force and fresh():  # another process built it while we waited
                return lib
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                tmp_lib = Path(tmp) / LIB_NAME
                cmd = [_compiler(), *FLAGS, "-o", str(tmp_lib), str(SOURCE)]
                try:
                    r = subprocess.run(cmd, capture_output=True, text=True)
                except OSError as e:
                    raise RuntimeError(f"the host library cannot be built: {cmd[0]}: {e}") from e
                if r.returncode != 0:
                    raise RuntimeError(f"g++ failed ({r.returncode}): {' '.join(cmd)}\n"
                                       f"{r.stdout}{r.stderr}")
                os.replace(tmp_lib, lib)  # atomic: a concurrent loader sees old or new
            stamp.write_text(digest)
            build_s = time.perf_counter() - t0
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.bigdl_crc32c.restype = ctypes.c_uint32
    lib.bigdl_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.bigdl_u8hwc_to_f32chw.restype = None
    lib.bigdl_u8hwc_to_f32chw.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.bigdl_gather_f32.restype = None
    lib.bigdl_gather_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.bigdl_host_abi_version.restype = ctypes.c_int
    version = lib.bigdl_host_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(f"host library ABI {version}, expected {ABI_VERSION}")
    return lib


def _load() -> ctypes.CDLL:
    """The loaded library, built on first call; raises when it cannot be."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except OSError as e:
                raise RuntimeError(f"the host library {path} does not load: {e}") from e
        return _lib


def available() -> bool:
    """Whether the library builds and loads (the entry points raise where
    this is False)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


# ------------------------------------------------------------------- crc32c
def _make_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1  # Castagnoli, reflected
        table.append(c)
    return table


_CRC_TABLE = _make_table()


def _py_crc32c(data: bytes) -> int:
    """The plain version: one table step a byte."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    """Castagnoli CRC of ``data`` (slice-by-8 in the library)."""
    return int(_load().bigdl_crc32c(data, len(data)))


# --------------------------------------------------------- image batch prep
def _u8_batch(batch: np.ndarray, mean, std):
    batch = np.ascontiguousarray(batch)
    if batch.dtype != np.uint8 or batch.ndim != 4:
        raise ValueError(f"expected uint8 (N,H,W,C), got {batch.dtype} {batch.shape}")
    c = batch.shape[3]
    mean = np.ascontiguousarray(np.broadcast_to(np.asarray(mean, np.float32), (c,)))
    std = np.ascontiguousarray(np.broadcast_to(np.asarray(std, np.float32), (c,)))
    return batch, mean, std


def u8hwc_to_f32chw_plain(batch: np.ndarray, mean, std) -> np.ndarray:
    """The plain version of :func:`u8hwc_to_f32chw`: numpy's ``(x - mean) /
    std`` and a transpose (within 1e-5 of the library, which multiplies by
    ``1 / std``)."""
    batch, mean, std = _u8_batch(batch, mean, std)
    out = (batch.astype(np.float32) - mean) / std
    return np.ascontiguousarray(out.transpose(0, 3, 1, 2))


def u8hwc_to_f32chw(batch: np.ndarray, mean, std) -> np.ndarray:
    """Fused ``(x - mean) / std`` and HWC -> CHW over a uint8 image batch
    (N, H, W, C), threaded across images in the library."""
    batch, mean, std = _u8_batch(batch, mean, std)
    lib = _load()
    n, h, w, c = batch.shape
    dst = np.empty((n, c, h, w), np.float32)
    lib.bigdl_u8hwc_to_f32chw(batch.ctypes.data, dst.ctypes.data, n, h, w, c,
                              mean.ctypes.data, std.ctypes.data)
    return dst


# ------------------------------------------------------------ batch gather
# below this, thread spawn/join overhead beats the memcpy win: numpy (the JAX
# package's threshold, from a host it does not name)
_GATHER_NATIVE_MIN_BYTES = 1 << 20


def _gather_indices(src: np.ndarray, indices) -> np.ndarray:
    indices = np.ascontiguousarray(np.asarray(indices, np.int64))
    # checked before the route is chosen: numpy would wrap a negative index
    if indices.size and (indices.min() < 0 or indices.max() >= src.shape[0]):
        raise IndexError("gather index out of range")
    return indices


def gather_rows_plain(src: np.ndarray, indices) -> np.ndarray:
    """The plain version of :func:`gather_rows`: numpy fancy indexing."""
    return np.ascontiguousarray(src[_gather_indices(src, indices)])


def gather_rows(src: np.ndarray, indices) -> np.ndarray:
    """``dst[i] = src[indices[i]]`` over the leading axis (minibatch
    assembly): the library's threaded copy for a float32 C-contiguous
    source with at least ``_GATHER_NATIVE_MIN_BYTES`` of rows to copy,
    numpy fancy indexing otherwise."""
    indices = _gather_indices(src, indices)
    row_len = int(np.prod(src.shape[1:], dtype=np.int64))
    if (src.dtype != np.float32 or not src.flags["C_CONTIGUOUS"]
            or len(indices) * row_len * 4 < _GATHER_NATIVE_MIN_BYTES):
        return np.ascontiguousarray(src[indices])
    lib = _load()
    dst = np.empty((len(indices),) + src.shape[1:], np.float32)
    lib.bigdl_gather_f32(src.ctypes.data, indices.ctypes.data, dst.ctypes.data,
                         len(indices), row_len)
    return dst
