"""The port's native host library (``bigdl_tpu_torch/csrc/bigdl_host.cpp``,
built by ``bigdl_tpu_torch/native.py`` with g++ at first use) against its
plain versions and the JAX package's ``native`` module.

Limits: ``gather_rows`` bit-equal to numpy fancy indexing; ``crc32c`` equal
to the one-byte-a-step ``_py_crc32c``; ``u8hwc_to_f32chw`` within 1e-5 of
numpy's ``(x - mean) / std`` (the library multiplies by ``1 / std``, as the
JAX package's test allows). Against the JAX package's module every entry
point is bit-equal (``u8hwc_to_f32chw`` where its library is loaded). The
build: into ``build/host`` (which ``.gitignore`` lists), a failed build
raises with the compiler's output, concurrent builders leave one good
library, and the repo's ``csrc/libbigdl_host.so`` is never what the port
loads.
"""

import os
import threading
from pathlib import Path

import numpy as np
import pytest

import bigdl_tpu.native as jnative
from bigdl_tpu_torch import native


def test_library_builds_into_the_ignored_build_dir():
    assert native.available()
    path = Path(native._load()._name)
    root = Path(native.__file__).resolve().parents[1]
    assert path == root / "build" / "host" / native.LIB_NAME
    assert path.resolve() != (root / "csrc" / "libbigdl_host.so").resolve()
    ignored = (root / ".gitignore").read_text().split()
    assert "build/" in ignored
    stamp = path.parent / (native.LIB_NAME + ".sha256")
    assert stamp.read_text() == native.source_hash()


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 777, 4096, 1 << 16])
def test_crc32c_matches_the_plain_version(n):
    data = np.random.default_rng(n).bytes(n)
    assert native.crc32c(data) == native._py_crc32c(data)
    assert native.crc32c(b"\x00" * 32) == 0x8A9136AA  # RFC 3720 vector


@pytest.mark.parametrize("shape", [(5, 9, 7, 3), (2, 64, 64, 3), (3, 4, 4, 1)])
def test_u8hwc_to_f32chw_matches_the_plain_version(shape):
    batch = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    c = shape[3]
    mean, std = [120.0, 110.0, 100.0][:c], [60.0, 61.0, 62.0][:c]
    out = native.u8hwc_to_f32chw(batch, mean, std)
    assert out.shape == (shape[0], c, shape[1], shape[2]) and out.dtype == np.float32
    np.testing.assert_allclose(out, native.u8hwc_to_f32chw_plain(batch, mean, std),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(native.u8hwc_to_f32chw(batch[:1], 0.0, 1.0),
                               batch[:1].transpose(0, 3, 1, 2).astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        native.u8hwc_to_f32chw(batch.astype(np.float32), mean, std)


@pytest.mark.parametrize("rows,width,dtype", [
    (50, 24, np.float32),          # under 1 MiB: numpy
    (300, 4096, np.float32),       # 2.3 MiB of rows: the library's threads
    (300, 4096, np.float64),       # not float32: numpy
    (40, 8192, np.int64),
])
def test_gather_rows_is_bit_equal_to_numpy(rows, width, dtype):
    rng = np.random.default_rng(2)
    src = (rng.standard_normal((rows, width)) * 100).astype(dtype)
    idx = rng.integers(0, rows, 150)
    got = native.gather_rows(src, idx)
    want = native.gather_rows_plain(src, idx)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert got.tobytes() == src[idx].tobytes()
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([rows]))
    with pytest.raises(IndexError):
        native.gather_rows(src, np.array([-1]))  # numpy would wrap it


def test_gather_rows_of_a_non_contiguous_source():
    src = np.random.default_rng(3).standard_normal((400, 2048)).astype(np.float32)[:, ::2]
    idx = np.arange(0, 400, 3)
    assert native.gather_rows(src, idx).tobytes() == src[idx].tobytes()


def test_entry_points_match_the_jax_package():
    """Bit-equal where the JAX package's module is exact on every route (its
    library or its numpy fallback: ``crc32c``, ``gather_rows``);
    ``u8hwc_to_f32chw`` bit-equal to its library when that is loaded, else
    within 1e-5 of its numpy fallback. (This test does not build the JAX
    package's library: its own tests do, and two concurrent ``make`` runs
    could clash.)"""
    rng = np.random.default_rng(4)
    for n in (0, 5, 1000, 65536):
        data = rng.bytes(n)
        assert native.crc32c(data) == jnative.crc32c(data)
    batch = rng.integers(0, 256, (4, 32, 16, 3), dtype=np.uint8)
    a = native.u8hwc_to_f32chw(batch, (1.0, 2.0, 3.0), (0.5, 3.0, 7.0))
    b = jnative.u8hwc_to_f32chw(batch, (1.0, 2.0, 3.0), (0.5, 3.0, 7.0))
    if jnative.available():
        assert a.tobytes() == b.tobytes()
    else:
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    src = rng.standard_normal((500, 1024)).astype(np.float32)
    idx = rng.integers(0, 500, 400)
    assert native.gather_rows(src, idx).tobytes() == jnative.gather_rows(src, idx).tobytes()


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build()
    assert "bad.cpp" in str(e.value)
    assert not (tmp_path / native.LIB_NAME).exists()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot be built"):
        native.build()


def test_concurrent_builders_leave_one_good_library(tmp_path, monkeypatch):
    """Four builders at once (the test runner's workers): one compiles under
    the lock, the others find its library fresh; each result loads."""
    import ctypes

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    out, errors = [], []

    def build():
        try:
            out.append(native.build())
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(out)) == 1
    lib = ctypes.CDLL(str(out[0]))
    assert lib.bigdl_host_abi_version() == native.ABI_VERSION
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [native.LIB_NAME, native.LIB_NAME + ".lock", native.LIB_NAME + ".sha256"])
    mtime = os.path.getmtime(out[0])
    assert native.build() == out[0] and os.path.getmtime(out[0]) == mtime  # fresh: kept
