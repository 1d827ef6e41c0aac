"""The port's runtime probe (``bigdl_tpu_torch/ops/probe.py``) against the
JAX package's (``bigdl_tpu/ops/pallas_probe.py``): a CPU device is not a
place the kernels run and gets False with a reason; the verdict and its
reason are cached and cleared by ``reset_probe_cache``; the plain version
equals the JAX probe kernel's body run through ``pallas_call`` in interpret
mode; on a CUDA device a failed probe raises and is never a False (the JAX
gate's degrade-to-XLA answer). Marked ``gpu``: the probe on the card, and
a corrupted result that must raise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu.ops import pallas_probe
from bigdl_tpu.utils import compat
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops import probe


@pytest.fixture(autouse=True)
def _fresh_cache():
    probe.reset_probe_cache()
    yield
    probe.reset_probe_cache()


def test_cpu_device_is_unavailable_without_probing(monkeypatch):
    calls = []
    monkeypatch.setattr(probe, "_probe_once", lambda *a: calls.append(a))
    assert probe.kernels_available("cpu") is False
    assert probe.kernels_available(torch.device("cpu")) is False
    assert calls == []  # short-circuits on the device, never launches
    assert "cpu" in probe.unavailable_reason()
    assert "cpu" in probe.unavailable_reason("cpu")


def test_reason_clears_after_reset():
    assert probe.kernels_available("cpu") is False
    assert probe.unavailable_reason() is not None
    probe.reset_probe_cache()
    assert probe.unavailable_reason() is None
    assert probe.unavailable_reason("cpu") is None


def _interpret_pallas_probe(monkeypatch):
    """Run the JAX package's ``_probe_once`` with its ``pallas_call`` in
    interpret mode; returns its kernel body and the (input, output) pair."""
    seen = {}
    real = compat.pallas_call

    def interpreted(body, **kw):
        kw["interpret"] = True
        call = real(body, **kw)

        def run(x):
            y = call(x)
            seen.update(body=body, x=np.array(x), y=np.array(y))
            return y

        return run

    monkeypatch.setattr(compat, "pallas_call", interpreted)
    pallas_probe._probe_once()  # raises if its own check fails
    return seen


def test_plain_version_matches_the_jax_probe_kernel(monkeypatch):
    seen = _interpret_pallas_probe(monkeypatch)
    assert seen["x"].shape == probe.SHAPE and seen["x"].dtype == np.float32
    got = probe.probe_reference(torch.from_numpy(seen["x"]))
    np.testing.assert_array_equal(got.numpy(), seen["y"])
    # the same body on a random (8, 128) block, through pallas_call in interpret mode
    x = np.random.default_rng(0).standard_normal(probe.SHAPE).astype(np.float32)
    want = compat.pallas_call(seen["body"], interpret=True,
                              out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32))(
        jnp.asarray(x))
    np.testing.assert_array_equal(probe.probe_reference(torch.from_numpy(x)).numpy(),
                                  np.asarray(want))


def test_add_one_on_cpu_takes_the_plain_version_and_launches_nothing():
    before = probe.launches
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    torch.testing.assert_close(probe.add_one(x), x + 1, rtol=0, atol=0)
    assert probe.launches == before


def test_add_one_takes_no_other_route():
    with pytest.raises(ValueError, match="device"):
        probe.add_one(torch.empty(probe.SHAPE, device="meta"))


class _FakeLib:
    pass


def test_failure_on_a_cuda_device_raises_and_is_cached(monkeypatch):
    """A probe that fails on a CUDA device raises with the reason and the
    build log's path, and raises again from the cache without relaunching."""
    calls = []

    def boom(lib, device):
        calls.append(device)
        raise RuntimeError("illegal instruction")

    monkeypatch.setattr(probe, "_probe_once", boom)
    dev = torch.device("cuda", 0)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="illegal instruction") as e:
            probe.run(_FakeLib(), dev)
        assert str(_build.build_dir() / "build.log") in str(e.value)
    assert calls == [dev]
    assert "illegal instruction" in probe.unavailable_reason(dev)


def test_success_on_a_cuda_device_is_cached(monkeypatch):
    calls = []
    monkeypatch.setattr(probe, "_probe_once", lambda lib, dev: calls.append(dev))
    dev = torch.device("cuda", 0)
    assert probe.run(_FakeLib(), dev) is True
    assert probe.run(_FakeLib(), dev) is True
    assert calls == [dev]
    assert probe.unavailable_reason(dev) is None


def test_load_probes_the_library_it_loads(monkeypatch):
    """``_build.load`` probes a freshly loaded library before returning it,
    and does not keep a library whose probe raised."""
    lib, seen = _FakeLib(), []
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "build", lambda: "libfake.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: lib)
    monkeypatch.setattr(_build, "_bind", lambda l: l)

    def fail(l, device):
        seen.append((l, device))
        raise RuntimeError("probe kernel wrote zeros")

    monkeypatch.setattr(probe, "run", fail)
    with pytest.raises(RuntimeError, match="zeros"):
        _build.load()
    assert seen == [(lib, "cuda")] and _build._lib is None
    monkeypatch.setattr(probe, "run", lambda l, device: seen.append((l, device)) or True)
    assert _build.load() is lib and _build.load() is lib
    assert seen[1:] == [(lib, "cuda")]  # probed once, at the first load


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_probe.py`")


@pytest.mark.gpu
def test_probe_on_card(cuda_card, monkeypatch):
    assert probe.kernels_available("cuda") is True
    assert probe.unavailable_reason() is None
    x = torch.randn(probe.SHAPE, device="cuda")
    before = probe.launches
    y = probe.add_one(x)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert torch.equal(y, probe.probe_reference(x))
    # a launch that writes zeros instead of x + 1 must raise, never answer False
    probe.reset_probe_cache()
    monkeypatch.setattr(probe, "_launch", lambda lib, x, y: (y.zero_(), 0)[1])
    with pytest.raises(RuntimeError, match="other than 1.0"):
        probe.kernels_available("cuda")
