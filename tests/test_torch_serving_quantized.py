"""The quantized serving tiers of the port's ``ModelServer`` against the JAX
package's, on the CPU: ``register(quantize=False|True|"int8"|"fp8")`` and
``update(quantize=...)``, each case of the JAX package's serving tests
(``tests/test_serving.py``'s quantized fast path, ``tests/test_quantized.py``'s
fp8 tier) and each branch of the quantize contract (a pre-quantized model
detected, a family that differs from it refused, an unknown value refused,
fp8 without float8 refused), run through both packages' servers in one
test with the same model and records.

Models: the JAX serving tests' MLP (12 -> 16 -> ReLU -> 4) with the JAX
weights carried into the port. Outcomes must be equal: the ``models()``
tag, the serve records' ``quantized`` field, the typed errors, the version
after a refused update. Served rows within 1e-6 of the largest |value|:
the JAX server's compiled executable may fuse the f32 dequantization
multiply with the bias add (one rounding for two), and fp8's f32 sums run in
another order (the int8 codes and int32 sums themselves are equal to the
bit: ``tests/test_torch_quantized.py``).
"""

import numpy as np
import pytest

import bigdl_tpu.utils.compat as jcompat
from bigdl_tpu_torch.utils import compat as pcompat

from test_torch_serving_resilience import (PKGS, TIMEOUT, _fp32_policy,  # noqa: F401
                                           _rows, _server, _wait_until)

ROW_REL = 1e-6


def _records(n=5, seed=3):
    return np.random.default_rng(seed).standard_normal((n, 12)).astype(np.float32)


def _serve(pkg, quantize, records, tel=None):
    """Register the MLP with ``quantize``, serve ``records``; returns the
    tag, the rows and the serve records' tags."""
    tel = tel or pkg.Telemetry(exporters=[])
    with _server(pkg, telemetry=tel) as srv:
        srv.register("q", pkg.mlp(), sample_input=records[0], batch_size=8, quantize=quantize,
                     max_delay_ms=3)
        tag = srv.models()["q"]["quantized"]
        rows = np.stack([_rows(srv.infer("q", r).result(timeout=TIMEOUT)) for r in records])
        # a flush's serve record follows its results on the batching thread
        assert _wait_until(lambda: _n_serves(tel) >= len(records), TIMEOUT)
    serves = [r["quantized"] for r in tel.ring.records if r["type"] == "serve"]
    return tag, rows, serves


def _n_serves(tel):
    return sum(1 for r in tel.ring.records if r["type"] == "serve")


def _held(port_rows, jax_rows):
    np.testing.assert_allclose(port_rows, jax_rows, rtol=0, atol=ROW_REL * np.abs(jax_rows).max())


@pytest.mark.parametrize("quantize,family", [(True, "int8"), ("int8", "int8"), ("fp8", "fp8")])
def test_register_quantize_tags_the_family_and_serves_jax_rows(quantize, family):
    x = _records()
    out = {p.name: _serve(p, quantize, x) for p in PKGS}
    (ptag, prows, pserves), (jtag, jrows, jserves) = out["port"], out["jax"]
    assert ptag == jtag == family
    assert pserves and pserves == [family] * len(pserves)
    assert jserves and set(jserves) == {family}
    assert prows.shape == jrows.shape == (5, 4)
    _held(prows, jrows)


@pytest.mark.parametrize("quantize", [False, None])
def test_float_registration_is_tagged_false(quantize):
    x = _records(2)
    tags = {p.name: _serve(p, quantize, x)[::2] for p in PKGS}
    assert tags["port"] == tags["jax"]
    assert tags["port"][0] is False and set(tags["port"][1]) == {False}


def test_pre_quantized_model_is_detected_and_a_second_family_refused():
    x = _records(3)

    def scenario(pkg):
        with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as srv:
            srv.register("a", pkg.mlp().quantize("int8"), sample_input=x[0], batch_size=8)
            srv.register("b", pkg.mlp().quantize("fp8"), sample_input=x[0], batch_size=8,
                         quantize="fp8")
            with pytest.raises(ValueError, match="already int8-quantized") as e:
                srv.register("c", pkg.mlp().quantize("int8"), sample_input=x[0], batch_size=8,
                             quantize="fp8")
            rows = _rows(srv.infer("a", x[1]).result(timeout=TIMEOUT))
            return ({k: v["quantized"] for k, v in srv.models().items()},
                    str(e.value).split(";")[0], rows)

    out = {p.name: scenario(p) for p in PKGS}
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][0] == {"a": "int8", "b": "fp8"}
    _held(out["port"][2], out["jax"][2])


@pytest.mark.parametrize("bad", ["int4", "float8", 8])
def test_unknown_quantize_value_raises_the_same_error(bad):
    x = _records(1)

    def scenario(pkg):
        with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as srv:
            with pytest.raises(ValueError, match="int8.*fp8|fp8.*int8") as e:
                srv.register("bad", pkg.mlp(), sample_input=x[0], batch_size=8, quantize=bad)
            return str(e.value), srv.models()

    out = {p.name: scenario(p) for p in PKGS}
    assert out["port"] == out["jax"]
    assert out["port"][1] == {}


def test_fp8_without_float8_is_refused_at_registration(monkeypatch):
    x = _records(1)
    for mod in (jcompat, pcompat):
        monkeypatch.setattr(mod, "_float8_probe_cache", mod.Float8Support(False, reason="simulated"))

    def scenario(pkg):
        with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as srv:
            with pytest.raises(ValueError, match="simulated") as e:
                srv.register("f8", pkg.mlp(), sample_input=x[0], batch_size=8, quantize="fp8")
            srv.register("i8", pkg.mlp(), sample_input=x[0], batch_size=8, quantize="int8")
            return str(e.value), srv.models()["i8"]["quantized"]

    out = {p.name: scenario(p) for p in PKGS}
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("family", ["int8", "fp8"])
def test_update_quantize_swaps_to_the_tier_and_tags_later_records(family):
    x = _records(4)

    def scenario(pkg):
        tel = pkg.Telemetry(exporters=[])
        with _server(pkg, telemetry=tel) as srv:
            srv.register("m", pkg.mlp(), sample_input=x[0], batch_size=8, max_delay_ms=3)
            before = _rows(srv.infer("m", x[0]).result(timeout=TIMEOUT))
            # the float version's flush has emitted its record before the
            # swap (the record follows the results on the batching thread)
            assert _wait_until(lambda: _n_serves(tel) >= 1, TIMEOUT)
            version = srv.update("m", pkg.mlp(seed=2), quantize=family)
            after = np.stack([_rows(srv.infer("m", r).result(timeout=TIMEOUT)) for r in x])
            info = srv.models()["m"]
            with pytest.raises(ValueError, match="already"):
                other = "fp8" if family == "int8" else "int8"
                srv.update("m", pkg.mlp(seed=3).quantize(family), quantize=other)
            again = srv.models()["m"]
        tags = [r["quantized"] for r in tel.ring.records if r["type"] == "serve"]
        return (version, info["quantized"], info["version"], again["version"],
                again["quantized"], tags[0], set(tags[1:])), before, after

    out = {p.name: scenario(p) for p in PKGS}
    assert out["port"][0] == out["jax"][0] == (2, family, 2, 2, family, False, {family})
    np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=0, atol=1e-5)
    _held(out["port"][2], out["jax"][2])


def test_update_of_a_pre_quantized_model_keeps_its_family_without_asking():
    x = _records(2)

    def scenario(pkg):
        with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as srv:
            srv.register("m", pkg.mlp(), sample_input=x[0], batch_size=8, quantize=True)
            srv.update("m", pkg.mlp(seed=2).quantize("fp8"))
            rows = _rows(srv.infer("m", x[1]).result(timeout=TIMEOUT))
            return srv.models()["m"]["quantized"], rows

    out = {p.name: scenario(p) for p in PKGS}
    assert out["port"][0] == out["jax"][0] == "fp8"
    _held(out["port"][1], out["jax"][1])


def test_a_swap_after_the_results_keeps_the_flush_records_tag():
    """The serve record of a flush carries the tags of the version that
    dispatched it, also when ``update`` swaps in a quantized version between
    the flush's results and its record (the batching thread held there)."""
    import threading

    from bigdl_tpu_torch.obs import Telemetry
    from test_torch_serving_resilience import PORT

    tel = Telemetry(exporters=[])
    b = PORT.s.ContinuousBatcher(PORT.predictor(PORT.mlp(), 4), name="m", telemetry=tel,
                                 max_delay_ms=1.0, tags={"quantized": False})
    held, go = threading.Event(), threading.Event()
    record_success = b.breaker.record_success

    def hold_once(*a, **k):
        if not held.is_set():
            held.set()
            go.wait(TIMEOUT)
        return record_success(*a, **k)

    b.breaker.record_success = hold_once
    b.start()
    try:
        fut = b.submit(PORT.s.ServeRequest(_records(1)[0]))
        fut.result(timeout=TIMEOUT)
        assert held.wait(TIMEOUT)
        b.swap(PORT.predictor(PORT.mlp(seed=2).quantize("int8"), 4), 2,
               tags={"quantized": "int8"})
        go.set()
        assert _wait_until(lambda: _n_serves(tel) >= 1, TIMEOUT)
        b.submit(PORT.s.ServeRequest(_records(1)[0])).result(timeout=TIMEOUT)
        assert _wait_until(lambda: _n_serves(tel) >= 2, TIMEOUT)
    finally:
        go.set()
        b.stop()
    tags = [(r["version"], r["quantized"]) for r in tel.ring.records if r["type"] == "serve"]
    assert tags == [(1, False), (2, "int8")]
