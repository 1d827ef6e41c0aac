"""The port's serving path on the CPU: Predictor, ContinuousBatcher,
ModelServer, against the port's own forward and the JAX model's.

A small Transformer-LM (2 layers, hidden 64) with the JAX model's weights
answers single-record requests from several threads. Tolerances: 1e-5 to
the port's own forward (same f32 arithmetic at another batch size) and
1e-4 to JAX's (another summation order, as in test_torch_transformer.py).
Every ``result()`` and ``close()`` carries a timeout.
"""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu_torch.nn import FeedForwardNetwork
from bigdl_tpu_torch.optim import Predictor, Trigger
from bigdl_tpu_torch.serving import (ModelServer, RequestQueue, ServeRequest,
                                     ServerClosed, ServingStopped)

from test_torch_transformer import CFG, _fp32_policy, _ids, make_pair  # noqa: F401

TIMEOUT = 60


@pytest.fixture(scope="module")
def pair():
    return make_pair(_ids(1, 17))


def test_sixteen_requests_from_four_threads(pair):
    jm, pm = pair
    records = _ids(16, 17, seed=5)
    results = [None] * 16
    with ModelServer() as server:
        server.register("lm", pm, sample_input=records[0], batch_size=4, max_delay_ms=5)

        def client(idx):
            futs = [(i, server.infer("lm", records[i])) for i in idx]
            for i, f in futs:
                results[i] = f.result(TIMEOUT)

        threads = [threading.Thread(target=client, args=(range(c, 16, 4),))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        info = server.models()["lm"]
        assert info["batch_size"] == 4 and info["flushes"] >= 4
        server.close(timeout=TIMEOUT)
    own = pm.forward(records).detach()
    want = np.asarray(jm.forward(jnp.asarray(records)))
    for i, got in enumerate(results):
        assert got.device.type == "cpu" and got.shape == (17, CFG["vocab_size"])
        torch.testing.assert_close(got, own[i], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), want[i], atol=1e-4, rtol=1e-4)


def test_shape_buckets_pad_and_keep_causal_prefix(pair):
    _, pm = pair
    lengths = [9, 12, 17, 5, 14]
    rs = np.random.RandomState(6)
    records = [rs.randint(1, CFG["vocab_size"], n).astype(np.int32) for n in lengths]
    with ModelServer() as server:
        server.register("lm", pm, sample_input=records[0], batch_size=4,
                        shape_buckets=(12, 17), max_delay_ms=2)
        futs = [server.infer("lm", r) for r in records]
        outs = [f.result(TIMEOUT) for f in futs]
        server.close(timeout=TIMEOUT)
    for r, out in zip(records, outs):
        assert out.shape[0] == (12 if len(r) <= 12 else 17)
        # trailing pad ids never reach earlier positions under causal attention
        own = pm.forward(r[None]).detach()[0]
        torch.testing.assert_close(out[:len(r)], own, atol=1e-5, rtol=1e-5)


def test_predict_stacks_in_order(pair):
    _, pm = pair
    records = _ids(6, 17, seed=7)
    with ModelServer() as server:
        server.register("lm", pm, sample_input=records[0], batch_size=4, max_delay_ms=1)
        got = server.predict("lm", records, timeout=TIMEOUT)
        server.close(timeout=TIMEOUT)
    torch.testing.assert_close(got, pm.forward(records).detach(), atol=1e-5, rtol=1e-5)


def test_close_without_drain_fails_pending(pair):
    _, pm = pair
    server = ModelServer()
    server.register("lm", pm, sample_input=_ids(1, 17)[0], batch_size=4,
                    max_delay_ms=60_000, warmup=False)
    fut = server.infer("lm", _ids(1, 17)[0])  # 1 < max_batch: waits for the delay
    server.close(drain=False, timeout=TIMEOUT)
    with pytest.raises(ServerClosed):
        fut.result(TIMEOUT)
    with pytest.raises(KeyError):
        server.infer("lm", _ids(1, 17)[0])


def test_register_needs_a_sample_and_unique_names(pair):
    """An unbuilt model needs a sample to be built from; a built one
    registers without one, unwarmed, with an ``unwarmed_model`` warn (the
    JAX server's contract)."""
    _, pm = pair
    with ModelServer() as server:
        with pytest.raises(ValueError, match="sample_input"):
            server.register("ffn", FeedForwardNetwork(16, 32, device="cpu"))
        server.register("built", pm, batch_size=2)
        warns = [r for r in server.telemetry.ring.records if r["type"] == "warn"]
        assert [(w["reason"], w["model"]) for w in warns] == [("unwarmed_model", "built")]
        server.register("lm", pm, sample_input=_ids(1, 17)[0], batch_size=2,
                        warmup=False)
        with pytest.raises(ValueError, match="already registered"):
            server.register("lm", pm, sample_input=_ids(1, 17)[0])
        server.close(timeout=TIMEOUT)


def test_predictor_pads_and_slices(pair):
    _, pm = pair
    p = Predictor(pm, batch_size=4)
    x = _ids(3, 17, seed=8)
    y = p.forward_batch(x)
    assert y.shape == (3, 17, CFG["vocab_size"])
    torch.testing.assert_close(y, pm.forward(x).detach(), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(p.predict(_ids(9, 17, seed=9)),
                               pm.forward(_ids(9, 17, seed=9)).detach(),
                               atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="exceeds"):
        p.forward_batch(_ids(5, 17))
    with pytest.raises(ValueError, match="ascending"):
        Predictor(pm, shape_buckets=(17, 12))
    with pytest.raises(ValueError, match="largest shape bucket"):
        Predictor(pm, shape_buckets=(8,)).bucket_of(9)


def test_triggers():
    t = Trigger.or_(Trigger.pending_at_least(4), Trigger.waited_ms(5.0))
    assert not t({"pending": 3, "waited_ms": 4.9})
    assert t({"pending": 4, "waited_ms": 0.0})
    assert t({"pending": 1, "waited_ms": 5.0})


def test_request_queue_groups_and_fifo_pop():
    q = RequestQueue()
    reqs = [ServeRequest(np.zeros(3), bucket=b) for b in (8, 16, 8, 8)]
    for r in reqs:
        q.put(r)
    groups = q.groups()
    assert [(g.bucket, g.count) for g in groups] == [(8, 3), (16, 1)]
    assert q.pop(8, 2) == [reqs[0], reqs[2]]
    assert q.depth() == 2
    q.close()
    with pytest.raises(ServingStopped):
        q.put(ServeRequest(np.zeros(3)))
    fut = reqs[1].future
    assert fut.set_result(torch.ones(2)) and not fut.set_exception(RuntimeError())
    torch.testing.assert_close(fut.result(TIMEOUT), torch.ones(2))
    with pytest.raises(TimeoutError):
        reqs[3].future.result(0.01)


def test_stress_many_threads_each_get_their_own_row():
    """More client threads than cores and a short switch interval: every
    future must resolve to its own record's row (a lost or crossed update
    would hand a caller another request's answer)."""
    model = FeedForwardNetwork(16, 32, device="cpu")
    records = np.random.RandomState(11).randn(16 * 8, 3, 16).astype(np.float32)
    model.init(sample_input=records[:1])
    want = model.forward(records).detach()
    results = [None] * len(records)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ModelServer() as server:
            server.register("ffn", model, sample_input=records[0], batch_size=8,
                            max_delay_ms=1)

            def client(idx):
                futs = [(i, server.infer("ffn", records[i])) for i in idx]
                for i, f in futs:
                    results[i] = f.result(TIMEOUT)

            threads = [threading.Thread(target=client, args=(range(c, len(records), 16),))
                       for c in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            server.close(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(old)
    for i, got in enumerate(results):
        torch.testing.assert_close(got, want[i], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The JAX runtime's serving contract, each case through both packages (the
# helpers, the MLP pair and the tolerances are test_torch_serving_resilience's)
# ---------------------------------------------------------------------------

from test_torch_serving_resilience import (CROSS_TOL, JAX, PKGS, PORT, ROW_TOL,  # noqa: E402
                                           _records, _rows, _server, both)


class TestHotSwap:
    def test_update_swaps_version_and_releases_old_version(self):
        x = np.linspace(0, 1, 12).astype(np.float32)

        def scenario(pkg):
            v1, v2 = pkg.mlp(seed=1), pkg.mlp(seed=2)
            with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as srv:
                srv.register("m", v1, sample_input=x, max_delay_ms=3)
                f1 = srv.infer("m", x)
                out1 = _rows(f1.result(timeout=TIMEOUT))
                version = srv.update("m", v2)
                f2 = srv.infer("m", x)
                out2 = _rows(f2.result(timeout=TIMEOUT))
                for out, m in ((out1, v1), (out2, v2)):
                    np.testing.assert_allclose(
                        out, _rows(pkg.predictor(m, 32).predict(x[None]))[0], rtol=0,
                        atol=ROW_TOL)
                info = srv.models()["m"]
                warmups = [r["version"] for r in _records(srv.telemetry, "warmup")]
                return ((f1.version, version, f2.version, info["version"],
                         info["retired_versions"], warmups), out1, out2)

        outs = {p.name: scenario(p) for p in PKGS}
        assert outs["port"][0] == outs["jax"][0] == (1, 2, 2, 2, [], [1, 2])
        for i in (1, 2):
            np.testing.assert_allclose(outs["port"][i], outs["jax"][i], rtol=0, atol=CROSS_TOL)

    def test_old_version_retained_until_last_future_resolves(self):
        def scenario(pkg):
            with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as srv:
                srv.register("m", pkg.mlp(seed=1), sample_input=np.zeros(12, np.float32),
                             max_delay_ms=3)
                fut = srv.infer("m", np.ones(12, np.float32))
                assert fut._event.wait(TIMEOUT)  # dispatched, not materialized
                srv.update("m", pkg.mlp(seed=2))
                b = srv._entry("m").batcher
                trace = [b.retired_versions(), b.outstanding()]
                fut.result(timeout=TIMEOUT)
                return trace + [b.retired_versions(), b.outstanding()]

        assert both(scenario) == [[1], {1: 1}, [], {}]

    def test_swap_under_load_serves_consistent_versions(self):
        """A hot swap under 4 client threads: every request resolves, each
        on one version, its row that version's forward (and the JAX model's
        of the same version)."""
        records = np.random.default_rng(0).standard_normal((40, 12)).astype(np.float32)
        jref = {v: JAX.predictor(JAX.mlp(seed=v), 32) for v in (1, 2)}
        models = {v: PORT.mlp(seed=v) for v in (1, 2)}
        results, lock = [], threading.Lock()
        with _server(PORT, telemetry=PORT.Telemetry(exporters=[])) as srv:
            srv.register("m", models[1], sample_input=records[0], max_delay_ms=2)

            def client(rows):
                for r in rows:
                    f = srv.infer("m", r)
                    out = f.result(timeout=TIMEOUT)
                    with lock:
                        results.append((r, out, f.version))

            threads = [threading.Thread(target=client, args=(records[i::4],)) for i in range(4)]
            for t in threads:
                t.start()
            srv.update("m", models[2])
            for t in threads:
                t.join(TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            serves = _records(srv.telemetry, "serve")
        assert len(results) == 40 and {v for _, _, v in results} <= {1, 2}
        for r, out, v in results:
            own = PORT.predictor(models[v], 32).predict(r[None])[0]
            torch.testing.assert_close(out, own, atol=ROW_TOL, rtol=0)
            np.testing.assert_allclose(out.numpy(), np.asarray(jref[v].predict(r[None]))[0],
                                       rtol=0, atol=CROSS_TOL)
        assert sum(s["records"] for s in serves) == 40
        assert all(s["version"] in (1, 2) for s in serves)


class TestAdmissionControl:
    def test_queue_rejects_past_max_pending(self):
        def scenario(pkg):
            q = pkg.s.RequestQueue(max_pending=2)
            depths = [q.put(pkg.s.ServeRequest(np.zeros(3, np.int32))) for _ in range(2)]
            with pytest.raises(pkg.s.AdmissionRejected, match="max_pending") as ei:
                q.put(pkg.s.ServeRequest(np.zeros(3, np.int32)))
            q.pop_all()
            depths.append(q.put(pkg.s.ServeRequest(np.zeros(3, np.int32))))
            return depths, str(ei.value)

        assert both(scenario) == ([1, 2, 1], "request rejected: 2 pending >= max_pending 2")

    def test_queue_validates_bound(self):
        def scenario(pkg):
            with pytest.raises(ValueError):
                pkg.s.RequestQueue(max_pending=0)
            return pkg.s.RequestQueue().max_pending

        assert both(scenario) is None

    def test_batcher_counts_rejects_on_serve_records(self):
        x = np.random.default_rng(4).standard_normal((3, 12)).astype(np.float32)

        def scenario(pkg):
            tel = pkg.Telemetry(exporters=[])
            b = pkg.s.ContinuousBatcher(pkg.predictor(pkg.mlp(), 8), name="m", telemetry=tel,
                                        max_pending=2, max_delay_ms=5.0)  # not started
            futs = [b.submit(pkg.s.ServeRequest(r)) for r in x[:2]]
            with pytest.raises(pkg.s.AdmissionRejected):
                b.submit(pkg.s.ServeRequest(x[2]))
            rejected = b.rejected()
            b.start()
            try:
                rows = np.stack([_rows(f.result(timeout=TIMEOUT)) for f in futs])
            finally:
                b.stop()
            serves = _records(tel, "serve")
            return (rejected, [s["rejected"] for s in serves],
                    sum(s["records"] for s in serves), b.health_snapshot()["rejected"]), rows

        outs = {p.name: scenario(p) for p in PKGS}
        assert outs["port"][0] == outs["jax"][0] == (1, [1], 2, 1)
        np.testing.assert_allclose(outs["port"][1], outs["jax"][1], rtol=0, atol=CROSS_TOL)

    def test_server_per_model_policy(self):
        z = np.zeros(12, np.float32)

        def scenario(pkg):
            with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as srv:
                srv.register("bounded", pkg.mlp(), sample_input=z, batch_size=8,
                             max_delay_ms=60000.0, max_pending=2, warmup=False)
                srv.register("unbounded", pkg.mlp(seed=8), sample_input=z, batch_size=8,
                             max_delay_ms=5.0, warmup=False)
                srv.infer("bounded", z)
                srv.infer("bounded", z)
                with pytest.raises(pkg.s.AdmissionRejected):
                    srv.infer("bounded", z)
                info = srv.models()
                out = _rows(srv.predict("unbounded", [z] * 6))
                warns = [(w["reason"], w["model"]) for w in _records(srv.telemetry, "warn")]
                return ((info["bounded"]["max_pending"], info["bounded"]["rejected"],
                         info["unbounded"]["max_pending"], out.shape, warns), out)

        outs = {p.name: scenario(p) for p in PKGS}
        assert outs["port"][0] == outs["jax"][0] == (
            2, 1, None, (6, 4), [("unwarmed_model", "bounded"), ("unwarmed_model", "unbounded")])
        np.testing.assert_allclose(outs["port"][1], outs["jax"][1], rtol=0, atol=CROSS_TOL)


class TestServerSurface:
    def test_warmup_record_and_run_bounds(self):
        """One ``warmup`` record per registration with the JAX record's
        fields; ``meta`` run_start/run_end around the server's life. On the
        CPU the port builds no kernel library, so its warmup reports 0
        library loads and builds (JAX counts its traced programs)."""
        def scenario(pkg):
            tel = pkg.Telemetry(exporters=[])
            with _server(pkg, telemetry=tel) as srv:
                srv.register("m", pkg.mlp(), sample_input=np.zeros(12, np.float32),
                             max_delay_ms=3)
                info = srv.models()["m"]
            w = _records(tel, "warmup")
            metas = [r["event"] for r in _records(tel, "meta")]
            return (sorted(w[0]), [(r["model"], r["warm_start"], r["version"]) for r in w],
                    metas, info["warmup_s"] > 0), w[0]

        outs = {p.name: scenario(p) for p in PKGS}
        assert outs["port"][0] == outs["jax"][0]
        assert outs["port"][0][2] == ["run_start", "run_end"]
        assert (outs["port"][1]["compiles"], outs["port"][1]["fresh_compiles"]) == (0, 0)

    def test_unregister_serves_queued_then_forgets(self):
        def scenario(pkg):
            with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as srv:
                srv.register("m", pkg.mlp(), sample_input=np.zeros(12, np.float32),
                             max_delay_ms=60000.0)
                fut = srv.infer("m", np.ones(12, np.float32))
                srv.unregister("m")
                out = _rows(fut.result(timeout=TIMEOUT))
                with pytest.raises(KeyError):
                    srv.infer("m", np.ones(12, np.float32))
                with pytest.raises(KeyError):
                    srv.unregister("m")
                return sorted(srv.health()), out

        outs = {p.name: scenario(p) for p in PKGS}
        assert outs["port"][0] == outs["jax"][0] == []
        np.testing.assert_allclose(outs["port"][1], outs["jax"][1], rtol=0, atol=CROSS_TOL)

    def test_unported_options_raise(self, tmp_path):
        """The five options the port once refused now work: the scrape
        port binds, ``drift=`` stamps the serve records, ``export_artifacts``
        writes a bundle that ``warm_start`` verifies and ``artifacts=``
        covers with no ``warn``."""
        z = np.zeros(12, np.float32)
        bundle = str(tmp_path / "bundle")
        with _server(PORT, telemetry=PORT.Telemetry(exporters=[]), metrics_port=0) as srv:
            assert isinstance(srv.metrics_port, int) and srv.metrics_port > 0
            srv.register("m", PORT.mlp(), sample_input=z, drift=True, drift_every=1,
                         max_delay_ms=2)
            srv.predict("m", [z], timeout=TIMEOUT)
            manifest = srv.export_artifacts(bundle)
        assert any(r.get("drift") for r in _records(srv.telemetry, "serve"))
        assert srv.metrics_port is None  # close() took the endpoint down
        with _server(PORT, telemetry=PORT.Telemetry(exporters=[])) as srv:
            assert srv.warm_start(bundle)["models"] == manifest["models"]
            srv.register("m", PORT.mlp(), sample_input=z, drift=True, artifacts=bundle)
            assert srv.models()["m"]["aot_modules"] == 1
            assert not _records(srv.telemetry, "warn")


# ---------------------------------------------------------------------------
# the served model: a small conv7 ResNet-50 through both packages' servers
# ---------------------------------------------------------------------------

def test_conv7_resnet_served_rows_match_the_jax_server():
    """ResNet-50 with the conv7 stem (the stem ``bench.py``'s serving
    measurement serves), class_num 10, 64x64 images, the JAX model's weights
    and BN state carried into the port; 5 records through each package's
    ``ModelServer`` (batch 8, eval mode: BN running statistics) from two
    threads. Each served row is held against the JAX server's row in f32 at
    1e-4 of the rows' largest value (test_torch_resnet's eval-logit limit:
    the same products summed in another order through 50 layers)."""
    from bigdl_tpu.models import ResNet as JResNet
    from bigdl_tpu.utils.random import RandomGenerator as JRandomGenerator
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

    import jax

    x = np.random.default_rng(0).standard_normal((5, 3, 64, 64)).astype(np.float32)
    JRandomGenerator.set_seed(0)
    jm = JResNet(50, class_num=10, stem="conv7")
    jm.init(sample_input=x[:1])
    pm = ResNet(50, class_num=10, stem="conv7", device="cpu")
    pm.init(sample_input=x[:1])
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jm.get_parameters()))
    load_jax_state(pm, jax.tree_util.tree_map(np.asarray, jm.get_state()))

    def serve(pkg, model):
        rows = [None] * len(x)
        with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as srv:
            srv.register("resnet", model, sample_input=x[0], batch_size=8, max_delay_ms=5)

            def client(idx):
                for i in idx:
                    rows[i] = _rows(srv.infer("resnet", x[i]).result(timeout=120))

            threads = [threading.Thread(target=client, args=(range(c, len(x), 2),))
                       for c in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
            serves = _records(srv.telemetry, "serve")
        assert sum(s["records"] for s in serves) == len(x)
        return np.stack(rows)

    want = serve(JAX, jm)
    got = serve(PORT, pm)
    assert got.shape == want.shape == (5, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    # and the port's server row is the port's own eval forward of the record
    with torch.inference_mode():
        own = pm.eval().forward(x).numpy()
    np.testing.assert_allclose(got, own, rtol=0, atol=1e-5 * np.abs(own).max())
