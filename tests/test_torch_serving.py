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
    _, pm = pair
    with ModelServer() as server:
        with pytest.raises(ValueError, match="sample_input"):
            server.register("lm", pm)
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
