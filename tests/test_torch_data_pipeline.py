"""The port's ``DataPipeline`` and ``StagingRing`` against the JAX package's.

The batch streams of both packages are compared byte for byte at 0, 1 and 4
workers, over a chain whose ``Lambda`` draws from ``numpy_rng()`` (so the
per-chunk RNG, seeded from (seed, epoch, chunk), is what both draw), with
ragged tails kept or dropped, shuffled epochs and ``skip_positions``. Then
the contract's refusals, exceptions in order, and the rings' prompt close:
a blocked ``put``/``get`` wakes at once and an abandoned stream leaves no
thread.
"""

import threading
import time

import numpy as np
import pytest

from bigdl_tpu.dataset import dataset as jd
from bigdl_tpu.dataset import pipeline as jp
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import RandomGenerator
from bigdl_tpu_torch.dataset import dataset as pd
from bigdl_tpu_torch.dataset import pipeline as pp

from test_torch_dataset_chains import _jitter, _seed_both, assert_same_batches

SEED = 5
WORKERS = [0, 1, 4]


def _data(n=45, width=6, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, width)).astype(np.float32), rng.integers(0, 5, n)


def _pair(workers, n=45, batch=8, drop=None, chain=True, **kw):
    """(JAX pipeline, port pipeline) over the same records and chain."""
    x, y = _data(n)
    jsrc = jd.LocalArrayDataSet(x, y, batch_size=batch)
    psrc = pd.LocalArrayDataSet(x, y, batch_size=batch)
    jt = jd.Lambda(_jitter(jd.Sample, JRandom)) if chain else None
    pt = pd.Lambda(_jitter(pd.Sample, RandomGenerator)) if chain else None
    return (jp.DataPipeline(jsrc, jt, num_workers=workers, drop_remainder=drop, **kw),
            pp.DataPipeline(psrc, pt, num_workers=workers, drop_remainder=drop, **kw))


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("train,drop", [(True, None), (True, False), (False, None)])
def test_batch_stream_matches_jax(workers, train, drop):
    """Two shuffled epochs; the ragged tail (45 = 5 x 8 + 5) dropped in
    training by default, kept with ``drop_remainder=False`` and in eval."""
    _seed_both(SEED)
    jpipe, ppipe = _pair(workers, drop=drop)
    for epoch in (1, 2):
        jpipe.shuffle(epoch)
        ppipe.shuffle(epoch)
        n = assert_same_batches(jpipe.data(train), ppipe.data(train))
        assert n == (5 if train and drop is None else 6)


@pytest.mark.parametrize("workers", [1, 4])
def test_any_worker_count_equals_the_serial_stream(workers):
    _seed_both(SEED)
    serial = list(_pair(0)[1].data(True))
    _seed_both(SEED)
    assert assert_same_batches(serial, _pair(workers)[1].data(True)) == 5


@pytest.mark.parametrize("workers", WORKERS)
def test_skip_positions_match_jax(workers):
    """Quarantined positions of the current epoch are holes; other epochs'
    are ignored."""
    _seed_both(SEED)
    jpipe, ppipe = _pair(workers)
    jpipe.shuffle(3)
    ppipe.shuffle(3)
    skips = {(3, 1), (3, 4), (2, 0)}
    pb = list(ppipe.data(True, skip_positions=skips))
    assert len(pb) == 3
    assert assert_same_batches(jpipe.data(True, skip_positions=skips), pb) == 3
    _seed_both(SEED)
    clean = _pair(workers)[1]
    clean.shuffle(3)
    clean_batches = list(clean.data(True))
    assert_same_batches([clean_batches[i] for i in (0, 2, 3)], pb)


def test_distributed_dataset_forwards_skip_positions():
    _seed_both(SEED)
    _, ppipe = _pair(2)
    ds = pd.DataSet.distributed(ppipe, 4)
    assert ds.supports_skip_positions
    assert len(list(ds.data(True, skip_positions={(0, 0)}))) == 4


@pytest.mark.parametrize("workers", [0, 3])
def test_a_batching_chain_gives_one_batch_a_chunk(workers):
    _seed_both(SEED)
    x, y = _data(32)
    jpipe = jp.DataPipeline(jd.LocalArrayDataSet(x, y, batch_size=8),
                            jd.SampleToMiniBatch(8), num_workers=workers)
    ppipe = pp.DataPipeline(pd.LocalArrayDataSet(x, y, batch_size=8),
                            pd.SampleToMiniBatch(8), num_workers=workers)
    assert assert_same_batches(jpipe.data(True), ppipe.data(True)) == 4
    bad = pp.DataPipeline(pd.LocalArrayDataSet(x, y, batch_size=8), pd.SampleToMiniBatch(4),
                          num_workers=workers)
    with pytest.raises(ValueError, match="exactly one batch"):
        list(bad.data(True))


@pytest.mark.parametrize("workers", [0, 3])
def test_filtering_chains_and_worker_faults_raise(workers):
    x, y = _data(32)
    src = pd.LocalArrayDataSet(x, y, batch_size=8)

    class Drop(pd.Transformer):
        def apply(self, it):
            return (s for i, s in enumerate(it) if i % 2)

    with pytest.raises(ValueError, match="sample-preserving"):
        list(pp.DataPipeline(src, Drop(), num_workers=workers).data(True))

    def boom(s):
        if s.label == y[17]:
            raise RuntimeError("bad record")
        return s

    stream = pp.DataPipeline(src, pd.Lambda(boom), num_workers=workers).data(False)
    got = []
    with pytest.raises(RuntimeError, match="bad record"):
        for b in stream:
            got.append(b)
    assert len(got) < 4  # the batches before the fault arrive first, in order


def test_constructor_checks():
    with pytest.raises(TypeError, match="samples"):
        pp.DataPipeline(object(), batch_size=4)
    with pytest.raises(ValueError, match="batch_size"):
        pp.DataPipeline(pd.LocalArrayDataSet(np.zeros((4, 2), np.float32), batch_size=0))
    pipe = pd.DataSet.pipeline(pd.LocalArrayDataSet(np.zeros((4, 2), np.float32),
                                                     batch_size=2), num_workers=3)
    assert isinstance(pipe, pp.DataPipeline) and pipe.depth == 6 and pipe.size() == 4


def _pipeline_threads():
    return [t for t in threading.enumerate() if t.name.startswith("bigdl-pipe")]


def test_an_abandoned_stream_leaves_no_thread():
    """Closing a stream mid-epoch ends the feeder and every worker."""
    _seed_both(SEED)
    x, y = _data(400)
    slow = pd.Lambda(lambda s: (time.sleep(0.002), s)[1])
    pipe = pp.DataPipeline(pd.LocalArrayDataSet(x, y, batch_size=8), slow, num_workers=4)
    stream = pipe.data(True)
    next(stream)
    assert _pipeline_threads()
    t0 = time.perf_counter()
    stream.close()
    deadline = time.perf_counter() + 5
    while _pipeline_threads() and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert not _pipeline_threads(), _pipeline_threads()
    assert time.perf_counter() - t0 < 5


@pytest.mark.parametrize("pkg", [jp, pp], ids=["jax", "port"])
def test_ring_close_wakes_blocked_put_and_get_at_once(pkg):
    """A put blocked on a full ring and a get blocked on an empty one both
    return within 0.5 s of ``close()`` (no poll tick), in both packages."""
    full, empty = pkg.StagingRing(1), pkg.StagingRing(2)
    assert full.put("a") and full.qsize() == 1
    out = {}

    def put():
        out["put"] = (full.put("b"), time.perf_counter())

    def get():
        out["get"] = (empty.get(), time.perf_counter())

    threads = [threading.Thread(target=put), threading.Thread(target=get)]
    for t in threads:
        t.start()
    time.sleep(0.1)
    assert not out
    t_close = time.perf_counter()
    full.close()
    empty.close()
    for t in threads:
        t.join(2)
    assert out["put"][0] is False and out["get"][0] is pkg.RING_CLOSED
    assert max(out["put"][1], out["get"][1]) - t_close < 0.5
    assert full.closed and full.qsize() == 0  # buffered items dropped
    assert not full.put("c")


def test_ring_is_fifo_and_bounded():
    ring = pp.StagingRing(3)
    for i in range(3):
        assert ring.put(i)
    assert ring.qsize() == 3
    assert [ring.get() for _ in range(3)] == [0, 1, 2]


def test_many_workers_under_a_short_switch_interval_keep_the_stream():
    """16 workers (more than the cores) and a 1 us switch interval: the
    staging rings' reassembly still gives the serial stream, and the pool
    ends with the epoch."""
    import sys

    _seed_both(SEED)
    serial = list(_pair(0, n=203)[1].data(True))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _seed_both(SEED)
        t0 = time.perf_counter()
        many = list(_pair(16, n=203)[1].data(True))
        assert time.perf_counter() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    assert assert_same_batches(serial, many) == 25
    deadline = time.perf_counter() + 5
    while _pipeline_threads() and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert not _pipeline_threads()
