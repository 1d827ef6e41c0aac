"""The port's elastic fleet against the JAX package's, on the CPU.

* ``ElasticCoordinator`` arithmetic (membership and generation, exhaustion,
  device blocks, ``process_bounds``, reader slices, ``hybrid_mesh`` shapes,
  the pristine identity refresh, ``rejoin_ready``) against the JAX
  coordinator's under the same ``BIGDL_PROCESS_*`` identity.
* The end-to-end chaos drive (``tests/test_elastic.py``'s
  ``_run_elastic_fit``: ``Linear(8, 4)`` + ``LogSoftMax``, N 48, batch 24,
  SGD 0.1, host 3 killed after step 4 and revived after step 9, the fit
  ending after epoch 8) on 4 spawned gloo ranks (``torch_elastic_worker``),
  held against the JAX ``SimulatedFleet`` run on its 8 virtual devices from
  the same initial weights: the shrink and rejoin records (members,
  processes, generation, restored step, iteration), the manifests'
  generations and shard counts, losses within 1e-6 step by step, the final
  parameters within 1e-5 relative L2 (float32 sums over 4 ranks against
  8 devices round differently); and against a clean 4-rank port run,
  bit-equal at the shrink step. The JAX mesh shape is in devices ([8] /
  [6]) and the port's in ranks ([4] / [3]).
* ``HybridParallelOptimizer`` elastic on 4 ranks (data 2 x model 2, hosts 2
  and 3 lost: data 1 x model 2, then back), bit-equal to a clean run at
  the shrink step, its shapes the JAX ``hybrid_mesh`` 's.
* Exhaustion leaves a fleet checkpoint behind a typed error; a fault at
  each of the ``coordinate`` / ``reshard`` / ``rejoin`` seams surfaces as
  ``FaultInjected`` on every rank; the whole spawn joins under a deadline
  (every group the runtime makes has a 60 s timeout there), so a hang fails
  the test instead of stalling it.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.obs import Telemetry as JTelemetry
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.parallel import make_mesh as jmake_mesh
from bigdl_tpu.parallel.distri_optimizer import DistriOptimizer as JDistri
from bigdl_tpu.parallel.parameter import FlatParameter as JFlat
from bigdl_tpu.resilience import ElasticConfig as JConfig
from bigdl_tpu.resilience import ElasticCoordinator as JCoord
from bigdl_tpu.resilience import SimulatedFleet as JFleet
from bigdl_tpu.utils import serialization as jser
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch import optim as poptim
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.parallel import DistriOptimizer, FlatParameter
from bigdl_tpu_torch.resilience import (FLEET_SEAMS, ElasticConfig, ElasticCoordinator,
                                        ElasticFleetExhausted)
from bigdl_tpu_torch.utils import serialization as pser
from bigdl_tpu_torch.utils.engine import Engine

from torch_elastic_worker import spawn_cases

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("obs_report_torch_elastic",
                                               REPO / "tools" / "obs_report.py")
obs_report = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = obs_report
_spec.loader.exec_module(obs_report)

N, BATCH, FLEET = 48, 24, 4
KILL_AT, REVIVE_AT, END_EPOCH = 4, 9, 8
REMESH_KEYS = ("iteration", "members", "processes", "process_count", "generation",
               "restored_step")


def _data():
    rng = np.random.default_rng(0)
    return rng.standard_normal((N, 8)).astype(np.float32), rng.integers(0, 4, N)


def _coords(monkeypatch, index=0, count=4, **cfg):
    monkeypatch.setenv("BIGDL_PROCESS_INDEX", str(index))
    monkeypatch.setenv("BIGDL_PROCESS_COUNT", str(count))
    return JCoord(JConfig(**cfg)), ElasticCoordinator(ElasticConfig(**cfg))


# ---------------------------------------------------------------------------
# coordinator arithmetic
# ---------------------------------------------------------------------------

def test_membership_generation_and_snapshot(monkeypatch):
    for el in _coords(monkeypatch):
        el.note_host_lost(0)  # itself: alive
        el.note_host_lost(9)  # not a member
        assert el.poll() == []
        el.note_host_lost(3)
        el.note_host_lost(3)
        assert el.poll() == [3]
        assert el.coordinate(step=4) == 1 == el.generation
        lost = el.take_shrink()
        assert lost == [3] and el.take_shrink() == []
        assert el.apply_shrink(lost) == [0, 1, 2]
        assert not el.is_full() and el.n_active() == 3 and el.reshard_count == 1
    j, p = _coords(monkeypatch)
    for el in (j, p):
        el.apply_shrink([2])
        el.coordinate(step=1)
    assert p.snapshot() == j.snapshot()


def test_exhaustion_is_typed(monkeypatch):
    for el in _coords(monkeypatch, count=2, min_processes=2):
        with pytest.raises(Exception) as e1:
            el.check_viable([1])
        with pytest.raises(Exception) as e2:
            el.apply_shrink([1])
        assert type(e1.value).__name__ == type(e2.value).__name__ == "ElasticFleetExhausted"
    _, p = _coords(monkeypatch, count=2, min_processes=2)
    with pytest.raises(ElasticFleetExhausted, match="below min_processes=2"):
        p.check_viable([1])


def test_device_blocks_and_process_bounds(monkeypatch):
    j, p = _coords(monkeypatch)
    assert p.device_blocks(list(range(8))) == j.device_blocks(list(range(8)))
    with pytest.raises(ValueError, match="do not split evenly"):
        p.device_blocks(list(range(6)))
    tree = {"w": np.zeros((5, 3), np.float32), "b": np.zeros(7, np.float32)}
    ptree = {k: np.asarray(v) for k, v in tree.items()}
    import torch

    for n_shards in (4, 8):
        jb = j.process_bounds(JFlat(tree, n_shards))
        pb = p.process_bounds(FlatParameter({k: torch.from_numpy(v) for k, v in ptree.items()},
                                            n_shards))
        assert pb == jb
    for el in (j, p):
        el.apply_shrink([2])
    fp6 = FlatParameter({k: torch.from_numpy(v) for k, v in ptree.items()}, 6)
    assert p.process_bounds(fp6) == j.process_bounds(JFlat(tree, 6))
    with pytest.raises(ValueError, match="does not split"):
        p.process_bounds(FlatParameter({k: torch.from_numpy(v) for k, v in ptree.items()}, 8))
    assert p.active_devices(list(range(8))) == j.active_devices(list(range(8)))


def test_reader_slices(monkeypatch):
    j, p = _coords(monkeypatch, index=2)
    assert p.reader_slice() is None  # no process group
    for el in (j, p):
        el.apply_shrink([1])
    assert p.reader_slices() == j.reader_slices() == {0: (0, 3), 2: (1, 3), 3: (2, 3)}
    monkeypatch.setattr(Engine, "_group", ("gloo", 2, 4, None))
    assert p.reader_slice() == (1, 3)  # the rank among the survivors
    _, p1 = _coords(monkeypatch, index=1)
    p1.apply_shrink([1])
    assert p1.reader_slice() is None  # outside the membership: it must not read


class _StubMesh:
    """A port mesh's surface for ``hybrid_mesh`` 's arithmetic."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)
        self.devices = np.arange(int(np.prod(list(sizes.values())))).reshape(
            tuple(sizes.values()))


def test_hybrid_mesh_shapes_match_jax(monkeypatch):
    from bigdl_tpu.parallel import ParallelCompositionError as JError
    from bigdl_tpu_torch.parallel.hybrid import ParallelCompositionError

    saved = JEngine._state
    JEngine.reset()
    JEngine.init()
    try:
        j, p = _coords(monkeypatch)
        monkeypatch.setattr(ElasticCoordinator, "_mesh_over",
                            lambda self, ranks, sizes: (list(ranks), dict(sizes)))
        jbase, pbase = jmake_mesh({"data": 4, "model": 2}), _StubMesh({"data": 4, "model": 2})
        assert p.hybrid_mesh(pbase) is pbase and j.hybrid_mesh(jbase) is jbase
        jdata, pdata = JEngine.mesh(), _StubMesh({"data": 8})
        assert p.mesh(pdata) is pdata and j.mesh(jdata) is jdata
        for el in (j, p):
            el.apply_shrink([1])
        ranks1, sizes1 = p.mesh(pdata)  # the 1-D data mesh over the survivors' blocks
        jm1 = j.mesh(jdata)
        assert ranks1 == [d.id for d in np.asarray(jm1.devices).flat] and sizes1 == {"data": 6}
        jm = j.hybrid_mesh(jbase)
        ranks, sizes = p.hybrid_mesh(pbase)
        assert tuple(sizes.values()) == tuple(np.asarray(jm.devices).shape) == (3, 2)
        assert tuple(sizes) == tuple(jm.axis_names)
        assert ranks == [d.id for d in np.asarray(jm.devices).flat]
        # data 2 x model 2 over 4 hosts, hosts 2 and 3 lost: data 1 x model 2
        j2, p2 = _coords(monkeypatch)
        for el in (j2, p2):
            el.apply_shrink([2, 3])
        jm2 = j2.hybrid_mesh(jmake_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4]))
        r2, s2 = p2.hybrid_mesh(_StubMesh({"data": 2, "model": 2}))
        assert tuple(s2.values()) == tuple(np.asarray(jm2.devices).shape) == (1, 2)
        assert r2 == [0, 1]
        with pytest.raises(ParallelCompositionError, match="data axis"):
            p.hybrid_mesh(_StubMesh({"model": 2, "data": 4}))
        with pytest.raises(JError, match="data axis"):
            j.hybrid_mesh(jmake_mesh({"model": 2, "data": 4}))
        with pytest.raises(ParallelCompositionError, match="do not tile"):
            p.hybrid_mesh(_StubMesh({"data": 2, "model": 4}))
    finally:
        JEngine._state = saved


def test_bind_refreshes_pristine_identity_only(monkeypatch):
    monkeypatch.delenv("BIGDL_PROCESS_INDEX", raising=False)
    monkeypatch.delenv("BIGDL_PROCESS_COUNT", raising=False)
    el = ElasticCoordinator(ElasticConfig())
    assert el.process_count == 1
    monkeypatch.setenv("BIGDL_PROCESS_INDEX", "0")
    monkeypatch.setenv("BIGDL_PROCESS_COUNT", "4")
    el.bind()
    assert el.process_count == 4 and el.active() == [0, 1, 2, 3]
    el.apply_shrink([3])
    monkeypatch.setenv("BIGDL_PROCESS_COUNT", "8")
    el.bind()
    assert el.process_count == 4 and el.active() == [0, 1, 2]
    # a membership that is not the process group's ranks cannot re-form groups
    with pytest.raises(ValueError, match="membership"):
        el.attach()


def test_rejoin_ready(monkeypatch, tmp_path):
    from bigdl_tpu.obs import write_heartbeat as jwrite
    from bigdl_tpu_torch.obs import write_heartbeat as pwrite

    clk = {"t": 1000.0}
    j, p = _coords(monkeypatch, wall_clock=lambda: clk["t"], stale_after_s=5.0)
    for el in (j, p):
        el.run_dir = str(tmp_path)
        el.apply_shrink([2])
    assert p.rejoin_ready() == j.rejoin_ready() == []
    ident = {"process_index": 2, "process_count": 4, "host": "h2"}
    jwrite(str(tmp_path), identity=ident, step=7, clock=lambda: clk["t"])
    assert p.rejoin_ready() == j.rejoin_ready() == [2]
    clk["t"] += 100.0
    assert p.rejoin_ready() == j.rejoin_ready() == []
    pwrite(str(tmp_path), identity=ident, step=7, leaving=True, clock=lambda: clk["t"])
    assert p.rejoin_ready() == j.rejoin_ready() == []
    assert p.apply_rejoin([2]) == j.apply_rejoin([2]) == [0, 1, 2, 3]
    _, off = _coords(monkeypatch, rejoin=False)
    off.run_dir = str(tmp_path)
    off.apply_shrink([2])
    pwrite(str(tmp_path), identity=ident, step=8, clock=lambda: clk["t"])
    assert off.rejoin_ready() == []


def test_fleet_seams_registry():
    from bigdl_tpu.resilience import FLEET_SEAMS as JSEAMS

    assert FLEET_SEAMS == JSEAMS == ("hb_write", "coordinate", "reshard", "rejoin")


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------

def _port_opt(cls=DistriOptimizer, **kw):
    x, y = _data()
    model = pnn.Sequential(pnn.Linear(8, 4, device="cpu"), pnn.LogSoftMax(device="cpu"),
                           device="cpu")
    ds = DataSet.array(x, y, batch_size=BATCH)
    if cls is DistriOptimizer:
        ds = DataSet.distributed(ds, 1)
    opt = cls(model, ds, pnn.ClassNLLCriterion(), **kw)
    return opt.set_optim_method(poptim.SGD(learningrate=0.1)).set_end_when(
        poptim.Trigger.max_epoch(1))


def test_elastic_refusals(tmp_path):
    with pytest.raises(ValueError, match="resharding-capable"):
        _port_opt(poptim.LocalOptimizer).set_elastic().optimize()
    with pytest.raises(ValueError, match="set_checkpoint"):
        _port_opt(parameter_sync="sharded").set_elastic().optimize()
    opt = _port_opt(parameter_sync="replicated").set_elastic()
    opt.set_checkpoint(str(tmp_path), poptim.Trigger.several_iteration(10 ** 6))
    with pytest.raises(ValueError, match="sharded"):
        opt.optimize()
    with pytest.raises(TypeError):
        opt.set_elastic(123)
    assert opt.set_elastic(False)._elastic is None


# ---------------------------------------------------------------------------
# end to end on 4 spawned ranks
# ---------------------------------------------------------------------------

def _jax_init():
    x, _ = _data()
    JRandom.set_seed(7)
    jm = jnn.Sequential(jnn.Linear(8, 4), jnn.LogSoftMax())
    jm.init(jax.random.PRNGKey(7), sample_input=x[:3])
    return jm, jax.tree_util.tree_map(np.asarray, jm.get_parameters())


@pytest.fixture(scope="module")
def init():
    saved = JEngine._state
    JEngine.reset()
    JEngine.init()
    try:
        return _jax_init()[1]
    finally:
        JEngine._state = saved


@pytest.fixture(scope="module")
def runs(init, tmp_path_factory):
    x, y = _data()
    base = dict(x=x, y=y, batch=BATCH, init=init)
    sched = dict(elastic=True, kill=(3,), kill_at=KILL_AT, revive_at=REVIVE_AT,
                 end_epoch=END_EPOCH)
    cases = [
        dict(base, name="clean", ckpt_every=1, max_iteration=12),
        dict(base, name="elastic", **sched),
        dict(base, name="exhausted", elastic=True, kill=(3,), kill_at=KILL_AT, end_epoch=20,
             min_processes=4),
        dict(base, name="hybrid_clean", hybrid=True, init=None, ckpt_every=1, max_iteration=12),
        dict(base, name="hybrid_elastic", hybrid=True, init=None,
             **dict(sched, kill=(2, 3))),
        dict(base, name="hybrid_clean_data", hybrid=True, data_plan=True, init=None,
             ckpt_every=1, max_iteration=12),
        dict(base, name="hybrid_elastic_data", hybrid=True, data_plan=True, init=None,
             **dict(sched, kill=(2, 3))),
        dict(base, name="never_back", **dict(sched, revive_at=None)),
    ] + [dict(base, name=f"fault_{seam}", fault=seam, **sched)
         for seam in ("coordinate", "reshard", "rejoin")]
    return spawn_cases(FLEET, cases, str(tmp_path_factory.mktemp("elastic")),
                       deadline_s=240.0)


def _warns(rank, reason):
    return [r for r in rank["meta"]["records"]
            if r.get("type") == "warn" and r.get("reason") == reason]


@pytest.fixture(scope="module")
def jax_run(init, tmp_path_factory):
    """The JAX package's ``SimulatedFleet`` run of the same schedule, from
    the same initial weights."""
    tmp = tmp_path_factory.mktemp("jax_elastic")
    saved = JEngine._state
    JEngine.reset()
    JEngine.init()
    try:
        JEngine.set_run_dir(str(tmp / "run"))
        clk = {"t": 1000.0}
        cfg = JConfig(stale_after_s=2.5, poll_interval_s=0.0, min_fleet_steps=0,
                      wall_clock=lambda: clk["t"])
        with JFleet(str(tmp / "run"), FLEET, threads=False, clock=lambda: clk["t"]) as fleet:
            coord = JCoord(cfg)
            tel = JTelemetry(heartbeat_interval_s=0.0)
            jm, _ = _jax_init()
            x, y = _data()
            opt = JDistri(jm, JDataSet.distributed(JDataSet.array(x, y, batch_size=BATCH), 8),
                          jnn.ClassNLLCriterion(), parameter_sync="sharded")
            opt.set_optim_method(JSGD(learningrate=0.1))
            opt.set_checkpoint(str(tmp / "ckpt"), trigger=JTrigger.several_iteration(10 ** 6))
            opt.set_elastic(coord)
            opt.set_telemetry(tel)

            def end_when(state):
                step = int(state.get("neval", 0))
                clk["t"] += 1.0
                fleet.beat_all(step)
                if step == KILL_AT:
                    fleet.kill(3)
                if step == REVIVE_AT:
                    fleet.revive(3)
                return int(state.get("epoch", 1)) > END_EPOCH

            opt.set_end_when(end_when)
            opt.optimize()
            tel.close()
        recs = list(tel.ring.records)
        return dict(records=recs, ckpt=str(tmp / "ckpt"), coord=coord.snapshot(),
                    params=jax.tree_util.tree_map(np.asarray, jm.get_parameters()))
    finally:
        JEngine._state = saved


def test_elastic_run_matches_the_jax_simulated_fleet(runs, jax_run, tmp_path_factory):
    ranks = runs["elastic"]
    assert [r["meta"]["outcome"] for r in ranks] == ["ok"] * FLEET
    jw = [r for r in jax_run["records"] if r.get("type") == "warn"]
    for reason in ("mesh_shrunk", "mesh_rejoin"):
        want = [{k: r[k] for k in REMESH_KEYS} for r in jw if r.get("reason") == reason]
        assert len(want) == 1
        for r, rank in enumerate(ranks):
            got = [{k: w[k] for k in REMESH_KEYS} for w in _warns(rank, reason)]
            # the dropped rank parks through the shrink: it records the rejoin only
            assert got == ([] if (r == 3 and reason == "mesh_shrunk") else want), (r, reason)
    snap = dict(jax_run["coord"])
    for r, rank in enumerate(ranks):
        assert rank["meta"]["snapshot"] == dict(snap, process_index=r)
    # the manifests: generation and shard count (mesh shape in ranks here)
    s = _warns(ranks[0], "mesh_shrunk")[0]
    j = _warns(ranks[0], "mesh_rejoin")[0]
    ckpt = str(Path(runs_folder(runs)) / "elastic" / "ckpt")
    for step, gen, shards, procs in ((s["iteration"], 1, [0, 1, 2, 3], 4),
                                     (j["iteration"], 2, [0, 1, 2], 3)):
        mj = jser.checkpoint_manifest(jax_run["ckpt"], step)
        mp = pser.checkpoint_manifest(ckpt, step)
        for m in (mj, mp):
            assert m["kind"] == "fleet" and m["generation"] == gen
            assert sorted(int(k) for k in m["shards"]) == shards and m["process_count"] == procs
        assert mp["mesh"]["shape"] == [procs] and mj["mesh"]["shape"] == [2 * procs]
    # losses step by step, and the final parameters
    jl = {r["iteration"]: r["loss"] for r in jax_run["records"] if r.get("type") == "step"}
    pl = dict(zip(ranks[0]["nevals"].tolist(), ranks[0]["losses"].tolist()))
    assert sorted(pl) == sorted(jl)
    for it in jl:
        assert abs(pl[it] - jl[it]) <= 1e-6, it
    for k, v in jax_run["params"]["Linear_0"].items():
        got = ranks[0][f"p.Linear_0/{k}"]
        assert np.linalg.norm(got - v) <= 1e-5 * np.linalg.norm(v), k
    # every rank ends with the same parameters
    for rank in ranks[1:]:
        for k in ranks[0]:
            if k.startswith("p."):
                assert np.array_equal(rank[k], ranks[0][k]), k


def runs_folder(runs) -> str:
    return runs["clean"][0]["meta"]["folder"]


def test_emergency_checkpoint_bit_equal_to_the_clean_run(runs):
    folder = Path(runs_folder(runs))
    step = int(_warns(runs["elastic"][0], "mesh_shrunk")[0]["iteration"])
    like = {"Linear_0": {"weight": np.zeros((4, 8), np.float32),
                         "bias": np.zeros(4, np.float32)}}
    import torch

    like = {"Linear_0": {k: torch.from_numpy(v) for k, v in like["Linear_0"].items()}}
    pe, se, he, _ = pser.load_checkpoint(str(folder / "elastic" / "ckpt"), step, params_like=like)
    pc, sc, hc, _ = pser.load_checkpoint(str(folder / "clean" / "ckpt"), step)
    assert he["neval"] == hc["neval"] == step
    assert sorted(pe) == sorted(pc) and pe
    for k in pe:
        np.testing.assert_array_equal(pe[k], pc[k], err_msg=k)


def test_two_layouts_and_valid_records(runs):
    caches = [rank["meta"]["step_cache"] for rank in runs["elastic"]]
    # a shrink and a rejoin: two layouts, not three (the parked rank: one)
    assert caches == [[[0, 1, 2, 3], [0, 1, 2]]] * 3 + [[[0, 1, 2, 3]]]
    for rank in runs["elastic"]:
        for w in [r for r in rank["meta"]["records"] if r.get("type") == "warn"]:
            obs_report.validate_record(w)


def test_exhaustion_leaves_a_resumable_run(runs):
    ranks = runs["exhausted"]
    assert [r["meta"]["outcome"] for r in ranks] == ["ElasticFleetExhausted"] * FLEET
    ckpt = Path(runs_folder(runs)) / "exhausted" / "ckpt"
    steps = [s for s in range(30)
             if (pser.checkpoint_manifest(str(ckpt), s) or {}).get("kind") == "fleet"]
    assert steps, "no emergency fleet checkpoint behind the exhaustion"
    m = pser.checkpoint_manifest(str(ckpt), steps[-1])
    assert m["generation"] == 1 and len(m["shards"]) == FLEET


def test_a_host_that_never_returns(runs):
    """The fit ends on the survivors while rank 3 is parked: ``done``
    releases it (no hang), and it holds the newest checkpoint's weights,
    the emergency one's."""
    ranks = runs["never_back"]
    assert [r["meta"]["outcome"] for r in ranks] == ["ok"] * FLEET
    s = _warns(ranks[0], "mesh_shrunk")[0]
    assert not _warns(ranks[0], "mesh_rejoin") and ranks[0]["meta"]["snapshot"]["active"] == [
        0, 1, 2]
    import torch

    like = {"Linear_0": {"weight": torch.zeros(4, 8), "bias": torch.zeros(4)}}
    params, _, _, _ = pser.load_checkpoint(
        str(Path(runs_folder(runs)) / "never_back" / "ckpt"), s["iteration"], params_like=like)
    for k, v in params.items():
        np.testing.assert_array_equal(ranks[3][f"p.{k}"], v, err_msg=k)
    for rank in ranks[1:3]:
        for k in ranks[0]:
            if k.startswith("p."):
                assert np.array_equal(rank[k], ranks[0][k]), k


def test_hybrid_elastic_recuts_a_data_sharded_leaf(runs):
    """The second Linear's weight rows over the data axis: 2 rows a rank on
    data 2 x model 2, the whole 4 on the survivors' data 1 x model 2 (re-cut
    from the tree-layout emergency checkpoint), 2 again after the rejoin.
    The emergency checkpoint equals a clean run's at the shrink step, and
    every rank ends with the same whole parameters."""
    ranks = runs["hybrid_elastic_data"]
    assert [r["meta"]["outcome"] for r in ranks] == ["ok"] * FLEET
    s = _warns(ranks[0], "mesh_shrunk")
    assert len(s) == 1 and s[0]["processes"] == [0, 1]
    assert len(_warns(ranks[0], "mesh_rejoin")) == 1
    folder = Path(runs_folder(runs))
    step = int(s[0]["iteration"])
    pe, _, he, _ = pser.load_checkpoint(str(folder / "hybrid_elastic_data" / "ckpt"), step)
    pc, _, hc, _ = pser.load_checkpoint(str(folder / "hybrid_clean_data" / "ckpt"), step)
    assert he["neval"] == hc["neval"] == step
    (leaf,) = [k for k in pe if "Linear_2" in k and "weight" in k]
    assert np.shape(pe[leaf]) == (4, 8)
    for k in pc:
        np.testing.assert_array_equal(pe[k], pc[k], err_msg=k)
    for rank in ranks[1:]:
        for k in ranks[0]:
            if k.startswith("p."):
                assert np.array_equal(rank[k], ranks[0][k]), k
    assert np.shape(ranks[0]["p.Linear_2/weight"]) == (4, 8)
    for rank in ranks[:2]:  # the survivors cut it at the start, the shrink and the rejoin
        assert list(rank["cut_rows"]) == [2, 4, 2]


@pytest.mark.parametrize("seam", ["coordinate", "reshard", "rejoin"])
def test_seam_faults_surface_typed(runs, seam):
    assert [r["meta"]["outcome"] for r in runs[f"fault_{seam}"]] == ["FaultInjected"] * FLEET


def test_hybrid_elastic_shrinks_the_data_axis(runs):
    ranks = runs["hybrid_elastic"]
    assert [r["meta"]["outcome"] for r in ranks] == ["ok"] * FLEET
    s = _warns(ranks[0], "mesh_shrunk")
    j = _warns(ranks[0], "mesh_rejoin")
    assert len(s) == len(j) == 1
    assert s[0]["members"] == [2, 3] and s[0]["processes"] == [0, 1]
    assert s[0]["restored_step"] == s[0]["iteration"] and s[0]["generation"] == 1
    assert j[0]["processes"] == [0, 1, 2, 3] and j[0]["generation"] == 2
    for rank in ranks[2:]:  # the dropped ranks park through the shrink
        assert not _warns(rank, "mesh_shrunk") and len(_warns(rank, "mesh_rejoin")) == 1
    # the emergency checkpoint (tree layout, rank 0) equals the clean run's
    folder = Path(runs_folder(runs))
    step = int(s[0]["iteration"])
    pe, _, he, _ = pser.load_checkpoint(str(folder / "hybrid_elastic" / "ckpt"), step)
    pc, _, hc, _ = pser.load_checkpoint(str(folder / "hybrid_clean" / "ckpt"), step)
    assert he["neval"] == hc["neval"] == step
    for k in pc:
        np.testing.assert_array_equal(pe[k], pc[k], err_msg=k)
    for rank in ranks[1:]:  # whole and equal on every rank at the end
        for k in ranks[0]:
            if k.startswith("p."):
                assert np.array_equal(rank[k], ranks[0][k]), k
