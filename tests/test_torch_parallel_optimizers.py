"""The port's mesh optimizers against the JAX package's, on the CPU:
``PipelineOptimizer`` and ``ExpertParallelOptimizer`` (their 2-epoch
fits, 56 rows in batches of 16, alone and composed with a data axis), ``HybridParallelOptimizer`` under ``megatron_transformer_plan``,
``ShardedParamAudit``, every refusal, a checkpoint resumed to the bit, and
the three mesh examples at a small size.

The JAX fits run in this process on the conftest's 8 virtual CPU devices,
from weights the JAX model was built with; the port's run in 8 spawned
gloo ranks (``torch_mesh_worker.py``, one spawn for the module) from the
same weights, on meshes of the JAX tests' shapes (an unused ``rep`` axis
fills the 8 ranks where a JAX mesh has 4 devices).

Tolerances (float32): the pipeline and expert fits' parameters atol 1e-5
against the JAX fits (the JAX tests hold theirs to the local oracle at
1e-6; the port's products round in another order); the hybrid LM, 3 SGD
steps: loss within 1e-4 and parameters within 2e-4 of the local run, the
JAX test's bounds, against the port's ``LocalOptimizer`` and the JAX
``HybridParallelOptimizer`` alike; a resumed run equals the uninterrupted
one to the bit; every rank returns the same parameters.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import bigdl_tpu.nn as jnn
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset.dataset import LocalArrayDataSet as JLocalArrayDataSet
from bigdl_tpu.dataset.dataset import SampleToMiniBatch
from bigdl_tpu.optim import SGD as JSGD
from bigdl_tpu.optim import LocalOptimizer as JLocal
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.parallel import ExpertParallelOptimizer as JExpert
from bigdl_tpu.parallel import HybridParallelOptimizer as JHybrid
from bigdl_tpu.parallel import PipelineOptimizer as JPipeline
from bigdl_tpu.parallel import make_mesh as j_make_mesh
from bigdl_tpu.parallel import megatron_transformer_plan as j_plan
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.optim import SGD, Trigger
from bigdl_tpu_torch.parallel import (ExpertParallelOptimizer, HybridParallelOptimizer,
                                      ParallelCompositionError, PipelineOptimizer, make_mesh)

from test_torch_conv_bn import flat, np_tree
from torch_distri_worker import health_rows
from torch_mesh_worker import CASES, spawn_mesh_cases

W = 8


def _problem(n=56, d=8, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.integers(0, classes, n).astype(np.int64))


def _j_problem_model(kind, d=8, classes=4):
    if kind == "pipe":
        return jnn.Sequential(jnn.Linear(d, 16),
                              jnn.PipelinedBlocks(jnn.Sequential(jnn.Linear(16, 16), jnn.Tanh()),
                                                  4),
                              jnn.Linear(16, classes), jnn.LogSoftMax())
    return jnn.Sequential(jnn.Linear(d, 16), jnn.MoE(4, ffn_size=16, capacity_factor=4.0),
                          jnn.Linear(16, classes), jnn.LogSoftMax())


def _jax_built(kind, x, seed=11):
    JRandom.set_seed(seed)
    m = _j_problem_model(kind)
    m.init(jax.random.PRNGKey(seed), sample_input=x[:16])
    return m


def _jax_health(opt):
    """Telemetry and ``set_health`` on a JAX optimizer; returns the function
    that reads its health records as rows (``health_rows``) and the
    per-shard counts."""
    from bigdl_tpu.obs import HealthConfig, Telemetry

    tel = Telemetry(heartbeat_interval_s=None)
    opt.set_telemetry(tel).set_health(HealthConfig(every_n_steps=1))

    def rows():
        recs = [r for r in tel.ring.records if r["type"] == "health"]
        shards = [[v["nonfinite_inputs"], v["nonfinite_targets"]]
                  for r in recs for _, v in sorted(r.get("shards", {}).items())]
        return health_rows(recs), np.asarray(shards)

    return rows


def _jax_fit(kind, opt_cls=None, mesh=None, data_axis=None, seed=11, health=False):
    x, y = _problem()
    m = _jax_built(kind, x)
    ds = JDataSet.array(x, y, batch_size=16)
    if opt_cls is None:
        opt = JLocal(m, ds, jnn.ClassNLLCriterion())
    else:
        opt = opt_cls(m, ds, jnn.ClassNLLCriterion(), mesh=mesh, data_axis=data_axis)
    rows = _jax_health(opt) if health else None
    JRandom.set_seed(seed)
    opt.set_optim_method(JSGD(learningrate=0.1))
    opt.set_end_when(JTrigger.max_epoch(2))
    opt.optimize()
    jax.block_until_ready(jax.tree_util.tree_leaves(m.get_parameters()))
    if health:
        return rows()
    return flat(np_tree(m.get_parameters()))


def _lm_data(n=16, vocab=32, t=8, seed=0):
    r = np.random.default_rng(seed)
    x = r.integers(1, vocab, (n, t)).astype(np.int32)
    y = np.concatenate([x[:, 1:], np.ones((n, 1), np.int32)], axis=1)
    return x, y


def _j_lm():
    return jnn.Transformer(vocab_size=32, hidden_size=16, num_heads=2, filter_size=32,
                           num_hidden_layers=2, postprocess_dropout=0.0, attention_dropout=0.0,
                           relu_dropout=0.0, mode="lm")


def _j_hybrid_plan(plan):
    """The JAX counterpart of ``torch_mesh_worker.hybrid_plan``."""
    from jax.sharding import PartitionSpec as JP

    from bigdl_tpu.parallel import ShardingPlan as JPlan
    from bigdl_tpu.parallel.sharding import megatron_transformer_rules as j_rules

    extra = {"data": [(r"^embedding$", JP("data", None))],
             "data_model": [(r"^embedding$", JP(("data", "model"), None))]}
    return JPlan(extra.get(plan, []) + j_rules())


def _jax_lm(hybrid: bool, health: bool = False, micro: int = 1, tail: bool = False,
            plan=None, n: int = 16):
    """3 SGD steps of the small LM in the JAX package: its
    ``HybridParallelOptimizer`` on data 2 x model 4 (``hybrid``) or its
    ``LocalOptimizer``; with ``tail`` the dataset yields each epoch's
    ragged tail (``SampleToMiniBatch``)."""
    x, y = _lm_data(n)
    JRandom.set_seed(7)
    m = _j_lm()
    m.init(jax.random.PRNGKey(7), sample_input=x[:16])
    init = np_tree(m.get_parameters())
    ds = (JLocalArrayDataSet(x, y, transformer=SampleToMiniBatch(16), batch_size=16) if tail
          else JDataSet.array(x, y, batch_size=16))
    crit = (jnn.CrossEntropyCriterion() if tail  # a row-wise form: the tail is masked
            else jnn.TimeDistributedCriterion(jnn.CrossEntropyCriterion()))
    if hybrid:
        opt = JHybrid(m, ds, crit, plan=_j_hybrid_plan(plan),
                      mesh=j_make_mesh({"data": 2, "model": 4}))
    else:
        opt = JLocal(m, ds, crit)
    opt.set_micro_batches(micro)
    rows = _jax_health(opt) if health else None
    opt.set_optim_method(JSGD(learningrate=0.1))
    opt.set_end_when(JTrigger.max_iteration(3))
    opt.optimize()
    if health:
        return rows()
    return init, flat(np_tree(m.get_parameters())), opt.optim_method.state["loss"]


@pytest.fixture(autouse=True, scope="module")
def _jax_engine_as_found():
    """The JAX Engine is process-wide, and the JAX calls here initialise it
    on every virtual device: a later test file on this worker sees it as it
    was."""
    saved = JEngine._state
    JEngine.reset()
    yield
    JEngine._state = saved


# ------------------------------------------------------------------ the cases
@pytest.fixture(scope="module")
def inits():
    x, _ = _problem()
    return {k: np_tree(_jax_built(k, x).get_parameters()) for k in ("pipe", "moe")}


@pytest.fixture(scope="module")
def ranks(inits, tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("opt"))
    x, y = _problem()
    xl, yl = _lm_data()
    lm_init = _jax_lm(False)[0]

    def fit(name, kind, mesh, **kw):
        return dict(name=name, fn="fit", kind=kind, mesh=mesh, x=x, y=y, batch=16,
                    init=inits[kind], **kw)

    cases = [
        fit("pp", "pipe", {"rep": 2, "pipe": 4}),
        fit("ep", "moe", {"rep": 2, "expert": 4}),
        fit("dp_pp", "pipe", {"data": 2, "pipe": 4}, data_axis="data"),
        fit("dp_ep", "moe", {"data": 2, "expert": 4}, data_axis="data"),
        fit("pp_local", "pipe", None),
        fit("pp_nmicro8", "pipe", {"rep": 2, "pipe": 4}, n_micro=8),
        fit("pp_cv", "pipe", {"rep": 2, "pipe": 4}, clip=0.05, validate=True),
        fit("pp_local_cv", "pipe", None, clip=0.05, validate=True),
        fit("ep_cv", "moe", {"rep": 2, "expert": 4}, clip=0.05, validate=True),
        fit("ep_local_cv", "moe", None, clip=0.05, validate=True),
        fit("pp_resume", "pipe", {"rep": 2, "pipe": 4}, steps=8, momentum=0.9,
            ckpt_dir=f"{folder}/ckpt"),
        dict(name="hybrid", fn="hybrid", mesh={"data": 2, "model": 4}, x=xl, y=yl, batch=16,
             init=lm_init),
        dict(name="hybrid_local", fn="hybrid", mesh=None, x=xl, y=yl, batch=16, init=lm_init),
        dict(name="hybrid_resume", fn="hybrid", mesh={"data": 2, "model": 4}, x=xl, y=yl,
             batch=16, init=lm_init, steps=1, ckpt_dir=f"{folder}/hybrid_ckpt"),
        dict(name="hybrid_nan", fn="hybrid", mesh={"data": 2, "model": 4}, x=xl, y=yl, batch=16,
             init=lm_init, nan_rank=5),
        fit("dp_pp_health", "pipe", {"data": 2, "pipe": 4}, data_axis="data", health=True),
        fit("ep_health", "moe", {"rep": 2, "expert": 4}, health=True),
        dict(name="hybrid_health", fn="hybrid", mesh={"data": 2, "model": 4}, x=xl, y=yl,
             batch=16, init=lm_init, health=True),
        dict(name="hybrid_undonated", fn="hybrid", mesh={"data": 2, "model": 4}, x=xl, y=yl,
             batch=16, init=lm_init, donate=False),
    ]
    xt, yt = _lm_data(24)
    lm = dict(fn="hybrid", mesh={"data": 2, "model": 4}, x=xl, y=yl, batch=16, init=lm_init)
    for name, kw in HYBRID_CASES.items():
        case = dict(lm, name=name, **kw)
        if kw.get("tail"):
            case.update(x=xt, y=yt)
        cases += [case, dict(case, name=f"{name}_local", mesh=None)]
    cases.append(dict(lm, name="hybrid_data_resume", mesh={"data": 2, "model": 2, "rep": 2},
                      plan="data", micro=2, steps=1, ckpt_dir=f"{folder}/hybrid_data_ckpt"))
    # the one-rank references run here, once (each rank would run the same)
    local = {c["name"]: [CASES[c["fn"]](c, "cpu")] for c in cases if c["mesh"] is None}
    spawned = spawn_mesh_cases(W, [c for c in cases if c["mesh"] is not None], folder,
                               deadline_s=240.0)
    return {**spawned, **local}


def _params(got):
    return {k[2:]: v for k, v in got.items() if k.startswith("p.")}


def _same_on_every_rank(got, prefix="p."):
    for r in range(1, W):
        for k, v in got[0].items():
            if k.startswith(prefix):
                np.testing.assert_array_equal(got[r][k], v, err_msg=f"rank {r} {k}")


# ----------------------------------------------------------------- parity
@pytest.mark.parametrize("name,kind,opt,mesh,data_axis", [
    ("pp", "pipe", JPipeline, {"pipe": 4}, None),
    ("ep", "moe", JExpert, {"expert": 4}, None),
    ("dp_pp", "pipe", JPipeline, {"data": 2, "pipe": 4}, "data"),
    ("dp_ep", "moe", JExpert, {"data": 2, "expert": 4}, "data"),
])
def test_fit_matches_the_jax_fit(name, kind, opt, mesh, data_axis, ranks):
    """The 2-epoch fit (56 rows: the array dataset drops each epoch's
    8-row tail in both packages) of each composition against the JAX
    optimizer's on the virtual mesh."""
    devices = jax.devices()[:int(np.prod(list(mesh.values())))]
    want = _jax_fit(kind, opt, j_make_mesh(mesh, devices=devices), data_axis)
    got = ranks[name]
    _same_on_every_rank(got)
    assert set(_params(got[0])) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(_params(got[0])[k], v, atol=1e-5, err_msg=k)
    assert list(got[0]["records"]) == [16] * 6


def test_pipeline_fit_matches_the_local_fit(ranks):
    got, local = _params(ranks["pp"][0]), _params(ranks["pp_local"][0])
    for k, v in local.items():
        np.testing.assert_allclose(got[k], v, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["pp", "ep"])
def test_clipping_and_validation_on_the_mesh(name, ranks):
    """Clipping by the global L2 norm (the stacked blocks' squares summed
    over their axis) and a validation each epoch (on the whole parameters,
    gathered for it): the same parameters (1e-6) and scores as one rank's
    LocalOptimizer."""
    got, local = ranks[f"{name}_cv"], ranks[f"{name}_local_cv"][0]
    _same_on_every_rank(got)
    assert int(got[0]["n_validations"]) == int(local["n_validations"]) == 2
    np.testing.assert_allclose(got[0]["score"], local["score"], atol=1e-6)
    for k, v in _params(local).items():
        np.testing.assert_allclose(_params(got[0])[k], v, atol=1e-6, err_msg=k)


def test_each_rank_holds_one_stage_and_its_slots(ranks):
    """A stacked leaf and its slot are a quarter on every rank: the held
    bytes are the replicated layers' plus a quarter of the stack's."""
    got = ranks["pp_resume"][0]
    d, classes = 8, 4
    replicated = (d * 16 + 16 + 16 * classes + classes) * 4
    stack = 4 * (16 * 16 + 16) * 4
    assert int(got["held.params"]) == replicated + stack // 4
    assert int(got["held.slots"]) == replicated + stack // 4  # SGD momentum: one slot


def test_checkpoint_resume_is_bit_equal(ranks):
    """A run checkpointed at step 4 (rank 0 writes the gathered tree) and
    resumed to step 8 equals the uninterrupted 8 steps to the bit."""
    got = ranks["pp_resume"]
    _same_on_every_rank(got, "r.")
    for k, v in _params(got[0]).items():
        np.testing.assert_array_equal(got[0][f"r.{k}"], v, err_msg=k)


def test_hybrid_matches_local_and_jax(ranks):
    """Data 2 x model 4 under the Megatron plan, 3 SGD steps: loss within
    1e-4 and parameters within 2e-4 of one rank's LocalOptimizer, and of
    the JAX HybridParallelOptimizer."""
    _, j_params, j_loss = _jax_lm(True)
    got, local = ranks["hybrid"], ranks["hybrid_local"][0]
    _same_on_every_rank(got)
    assert abs(got[0]["losses"][-1] - local["losses"][-1]) < 1e-4
    assert abs(got[0]["losses"][-1] - j_loss) < 1e-4
    for k, v in _params(local).items():
        np.testing.assert_allclose(_params(got[0])[k], v, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(_params(got[0])[k], j_params[k], atol=2e-4, err_msg=k)


# micro-batches, ragged tails and plans over the data axis: each against
# the JAX HybridParallelOptimizer on the virtual mesh and the port's
# LocalOptimizer (same micro-batches) on one rank
HYBRID_CASES = {
    "hybrid_micro": dict(micro=2),
    "hybrid_micro_tail": dict(micro=2, tail=True),
    "hybrid_data": dict(plan="data"),
    "hybrid_data_model_micro": dict(plan="data_model", micro=2),
}


@pytest.mark.parametrize("name", sorted(HYBRID_CASES))
def test_hybrid_micro_batches_and_data_plans_match_jax(name, ranks):
    """3 SGD steps (the tail case: 16 rows, then 8 padded to 16 and
    masked, then 16): every rank's losses and parameters the same; within
    the hybrid test's bounds (loss 1e-4, parameters 2e-4) of the JAX
    ``HybridParallelOptimizer`` with the same plan and micro-batches and of
    the port's ``LocalOptimizer``; a data-sharded embedding is held as a
    block (a quarter or an eighth of its rows)."""
    kw = HYBRID_CASES[name]
    _, j_params, j_loss = _jax_lm(True, micro=kw.get("micro", 1), tail=kw.get("tail", False),
                                  plan=kw.get("plan"), n=24 if kw.get("tail") else 16)
    got, local = ranks[name], ranks[f"{name}_local"][0]
    _same_on_every_rank(got)
    if kw.get("tail"):
        assert list(local["records"]) == [16, 8, 16]
    assert abs(got[0]["losses"][-1] - local["losses"][-1]) < 1e-4
    assert abs(got[0]["losses"][-1] - j_loss) < 1e-4
    for k, v in _params(local).items():
        np.testing.assert_allclose(_params(got[0])[k], v, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(_params(got[0])[k], j_params[k], atol=2e-4, err_msg=k)
    if kw.get("plan"):
        rows = 32 // (2 if kw["plan"] == "data" else 8)
        assert all(int(r["embedding_rows"]) == rows for r in got)


def test_hybrid_data_plan_checkpoint_resumes_on_one_rank(ranks):
    """The data-axis plan with micro-batches on data 2 x model 2 (an
    unused ``rep`` axis fills the 8 ranks), checkpointed at step 2 and
    resumed to step 4: on the mesh equal to the uninterrupted run to the
    bit; by a one-rank ``LocalOptimizer`` (the file's embedding whole)
    within 2e-4."""
    got = ranks["hybrid_data_resume"]
    _same_on_every_rank(got, "resumed.")
    gold = {k[5:]: v for k, v in got[0].items() if k.startswith("gold.")}
    assert gold["embedding"].shape == (32, 16)
    for k, v in gold.items():
        np.testing.assert_array_equal(got[0][f"resumed.{k}"], v, err_msg=k)
        np.testing.assert_allclose(got[0][f"local.{k}"], v, atol=2e-4, err_msg=k)


def test_hybrid_holds_its_blocks(ranks):
    """Each rank holds a quarter of every Megatron-sharded leaf (and, with
    no momentum, no slots): its bytes against a replicated rank's, and the
    (16, 16) q projection's block is 4 rows (the JAX test's shard shape)."""
    for got in ranks["hybrid"]:
        assert tuple(got["q_block"]) == (4, 16)
    got, local = ranks["hybrid"][0], ranks["hybrid_local"][0]
    params = _params(local)
    sharded = sum(v.size for k, v in params.items()
                  if k.endswith(("_q_w", "_k_w", "_v_w", "_out_w", "filter_w", "filter_b"))
                  or k.split(".")[-1] == "out_w")
    whole = sum(v.size for v in params.values())
    assert int(got["held.params"]) == (whole - sharded + sharded // 4) * 4
    assert int(got["held.slots"]) == 0


def test_hybrid_checkpoint_resumes_at_any_mesh(ranks):
    """Momentum SGD on data 2 x model 4, checkpointed at step 2 (rank 0
    writes the gathered tree and slots) and resumed to step 4: on the mesh
    equal to the uninterrupted run to the bit; by a one-rank
    ``LocalOptimizer`` within the JAX test's 2e-4."""
    got = ranks["hybrid_resume"]
    _same_on_every_rank(got, "resumed.")
    gold = {k[5:]: v for k, v in got[0].items() if k.startswith("gold.")}
    assert gold
    for k, v in gold.items():
        np.testing.assert_array_equal(got[0][f"resumed.{k}"], v, err_msg=k)
        np.testing.assert_allclose(got[0][f"local.{k}"], v, atol=2e-4, err_msg=k)


def test_sharded_audit_names_the_leaf_and_the_rank(ranks):
    got = ranks["hybrid_nan"]
    msgs = [str(g.get("message", "")) for g in got]
    assert "planted" in got[5] and "non-finite" in msgs[5] and "rank 5" in msgs[5]
    # rank 5 is (data 1, model 1): rows 4:8 of the first (16, 16) leaf cut
    assert "['block0']['self_q_w'] (shard [4:8, 0:16] on rank 5)" in msgs[5], msgs[5]
    # the other ranks' blocks are finite; they stop too, naming rank 5
    for r, m in enumerate(msgs):
        if r != 5:
            assert "non-finite" not in m and "rank(s) [5]" in m, m


# ------------------------------------------------ health, donate, telemetry
@pytest.mark.parametrize("name,kind,opt,mesh,data_axis", [
    ("dp_pp_health", "pipe", JPipeline, {"data": 2, "pipe": 4}, "data"),
    ("ep_health", "moe", JExpert, {"expert": 4}, None),
    ("hybrid_health", "lm", JHybrid, {"data": 2, "model": 4}, "data"),
])
def test_mesh_health_matches_jax(name, kind, opt, mesh, data_axis, ranks):
    """``set_health`` on the mesh optimizers (each rank's blocks, a stacked
    or sharded leaf's rows summed over its axes): the same rows on every
    rank, and the JAX optimizer's health records within 1e-4 relative
    (1e-6 absolute: the fits' parameters agree at 1e-5) — the global grad
    norm, weight norm, update ratio, non-finite counts and each layer's
    three norms, every step — with the per-data-shard counts (all 0 here)
    where the JAX optimizer binds a data axis."""
    got = ranks[name]
    for r in range(1, W):
        np.testing.assert_array_equal(got[r]["health"], got[0]["health"])
    if kind == "lm":
        want, shards = _jax_lm(True, health=True)
    else:
        devices = jax.devices()[:int(np.prod(list(mesh.values())))]
        want, shards = _jax_fit(kind, opt, j_make_mesh(mesh, devices=devices), data_axis,
                                health=True)
    assert got[0]["health"].shape == want.shape and want.shape[0] >= 3
    np.testing.assert_allclose(got[0]["health"], want, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got[0]["shards"].reshape(shards.shape), shards)


def test_hybrid_donate_false_is_bit_equal(ranks):
    """``donate=False`` writes every update into fresh blocks: the same
    parameters as the donated run, to the bit."""
    for a, b in zip(ranks["hybrid_undonated"], ranks["hybrid"]):
        for k, v in _params(b).items():
            np.testing.assert_array_equal(_params(a)[k], v, err_msg=k)


@pytest.mark.parametrize("name", ["dp_pp_health", "ep_health", "hybrid_health"])
def test_step_records_carry_the_wire_and_the_bubble(name, ranks):
    """Each ``step`` record's ``collective_bytes`` (with its all-to-all and
    ppermute parts) is that step's delta of ``parallel._comm`` 's counters;
    the pipeline stamps ``(S-1)/(n_micro+S-1)`` = 3/7 on every record."""
    for got in ranks[name]:
        np.testing.assert_array_equal(got["rec_wire"], got["wire"])
        assert (got["rec_wire"][:, 0] > 0).all()
    rec = ranks[name][0]
    if name == "dp_pp_health":
        assert (rec["rec_wire"][:, 2] > 0).all()  # the GPipe ring's hops
        np.testing.assert_allclose(rec["bubble"], 3 / 7, rtol=1e-6)
    else:
        assert (rec["bubble"] == -1.0).all()
    if name == "ep_health":
        assert (rec["rec_wire"][:, 1] > 0).all()  # the expert dispatch


# ---------------------------------------------------------------- refusals
class _ShapeMesh:
    """A mesh's shape alone: the refusals below raise before any collective."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _p_model(kind):
    from torch_mesh_worker import _problem_model

    return _problem_model(pnn, kind)


def _p_opt(cls, model, rows=16, batch=16, **kw):
    x, y = _problem(n=rows)
    opt = cls(model, DataSet.array(x, y, batch_size=batch), pnn.ClassNLLCriterion(), **kw)
    return opt.set_optim_method(SGD(learningrate=0.1)).set_end_when(Trigger.max_iteration(1))


@pytest.mark.parametrize("cls,kind", [(PipelineOptimizer, "pipe"),
                                      (ExpertParallelOptimizer, "moe")])
@pytest.mark.parametrize("kw", [{"flat_update": True}, {"comms_dtype": "bfloat16"}])
def test_incompatible_composition_is_typed(cls, kind, kw):
    jcls = {PipelineOptimizer: JPipeline, ExpertParallelOptimizer: JExpert}[cls]
    x, y = _problem(n=16)
    with pytest.raises(ParallelCompositionError) as pe:
        cls(_p_model(kind), DataSet.array(x, y, batch_size=16), pnn.ClassNLLCriterion(), **kw)
    with pytest.raises(Exception) as je:
        jcls(_j_problem_model(kind), JDataSet.array(x, y, batch_size=16),
             jnn.ClassNLLCriterion(), **kw)
    assert isinstance(pe.value, ValueError) and "incompatible" in str(pe.value)
    assert str(pe.value).split(":")[0] == str(je.value).split(":")[0]


def test_hybrid_refuses_flat_update_and_takes_micro_batches():
    """``flat_update`` is refused, as in the JAX package; micro-batches are
    taken (their runs: ``test_hybrid_micro_batches_and_data_plans_match_jax``)
    and a micro-batch whose rows do not divide over the data axis is
    refused naming the batch, the micro-batch count and the data axis."""
    from bigdl_tpu_torch.parallel import megatron_transformer_plan

    x, y = _problem(n=16)
    with pytest.raises(ParallelCompositionError, match="flat_update"):
        HybridParallelOptimizer(_p_model("pipe"), DataSet.array(x, y, batch_size=16),
                                pnn.ClassNLLCriterion(), flat_update=True)
    opt = HybridParallelOptimizer(_p_model("pipe"), DataSet.array(x, y, batch_size=16),
                                  pnn.ClassNLLCriterion(), plan=megatron_transformer_plan(),
                                  mesh=_ShapeMesh(data=4, model=2))
    assert opt.set_micro_batches(8) is opt
    with pytest.raises(ValueError, match=r"micro-batch's 2 rows \(batch 16 / 8 micro-batches\) "
                                         "do not divide over data axis 4"):
        opt._check_first_batch(_FirstBatch(16))
    opt.set_micro_batches(3)
    with pytest.raises(ValueError, match="batch size 16 not divisible by micro batch count 3"):
        opt._check_first_batch(_FirstBatch(16))


class _FirstBatch:
    def __init__(self, rows):
        self.rows = rows

    def size(self):
        return self.rows


def test_set_micro_batches_refused():
    opt = _p_opt(PipelineOptimizer, _p_model("pipe"))
    with pytest.raises(NotImplementedError, match="n_micro"):
        opt.set_micro_batches(2)
    with pytest.raises(ValueError, match="n_micro must be"):
        _p_opt(PipelineOptimizer, _p_model("pipe"), n_micro=0)


def test_mesh_missing_axis_fails_loudly():
    """Without a mesh the Engine's 1-D data mesh has no 'pipe' axis; a
    data axis the mesh lacks fails too."""
    with pytest.raises(ValueError, match="make_mesh"):
        _p_opt(PipelineOptimizer, _p_model("pipe")).optimize()
    with pytest.raises(ValueError, match="data_axis 'batch' not in mesh axes"):
        _p_opt(PipelineOptimizer, _p_model("pipe"), mesh=_ShapeMesh(pipe=4),
               data_axis="batch").optimize()
    with pytest.raises(ValueError, match="lack data axis"):
        _p_opt(HybridParallelOptimizer, _p_model("pipe"), data_axis="batch").optimize()


def test_batch_must_fill_schedule_grid():
    with pytest.raises(ValueError, match="n_micro"):
        _p_opt(PipelineOptimizer, _p_model("pipe"), rows=12, batch=6,
               mesh=_ShapeMesh(pipe=4)).optimize()
    with pytest.raises(ValueError, match="tile the mesh"):
        _p_opt(ExpertParallelOptimizer, _p_model("moe"), rows=12, batch=12,
               mesh=_ShapeMesh(data=2, expert=4), data_axis="data").optimize()


def test_model_without_parallel_module_fails_loudly():
    plain = pnn.Sequential(pnn.Linear(8, 4, device="cpu"), pnn.LogSoftMax(device="cpu"),
                           device="cpu")
    with pytest.raises(ValueError, match="PipelinedBlocks"):
        _p_opt(PipelineOptimizer, plain, mesh=make_mesh({"pipe": 1})).optimize()
    plain = pnn.Sequential(pnn.Linear(8, 4, device="cpu"), pnn.LogSoftMax(device="cpu"),
                           device="cpu")
    with pytest.raises(ValueError, match="nn.MoE"):
        _p_opt(ExpertParallelOptimizer, plain, mesh=make_mesh({"expert": 1})).optimize()
    with pytest.raises(ValueError, match="size the stack"):
        _p_opt(PipelineOptimizer, _p_model("pipe"), mesh=_ShapeMesh(pipe=2)).optimize()


def test_plan_over_the_data_axis_runs():
    """A plan that cuts a leaf over the data axis trains (its multi-rank
    runs: ``test_hybrid_micro_batches_and_data_plans_match_jax``); on a
    one-rank mesh it equals ``LocalOptimizer`` to the bit."""
    import torch

    from bigdl_tpu_torch.optim import LocalOptimizer
    from bigdl_tpu_torch.parallel import P, ShardingPlan

    got = []
    for cls, kw in ((HybridParallelOptimizer,
                     dict(plan=ShardingPlan([(r"weight$", P("data", None))]),
                          mesh=make_mesh({"data": 1}))), (LocalOptimizer, {})):
        torch.manual_seed(0)
        model = pnn.Sequential(pnn.Linear(8, 4, device="cpu"), pnn.LogSoftMax(device="cpu"),
                               device="cpu")
        model.init(sample_input=torch.zeros(2, 8))
        with torch.no_grad():
            for i, p in enumerate(model.parameters()):
                p.copy_(torch.linspace(-1, 1, p.numel()).reshape(p.shape) * (i + 1))
        _p_opt(cls, model, **kw).optimize()
        got.append([p.detach().clone() for p in model.parameters()])
    for a, b in zip(*got):
        assert torch.equal(a, b)


def test_make_mesh_spans_the_group():
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh({"data": 2})
    with pytest.raises(ValueError, match="every rank of the group"):
        make_mesh({"data": 1}, devices=[3])


# ---------------------------------------------------------------- examples
@pytest.mark.parametrize("name,argv,world", [
    ("pipeline_train", ["--n-stages", "2", "--dp", "2"], 4),
    ("longctx_train", ["--sp", "2", "--seq-len", "16"], 2),
])
def test_mesh_example_matches_its_one_rank_run(name, argv, world):
    """The main on its spawned mesh ranks (the GPipe schedule, the ring)
    against the same model trained in this process on its sequential or
    dense path: losses within 1e-5, and the bigram recovery read alike."""
    import importlib

    from bigdl_tpu_torch.utils.engine import Engine

    mod = importlib.import_module(f"bigdl_tpu_torch.examples.{name}")
    argv = ["--platform", "cpu", "--max-epoch", "1", "--synthetic-size", "3000"] + argv
    run = mod.main(argv)
    ranks = run.results["ranks"]
    assert len(ranks) == world and 0.0 <= run.results["bigram_recovery"] <= 1.0
    mesh_losses = [h["loss"] for h in ranks[0]["history"]]
    for r in ranks[1:]:
        assert [h["loss"] for h in r["history"]] == mesh_losses
    local = mod.build(mod.parser().parse_args(argv))
    assert Engine.sequence_parallel() is None
    model = local.optimizer.optimize()
    losses = [h["loss"] for h in local.optimizer.history]
    assert len(losses) == len(mesh_losses) > 0 and np.isfinite(losses).all()
    np.testing.assert_allclose(mesh_losses, losses, atol=1e-5)
    from bigdl_tpu_torch.examples.pipeline_train import probe_recovery

    assert abs(probe_recovery(model, 64)[0] - run.results["bigram_recovery"]) < 0.05
