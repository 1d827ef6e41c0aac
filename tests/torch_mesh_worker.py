"""The rank side of the mesh tests (``test_torch_parallel_mesh.py``,
``test_torch_parallel_optimizers.py``): spawned processes joined into one
gloo group through a file, each running a list of cases (a function of
this module by name, its inputs as numpy arrays) and writing each case's
results as ``<case>.<rank>.npz``. It imports torch and the port only
(never JAX), so a rank starts in a few seconds.

Every rank runs every case in the same order, so the meshes the cases
build (collectively) line up. ``spawn_mesh_cases(world, cases, folder)``
starts the ranks (on the CPU, or on the card with ``device="cuda"``)
through the examples' ``spawn`` under a deadline and returns ``{case
name: [rank 0's arrays, rank 1's, ...]}``.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List

import numpy as np

from bigdl_tpu_torch.examples._common import spawn


def _np(t):
    return t.detach().float().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = _np(v)
    return out


def _tensors(case, names, dev, grad=False):
    import torch

    return [torch.tensor(case[n], device=dev, requires_grad=grad) for n in names]


def _bytes_of(name):
    from bigdl_tpu_torch.parallel import _comm

    return np.asarray(_comm.counts()[name]["bytes"])


def _observe(opt, case, res):
    """With ``case["health"]``: telemetry and ``set_health`` on ``opt``, and
    each step's collective bytes read around its ``_train_step`` into
    ``res["wire"]`` (total, all-to-all, ppermute). Returns a function that
    files the step and health records into ``res`` after the fit."""
    if not case.get("health"):
        return lambda: None
    from bigdl_tpu_torch.obs import HealthConfig, Telemetry
    from bigdl_tpu_torch.parallel import _comm

    tel = Telemetry(heartbeat_interval_s=None)
    opt.set_telemetry(tel).set_health(HealthConfig(every_n_steps=1))
    step, wire = opt._train_step, []

    def counted(*a, **k):
        before = _comm.counts()
        out = step(*a, **k)
        after = _comm.counts()
        d = {n: after[n]["bytes"] - before[n]["bytes"] for n in after}
        wire.append([sum(d.values()), d["all_to_all"], d["ppermute"]])
        return out

    opt._train_step = counted

    def done():
        from torch_distri_worker import health_rows

        recs = tel.ring.records
        res["health"] = health_rows([r for r in recs if r["type"] == "health"])
        res["shards"] = np.asarray([[v["nonfinite_inputs"], v["nonfinite_targets"]]
                                    for r in recs if r["type"] == "health"
                                    for _, v in sorted(r.get("shards", {}).items())])
        steps = [r for r in recs if r["type"] == "step"]
        res["rec_wire"] = np.asarray([[r["collective_bytes"], r["all_to_all_bytes"],
                                       r["ppermute_bytes"]] for r in steps])
        res["wire"] = np.asarray(wire[:len(steps)])
        res["bubble"] = np.asarray([r.get("pipe_bubble_frac", -1.0) for r in steps])

    return done


# ----------------------------------------------------------------- functions
def ring(case, dev):
    """``ring_attention`` forward (and gradients against a cotangent)."""
    import torch

    from bigdl_tpu_torch.parallel import _comm, make_mesh, ring_attention

    mesh = make_mesh(case["mesh"])
    grad = "ct" in case
    q, k, v = _tensors(case, ("q", "k", "v"), dev, grad)
    lengths = torch.tensor(case["lengths"], device=dev) if "lengths" in case else None
    _comm.reset_counts()
    out = ring_attention(q, k, v, mesh, axis_name=case.get("axis", "sp"),
                         causal=case.get("causal", False), lengths=lengths,
                         mask_q=case.get("mask_q"))
    res = {"out": _np(out), "ppermute_fwd": _bytes_of("ppermute")}
    if grad:
        (out * torch.tensor(case["ct"], device=dev)).sum().backward()
        res.update(dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad),
                   ppermute_all=_bytes_of("ppermute"))
    return res


def _moe_expert(p, h):
    import torch

    return torch.relu(h @ p["w1"]) @ p["w2"]


def moe(case, dev):
    """``moe_ffn`` forward (and gradients against a cotangent)."""
    import torch

    from bigdl_tpu_torch.parallel import _comm, make_mesh, moe_ffn

    mesh = make_mesh(case["mesh"])
    grad = "ct" in case
    router_w, w1, w2, x = _tensors(case, ("router_w", "w1", "w2", "x"), dev, grad)
    _comm.reset_counts()
    y = moe_ffn(router_w, {"w1": w1, "w2": w2}, _moe_expert, x, mesh,
                axis=case.get("axis", "expert"), capacity_factor=case.get("cf", 1.25),
                router_top_k=case.get("k", 1), batch_axis=case.get("batch_axis"))
    res = {"y": _np(y), "a2a_fwd": _bytes_of("all_to_all")}
    if grad:
        (y * torch.tensor(case["ct"], device=dev)).sum().backward()
        res.update(g_router=_np(router_w.grad), g_w1=_np(w1.grad), g_w2=_np(w2.grad),
                   g_x=_np(x.grad))
    return res


def _mlp_stage(p, h):
    import torch

    return torch.tanh(h @ p["w"] + p["b"])


def pipeline(case, dev):
    """``pipeline_apply`` forward (and gradients against a cotangent)."""
    import torch

    from bigdl_tpu_torch.parallel import make_mesh, pipeline_apply

    mesh = make_mesh(case["mesh"])
    grad = "ct" in case
    w, b, x = _tensors(case, ("w", "b", "x"), dev, grad)
    y = pipeline_apply(_mlp_stage, {"w": w, "b": b}, x, mesh, axis=case.get("axis", "pipe"),
                       n_micro=case.get("n_micro"), batch_axis=case.get("batch_axis"),
                       remat_stages=case.get("remat", False))
    res = {"y": _np(y)}
    if grad:
        (y * torch.tensor(case["ct"], device=dev)).sum().backward()
        res.update(g_w=_np(w.grad), g_b=_np(b.grad), g_x=_np(x.grad))
    return res


def pipe_train(case, dev):
    """25 SGD steps through ``pipeline_apply`` (the JAX test's jitted
    loop): the losses."""
    import torch

    from bigdl_tpu_torch.parallel import make_mesh, pipeline_apply

    mesh = make_mesh(case["mesh"])
    w, b, x, t = _tensors(case, ("w", "b", "x", "t"), dev)
    params = {"w": w.requires_grad_(), "b": b.requires_grad_()}
    losses = []
    for _ in range(25):
        y = pipeline_apply(_mlp_stage, params, x, mesh, n_micro=4)
        loss = torch.mean((y - t) ** 2)
        gw, gb = torch.autograd.grad(loss, [params["w"], params["b"]])
        with torch.no_grad():
            params = {"w": (params["w"] - 0.2 * gw).requires_grad_(),
                      "b": (params["b"] - 0.2 * gb).requires_grad_()}
        losses.append(float(loss))
    return {"losses": np.asarray(losses)}


def _cnn_s0(p, h):
    import torch.nn.functional as F

    # XLA's "SAME" at stride 2 on an even size pads one row and column at the end
    return F.relu(F.conv2d(F.pad(h, (0, 1, 0, 1)), p["k"], stride=2)
                  + p["b"][None, :, None, None])


def _cnn_s1(p, h):
    return h.reshape(h.shape[0], -1) @ p["w"] + p["b"]


def _tanh_w(p, h):
    import torch

    return torch.tanh(h @ p["w"])


def hetero(case, dev):
    """``pipeline_apply_hetero`` forward and gradients of ``sum(y**2)``."""
    import torch

    from bigdl_tpu_torch.parallel import make_mesh, pipeline_apply_hetero

    mesh = make_mesh(case["mesh"])
    params = [{k: torch.tensor(v, device=dev, requires_grad=True) for k, v in p.items()}
              for p in case["params"]]
    fns = {"cnn": [_cnn_s0, _cnn_s1], "pyramid": [_tanh_w] * 4}[case["fns"]]
    x = torch.tensor(case["x"], device=dev)
    y = pipeline_apply_hetero(fns, params, x, mesh, n_micro=case["n_micro"],
                              skip_bubble_compute=case.get("skip", True))
    (y ** 2).sum().backward()
    res = {"y": _np(y)}
    for i, p in enumerate(params):
        res.update({f"g{i}_{k}": _np(v.grad) for k, v in p.items()})
    return res


# ------------------------------------------------------------------ training
def _problem_model(nn, kind, d=8, classes=4, dev="cpu"):
    kw = {"device": dev}
    if kind == "pipe":
        return nn.Sequential(nn.Linear(d, 16, **kw),
                             nn.PipelinedBlocks(nn.Sequential(nn.Linear(16, 16, **kw),
                                                              nn.Tanh(**kw), **kw), 4, **kw),
                             nn.Linear(16, classes, **kw), nn.LogSoftMax(**kw), **kw)
    return nn.Sequential(nn.Linear(d, 16, **kw),
                         nn.MoE(4, ffn_size=16, capacity_factor=4.0, **kw),
                         nn.Linear(16, classes, **kw), nn.LogSoftMax(**kw), **kw)


def fit(case, dev):
    """A ragged fit (``PipelineOptimizer`` / ``ExpertParallelOptimizer`` /
    ``LocalOptimizer``) of the small problem from the JAX weights; with
    ``ckpt`` a checkpoint run, then a resumed one."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch import optim as poptim
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.parallel import (ExpertParallelOptimizer, PipelineOptimizer,
                                          make_mesh)
    from bigdl_tpu_torch.utils.convert import load_jax_params
    from bigdl_tpu_torch.utils.random import RandomGenerator

    mesh = make_mesh(case["mesh"]) if case.get("mesh") else None
    res = {}

    def run(steps=None, ckpt=None, resume=None, epochs=2):
        RandomGenerator.set_seed(case.get("seed", 11))
        model = _problem_model(nn, case["kind"], dev=dev)
        model.init(sample_input=torch.from_numpy(case["x"][:case["batch"]]))
        load_jax_params(model, case["init"])
        ds = DataSet.array(case["x"], case["y"], batch_size=case["batch"])
        crit = nn.ClassNLLCriterion()
        if mesh is None:
            opt = poptim.LocalOptimizer(model, ds, crit)
        elif case["kind"] == "pipe":
            opt = PipelineOptimizer(model, ds, crit, mesh=mesh, data_axis=case.get("data_axis"),
                                    n_micro=case.get("n_micro"))
        else:
            opt = ExpertParallelOptimizer(model, ds, crit, mesh=mesh,
                                          data_axis=case.get("data_axis"))
        done = _observe(opt, case, res)
        opt.set_optim_method(poptim.SGD(learningrate=0.1, momentum=case.get("momentum", 0.0)))
        opt.set_end_when(poptim.Trigger.max_iteration(steps) if steps
                         else poptim.Trigger.max_epoch(epochs))
        if ckpt:
            opt.set_checkpoint(ckpt, poptim.Trigger.several_iteration(2))
        if resume:
            opt.resume(resume)
        if case.get("clip"):
            opt.set_gradient_clipping_by_l2_norm(case["clip"])
        if case.get("validate"):
            opt.set_validation(poptim.Trigger.every_epoch(),
                               DataSet.array(case["x"][:48], case["y"][:48], batch_size=16),
                               [poptim.Top1Accuracy(), poptim.Loss(nn.ClassNLLCriterion())])
        opt.optimize()
        done()
        return model, opt

    model, opt = run(steps=case.get("steps"))
    if case.get("validate"):
        res["score"] = np.asarray(opt.optim_method.state["score"])
        res["n_validations"] = np.asarray(opt.optim_method.state["n_validations"])
    res.update({f"p.{k}": v for k, v in _flat(model.get_parameters()).items()})
    res["losses"] = np.asarray([h["loss"] for h in opt.history], np.float64)
    res["records"] = np.asarray([h["records"] for h in opt.history])
    for k, v in opt.held_bytes.items() if hasattr(opt, "held_bytes") else ():
        res[f"held.{k}"] = np.asarray(v)
    if case.get("ckpt_dir"):
        run(steps=4, ckpt=case["ckpt_dir"])
        resumed, _ = run(steps=8, resume=case["ckpt_dir"])
        res.update({f"r.{k}": v for k, v in _flat(resumed.get_parameters()).items()})
    return res


def _lm(nn, dev):
    return nn.Transformer(vocab_size=32, hidden_size=16, num_heads=2, filter_size=32,
                          num_hidden_layers=2, postprocess_dropout=0.0, attention_dropout=0.0,
                          relu_dropout=0.0, mode="lm", device=dev)


def hybrid_plan(case):
    """The case's plan: the Megatron rules, after a rule that cuts the
    embedding's rows over ``data`` (``plan="data"``) or over ``data`` x
    ``model`` (``plan="data_model"``)."""
    from bigdl_tpu_torch.parallel import P, ShardingPlan, megatron_transformer_rules

    extra = {"data": [(r"^embedding$", P("data", None))],
             "data_model": [(r"^embedding$", P(("data", "model"), None))]}
    return ShardingPlan(extra.get(case.get("plan"), []) + megatron_transformer_rules())


def _lm_dataset(case):
    """The case's records at its batch; with ``tail`` every epoch's ragged
    last batch is yielded in training too (the JAX package's
    ``SampleToMiniBatch`` chain)."""
    from bigdl_tpu_torch.dataset import DataSet, LocalArrayDataSet, MiniBatch

    class Tail(LocalArrayDataSet):
        def data(self, train):
            for start in range(0, len(self._order), self.batch_size):
                idx = self._order[start:start + self.batch_size]
                yield MiniBatch(self.features[idx], self.labels[idx])

    if case.get("tail"):
        return Tail(case["x"], case["y"], batch_size=case["batch"])
    return DataSet.array(case["x"], case["y"], batch_size=case["batch"])


def _lm_criterion(nn, case):
    """The LM's criterion; with ``tail`` the plain ``CrossEntropyCriterion``
    over every position, whose row-wise form masks a padded tail (the
    ``TimeDistributedCriterion`` has none: a tail is dropped)."""
    if case.get("tail"):
        return nn.CrossEntropyCriterion()
    return nn.TimeDistributedCriterion(nn.CrossEntropyCriterion())


def hybrid(case, dev):
    """3 SGD steps of ``HybridParallelOptimizer`` (or ``LocalOptimizer``)
    on the small LM from the JAX weights, under :func:`hybrid_plan`, with
    ``micro`` micro-batches; with ``nan_rank`` a NaN planted in that rank's
    block of one leaf and the audit's message kept."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch import optim as poptim
    from bigdl_tpu_torch.analysis import ParamAuditError
    from bigdl_tpu_torch.parallel import HybridParallelOptimizer, make_mesh
    from bigdl_tpu_torch.utils.convert import load_jax_params
    from bigdl_tpu_torch.utils.random import RandomGenerator

    mesh = make_mesh(case["mesh"]) if case.get("mesh") else None
    RandomGenerator.set_seed(7)
    model = _lm(nn, dev)
    model.init(sample_input=torch.from_numpy(case["x"]))
    if case.get("init") is not None:
        load_jax_params(model, case["init"])
    ds = _lm_dataset(case)
    crit = _lm_criterion(nn, case)
    if mesh is None:
        opt = poptim.LocalOptimizer(model, ds, crit)
    else:
        opt = HybridParallelOptimizer(model, ds, crit, plan=hybrid_plan(case),
                                      mesh=mesh, donate=case.get("donate", True))
    opt.set_micro_batches(case.get("micro", 1))
    opt.set_optim_method(poptim.SGD(learningrate=0.1, momentum=case.get("momentum", 0.0)))
    opt.set_end_when(poptim.Trigger.max_iteration(case.get("steps", 3)))
    res = {}
    done = _observe(opt, case, res)
    if "nan_rank" in case:
        # the NaN goes into one block after the cut: the audit runs on it
        from bigdl_tpu_torch.parallel import hybrid as hy

        real_shard = hy.shard_leaf

        def shard_and_plant(leaf, spec, m):
            out = real_shard(leaf, spec, m)
            if m.rank == case["nan_rank"] and out.dim() == 2 and "planted" not in res:
                out[0, 0] = float("nan")
                res["planted"] = np.asarray(1)
            return out

        hy.shard_leaf = shard_and_plant
        try:
            opt.optimize()
        except ParamAuditError as e:
            res["message"] = np.asarray(str(e))
        finally:
            hy.shard_leaf = real_shard
        return res
    if mesh is not None:
        init_state = opt._init_step_state

        def init_and_look(method, params):
            slots = init_state(method, params)
            res["q_block"] = np.asarray(model.get_parameters()["block0"]["self_q_w"].shape)
            res["embedding_rows"] = np.asarray(model.get_parameters()["embedding"].shape[0])
            return slots

        opt._init_step_state = init_and_look
    opt.optimize()
    done()
    res.update({f"p.{k}": v for k, v in _flat(model.get_parameters()).items()})
    res["losses"] = np.asarray([h["loss"] for h in opt.history], np.float64)
    res["records"] = np.asarray([h["records"] for h in opt.history])
    for k, v in getattr(opt, "held_bytes", {}).items():
        res[f"held.{k}"] = np.asarray(v)
    if case.get("ckpt_dir"):
        res.update(_hybrid_resume(case, dev, mesh))
    return res


def _hybrid_resume(case, dev, mesh):
    """The hybrid run with momentum checkpointed at step 2 and resumed to
    step 4, on the mesh and by a one-rank ``LocalOptimizer``; and the
    uninterrupted 4 steps (the case's plan and micro-batches)."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch import optim as poptim
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.parallel import HybridParallelOptimizer
    from bigdl_tpu_torch.utils.convert import load_jax_params
    from bigdl_tpu_torch.utils.random import RandomGenerator

    def run(steps, ckpt=None, resume=None, local=False):
        RandomGenerator.set_seed(7)
        model = _lm(nn, dev)
        model.init(sample_input=torch.from_numpy(case["x"]))
        load_jax_params(model, case["init"])
        ds = DataSet.array(case["x"], case["y"], batch_size=case["batch"])
        crit = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion())
        opt = (poptim.LocalOptimizer(model, ds, crit) if local else
               HybridParallelOptimizer(model, ds, crit, plan=hybrid_plan(case), mesh=mesh))
        opt.set_micro_batches(case.get("micro", 1))
        opt.set_optim_method(poptim.SGD(learningrate=0.1, momentum=0.9))
        opt.set_end_when(poptim.Trigger.max_iteration(steps))
        if ckpt:
            opt.set_checkpoint(ckpt, poptim.Trigger.several_iteration(2))
        if resume:
            opt.resume(resume)
        opt.optimize()
        return _flat(model.get_parameters())

    out = {f"gold.{k}": v for k, v in run(4).items()}
    run(2, ckpt=case["ckpt_dir"])
    out.update({f"resumed.{k}": v for k, v in run(4, resume=case["ckpt_dir"]).items()})
    out.update({f"local.{k}": v
                for k, v in run(4, resume=case["ckpt_dir"], local=True).items()})
    return out


def _grads_of(module, y):
    import torch

    from bigdl_tpu_torch.utils.serialization import tree_items

    items = tree_items(module.get_parameters())
    gs = torch.autograd.grad((y ** 2).sum(), list(items.values()))
    return {f"g.{k}": _np(g) for k, g in zip(items, gs)}


def module_moe(case, dev):
    """``MoE`` on the mesh against its dense path: output and gradients."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.utils.random import RandomGenerator

    mesh = make_mesh(case["mesh"])
    RandomGenerator.set_seed(3)
    m = nn.MoE(4, ffn_size=32, router_top_k=case["k"], expert_parallel=True, device=dev)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((32, 16)).astype(np.float32))
    m.init(sample_input=x)
    res = {}
    for tag, use in (("par", mesh), ("dense", None)):
        m.set_mesh(use)
        m.expert_parallel = use is not None
        y, _ = m.apply(m.get_parameters(), m.get_state(), x.to(dev), training=False)
        res[f"{tag}.y"] = _np(y)
        res.update({f"{tag}.{k}": v for k, v in _grads_of(m, y).items()})
    return res


def module_pipe(case, dev):
    """``PipelinedBlocks`` on the mesh against its sequential path."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.utils.random import RandomGenerator

    mesh = make_mesh(case["mesh"])
    RandomGenerator.set_seed(21)
    m = nn.PipelinedBlocks(nn.Sequential(nn.Linear(12, 12, device=dev), nn.Tanh(device=dev),
                                         device=dev), 4, pipeline_parallel=True,
                           batch_axis=case.get("batch_axis"),
                           remat_stages=case.get("remat", False), device=dev)
    x = np.random.default_rng(2).standard_normal((case.get("rows", 16), 12)).astype(np.float32)
    x = torch.from_numpy(x).to(dev)
    m.init(sample_input=x)
    res = {}
    for tag, use in (("pp", mesh), ("seq", None)):
        m.set_mesh(use)
        m.pipeline_parallel = use is not None
        y, _ = m.apply(m.get_parameters(), m.get_state(), x, training=False)
        res[f"{tag}.y"] = _np(y)
        res.update({f"{tag}.{k}": v for k, v in _grads_of(m, y).items()})
    return res


def sdpa_ring(case, dev):
    """``scaled_dot_product_attention`` under a registration (its ppermute
    bytes show it rode the ring) and without one."""
    import torch

    from bigdl_tpu_torch.nn.attention import scaled_dot_product_attention as sdpa
    from bigdl_tpu_torch.parallel import _comm, make_mesh
    from bigdl_tpu_torch.utils.engine import Engine

    mesh = make_mesh(case["mesh"])
    q, k, v = _tensors(case, ("q", "k", "v"), dev)
    ref = sdpa(q, k, v, causal=True)
    _comm.reset_counts()
    Engine.set_sequence_parallel(mesh, "sp")
    try:
        out = sdpa(q, k, v, causal=True)
    finally:
        Engine.set_sequence_parallel(None)
    return {"ring": _np(out), "dense": _np(ref), "ppermute": _bytes_of("ppermute")}


def transformer_sp(case, dev):
    """The translation ``Transformer`` 's forward under a registration and
    without one."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel import _comm, make_mesh
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.random import RandomGenerator

    mesh = make_mesh(case["mesh"])
    src, tgt = (torch.from_numpy(case[n]).to(dev) for n in ("src", "tgt"))
    out = {}
    for tag, reg in (("dense", None), ("ring", mesh)):
        RandomGenerator.set_seed(11)
        m = nn.Transformer(vocab_size=50, hidden_size=16, num_heads=2, filter_size=32,
                           num_hidden_layers=1, postprocess_dropout=0.0, attention_dropout=0.0,
                           relu_dropout=0.0, mode="translation", device=dev)
        m.init(sample_input=[src, tgt])
        _comm.reset_counts()
        Engine.set_sequence_parallel(reg, "sp")
        try:
            y, _ = m.apply(m.get_parameters(), m.get_state(), [src, tgt], training=False)
        finally:
            Engine.set_sequence_parallel(None)
        out[tag] = _np(y)
        out[f"{tag}.ppermute"] = _bytes_of("ppermute")
    return out


def hop(case, dev):
    """One ``ppermute`` around the ring of every rank, of a float32 and a
    bfloat16 tensor drawn from the rank's seed: what arrived, as bits."""
    import torch

    from bigdl_tpu_torch.parallel import _comm, make_mesh

    mesh = make_mesh({"x": case["world"]})
    me, n = mesh.rank, case["world"]
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        g = torch.Generator().manual_seed(1000 + me)
        t = torch.randn(case["shape"], generator=g).to(dtype).to(dev)
        got = _comm.ppermute(t, mesh, "x", [(i, (i + 1) % n) for i in range(n)])
        view = torch.int32 if dtype == torch.float32 else torch.int16
        out[name] = got.cpu().view(view).numpy()
    return out


CASES = {f.__name__: f for f in (ring, moe, pipeline, pipe_train, hetero, fit, hybrid,
                                 module_moe, module_pipe, sdpa_ring, transformer_sp, hop)}


def rank_main(rank: int, world: int, folder: str, device="cpu") -> None:
    """One rank: join the group, run every case, write ``<case>.<rank>.npz``."""
    from bigdl_tpu_torch.utils.engine import Engine

    with open(os.path.join(folder, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    if device == "cpu":  # eight ranks at the host's thread count each would crowd the host
        import torch

        torch.set_num_threads(1)
    Engine.init_distributed(f"file://{folder}/group", world, rank, device=device)
    dev = "cpu" if device == "cpu" else "cuda"
    try:
        for case in cases:
            np.savez(os.path.join(folder, f"{case['name']}.{rank}.npz"),
                     **CASES[case["fn"]](case, dev))
    finally:
        Engine.shutdown_distributed()


def spawn_mesh_cases(world: int, cases: List[Dict[str, Any]], folder: str,
                     deadline_s: float = 150.0, device="cpu"
                     ) -> Dict[str, List[Dict[str, np.ndarray]]]:
    with open(os.path.join(folder, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    spawn(rank_main, (folder, device), world, deadline_s, stderr_dir=folder)
    return {c["name"]: [dict(np.load(os.path.join(folder, f"{c['name']}.{r}.npz")))
                        for r in range(world)] for c in cases}


def spawn_module_case(world: int, case: Dict[str, Any], folder: str,
                      deadline_s: float = 120.0) -> List[Dict[str, np.ndarray]]:
    """One case on ``world`` spawned CPU ranks; each rank's arrays."""
    return spawn_mesh_cases(world, [case], folder, deadline_s)[case["name"]]
