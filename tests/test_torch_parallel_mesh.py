"""The port's mesh parallelisms against the JAX package's, on the CPU: ring
attention, the expert-parallel ``moe_ffn``, the GPipe ``pipeline_apply``
and ``pipeline_apply_hetero``, the ``MoE`` and ``PipelinedBlocks`` modules
on a mesh, the ring route of ``scaled_dot_product_attention``, the sharding
plans and the ``Engine`` registration.

The JAX side runs in this process on the conftest's 8 virtual CPU devices;
the port's side runs in 8 spawned gloo ranks (``torch_mesh_worker.py``, one
spawn for the module, every case on every rank). A JAX mesh of n devices
is held against a port mesh ``{"rep": 8/n, axis: n}``: the ``rep`` axis
carries nothing, so each of its rows runs the same program, and every rank
must return the same arrays.

Tolerances (float32; the per-rank sums and products round in another order
than XLA's): forwards atol 1e-5, gradients atol 1e-5 (2e-4 where the JAX
test itself allows it: the module paths and the hetero CNN, whose
3x3 convolutions sum 27 products); the ranks agree to the bit.
"""

from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from bigdl_tpu.nn.attention import scaled_dot_product_attention as j_sdpa
from bigdl_tpu.parallel.moe import moe_ffn as j_moe_ffn
from bigdl_tpu.parallel.pipeline import pipeline_apply as j_pipeline
from bigdl_tpu.parallel.pipeline import pipeline_apply_hetero as j_hetero
from bigdl_tpu.parallel.sequence import ring_attention as j_ring
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu_torch.nn.attention import scaled_dot_product_attention as p_sdpa
from bigdl_tpu_torch.parallel import (P, ShardingPlan, make_mesh, megatron_transformer_plan,
                                      moe_ffn_reference)
from bigdl_tpu_torch.utils.engine import Engine

from torch_mesh_worker import spawn_mesh_cases

W = 8  # the spawned ranks
ATOL = 1e-5


def _jmesh(sizes):
    names = tuple(sizes)
    shape = tuple(sizes.values())
    return JMesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), names)


def _rep(axis, n, **more):
    """The port mesh over W ranks holding a JAX mesh of n devices."""
    mesh = {"rep": W // (n * int(np.prod(list(more.values()) or [1])))}
    mesh.update(more)
    mesh[axis] = n
    return mesh


def _rng(seed):
    r = np.random.default_rng(seed)
    return lambda *s: r.standard_normal(s).astype(np.float32)


# ------------------------------------------------------------------ the cases
def _ring_case(name, n, tq=16, tk=16, causal=False, lengths=None, grad=True, seed=0):
    mk = _rng(seed)
    c = dict(name=name, fn="ring", mesh=_rep("sp", n), q=mk(2, 2, tq, 8), k=mk(2, 2, tk, 8),
             v=mk(2, 2, tk, 8), causal=causal, jmesh={"sp": n})
    if lengths is not None:
        c["lengths"] = np.asarray(lengths, np.int32)
    if grad:
        c["ct"] = mk(2, 2, tq, 8)
    return c


def _moe_case(name, e, k=1, cf=1.25, dp=None, b=None, grad=True, seed=0):
    mk = _rng(seed)
    b = b or 8 * e * (dp or 1)
    c = dict(name=name, fn="moe", router_w=mk(16, e) * 0.5, w1=mk(e, 16, 32) * 0.2,
             w2=mk(e, 32, 16) * 0.2, x=mk(b, 16), k=k, cf=cf)
    if dp:
        c.update(mesh=_rep("expert", e, data=dp), batch_axis="data",
                 jmesh={"data": dp, "expert": e})
    else:
        c.update(mesh=_rep("expert", e), jmesh={"expert": e})
    if grad:
        c["ct"] = mk(b, 16)
    return c


def _pipe_case(name, s, n_micro, dp=None, remat=False, seed=0):
    mk = _rng(seed)
    c = dict(name=name, fn="pipeline", w=mk(s, 16, 16) * 0.3, b=mk(s, 16) * 0.1,
             x=mk(16, 16), n_micro=n_micro, remat=remat, ct=mk(16, 16))
    if dp:
        c.update(mesh=_rep("pipe", s, data=dp), batch_axis="data",
                 jmesh={"data": dp, "pipe": s})
    else:
        c.update(mesh=_rep("pipe", s), jmesh={"pipe": s})
    return c


def _pipe_train_case():
    mk = _rng(4)
    r = np.random.default_rng(11)
    return dict(name="pipe_train", fn="pipe_train", mesh=_rep("pipe", 4),
                w=(r.standard_normal((4, 8, 8)) * 0.3).astype(np.float32),
                b=(r.standard_normal((4, 8)) * 0.1).astype(np.float32), x=mk(16, 8),
                t=mk(16, 8))


def _cnn_params(seed=3):
    r = np.random.default_rng(seed)
    return [{"k": (r.standard_normal((8, 3, 3, 3)) * 0.2).astype(np.float32),
             "b": np.zeros((8,), np.float32)},
            {"w": (r.standard_normal((8 * 8 * 8, 10)) * 0.05).astype(np.float32),
             "b": np.zeros((10,), np.float32)}]


def _pyramid_params():
    r = np.random.default_rng(9)
    widths = [12, 10, 6, 4, 2]
    return ([{"w": (r.standard_normal((a, b)) * 0.4).astype(np.float32)}
             for a, b in zip(widths[:-1], widths[1:])],
            r.standard_normal((8, 12)).astype(np.float32))


def _cases():
    cases = [
        _ring_case("ring_sp4", 4),
        _ring_case("ring_sp2", 2, seed=1),
        _ring_case("ring_causal_sp4", 4, causal=True, seed=2),
        _ring_case("ring_causal_sp2", 2, causal=True, seed=3),
        _ring_case("ring_lengths_sp4", 4, lengths=[16, 9], seed=4),
        _ring_case("ring_lengths_causal_sp2", 2, causal=True, lengths=[16, 5], seed=5),
        _ring_case("ring_rect_sp4", 4, tq=8, tk=16, lengths=[16, 11], seed=6),
        _ring_case("ring_rect_causal_sp2", 2, tq=8, tk=16, causal=True, seed=7),
        _moe_case("moe_e2", 2), _moe_case("moe_e4", 4, seed=1),
        _moe_case("moe_e8", 8, seed=2),
        _moe_case("moe_drops_e4", 4, cf=0.5, seed=3),
        _moe_case("moe_top2_e4", 4, k=2, seed=4),
        _moe_case("moe_top2_drops_e4", 4, k=2, cf=0.5, seed=5),
        _moe_case("moe_dp2_e4", 4, dp=2, cf=4.0, seed=6),
        _moe_case("moe_dp2_top2_e2", 2, k=2, dp=2, cf=4.0, seed=7),
        _pipe_case("pipe_s4_m4", 4, 4), _pipe_case("pipe_s4_m8", 4, 8, seed=1),
        _pipe_case("pipe_s2_m2", 2, 2, seed=2), _pipe_case("pipe_s8_m8", 8, 8, seed=3),
        _pipe_case("pipe_remat_s4_m4", 4, 4, remat=True),
        _pipe_case("pipe_dp2_s4_m2", 4, 2, dp=2, seed=5),
        _pipe_train_case(),
    ]
    x = np.random.default_rng(5).standard_normal((8, 3, 16, 16)).astype(np.float32)
    for n_micro in (2, 4):
        for skip in (True, False):
            cases.append(dict(name=f"hetero_cnn_m{n_micro}_{skip}", fn="hetero", fns="cnn",
                              mesh=_rep("pipe", 2), params=_cnn_params(), x=x,
                              n_micro=n_micro, skip=skip, jmesh={"pipe": 2}))
    params, xp = _pyramid_params()
    cases.append(dict(name="hetero_pyramid", fn="hetero", fns="pyramid", mesh=_rep("pipe", 4),
                      params=params, x=xp, n_micro=4, jmesh={"pipe": 4}))
    cases += _module_cases()
    return cases


def _module_cases():
    """``MoE`` and ``PipelinedBlocks`` on a mesh against their dense and
    sequential paths, the sdpa ring route and the ``Transformer`` under a
    registration: one case each, read by several tests."""
    mk = _rng(11)
    q, k, v = mk(2, 2, 32, 8), mk(2, 2, 32, 8), mk(2, 2, 32, 8)
    r = np.random.default_rng(13)
    return [
        dict(name="mod_moe", fn="module_moe", mesh=_rep("expert", 4), k=1),
        dict(name="mod_moe_top2", fn="module_moe", mesh=_rep("expert", 4), k=2),
        dict(name="mod_pipe", fn="module_pipe", mesh=_rep("pipe", 4)),
        dict(name="mod_pipe_dp", fn="module_pipe", mesh={"data": 2, "pipe": 4},
             batch_axis="data"),
        dict(name="mod_pipe_remat", fn="module_pipe", mesh=_rep("pipe", 4), remat=True),
        dict(name="mod_pipe_ragged", fn="module_pipe", mesh=_rep("pipe", 4), rows=6),
        dict(name="sdpa_ring", fn="sdpa_ring", mesh=_rep("sp", 4), q=q, k=k, v=v),
        dict(name="sdpa_ring_2d", fn="sdpa_ring", mesh={"data": 2, "sp": 4}, q=q, k=k, v=v),
        dict(name="transformer_sp", fn="transformer_sp", mesh=_rep("sp", 8),
             src=r.integers(1, 50, (2, 8)).astype(np.int64),
             tgt=r.integers(1, 50, (2, 8)).astype(np.int64)),
    ]


@pytest.fixture(autouse=True, scope="module")
def _jax_engine_as_found():
    """The JAX Engine is process-wide, and the JAX calls here initialise it
    on every virtual device: a later test file on this worker sees it as it
    was."""
    saved = JEngine._state
    JEngine.reset()
    yield
    JEngine._state = saved


@pytest.fixture(scope="module")
def cases():
    return {c["name"]: c for c in _cases()}


@pytest.fixture(scope="module")
def ranks(cases, tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("mesh"))
    return spawn_mesh_cases(W, list(cases.values()), folder, deadline_s=240.0)


def _same_on_every_rank(got):
    for r in range(1, W):
        for key, v in got[0].items():
            np.testing.assert_array_equal(got[r][key], v, err_msg=f"rank {r} {key}")


def _close(got, ref, atol=ATOL):
    _same_on_every_rank(got)
    for key, v in ref.items():
        np.testing.assert_allclose(got[0][key], np.asarray(v), atol=atol, err_msg=key)


# ------------------------------------------------------------------- ring
def _j_ring(c):
    mesh = _jmesh(c["jmesh"])
    lengths = jnp.asarray(c["lengths"]) if "lengths" in c else None

    def f(q, k, v):
        return j_ring(q, k, v, mesh, axis_name="sp", causal=c["causal"], lengths=lengths)

    @jax.jit
    def run(q, k, v, ct):
        out, vjp = jax.vjp(f, q, k, v)
        return (out,) + vjp(ct)

    out, dq, dk, dv = run(*(jnp.asarray(c[n]) for n in ("q", "k", "v", "ct")))
    return {"out": out, "dq": dq, "dk": dk, "dv": dv}


RING = ["ring_sp4", "ring_sp2", "ring_causal_sp4", "ring_causal_sp2", "ring_lengths_sp4",
        "ring_lengths_causal_sp2", "ring_rect_sp4", "ring_rect_causal_sp2"]


@pytest.mark.parametrize("name", RING)
def test_ring_attention_matches_jax(name, cases, ranks):
    """Forward and gradients of the ring against the JAX ring on the
    virtual mesh (and so against dense attention, which the JAX tests hold
    it to)."""
    _close(ranks[name], _j_ring(cases[name]))


@pytest.mark.parametrize("name", ["ring_sp4", "ring_causal_sp2"])
def test_ring_moves_two_blocks_a_hop_each_way(name, cases, ranks):
    """ppermute bytes a rank: (n-1) hops x K and V x its chunk, forward; the
    backward's reverse ring moves as much again."""
    c = cases[name]
    n = c["jmesh"]["sp"]
    chunk = c["k"].size // n * 4
    for got in ranks[name]:
        assert int(got["ppermute_fwd"]) == (n - 1) * 2 * chunk
        assert int(got["ppermute_all"]) == 2 * (n - 1) * 2 * chunk


def test_ring_rejects_indivisible_sequence():
    from bigdl_tpu_torch.parallel import ring_attention

    q = torch.zeros(1, 1, 10, 4)
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(q, q, q, _FakeMesh(4))


class _FakeMesh:
    """A mesh's shape alone: enough for the checks before any collective."""

    def __init__(self, n, axis="sp"):
        self.shape = {axis: n}


# -------------------------------------------------------------------- moe
def _j_moe(c):
    mesh = _jmesh(c["jmesh"])

    def expert(p, h):
        return jax.nn.relu(h @ p["w1"]) @ p["w2"]

    def f(rw, w1, w2, x):
        return j_moe_ffn(rw, {"w1": w1, "w2": w2}, expert, x, mesh, capacity_factor=c["cf"],
                         router_top_k=c["k"], batch_axis=c.get("batch_axis"))

    @jax.jit
    def run(ct, *args):
        y, vjp = jax.vjp(f, *args)
        return y, vjp(ct)

    y, g = run(jnp.asarray(c["ct"]), *(jnp.asarray(c[n]) for n in ("router_w", "w1", "w2", "x")))
    return {"y": y, "g_router": g[0], "g_w1": g[1], "g_w2": g[2], "g_x": g[3]}


MOE = ["moe_e2", "moe_e4", "moe_e8", "moe_drops_e4", "moe_top2_e4", "moe_top2_drops_e4",
       "moe_dp2_e4", "moe_dp2_top2_e2"]


@pytest.mark.parametrize("name", MOE)
def test_moe_ffn_matches_jax(name, cases, ranks):
    """Top-1 and top-2, with drops past the capacity, and dp x ep: output
    and the gradients of router, experts and tokens."""
    _close(ranks[name], _j_moe(cases[name]))


@pytest.mark.parametrize("name", ["moe_e4", "moe_top2_e4"])
def test_moe_ffn_matches_the_dense_oracle(name, cases, ranks):
    c = cases[name]

    def expert(p, h):
        return torch.relu(h @ p["w1"]) @ p["w2"]

    ref = moe_ffn_reference(torch.tensor(c["router_w"]),
                            {"w1": torch.tensor(c["w1"]), "w2": torch.tensor(c["w2"])},
                            expert, torch.tensor(c["x"]), c["w1"].shape[0],
                            capacity_factor=c["cf"], router_top_k=c["k"])
    np.testing.assert_allclose(ranks[name][0]["y"], ref.numpy(), atol=ATOL)


def test_moe_all_to_all_bytes(cases, ranks):
    """Two hops of the (E, C, D) send buffer a rank in the forward."""
    c = cases["moe_e4"]
    e, b, d = 4, c["x"].shape[0], 16
    cap = int(np.ceil(b / e / e * c["cf"]))
    for got in ranks["moe_e4"]:
        assert int(got["a2a_fwd"]) == 2 * e * cap * d * 4


def test_moe_ffn_checks_as_jax_does():
    from bigdl_tpu_torch.parallel import moe_ffn

    mesh = _FakeMesh(4, "expert")
    rw = torch.zeros(16, 4)
    params = {"w1": torch.zeros(4, 16, 32), "w2": torch.zeros(4, 32, 16)}
    x = torch.zeros(32, 16)
    with pytest.raises(ValueError, match="leading dim"):
        moe_ffn(rw, {"w1": params["w1"][:3], "w2": params["w2"]}, None, x, mesh)
    with pytest.raises(ValueError, match="routes over"):
        moe_ffn(torch.zeros(16, 8), params, None, x, mesh)
    with pytest.raises(ValueError, match="router_top_k"):
        moe_ffn(rw, params, None, x, mesh, router_top_k=5)
    with pytest.raises(ValueError, match="not divisible"):
        moe_ffn(rw, params, None, x[:30], mesh)
    with pytest.raises(ValueError, match="must differ"):
        moe_ffn(rw, params, None, x, mesh, batch_axis="expert")
    with pytest.raises(ValueError, match="not in mesh axes"):
        moe_ffn(rw, params, None, x, mesh, batch_axis="data")


# --------------------------------------------------------------- pipeline
def _j_pipe(c):
    mesh = _jmesh(c["jmesh"])

    def stage(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def f(w, b, x):
        return j_pipeline(stage, {"w": w, "b": b}, x, mesh, n_micro=c["n_micro"],
                          batch_axis=c.get("batch_axis"), remat_stages=c["remat"])

    @jax.jit
    def run(ct, *args):
        y, vjp = jax.vjp(f, *args)
        return y, vjp(ct)

    y, g = run(jnp.asarray(c["ct"]), *(jnp.asarray(c[n]) for n in ("w", "b", "x")))
    return {"y": y, "g_w": g[0], "g_b": g[1], "g_x": g[2]}


PIPE = ["pipe_s4_m4", "pipe_s4_m8", "pipe_s2_m2", "pipe_s8_m8", "pipe_remat_s4_m4",
        "pipe_dp2_s4_m2"]


@pytest.mark.parametrize("name", PIPE)
def test_pipeline_apply_matches_jax(name, cases, ranks):
    """Output and the gradients of the stacked stages and of the input
    (a P() input: stage 0's, given to every stage) against ``jax.vjp`` of
    the JAX schedule; remat and dp x pp too."""
    _close(ranks[name], _j_pipe(cases[name]))


def test_pipeline_remat_keeps_the_bits(ranks):
    """remat_stages changes only when the stage runs: the same inputs give
    the same bits, output and gradients."""
    plain, remat = ranks["pipe_s4_m4"][0], ranks["pipe_remat_s4_m4"][0]
    for key in plain:
        np.testing.assert_array_equal(remat[key], plain[key], err_msg=key)


def test_pipeline_trains(ranks):
    """25 SGD steps through the schedule (the JAX test's jitted loop):
    steady descent, the same losses on every rank."""
    got = ranks["pipe_train"]
    _same_on_every_rank(got)
    losses = got[0]["losses"]
    assert losses[-1] < losses[0] * 0.8, losses[::6]


def test_pipeline_checks_as_jax_does():
    from bigdl_tpu_torch.parallel import pipeline_apply

    mesh = _FakeMesh(4, "pipe")
    w = {"w": torch.zeros(4, 8, 8)}
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_apply(None, w, torch.zeros(6, 8), mesh, n_micro=4)
    with pytest.raises(ValueError, match="leading dim"):
        pipeline_apply(None, {"w": torch.zeros(3, 8, 8)}, torch.zeros(8, 8), mesh)
    with pytest.raises(ValueError, match="must differ"):
        pipeline_apply(None, w, torch.zeros(8, 8), mesh, batch_axis="pipe")
    with pytest.raises(ValueError, match="not in mesh axes"):
        pipeline_apply(None, w, torch.zeros(8, 8), mesh, batch_axis="data")


def _j_hetero(c):
    mesh = _jmesh(c["jmesh"])
    if c["fns"] == "cnn":
        def s0(p, h):
            y = jax.lax.conv_general_dilated(h, p["k"], window_strides=(2, 2), padding="SAME",
                                             dimension_numbers=("NCHW", "OIHW", "NCHW"))
            return jax.nn.relu(y + p["b"][None, :, None, None])

        def s1(p, h):
            return h.reshape(h.shape[0], -1) @ p["w"] + p["b"]

        fns = [s0, s1]
    else:
        fns = [lambda p, h: jnp.tanh(h @ p["w"])] * 4
    params = [{k: jnp.asarray(v) for k, v in p.items()} for p in c["params"]]
    x = jnp.asarray(c["x"])

    def loss(ps):
        y = j_hetero(fns, ps, x, mesh, n_micro=c["n_micro"],
                     skip_bubble_compute=c.get("skip", True))
        return jnp.sum(y ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    out = {"y": y}
    for i, gi in enumerate(g):
        out.update({f"g{i}_{k}": v for k, v in gi.items()})
    return out


HETERO = ["hetero_cnn_m2_True", "hetero_cnn_m2_False", "hetero_cnn_m4_True",
          "hetero_cnn_m4_False", "hetero_pyramid"]


@pytest.mark.parametrize("name", HETERO)
def test_pipeline_hetero_matches_jax(name, cases, ranks):
    """Per-stage trees and activation shapes, bubble compute skipped or
    not (the same in the port), forward and gradients of every stage's
    tree (gathered from their owners)."""
    _close(ranks[name], _j_hetero(cases[name]), atol=2e-4 if "cnn" in name else ATOL)


def test_pipeline_hetero_checks_as_jax_does():
    from bigdl_tpu_torch.parallel import pipeline_apply_hetero

    mesh = _FakeMesh(2, "pipe")
    params = [{k: torch.tensor(v) for k, v in p.items()} for p in _cnn_params()]
    fns = [lambda p, h: h, lambda p, h: h]
    x = torch.zeros(8, 3, 16, 16)
    with pytest.raises(ValueError, match="stage_fns"):
        pipeline_apply_hetero(fns[:1], params[:1], x, mesh)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_apply_hetero(fns, params, x[:6], mesh, n_micro=4)


# ------------------------------------------------------------------ modules
def _pairs(got, a, b, atol):
    _same_on_every_rank(got)
    keys = [k[len(a) + 1:] for k in got[0] if k.startswith(a + ".")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[0][f"{a}.{k}"], got[0][f"{b}.{k}"], atol=atol, err_msg=k)


@pytest.mark.parametrize("name", ["mod_moe", "mod_moe_top2"])
def test_moe_module_sharded_matches_dense(name, ranks):
    """``MoE.set_mesh`` runs the expert-parallel path; output within 1e-5
    and gradients within 2e-4 of the dense path (the JAX test's limits)."""
    got = ranks[name]
    np.testing.assert_allclose(got[0]["par.y"], got[0]["dense.y"], atol=ATOL)
    _pairs(got, "par", "dense", 2e-4)


@pytest.mark.parametrize("name", ["mod_pipe", "mod_pipe_dp", "mod_pipe_remat",
                                  "mod_pipe_ragged"])
def test_pipelined_module_matches_sequential(name, ranks):
    """``PipelinedBlocks.set_mesh`` runs the GPipe route (dp x pp, remat);
    a batch that cannot fill the microbatch grid takes the sequential
    path; output within 1e-5, gradients within 2e-4."""
    got = ranks[name]
    np.testing.assert_allclose(got[0]["pp.y"], got[0]["seq.y"], atol=ATOL)
    _pairs(got, "pp", "seq", 2e-4)


@pytest.mark.parametrize("name", ["sdpa_ring", "sdpa_ring_2d"])
def test_auto_attention_rides_the_ring_and_matches_dense(name, ranks):
    """With ``Engine.set_sequence_parallel`` registered, ``impl='auto'``
    rides the ring (it moved K/V blocks), on a 1-D mesh and on a
    ('data', 'sp') one, and equals the dense route."""
    got = ranks[name]
    _same_on_every_rank(got)
    assert int(got[0]["ppermute"]) > 0
    np.testing.assert_allclose(got[0]["ring"], got[0]["dense"], atol=ATOL)


def test_transformer_module_forward_under_sp(ranks):
    got = ranks["transformer_sp"]
    _same_on_every_rank(got)
    assert int(got[0]["ring.ppermute"]) > 0 and int(got[0]["dense.ppermute"]) == 0
    np.testing.assert_allclose(got[0]["ring"], got[0]["dense"], atol=1e-4)


@pytest.fixture
def _clear_sp():
    yield
    Engine.set_sequence_parallel(None)
    JEngine.set_sequence_parallel(None)


def test_explicit_ring_without_registration_raises(_clear_sp):
    q = torch.zeros(1, 2, 16, 8)
    with pytest.raises(ValueError, match="set_sequence_parallel") as pe:
        p_sdpa(q, q, q, impl="ring")
    with pytest.raises(ValueError, match="set_sequence_parallel") as je:
        z = jnp.zeros((1, 2, 16, 8))
        j_sdpa(z, z, z, impl="ring")
    assert str(pe.value) == str(je.value)


def test_indivisible_sequence_falls_back_under_auto(_clear_sp):
    """An ineligible call under 'auto' takes the dense route (no collective
    runs); 'ring' raises the JAX package's message."""
    mk = _rng(9)
    q, k, v = (torch.from_numpy(mk(1, 2, 10, 8)) for _ in range(3))
    ref = p_sdpa(q, k, v)
    Engine.set_sequence_parallel(_FakeMesh(4), "sp")
    np.testing.assert_allclose(p_sdpa(q, k, v).numpy(), ref.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        p_sdpa(q, k, v, impl="ring")
    with pytest.raises(ValueError, match="divisible"):
        p_sdpa(q, k, v, bias=torch.zeros(1, 1, 10, 10), impl="ring")


def test_set_sequence_parallel_checks_the_axis(_clear_sp):
    with pytest.raises(ValueError, match="no axis 'sp'"):
        Engine.set_sequence_parallel(_FakeMesh(2, "data"), "sp")
    Engine.set_sequence_parallel(_FakeMesh(2), "sp")
    assert Engine.sequence_parallel()[1] == "sp"
    Engine.set_sequence_parallel(None)
    assert Engine.sequence_parallel() is None


# ------------------------------------------------------------------ plans
def test_sharding_plan_rules_and_default():
    from bigdl_tpu.parallel.sharding import megatron_transformer_plan as j_plan

    plan, jp = megatron_transformer_plan(), j_plan()
    for path in ("block0/self_q_w", "block3/self_out_w", "block0/filter_w", "block0/out_w",
                 "block0/filter_b", "block0/ln1_g", "embedding", "block1/cross_v_w"):
        assert tuple(plan.spec_for(path)) == tuple(jp.spec_for(path)), path
    assert plan.spec_for("block0/self_q_w") == P("model", None)
    assert plan.spec_for("embedding") == P()


def test_validate_rejects_indivisible():
    from bigdl_tpu.parallel.hybrid import make_mesh as j_make_mesh
    from bigdl_tpu.parallel.sharding import ShardingPlan as JPlan
    from jax.sharding import PartitionSpec as JP

    mesh = _FakeMesh(4, "model")
    plan = ShardingPlan([(r"w$", P("model", None))])
    with pytest.raises(ValueError, match="not divisible") as pe:
        plan.validate({"w": torch.zeros(6, 3)}, mesh)
    with pytest.raises(ValueError, match="not divisible") as je:
        JPlan([(r"w$", JP("model", None))]).validate(
            {"w": jnp.zeros((6, 3))}, j_make_mesh({"data": 2, "model": 4}))
    assert str(pe.value).replace("'", "") == str(je.value).replace("'", "")
    with pytest.raises(ValueError, match="more dims"):
        ShardingPlan([(r"w$", P(None, None, "model"))]).validate({"w": torch.zeros(4, 4)}, mesh)


def test_make_mesh_shape():
    mesh = make_mesh({"data": 1})
    assert mesh.shape == {"data": 1} and mesh.coords == {"data": 0}
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_mesh({"data": 4, "model": 4})
    assert Engine.mesh().shape == {"data": 1}


def test_mesh_coordinates_are_row_major():
    """Rank r's coordinates are ``np.unravel_index(r, shape)``, the JAX
    package's ``np.array(devices).reshape(shape)`` (checked on the spawned
    meshes through the data rows of the hybrid and dp x pp cases)."""
    devices = np.arange(8).reshape(2, 4)
    for r in range(8):
        assert tuple(int(c) for c in np.unravel_index(r, (2, 4))) == tuple(
            int(c) for c in np.argwhere(devices == r)[0])


# ------------------------------------------------------------------- walk
_FILES = ("hybrid", "sharding", "sequence", "moe", "pipeline", "pipeline_optimizer")


@pytest.mark.parametrize("mod", _FILES)
def test_every_jax_parallel_symbol_has_a_port(mod):
    """Every public class and function of ``bigdl_tpu/parallel/<mod>.py``
    exists at the port's path, and ``parallel.__all__`` holds the JAX
    package's."""
    import importlib

    import bigdl_tpu.parallel as jpar
    import bigdl_tpu_torch.parallel as ppar

    jm = importlib.import_module(f"bigdl_tpu.parallel.{mod}")
    pm = importlib.import_module(f"bigdl_tpu_torch.parallel.{mod}")
    names = [n for n, v in vars(jm).items()
             if not n.startswith("_") and (inspect.isclass(v) or inspect.isfunction(v))
             and getattr(v, "__module__", "") == jm.__name__]
    assert names
    missing = [n for n in names if not hasattr(pm, n)]
    assert not missing, f"{mod}: {missing}"
    assert set(jpar.__all__) <= set(ppar.__all__)
    for n in jpar.__all__:
        assert getattr(ppar, n) is not None
