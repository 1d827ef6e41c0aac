"""The port's model health, perf accounting and profiler against the JAX
package's, on the CPU (the scenarios of ``tests/test_health.py`` and
``tests/test_perf.py`` that this slice covers).

Health: the same toy fit (``test_torch_resilience_training``'s model, the
JAX weights carried over) through both packages with ``set_health``; the
records' norms and ratios are held within ``HEALTH_RTOL`` (f32 sums in
another order over weights that drift ~1e-6 a step apart), the counters and
the layer names exactly. Perf: the monitor's decisions and the accountant's
fields from the same records, equal. The step's FLOP count: the LM step
counted on the meta device against its analytic count, within 1%.
"""

import math

import numpy as np
import pytest
import torch

import bigdl_tpu.obs.health as jhealth
import bigdl_tpu.obs.perf as jperf
import bigdl_tpu.obs.profiler as jprof
import bigdl_tpu_torch.obs.health as phealth
import bigdl_tpu_torch.obs.perf as pperf
import bigdl_tpu_torch.obs.profiler as pprof
import test_torch_resilience_training as T
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch.utils.serialization import tree_items

HEALTH_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


@pytest.fixture(autouse=True, scope="module")
def _engine_isolation():
    from bigdl_tpu.utils.engine import Engine as JEngine

    JEngine.reset()
    yield
    JEngine.reset()


# ------------------------------------------------------------------ health
def _health_fit(pkg, cfg_kw, iters=4, lr=0.2):
    x, y = T._problem(n=32)
    tel = pkg.obs.Telemetry(exporters=[])
    opt = T._opt(pkg, pkg.DataSet.array(x, y, batch_size=8), iters, lr=lr)
    opt.set_health(pkg.obs.HealthConfig(**cfg_kw))
    opt.set_telemetry(tel)
    opt.optimize()
    return [r for r in tel.ring.records if r["type"] == "health"], tel


def _held(p, j):
    """Health fields: counters and names exactly, floats within HEALTH_RTOL."""
    if isinstance(j, dict):
        assert p.keys() == j.keys()
        for k in j:
            _held(p[k], j[k])
    elif isinstance(j, float) and not isinstance(j, bool):
        assert math.isclose(p, j, rel_tol=HEALTH_RTOL, abs_tol=1e-7), (p, j)
    else:
        assert p == j


@pytest.mark.parametrize("cfg", [{}, {"per_layer": False}, {"every_n_steps": 2},
                                 {"activations": True}])
def test_health_records_equal_the_jax_package(cfg):
    recs = {pkg.name: _health_fit(pkg, cfg)[0] for pkg in T.PKGS}
    j, p = recs["jax"], recs["port"]
    assert len(p) == len(j) == (2 if cfg.get("every_n_steps") == 2 else 4)
    for pr, jr in zip(p, j):
        _held({k: v for k, v in pr.items() if k not in T._TIMES},
              {k: v for k, v in jr.items() if k not in T._TIMES})
    if cfg.get("activations"):
        assert sorted(p[0]["acts"]) == ["Linear_0", "Linear_2", "LogSoftMax_3", "Tanh_1"]
    if not cfg.get("per_layer", True):
        assert "layers" not in p[0]


def test_health_on_and_off_train_the_same_bits():
    x, y = T._problem(n=32)

    def fit(health):
        opt = T._opt(T.PORT, T.PDataSet.array(x, y, batch_size=8), 4)
        if health:
            opt.set_health(phealth.HealthConfig(activations=True))
        return T._pflat(opt.optimize()), opt

    a, _ = fit(False)
    b, opt = fit(True)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    opt.set_health(False)  # detach: the hooks and their state entries go
    assert not any("_health_act" in k for k in tree_items(opt.model.get_state()))


def test_stats_math_and_attribution_match():
    mat = np.array([[4.0, 9.0, 0.09, 0, 0], [1.0, 16.0, 0.16, 2, 0], [0.0, 1.0, 0.0, 0, 3]],
                   np.float32)

    def fields(mod, per_layer, m):
        hm = mod.HealthMonitor(mod.HealthConfig(per_layer=per_layer))
        hm._paths = ["a/w", "b/w", "c/w"]
        snap = {"layers": m}
        return hm.record_fields(snap), hm.attribute_nonfinite(snap)

    for per_layer in (True, False):
        m = mat if per_layer else mat.sum(0, keepdims=True)
        assert fields(phealth, per_layer, m) == fields(jhealth, per_layer, m)
    nan = mat.copy()
    nan[0, 0] = np.nan
    jf, pf = fields(jhealth, True, nan), fields(phealth, True, nan)
    assert math.isnan(pf[0]["global"]["grad_norm"]) and pf[1] == jf[1] == ("b/w", "grads")


def test_lr_guard_patience_once_per_streak():
    def events(mod):
        hm = mod.HealthMonitor(mod.HealthConfig(update_ratio_warn=0.1, update_ratio_patience=2))
        out = []
        for r in (0.2, 0.3, 0.4, 0.05, 0.2, 0.3, float("nan")):
            out.append(hm.lr_guard_event({"global": {"update_ratio": r},
                                          "layers": {"x": {"update_ratio": r}}}))
        return out

    assert events(phealth) == events(jhealth)
    assert [e is not None for e in events(phealth)] == [False, True, False, False, False, True,
                                                         False]


def test_set_health_spellings_and_bad_config():
    opt = T._opt(T.PORT, T.PDataSet.array(*T._problem(n=16), batch_size=8), 1)
    for cfg in (True, phealth.HealthConfig(), phealth.HealthMonitor()):
        assert isinstance(opt.set_health(cfg).health, phealth.HealthMonitor)
    assert opt.set_health(None).health is None
    with pytest.raises(TypeError, match="set_health expects"):
        opt.set_health(3)
    for mod in (phealth, jhealth):
        with pytest.raises(ValueError, match="every_n_steps"):
            mod.HealthConfig(every_n_steps=0)


# ---------------------------------------------------------------- profiler
def test_memory_breakdown_equals_the_jax_package():
    jm = T._jax_model()
    pm = T._port_model()
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu_torch.optim import SGD as PSGD

    j = jprof.memory_breakdown(jm.get_parameters(),
                               JSGD(momentum=0.9).init_slots(jm.get_parameters()))
    p = pprof.memory_breakdown(pm.get_parameters(),
                               PSGD(momentum=0.9).init_slots(pm.get_parameters()))
    assert p == j and p["totals"]["slot_bytes"] == p["totals"]["param_bytes"]


def test_flat_memory_breakdown_equals_the_jax_package():
    from bigdl_tpu.optim import Adam as JAdam
    from bigdl_tpu.parallel.parameter import FlatParameter as JFlat
    from bigdl_tpu_torch.optim import Adam as PAdam
    from bigdl_tpu_torch.parallel.parameter import FlatParameter as PFlat

    j = jprof.flat_memory_breakdown(JFlat(T._jax_model().get_parameters(), 4), JAdam())
    p = pprof.flat_memory_breakdown(PFlat(T._port_model().get_parameters(), 4), PAdam())
    assert p == j
    assert "flat ZeRO-1" in pprof.render_memory(p)


def test_profile_optimizer_and_collective_bytes():
    opt = T._opt(T.PORT, T.PDataSet.array(*T._problem(n=16), batch_size=8), 1)
    prof = pprof.profile_optimizer(opt)
    # 2 * rows * in * out a product; the first Linear has no input gradient
    assert prof["cost"]["flops"] == 2 * 2 * 8 * 5 * 16 + 3 * 2 * 8 * 16 * 3
    assert prof["n_params"] == 5 * 16 + 16 + 16 * 3 + 3
    cb = pprof.collective_bytes({"psum_scatter": {"calls": 2, "bytes": 64},
                                 "all_gather": {"calls": 2, "bytes": 16},
                                 "pmean": {"calls": 0, "bytes": 0}})
    assert cb["grad_exchange_bytes"] == 64 and cb["total_bytes"] == 80


# -------------------------------------------------------------------- perf
def test_cost_math_and_the_peak_table():
    for mod in (pperf, jperf):
        assert mod.mfu(1e12, 0.5, 1e13) == 0.2 and mod.mfu(None, 1.0, 1e12) is None
        assert mod.classify_roofline(10.0, 1e12, 1e9) == "bandwidth"
        assert mod.classify_roofline(2000.0, 1e12, 1e9) == "compute"
        assert mod.pipeline_bubble_fraction(4, 8) == 3 / 11
    peaks = pperf.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks.flops == 989e12 and peaks.hbm_bytes_s == 3.35e12
    assert list(pperf.DEVICE_PEAKS) == ["NVIDIA H100 80GB HBM3"]  # no TPU row
    assert pperf.device_peaks("TPU v5 lite") is None and pperf.device_peaks() is None


def _monitor_events(mod, walls, mfus=None, breakdowns=None, **cfg):
    m = mod.PerfMonitor(mod.PerfConfig(**cfg))
    out = []
    for i, w in enumerate(walls):
        out.append(m.note_step(iteration=i + 1, wall_s=w,
                               mfu_value=None if mfus is None else mfus[i],
                               breakdown=None if breakdowns is None else breakdowns[i]))
    return out, m.check(), m.baseline_wall_s()


def test_perf_monitor_decisions_equal_the_jax_package():
    walls = [5.0] + [1.0] * 4 + [2.5] * 4 + [1.0] * 4 + [3.0] * 4
    kw = dict(baseline_steps=4, window=4, skip_steps=1)
    assert _monitor_events(pperf, walls, **kw) == _monitor_events(jperf, walls, **kw)
    mfus = [0.4] * 9 + [0.1] * 8
    bd = [{"compute_s": 0.5, "comms_s": None, "input_s": 0.1 if i < 9 else 0.9, "host_s": 0.0}
          for i in range(17)]
    flat = [1.0] * 17
    assert (_monitor_events(pperf, flat, mfus, bd, **kw)
            == _monitor_events(jperf, flat, mfus, bd, **kw))
    events = _monitor_events(pperf, flat, mfus, bd, **kw)[0]
    hit = [e for ev in events for e in ev]
    assert hit[0]["trigger"] == "mfu_collapse" and hit[0]["component"] == "input"


def test_accountant_fields_equal_the_jax_package():
    recs = [{"iteration": i + 1, "wall_s": 0.5 + 0.01 * i, "input_wait_s": 0.01,
             "spans": {"dispatch": {"n": 1, "s": 0.002}}, "mfu": None} for i in range(8)]

    def drive(mod):
        pa = mod.PerfAccountant(mod.PerfConfig(every_n_steps=4, capture=False))
        pa.begin_run()
        pa.cost = mod.StepCost(flops=2e9)
        out = []
        for r in recs:
            rec = dict(r, **pa.step_fields(r["wall_s"]))
            out.append((pa.note_step(rec), rec.get("model_flops"), rec.get("achieved_flops_s")))
            if pa.should_emit():
                out.append(pa.perf_fields())
        pa.end_run()
        return out

    assert drive(pperf) == drive(jperf)


@pytest.mark.parametrize("routes,impl", [("cuda", "auto"), ("cpu", "auto"), ("cpu", "flash")])
def test_lm_step_flops_are_the_analytic_count(routes, impl, monkeypatch):
    """The LM's training step counted on the meta device: with the card's
    routes (T >= 1024 takes the flash kernels, which report their own
    FLOPs: 4 d a visible causal pair forward, 8 d backward) or the CPU's
    dense route (the full T^2 products), within 1% of the analytic count
    (3x the forward's products of every 2-D weight, plus attention). No
    parameter is allocated and nothing runs."""
    from bigdl_tpu_torch.nn import CrossEntropyCriterion, Transformer
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.ops.flash_attention import visible_pairs
    from bigdl_tpu_torch.optim import LocalOptimizer

    if impl != "auto":
        monkeypatch.setenv("BIGDL_ATTN_IMPL", impl)
    b, t, v, h, heads, f, layers = 2, 1024, 96, 32, 2, 64, 2
    m = Transformer(vocab_size=v, hidden_size=h, num_heads=heads, filter_size=f,
                    num_hidden_layers=layers, postprocess_dropout=0.0, attention_dropout=0.0,
                    relu_dropout=0.0, mode="lm", device="cpu")
    ids = np.ones((b, t), np.int32)
    m.init(sample_input=ids)
    opt = LocalOptimizer(m, DataSet.array(ids, ids, batch_size=b), CrossEntropyCriterion())
    cost = pperf.program_cost(opt, torch.from_numpy(ids), torch.from_numpy(ids), routes=routes)
    weights = sum(p.numel() for p in tree_items(m.get_parameters()).values() if p.dim() == 2)
    dh = h // heads
    flash = routes == "cuda" or impl == "flash"
    pairs = visible_pairs(t, t, True) if flash else t * t
    analytic = 3 * 2 * b * t * weights + 12 * dh * pairs * b * heads * layers
    assert abs(cost.flops - analytic) <= 0.01 * analytic, (cost.flops, analytic)
    # the kernels' share is counted: without it the count would fall short
    assert cost.flops > 3 * 2 * b * t * weights


def test_predictor_bucket_costs_counts_the_forward():
    from bigdl_tpu_torch.optim import Predictor

    pm = T._port_model()
    costs = pperf.predictor_bucket_costs(Predictor(pm, batch_size=4), np.zeros(5, np.float32))
    assert costs[None]["flops"] == 2 * 4 * (5 * 16 + 16 * 3)
    assert costs[None]["peak_flops_total"] is None  # the CPU has no peak row


def test_fit_stamps_model_flops_and_set_perf_off():
    x, y = T._problem(n=32)

    def fit(perf):
        tel = T.pobs.Telemetry(exporters=[])
        opt = T._opt(T.PORT, T.PDataSet.array(x, y, batch_size=8), 8)
        opt.set_telemetry(tel).set_perf(perf)
        opt.optimize()
        return tel.ring.records

    recs = fit(pperf.PerfConfig(every_n_steps=4))
    steps = [r for r in recs if r["type"] == "step"]
    assert steps[-1]["model_flops"] == 2 * 2 * 8 * 5 * 16 + 3 * 2 * 8 * 16 * 3
    assert steps[-1]["mfu"] is None  # the CPU has no peak
    perf = [r for r in recs if r["type"] == "perf"]
    assert len(perf) == 2 and set(perf[0]["breakdown"]) == set(pperf.COMPONENTS)
    off = fit(False)
    assert not any(r["type"] == "perf" for r in off)
    assert "model_flops" not in [r for r in off if r["type"] == "step"][-1]


def test_set_profile_window_captures_the_seams(tmp_path):
    """A ``set_profile`` window on the CPU: ``trace.json`` holds the step
    ranges and the seams, the prefetch thread's included."""
    import json

    x, y = T._problem(n=68)
    from bigdl_tpu_torch.dataset.dataset import SampleToMiniBatch

    opt = T._opt(T.PORT, T.PDataSet.array(x, y, transformer=SampleToMiniBatch(8)), 12)
    opt.set_checkpoint(str(tmp_path / "ck"), T.poptim.Trigger.several_iteration(2))
    # steps 3-7: the prefetch thread pads epoch 1's tail (the 9th batch)
    # while the driver runs them
    opt.set_profile(str(tmp_path / "prof"), start_iteration=3, num_iterations=5)
    opt.set_telemetry(T.pobs.Telemetry(exporters=[]))
    opt.optimize()
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"dispatch", "prefetch", "pad_mask", "checkpoint", "train#4"} <= names
    assert not pperf.capture_active()
