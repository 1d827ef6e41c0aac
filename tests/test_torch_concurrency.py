"""The port's concurrency auditor and lock tracer
(``bigdl_tpu_torch/analysis/concurrency.py``, ``analysis/lock_tracer.py``)
held against the JAX package's.

Every fixture that ``tests/test_concurrency_audit.py`` feeds the JAX
auditor (found by walking that file's syntax tree, so a fixture added there
is covered here) goes through both auditors, which must report the same
findings. The port's auditor also bans the torch forms of device
materialisation under a hot lock, audits ``bigdl_tpu_torch`` clean, maps
the port's threads and holds the port's lock-order graph; the tracer's
cases run on the port's ``Telemetry``, chaos seams and ``ContinuousBatcher``.
"""

import ast
import importlib.util
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
JAX_TESTS = REPO / "tests" / "test_concurrency_audit.py"
PORT_AUDITOR = REPO / "bigdl_tpu_torch" / "analysis" / "concurrency.py"
JAX_AUDITOR = REPO / "bigdl_tpu" / "analysis" / "concurrency.py"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses resolve via sys.modules
    spec.loader.exec_module(mod)
    return mod


pconc = _load("torch_conc_audit_under_test", PORT_AUDITOR)
jconc = _load("jax_conc_audit_for_torch_tests", JAX_AUDITOR)
obs_report = _load("obs_report_for_torch_conc", REPO / "tools" / "obs_report.py")

from bigdl_tpu_torch.analysis import lock_tracer  # noqa: E402


# ---------------------------------------------------------------------------
# the JAX test file's fixtures
# ---------------------------------------------------------------------------
def _jax_fixtures():
    """(test name, file name, source) of every ``run_audit(tmp_path, name,
    source)`` call and every ``build_program`` fixture in the JAX tests."""
    tree = ast.parse(JAX_TESTS.read_text())
    env = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_SPAWN_HELPER" for t in node.targets):
            env["_SPAWN_HELPER"] = ast.literal_eval(node.value)
    out = []
    for cls in tree.body:
        if not isinstance(cls, ast.ClassDef):
            continue
        for fn in cls.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            local = dict(env)
            for node in ast.walk(fn):
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)
                        and node.targets[0].id == "src"):
                    local["src"] = eval(compile(ast.Expression(node.value), "<fixture>", "eval"),
                                        {}, dict(local))
                    out.append((f"{cls.name}.{fn.name}", "serving/server.py", local["src"]))
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                        and node.func.id == "run_audit"):
                    name, src = (eval(compile(ast.Expression(a), "<fixture>", "eval"), {},
                                      dict(local)) for a in node.args[1:3])
                    out.append((f"{cls.name}.{fn.name}", name, src))
    return out


FIXTURES = _jax_fixtures()


def test_fixture_walk_finds_every_rule():
    """The walk sees the JAX file's BDL017, BDL018 and BDL019 fixtures (22
    ``run_audit`` cases and the typed-attribute ``build_program`` one)."""
    assert len(FIXTURES) >= 23
    assert {n.split(".")[0] for n, _, _ in FIXTURES} == {"TestBDL017", "TestBDL018",
                                                         "TestBDL019"}


def _audit(mod, tmp_path, name, src, tag):
    f = tmp_path / tag / name
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(src)
    return [(x.line, x.code, x.message) for x in mod.audit_paths([str(f)])]


@pytest.mark.parametrize("case,name,src", FIXTURES, ids=[c for c, _, _ in FIXTURES])
def test_jax_fixture_same_findings(tmp_path, case, name, src):
    port = _audit(pconc, tmp_path, name, src, "port")
    ref = _audit(jconc, tmp_path, name, src, "jax")
    assert port == ref
    # the typed-attribute fixture is a graph case: its edges agree too
    f = tmp_path / "graph" / name
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(src)
    pe = {(a, b) for a, b in pconc.lock_order_graph(pconc.build_program([str(f)])[0])}
    je = {(a, b) for a, b in jconc.lock_order_graph(jconc.build_program([str(f)])[0])}
    assert pe == je


# ---------------------------------------------------------------------------
# the torch forms of device materialisation
# ---------------------------------------------------------------------------
_MATERIALISE = {
    "item": "x.item()",
    "tolist": "x.tolist()",
    "cpu": "x.cpu()",
    "numpy": "x.numpy()",
    "cuda_synchronize": "torch.cuda.synchronize()",
    "stream_synchronize": "self._stream.synchronize()",
    "np_asarray": "np.asarray(x)",
    "indexed_item": "x[0].item()",
}


def _hot_src(stmt, hot=True):
    note = "  # hot-lock: dispatch" if hot else ""
    return ("import threading\n"
            "import numpy as np\n"
            "import torch\n"
            "class Batcher:\n"
            "    def __init__(self):\n"
            f"        self._swap_lock = threading.Lock(){note}\n"
            "        self._stream = None\n"
            "    def flush(self, x):\n"
            "        with self._swap_lock:\n"
            f"            return {stmt}\n")


@pytest.mark.parametrize("form", sorted(_MATERIALISE))
def test_torch_materialisation_under_hot_lock(tmp_path, form):
    stmt = _MATERIALISE[form]
    found = _audit(pconc, tmp_path, "serving/batcher.py", _hot_src(stmt), "hot")
    assert [c for _, c, _ in found] == ["BDL018"], found
    assert "_swap_lock" in found[0][2]
    assert _audit(pconc, tmp_path, "serving/batcher.py", _hot_src(stmt, hot=False),
                  "plain") == []


def test_materialisation_with_arguments_is_not_a_copy(tmp_path):
    # x.cpu(non_blocking=True) / x.numpy(force=...) / x.item(k) take arguments:
    # only the argument-free forms are the host copies the rule names, as in
    # the JAX auditor's .item() rule; dict.get and str.join stay free too
    src = _hot_src("(x.to('cpu', non_blocking=True), {}.get('k'), ','.join([]))")
    assert _audit(pconc, tmp_path, "serving/batcher.py", src, "args") == []


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------
def _port_program():
    files = pconc.scope_filter(pconc.iter_py_files([str(REPO / "bigdl_tpu_torch")]))
    prog, errs = pconc.build_program(files)
    assert not errs
    return prog, files


def test_scope_files_all_exist_in_the_port():
    _, files = _port_program()
    norm = {f.replace("\\", "/") for f in files}
    for suffix in pconc.CONCURRENCY_SCOPE_FILES:
        assert any(f.endswith("bigdl_tpu_torch/" + suffix) for f in norm), suffix
    assert pconc.CONCURRENCY_SCOPE_FILES == jconc.CONCURRENCY_SCOPE_FILES


def test_annotated_assignment_guard(tmp_path):
    """The port reads ``# guarded-by`` on an annotated assignment (the
    watchdog's ``self._callbacks: List[...] = []``); the JAX auditor only
    infers that guard from the writes."""
    src = (
        "import threading\n"
        "from typing import List\n"
        "def spawn_worker(target, name=None):\n"
        "    t = threading.Thread(target=target, daemon=True)\n"
        "    t.start()\n"
        "    return t\n"
        "class Box:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._cbs: List[int] = []  # guarded-by: _lock\n"
        "        spawn_worker(self._loop)\n"
        "    def _loop(self):\n"
        "        with self._lock:\n"
        "            self._cbs = [1]\n"
        "    def read(self):\n"
        "        return self._cbs\n")
    port = _audit(pconc, tmp_path, "obs/watchdog.py", src, "port")
    ref = _audit(jconc, tmp_path, "obs/watchdog.py", src, "jax")
    assert [c for _, c, _ in port] == [c for _, c, _ in ref] == ["BDL017"]
    assert "annotated guarded-by _lock" in port[0][2]
    assert "inferred guarded-by _lock" in ref[0][2]


def test_port_audit_clean():
    assert pconc.audit_paths([str(REPO / "bigdl_tpu_torch")]) == []


def test_port_cli_and_selftest():
    for args in ([str(REPO / "bigdl_tpu_torch")], ["--selftest"]):
        r = subprocess.run([sys.executable, str(PORT_AUDITOR), *args],
                           capture_output=True, text=True, cwd=str(REPO))
        assert r.returncode == 0, r.stdout + r.stderr
    r = subprocess.run([sys.executable, str(PORT_AUDITOR), "--entry-map", "--graph",
                        "bigdl_tpu_torch"], capture_output=True, text=True, cwd=str(REPO))
    assert r.returncode == 0, r.stderr
    assert "ContinuousBatcher._swap_lock -> ContinuousBatcher._acct_lock" in r.stdout
    assert "CYCLE" not in r.stdout


def test_hot_locks_annotated():
    prog, _ = _port_program()
    hot = {f"{c}.{a}" for c, a in pconc._hot_locks(prog)}
    assert hot == {"RequestQueue._lock", "ContinuousBatcher._swap_lock",
                   "ModelServer._lock", "ModelServer._mgmt_lock"}
    assert prog.classes["StallWatchdog"].guarded_by == {"_callbacks": "_lock"}


def test_entry_map_resolves_port_threads():
    em = pconc.entry_map(_port_program()[0])
    assert "worker:ContinuousBatcher._run" in em["ContinuousBatcher._run"]
    assert "worker:ContinuousBatcher._run" in em["ContinuousBatcher._flush"]
    assert "main" in em["ContinuousBatcher.submit"]
    assert any(t.startswith("monitor:") for t in em["StallWatchdog.check"])
    assert any(t.startswith("monitor:") for t in em["FleetMonitor.check"])
    nested = [q for q in em if ".<" in q and any(t.startswith("worker:") for t in em[q])]
    assert nested, "no nested worker closures resolved"


def test_port_lock_order_graph():
    edges = pconc.lock_order_graph(_port_program()[0])
    names = {(f"{a[0]}.{a[1]}", f"{b[0]}.{b[1]}") for a, b in edges}
    assert ("ContinuousBatcher._swap_lock", "ContinuousBatcher._acct_lock") in names
    assert ("ModelServer._mgmt_lock", "ModelServer._lock") in names
    assert pconc.find_cycles(edges) == []
    assert pconc.static_order_edges([str(REPO / "bigdl_tpu_torch")]) == names


def test_both_tracers_keep_their_own_auditor():
    """Both packages' tracers load their auditor by file path; in one
    process each keeps its own module and its own package's edges."""
    from bigdl_tpu.analysis import lock_tracer as jtracer

    pe = lock_tracer.load_static_edges([str(REPO / "bigdl_tpu_torch")])
    je = jtracer.load_static_edges([str(REPO / "bigdl_tpu")])
    pe2 = lock_tracer.load_static_edges([str(REPO / "bigdl_tpu_torch")])
    assert pe == pe2
    assert Path(sys.modules[lock_tracer._AUDIT_MODULE_KEY].__file__) == PORT_AUDITOR
    assert Path(sys.modules["_bigdl_conc_audit"].__file__) == JAX_AUDITOR
    assert lock_tracer._AUDIT_MODULE_KEY != "_bigdl_conc_audit"
    shared = ("ContinuousBatcher._swap_lock", "ContinuousBatcher._acct_lock")
    assert shared in pe and shared in je


# ---------------------------------------------------------------------------
# the runtime tracer
# ---------------------------------------------------------------------------
class _Pair:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()


def test_tracer_off_is_a_noop(monkeypatch):
    monkeypatch.delenv("BIGDL_LOCK_DEBUG", raising=False)
    o = _Pair()
    raw = o._a
    assert not lock_tracer.enabled()
    assert lock_tracer.instrument_locks(o) == []
    assert o._a is raw


def test_runtime_inversion_and_chaos_delay_hold_breach(monkeypatch):
    """Two threads take the pair in opposite orders, and the port's chaos
    ``delay`` fault inside the first critical section stretches the hold:
    both surface as ``warn`` records of the port's ``Telemetry`` that
    ``tools/obs_report.py`` validates."""
    from bigdl_tpu_torch.obs import Telemetry
    from bigdl_tpu_torch.obs.trace import fault_point
    from bigdl_tpu_torch.resilience import FaultPlan

    monkeypatch.setenv("BIGDL_LOCK_DEBUG", "1")
    tel = Telemetry(exporters=[])
    tr = lock_tracer.LockTracer(telemetry=tel, hold_warn_s=0.05)
    o = _Pair()
    assert lock_tracer.instrument_locks(o, tracer=tr) == ["_Pair._a", "_Pair._b"]

    def ab():
        with o._a:
            fault_point("lock_audit_hold")
            with o._b:
                pass

    def ba():
        with o._b:
            with o._a:
                pass

    with FaultPlan().arm("lock_audit_hold", kind="delay", delay_s=0.12):
        t = threading.Thread(target=ab)
        t.start()
        t.join()
    t = threading.Thread(target=ba)
    t.start()
    t.join()
    assert [i["kind"] for i in tr.inversions] == ["runtime"]
    assert tr.hold_breaches and tr.hold_breaches[0]["lock"] == "_Pair._a"
    assert tr.hold_breaches[0]["held_s"] >= 0.12
    warns = [r for r in tel.ring.records if r["type"] == "warn"]
    assert {"lock_order_inversion", "lock_hold_exceeded"} <= {w["reason"] for w in warns}
    for w in warns:
        obs_report.validate_record(w)


def test_static_contradiction_and_quiet_consistent_order(monkeypatch):
    monkeypatch.setenv("BIGDL_LOCK_DEBUG", "1")
    tr = lock_tracer.LockTracer(static_edges={("_Pair._a", "_Pair._b")})
    o = _Pair()
    lock_tracer.instrument_locks(o, tracer=tr)
    with o._b:
        with o._a:
            pass
    assert [i["kind"] for i in tr.inversions] == ["static"]
    tr2 = lock_tracer.LockTracer(static_edges={("_Pair._a", "_Pair._b")}, hold_warn_s=5.0)
    o2 = _Pair()
    lock_tracer.instrument_locks(o2, tracer=tr2)
    for _ in range(3):
        with o2._a:
            with o2._b:
                pass
    assert tr2.inversions == [] and tr2.hold_breaches == []
    assert tr2.edges == {("_Pair._a", "_Pair._b"): 3}


def test_rlock_reentry_records_once(monkeypatch):
    monkeypatch.setenv("BIGDL_LOCK_DEBUG", "1")

    class R:
        def __init__(self):
            self._r = threading.RLock()
            self._o = threading.Lock()

    tr = lock_tracer.LockTracer(hold_warn_s=5.0)
    o = R()
    lock_tracer.instrument_locks(o, tracer=tr)
    with o._r:
        with o._r:
            with o._o:
                pass
    assert tr.inversions == []
    assert tr.edges == {("R._r", "R._o"): 1}


def _port_predictor(seed=7):
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim.predictor import Predictor

    torch.manual_seed(seed)
    m = nn.Sequential(nn.Linear(6, 8, device="cpu"), nn.ReLU(device="cpu"),
                      nn.Linear(8, 3, device="cpu"), device="cpu")
    m.init(sample_input=np.zeros((1, 6), np.float32))
    return m, Predictor(m, batch_size=4)


def test_real_batcher_agrees_with_static_graph(monkeypatch):
    """A real port ``ContinuousBatcher`` instrumented against the port's
    static graph: no inversion, and the static nesting is observed."""
    from bigdl_tpu_torch.serving import ContinuousBatcher, ServeRequest

    monkeypatch.setenv("BIGDL_LOCK_DEBUG", "1")
    _, pred = _port_predictor()
    b = ContinuousBatcher(pred, name="m", max_delay_ms=5.0)
    static = lock_tracer.load_static_edges([str(REPO / "bigdl_tpu_torch")])
    tr = lock_tracer.LockTracer(static_edges=static, hold_warn_s=30.0)
    traced = lock_tracer.instrument_locks(b, tracer=tr)
    assert {"ContinuousBatcher._swap_lock", "ContinuousBatcher._acct_lock"} <= set(traced)
    b.start()
    try:
        futs = [b.submit(ServeRequest(np.zeros(6, np.float32))) for _ in range(6)]
        for f in futs:
            f.result(timeout=30)
    finally:
        b.stop()
    assert tr.inversions == []
    assert ("ContinuousBatcher._swap_lock", "ContinuousBatcher._acct_lock") in tr.edges


# ---------------------------------------------------------------------------
# the faults the port's audit found, each fixed
# ---------------------------------------------------------------------------
def test_register_copies_the_sample_outside_the_registry_lock():
    """``register`` brought a card sample to the host (``.cpu()``,
    ``.numpy()``, ``np.asarray``) while holding the hot ``_mgmt_lock``; it
    now copies first."""
    from bigdl_tpu_torch.serving import ModelServer

    m, _ = _port_predictor()
    server = ModelServer()
    held = []

    class Sample:
        def __array__(self, dtype=None, copy=None):
            held.append(server._mgmt_lock._is_owned())
            return np.zeros(6, np.float32)

    try:
        server.register("m", m, sample_input=Sample(), batch_size=4, warmup=False)
        assert held == [False]
        np.testing.assert_array_equal(server._entries["m"].sample, np.zeros(6, np.float32))
        server.register("t", m, sample_input=torch.ones(6), batch_size=4, warmup=False)
        assert isinstance(server._entries["t"].sample, np.ndarray)
    finally:
        server.close(timeout=30)


def test_swap_validates_geometry_under_the_lock():
    """The flush reads ``pad_record`` unlocked on the invariant that a swap
    keeps the geometry (the JAX package's suppression); ``swap`` enforces it
    under ``_swap_lock``."""
    from bigdl_tpu_torch.optim.predictor import Predictor
    from bigdl_tpu_torch.serving import ContinuousBatcher

    m, pred = _port_predictor(11)
    b = ContinuousBatcher(pred, name="m")
    with pytest.raises(ValueError, match="identical batch_size"):
        b.swap(Predictor(m, batch_size=8), version=2)
    assert b.version == 1
    b.swap(Predictor(m, batch_size=4), version=2)
    assert b.version == 2


def test_queue_wait_is_a_bounded_tick():
    """``RequestQueue.wait`` is a timed single-shot wait (the suppression's
    invariant): it returns at once when a put arrived since ``seen``, at
    ``wake``, and otherwise within its timeout."""
    from bigdl_tpu_torch.serving import RequestQueue, ServeRequest

    q = RequestQueue()
    seen = q.puts()
    q.put(ServeRequest(np.zeros(2, np.float32)))
    t0 = time.perf_counter()
    q.wait(5.0, seen)
    assert time.perf_counter() - t0 < 1.0
    t0 = time.perf_counter()
    q.wait(0.05)
    assert 0.04 <= time.perf_counter() - t0 < 2.0
    threading.Timer(0.05, q.wake).start()
    t0 = time.perf_counter()
    q.wait(5.0)
    assert time.perf_counter() - t0 < 2.5


def test_watchdog_callbacks_locked_and_fired_outside_lock():
    """``StallWatchdog._callbacks`` (now ``# guarded-by: _lock``) crosses
    threads: mutations hold the lock and the stall path fires its hooks
    outside it, so a hook may call back into the watchdog."""
    from bigdl_tpu_torch.obs.watchdog import StallWatchdog

    now = [0.0]
    wd = StallWatchdog(k=2.0, min_timeout_s=1.0, clock=lambda: now[0])
    lock_free = []

    def probe():
        got = wd._lock.acquire(timeout=1.0)
        if got:
            wd._lock.release()
        lock_free.append(got)

    def hook(info):
        t = threading.Thread(target=probe)
        t.start()
        t.join()

    wd.add_callback(hook)
    wd.remove_callback(hook)
    wd.add_callback(hook)
    wd.notify_step(0.5)
    now[0] = 10.0
    assert wd.check() is not None
    assert lock_free == [True]
