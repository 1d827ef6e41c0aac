"""The port's artifact bundles against the JAX package's, on the CPU.

Each case of ``tests/test_artifacts.py`` (``TestBundle``,
``TestCorruptionMatrix``, ``TestPruneCompileCache``, ``TestCacheDirWatch``,
``TestUnwarmedWarn``, ``TestStepArtifactSurface``) runs through both
packages' objects in one test, and the outcomes must agree: the typed
error and its reason, the fall-back ``warn`` record, the manifest's model
entries, the pruned names. Served rows: bit-equal to the same package's
cold boot, and port against JAX within ``CROSS_TOL`` (f32 sums in another
order).

What a bundle carries differs by design (``bigdl_tpu_torch/utils/aot.py``):
the JAX bundle serializes programs and XLA cache entries; the port's holds
signatures and the kernel library with its source-hash stamp. On the CPU no
library is built, so a plain export harvests 0 files, as the JAX package
records 0 without a cache. The corruption cases need a cache payload to
corrupt: there the export's cache directory holds a stand-in library and
stamp, files as a build leaves them (no kernel is loaded on the CPU).

Both packages' compile-cache settings (``Engine``, ``BIGDL_COMPILE_CACHE_DIR``)
are restored after each test, so later files on the same xdist worker see
the state they would have seen without this one.
"""

import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import bigdl_tpu.serving as jserving
from bigdl_tpu import nn as jnn
from bigdl_tpu.obs import Telemetry as JTelemetry
from bigdl_tpu.utils import aot as jaot
from bigdl_tpu.utils import compat as jcompat
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu.utils.random import RandomGenerator as JRandomGenerator
import bigdl_tpu_torch.nn as pnn
import bigdl_tpu_torch.serving as pserving
from bigdl_tpu_torch.obs import Telemetry as PTelemetry
from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.utils import aot as paot
from bigdl_tpu_torch.utils import compat as pcompat
from bigdl_tpu_torch.utils.convert import load_jax_params
from bigdl_tpu_torch.utils.engine import Engine as PEngine

from test_torch_serving_resilience import CROSS_TOL, _rows, _server, obs_report

TIMEOUT = 30


@pytest.fixture(autouse=True)
def _fp32_policy():
    PEngine.set_compute_dtype("float32")
    yield
    PEngine.set_compute_dtype(None)


def _jax_tiny(seed=5, hidden=8):
    JRandomGenerator.set_seed(seed)
    m = jnn.Sequential(jnn.Linear(6, hidden), jnn.Tanh(), jnn.Linear(hidden, 3))
    m.init(sample_input=np.zeros((1, 6), np.float32))
    return m


def _port_tiny(seed=5, hidden=8):
    """The port's model with the JAX model's weights of the same seed."""
    m = pnn.Sequential(pnn.Linear(6, hidden, device="cpu"), pnn.Tanh(device="cpu"),
                       pnn.Linear(hidden, 3, device="cpu"), device="cpu")
    m.init(sample_input=np.zeros((1, 6), np.float32))
    load_jax_params(m, jax.tree_util.tree_map(np.asarray,
                                              _jax_tiny(seed, hidden).get_parameters()))
    return m


def _plant_library(cache_dir: str) -> None:
    """A stand-in kernel library and its stamp, as a build leaves them."""
    with open(os.path.join(cache_dir, _build.LIB_NAME), "wb") as f:
        f.write(b"\x7fELF" + bytes(range(256)) * 16)
    with open(os.path.join(cache_dir, _build.STAMP_NAME), "w") as f:
        f.write(_build.source_hash())


JAX = SimpleNamespace(name="jax", s=jserving, aot=jaot, compat=jcompat, Engine=JEngine,
                      Telemetry=JTelemetry, tiny=_jax_tiny, env_key="jaxlib",
                      plant=lambda d: None)
PORT = SimpleNamespace(name="port", s=pserving, aot=paot, compat=pcompat, Engine=PEngine,
                       Telemetry=PTelemetry, tiny=_port_tiny, env_key="torch",
                       plant=_plant_library)
PKGS = (JAX, PORT)


@pytest.fixture
def cache_dirs(tmp_path):
    """``use(pkg, name)`` points ``pkg``'s compile cache at a fresh
    directory (a new host's empty ``BIGDL_COMPILE_CACHE_DIR``); both
    packages' settings are put back afterwards."""
    JEngine.ensure_compilation_cache()  # adopt the suite's dir first: that is what to restore
    jprev = JEngine.compilation_cache_dir()
    pprev = PEngine._compilation_cache_dir

    def use(pkg, name: str) -> str:
        d = str(tmp_path / pkg.name / name)
        os.makedirs(d, exist_ok=True)
        pkg.Engine.set_compilation_cache_dir(d)
        if pkg is JAX:
            jax.clear_caches()
        return d

    yield use
    if jprev:
        JEngine.set_compilation_cache_dir(jprev)
    else:
        JEngine._state.compilation_cache_dir = None
    jax.clear_caches()
    PEngine.set_compilation_cache_dir(pprev)


def _record():
    return np.arange(6, dtype=np.float32) / 6.0


def _warns(srv, reason):
    return [r for r in srv.telemetry.ring.records
            if r.get("type") == "warn" and r.get("reason") == reason]


def _export_tiny_bundle(pkg, tmp_path, cache_dirs, name="m", plant=False):
    d = cache_dirs(pkg, "cache_export")
    if plant:
        pkg.plant(d)
    bundle = str(tmp_path / pkg.name / "bundle")
    with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as server:
        server.register(name, pkg.tiny(), sample_input=_record(), batch_size=4)
        manifest = server.export_artifacts(bundle)
    return bundle, manifest


def _edit_manifest(bundle, edit):
    mpath = os.path.join(bundle, "manifest.json")
    with open(mpath) as f:
        man = json.load(f)
    edit(man)
    with open(mpath, "w") as f:
        json.dump(man, f)


# ------------------------------------------------------------- bundle basics
class TestBundle:
    def test_round_trip_and_layout(self, tmp_path, cache_dirs):
        entries = {}
        for pkg in PKGS:
            bundle, manifest = _export_tiny_bundle(pkg, tmp_path, cache_dirs)
            assert os.path.exists(os.path.join(bundle, "manifest.json"))
            assert manifest["kind"] == "serving"
            entry = manifest["models"]["m"]
            assert list(entry["modules"]) == ["fixed"]
            loaded = pkg.aot.load_bundle(bundle)
            assert loaded["models"] == manifest["models"]
            exported = pkg.aot.load_exported(bundle, entry["modules"]["fixed"], loaded)
            assert tuple(exported.in_avals[-1].shape) == (4, 6)
            entries[pkg.name] = ({k: v for k, v in entry.items() if k != "modules"},
                                 manifest["cache_entries"])
        assert entries["port"][0] == entries["jax"][0]
        assert entries["port"][0]["record_trailing"] == [6]
        assert entries["jax"][1] > 0
        assert entries["port"][1] == 0  # no library is built on the CPU

    def test_port_module_is_the_registration_signature(self, tmp_path, cache_dirs):
        """The port's module: every parameter leaf under its JAX path, the
        padded input, the outputs of the meta forward; the planted library
        and stamp harvested into ``cache/`` and hash-listed."""
        bundle, manifest = _export_tiny_bundle(PORT, tmp_path, cache_dirs, plant=True)
        sig = paot.load_exported(bundle, manifest["models"]["m"]["modules"]["fixed"], manifest)
        assert sig.in_paths == ["params/Linear_0/bias", "params/Linear_0/weight",
                                "params/Linear_2/bias", "params/Linear_2/weight", "x"]
        want = [tuple(np.shape(a)) for a in
                jax.tree_util.tree_leaves(_jax_tiny().get_parameters())] + [(4, 6)]
        assert [tuple(s.shape) for s in sig.in_avals] == want
        assert sig.out_paths == ["y"] and tuple(sig.out_avals[0].shape) == (4, 3)
        assert manifest["cache_entries"] == 2
        assert sorted(manifest["files"]) == sorted(
            [os.path.join("cache", _build.LIB_NAME), os.path.join("cache", _build.STAMP_NAME),
             manifest["models"]["m"]["modules"]["fixed"]])
        assert manifest["fingerprint"]["kernel_sources"] == _build.source_hash()

    def test_manifest_written_last(self, tmp_path, cache_dirs):
        for pkg in PKGS:
            bundle, _ = _export_tiny_bundle(pkg, tmp_path, cache_dirs)
            os.remove(os.path.join(bundle, "manifest.json"))
            with pytest.raises(pkg.s.ArtifactIncompatible, match="manifest.json missing"):
                pkg.aot.load_bundle(bundle)

    def test_fingerprint_gate(self, tmp_path, cache_dirs):
        for pkg in PKGS:
            bundle, _ = _export_tiny_bundle(pkg, tmp_path, cache_dirs)
            _edit_manifest(bundle, lambda m: m["fingerprint"].update(
                {pkg.env_key: "0.0.1-not-this-one"}))
            with pytest.raises(pkg.s.ArtifactIncompatible, match=pkg.env_key):
                pkg.aot.load_bundle(bundle)
            assert pkg.aot.load_bundle(bundle, check_env=False)["kind"] == "serving"

    def test_export_without_models_refuses(self, cache_dirs, tmp_path):
        for pkg in PKGS:
            cache_dirs(pkg, "c")
            with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as server:
                with pytest.raises(ValueError, match="no models registered"):
                    server.export_artifacts(str(tmp_path / pkg.name / "b"))


# ------------------------------------------------- corruption / drift matrix
class TestCorruptionMatrix:
    """Each corruption: a typed rejection inside, one ``warn`` record, a
    server that stays up and boots cold, rows bit-equal to a cold boot of
    the same package and within ``CROSS_TOL`` of the JAX package's."""

    @pytest.fixture
    def gold(self, tmp_path, cache_dirs):
        out = {}
        for pkg in PKGS:
            bundle, _ = _export_tiny_bundle(pkg, tmp_path, cache_dirs, plant=True)
            cache_dirs(pkg, "cache_gold")
            with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as server:
                server.register("m", pkg.tiny(), sample_input=_record(), batch_size=4)
                rows = _rows(server.predict("m", [_record(), _record() * 0.5]))
            out[pkg.name] = (bundle, rows)
        np.testing.assert_allclose(out["port"][1], out["jax"][1], rtol=0, atol=CROSS_TOL)
        return out

    def _boot_with(self, pkg, bundle, cache_dirs, tag, **kw):
        fresh = cache_dirs(pkg, f"cache_{tag}")
        server = pkg.s.ModelServer(telemetry=pkg.Telemetry(exporters=[]))
        kw.setdefault("batch_size", 4)
        server.register("m", kw.pop("model", None) or pkg.tiny(), sample_input=_record(),
                        artifacts=bundle, **kw)
        return server, fresh

    def _fell_back(self, pkg, server, gold, detail):
        try:
            assert server.models()["m"]["aot_modules"] == 0
            warns = _warns(server, "artifact_incompatible")
            assert len(warns) == 1 and detail in warns[0]["detail"], warns
            obs_report.validate_record(warns[0])
            rows = _rows(server.predict("m", [_record(), _record() * 0.5]))
        finally:
            server.close()
        if gold is not None:
            np.testing.assert_array_equal(rows, gold[pkg.name][1])
        return rows

    def _case(self, gold, cache_dirs, tag, corrupt, detail, untouched=True, **kw):
        for pkg in PKGS:
            bundle = gold[pkg.name][0]
            corrupt(pkg, bundle)
            server, fresh = self._boot_with(pkg, bundle, cache_dirs, tag, **kw)
            self._fell_back(pkg, server, gold if "model" not in kw else None, detail)
            if untouched and pkg is PORT:  # nothing half-seeded
                assert os.listdir(fresh) == []

    def test_truncated_cache_entry(self, gold, cache_dirs):
        def corrupt(pkg, bundle):
            cache_dir = os.path.join(bundle, "cache")
            victim = os.path.join(cache_dir, sorted(os.listdir(cache_dir))[0])
            with open(victim, "r+b") as f:
                f.truncate(max(1, os.path.getsize(victim) // 2))

        self._case(gold, cache_dirs, "trunc", corrupt, "truncated")

    def test_tampered_hash(self, gold, cache_dirs):
        def corrupt(pkg, bundle):
            _edit_manifest(bundle, lambda m: m["files"][next(iter(m["files"]))].update(
                sha256="0" * 64))

        self._case(gold, cache_dirs, "hash", corrupt, "checksum mismatch")

    def test_jaxlib_version_mismatch(self, gold, cache_dirs):
        """The port's counterpart names another torch."""
        def corrupt(pkg, bundle):
            _edit_manifest(bundle, lambda m: m["fingerprint"].update({pkg.env_key: "9.9.9"}))

        self._case(gold, cache_dirs, "ver", corrupt, "fingerprint mismatch")

    def test_bucket_geometry_drift(self, gold, cache_dirs):
        self._case(gold, cache_dirs, "geom", lambda pkg, b: None, "geometry drift",
                   untouched=False, batch_size=8)

    def test_architecture_drift_same_record_shape(self, gold, cache_dirs):
        """A wider model with the same record geometry passes the record
        check and is caught by the module's input signature."""
        for pkg in PKGS:
            server, _ = self._boot_with(pkg, gold[pkg.name][0], cache_dirs, "arch",
                                        model=pkg.tiny(seed=6, hidden=12))
            rows = self._fell_back(pkg, server, None, "signature mismatch")
            assert rows.shape == (2, 3)

    def test_missing_manifest(self, gold, cache_dirs):
        self._case(gold, cache_dirs, "noman",
                   lambda pkg, b: os.remove(os.path.join(b, "manifest.json")),
                   "manifest.json missing")

    def test_unknown_model_in_bundle(self, gold, cache_dirs):
        for pkg in PKGS:
            cache_dirs(pkg, "cache_unknown")
            server = pkg.s.ModelServer(telemetry=pkg.Telemetry(exporters=[]))
            try:
                server.register("other", pkg.tiny(), sample_input=_record(), batch_size=4,
                                artifacts=gold[pkg.name][0])
                assert server.models()["other"]["aot_modules"] == 0
                warns = _warns(server, "artifact_incompatible")
                assert warns and "no artifacts for model" in warns[0]["detail"]
            finally:
                server.close()

    def test_strict_warm_start_raises(self, gold, cache_dirs):
        for pkg in PKGS:
            os.remove(os.path.join(gold[pkg.name][0], "manifest.json"))
            cache_dirs(pkg, "cache_strict")
            with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as server:
                with pytest.raises(pkg.s.ArtifactIncompatible):
                    server.warm_start(gold[pkg.name][0])

    def test_port_warm_boot_seeds_the_library(self, gold, cache_dirs):
        """A verified bundle seeds the fresh cache directory with the
        library and its stamp (the stamp names the sources, so a load would
        build nothing), covers the geometry and serves the cold rows."""
        bundle = gold["port"][0]
        fresh = cache_dirs(PORT, "cache_warm")
        with _server(PORT, telemetry=PORT.Telemetry(exporters=[])) as server:
            server.warm_start(bundle)
            assert sorted(os.listdir(fresh)) == sorted([_build.LIB_NAME, _build.STAMP_NAME])
            with open(os.path.join(fresh, _build.STAMP_NAME)) as f:
                assert f.read() == _build.source_hash()
            server.register("m", PORT.tiny(), sample_input=_record(), batch_size=4,
                            artifacts=bundle)
            assert server.models()["m"]["aot_modules"] == 1
            rows = _rows(server.predict("m", [_record(), _record() * 0.5]))
            warm = [r for r in server.telemetry.ring.records if r["type"] == "warmup"]
            assert not _warns(server, "artifact_incompatible")
        np.testing.assert_array_equal(rows, gold["port"][1])
        assert warm[0]["warm_start"] is True and warm[0]["bundle"] == bundle
        obs_report.validate_record(warm[0])


# ------------------------------------------------------------ cache hygiene
def _mk_entry(d, name, size, age_s, atime=True):
    import time

    path = os.path.join(d, name)
    with open(path, "wb") as f:
        f.write(b"x" * size)
    old = time.time() - age_s
    os.utime(path, (old, old))
    if atime:
        with open(path + "-atime", "w"):
            pass
        os.utime(path + "-atime", (old, old))


class TestPruneCompileCache:
    """The same directory contents pruned by both packages: the same names
    go, the same files stay."""

    def _both(self, tmp_path, entries, **kw):
        out = {}
        for pkg in PKGS:
            d = str(tmp_path / pkg.name)
            os.makedirs(d)
            for e in entries:
                _mk_entry(d, *e)
            out[pkg.name] = (pkg.compat.prune_compile_cache(d, **kw), sorted(os.listdir(d)))
        assert out["port"] == out["jax"], out
        return out["port"]

    def test_age_prune(self, tmp_path):
        pruned, left = self._both(tmp_path, [("old", 10, 10 * 86400), ("new", 10, 60)],
                                  max_age_days=5)
        assert pruned == ["old"] and left == ["new", "new-atime"]

    def test_size_prune_lru_order(self, tmp_path):
        pruned, left = self._both(tmp_path, [("oldest", 100, 3000), ("mid", 100, 2000),
                                             ("newest", 100, 1000)], max_bytes=250)
        assert pruned == ["oldest"]
        assert {f for f in left if not f.endswith("-atime")} == {"mid", "newest"}

    def test_entry_without_atime_uses_mtime(self, tmp_path):
        assert self._both(tmp_path, [("bare", 10, 10 * 86400, False)],
                          max_age_days=1) == (["bare"], [])

    def test_noop_within_bounds(self, tmp_path):
        assert self._both(tmp_path, [("a", 10, 60)], max_bytes=1000,
                          max_age_days=30)[0] == []

    def test_missing_dir_is_empty(self, tmp_path):
        for pkg in PKGS:
            assert pkg.compat.prune_compile_cache(str(tmp_path / "nope"), max_bytes=1) == []

    def test_engine_env_call_site(self, tmp_path, monkeypatch, cache_dirs):
        """``Engine.ensure_compilation_cache`` adopts the variable and prunes
        once a process when the knobs are set."""
        monkeypatch.setenv("BIGDL_COMPILE_CACHE_MAX_AGE_DAYS", "7")
        for pkg in PKGS:
            d = str(tmp_path / pkg.name / "cache")
            os.makedirs(d)
            _mk_entry(d, "ancient", 10, 30 * 86400)
            monkeypatch.setenv("BIGDL_COMPILE_CACHE_DIR", d)
            monkeypatch.setattr(pkg.Engine, "_cache_pruned", False)
            if pkg is JAX:
                monkeypatch.setattr(JEngine._state, "compilation_cache_dir", None)
            else:
                PEngine.set_compilation_cache_dir(None)
            assert pkg.Engine.ensure_compilation_cache() == d
            assert "ancient" not in os.listdir(d)


# ----------------------------------------------------------------- watchers
class TestCacheDirWatch:
    def test_observe_classifies_fresh_vs_hit(self, cache_dirs):
        for pkg in PKGS:
            d = cache_dirs(pkg, "watch")
            watch = pkg.compat.CacheDirWatch()
            with open(os.path.join(d, "entry-cache"), "wb") as f:
                f.write(b"z")
            assert watch.observe() is False  # a fresh entry appeared: cold
            assert watch.observe() is True  # nothing new since


# ------------------------------------------------------- unwarmed satellite
class TestUnwarmedWarn:
    def _scenario(self, pkg, **kw):
        with _server(pkg, telemetry=pkg.Telemetry(exporters=[])) as server:
            server.register("m", pkg.tiny(), batch_size=4, **kw)
            warns = [(r["reason"], r["model"]) for r in _warns(server, "unwarmed_model")]
            warmups = [(r["model"], r["warm_start"]) for r in server.telemetry.ring.records
                       if r.get("type") == "warmup"]
        return warns, warmups

    @pytest.mark.parametrize("kw,want", [
        (dict(sample_input=_record(), warmup=False), ([("unwarmed_model", "m")], [])),
        ({}, ([("unwarmed_model", "m")], [])),
        (dict(sample_input=_record()), ([], [("m", False)])),
    ], ids=["warmup_false", "without_sample", "warmed"])
    def test_unwarmed_warn_records(self, cache_dirs, kw, want):
        for pkg in PKGS:
            cache_dirs(pkg, "warm")
        assert self._scenario(JAX, **kw) == self._scenario(PORT, **kw) == want


# ------------------------------------------------------------- trainer seam
def _optimizer(pkg):
    x = np.zeros((8, 6), np.float32)
    y = np.zeros(8, np.int64)
    if pkg is JAX:
        from bigdl_tpu.dataset import DataSet
        from bigdl_tpu.optim import LocalOptimizer

        JRandomGenerator.set_seed(2)
        return LocalOptimizer(jnn.Sequential(jnn.Linear(6, 4), jnn.LogSoftMax()),
                              DataSet.array(x, y, batch_size=8), jnn.ClassNLLCriterion())
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import LocalOptimizer

    model = pnn.Sequential(pnn.Linear(6, 4, device="cpu"), pnn.LogSoftMax(device="cpu"),
                           device="cpu")
    return LocalOptimizer(model, DataSet.array(x, y + 1, batch_size=8),
                          pnn.ClassNLLCriterion())


class TestStepArtifactSurface:
    def test_export_before_fit_refuses(self):
        for pkg in PKGS:
            with pytest.raises(RuntimeError, match="run optimize"):
                _optimizer(pkg).export_step_artifact("/nonexistent/never-written")

    def test_seed_without_cache_dir_refuses(self, tmp_path, cache_dirs, monkeypatch):
        for pkg in PKGS:
            bundle, _ = _export_tiny_bundle(pkg, tmp_path, cache_dirs, plant=True)
            monkeypatch.delenv("BIGDL_COMPILE_CACHE_DIR", raising=False)
            if pkg is JAX:
                monkeypatch.setattr(JEngine._state, "compilation_cache_dir", None)
            else:
                PEngine.set_compilation_cache_dir(None)
            with pytest.raises(pkg.s.ArtifactIncompatible, match="no persistent"):
                pkg.aot.seed_from_bundle(bundle)

    def test_trainer_warm_start_rejects_serving_bundle(self, tmp_path, cache_dirs):
        """The kind gate comes before any seeding."""
        for pkg in PKGS:
            bundle, _ = _export_tiny_bundle(pkg, tmp_path, cache_dirs, plant=True)
            fresh = cache_dirs(pkg, "kindgate")
            with pytest.raises(pkg.s.ArtifactIncompatible, match="train_step"):
                _optimizer(pkg).warm_start(bundle)
            assert os.listdir(fresh) == []

    def test_step_bundle_round_trip(self, tmp_path, cache_dirs):
        """After a step, both packages write a ``train_step`` bundle with the
        same ``path_type`` and argument count; the port's ``module`` is None
        and says why. A second optimizer warm-starts from it, and its run's
        ``run_start`` record names the bundle."""
        from bigdl_tpu_torch.optim import Trigger as PTrigger
        from bigdl_tpu.optim import Trigger as JTrigger

        steps = {}
        for pkg, trig in ((JAX, JTrigger), (PORT, PTrigger)):
            d = cache_dirs(pkg, "step_export")
            pkg.plant(d)
            opt = _optimizer(pkg)
            opt.set_end_when(trig.max_iteration(1))
            opt.optimize()
            path = str(tmp_path / pkg.name / "step")
            steps[pkg.name] = opt.export_step_artifact(path)["step"]
            cache_dirs(pkg, "step_resume")
            opt2 = _optimizer(pkg)
            assert opt2.warm_start(path)["kind"] == "train_step"
            tel = pkg.Telemetry(exporters=[])
            opt2.set_telemetry(tel).set_end_when(trig.max_iteration(1))
            opt2.optimize()
            starts = [r for r in tel.ring.records if r.get("event") == "run_start"]
            assert starts and starts[0]["warm_start"] == path
        assert steps["port"]["path_type"] == steps["jax"]["path_type"] == "LocalOptimizer"
        assert steps["port"]["module"] is None and "eager" in steps["port"]["export_error"]
        # the JAX step also takes the rng and the step counters: the port's
        # specs are the params, the optimizer's slots and the batch
        assert [s["shape"] for s in steps["port"]["arg_specs"]][-2:] == [[8, 6], [8]]


# ---------------------------------------------------------------- signatures
@pytest.mark.parametrize("mod,name", [
    ("utils.aot", "environment_fingerprint"), ("utils.aot", "check_fingerprint"),
    ("utils.aot", "spec_tree"), ("utils.aot", "load_bundle"), ("utils.aot", "load_exported"),
    ("utils.aot", "seed_from_bundle"), ("utils.aot", "warm_start"),
    ("utils.aot", "ArtifactIncompatible"), ("utils.aot", "BundleWriter"),
    ("serving.artifacts", "export_server_artifacts"), ("serving.artifacts", "model_entry"),
    ("serving.artifacts", "check_geometry"), ("serving.artifacts", "install_modules"),
    ("utils.compat", "harvest_compile_cache"), ("utils.compat", "seed_compile_cache"),
    ("utils.compat", "prune_compile_cache"), ("obs.export", "render_prometheus"),
    ("obs.export", "ObsEndpoint"), ("obs.export", "ensure_default"),
    ("obs.health", "ActivationDrift"), ("optim.predictor", "PredictionService"),
    ("serving.resilience", "spawn_worker"),
])
def test_signatures_match_the_jax_package(mod, name):
    """The parameters' names, kinds and defaults, as the JAX package's."""
    import importlib
    import inspect

    def sig(pkg):
        obj = getattr(importlib.import_module(f"{pkg}.{mod}"), name)
        params = inspect.signature(obj.__init__ if inspect.isclass(obj) else obj).parameters
        return [(p.name, p.kind, p.default) for p in params.values()]

    assert sig("bigdl_tpu_torch") == sig("bigdl_tpu")


def test_step_and_server_methods_match_the_jax_package():
    import inspect

    from bigdl_tpu.optim import LocalOptimizer as JLocal
    from bigdl_tpu.serving import ModelServer as JServer
    from bigdl_tpu_torch.optim import LocalOptimizer as PLocal
    from bigdl_tpu_torch.serving import ModelServer as PServer

    for jcls, pcls, names in ((JLocal, PLocal, ("export_step_artifact", "warm_start")),
                              (JServer, PServer, ("warm_start", "export_artifacts",
                                                  "__init__"))):
        for n in names:
            assert (list(inspect.signature(getattr(pcls, n)).parameters)
                    == list(inspect.signature(getattr(jcls, n)).parameters)), n
    # register: the JAX server's keywords, and no others
    assert (set(inspect.signature(PServer.register).parameters)
            == set(inspect.signature(JServer.register).parameters))
