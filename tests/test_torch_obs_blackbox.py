"""The port's flight recorder and postmortem bundles against the JAX
package's, on the CPU (the scenarios of ``tests/test_blackbox.py`` that
this slice covers; the terminal fault in a fit is in
``test_torch_resilience_training.py``).

The recorder's rings and counters from the same records must be equal; a
port bundle must pass the JAX package's ``verify_bundle`` and
``tools/postmortem.py``'s, and each package must reject the same
truncations and tamperings with the same error types.
"""

import importlib.util
import json
from pathlib import Path

import pytest

import bigdl_tpu.obs.blackbox as jbb
import bigdl_tpu_torch.obs.blackbox as pbb
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch.obs import Telemetry

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("pm_tool", REPO / "tools" / "postmortem.py")
pm_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pm_tool)


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("BIGDL_RUN_DIR", raising=False)
    Engine.set_run_dir(str(tmp_path))
    yield tmp_path
    Engine.set_run_dir(None)
    pbb.disarm_crash_handler()


def _records():
    out = [{"type": "step", "iteration": i, "ts": float(i)} for i in range(600)]
    out += [{"type": "meta", "event": "run_start", "ts": 0.5},
            {"type": "custom", "x": 1, "ts": 1.0}]
    return out


def test_recorder_rings_and_counts_equal_the_jax_package():
    def fill(mod):
        rec = mod.FlightRecorder({"step": 64})
        for r in _records():
            rec.emit(dict(r))
        return rec.snapshot(), rec.counts()

    assert fill(pbb) == fill(jbb)
    snap, counts = fill(pbb)
    assert len(snap["step"]) == 64 and counts["step"] == {"seen": 600, "kept": 64}
    assert counts["custom"] == {"seen": 1, "kept": 1}


def _dump(run_dir, reason="unit"):
    tel = Telemetry(exporters=[])
    tel.step(iteration=3, records=4, wall_s=0.1, loss=1.0)
    try:
        raise KeyError("boom")
    except KeyError as e:
        path = pbb.dump_postmortem(reason, telemetry=tel, error=e)
    return path, tel


def test_a_port_bundle_verifies_in_both_packages_and_the_tool(run_dir):
    path, tel = _dump(run_dir)
    assert path and Path(path).parent.name == "postmortem"
    for verify in (pbb.verify_bundle, jbb.verify_bundle, pm_tool.verify_bundle):
        verify(path)
    loaded = pbb.load_bundle(path)
    assert loaded["reason"]["error"]["class"] == "KeyError"
    assert loaded["rings"]["step"][-1]["iteration"] == 3
    assert loaded["fingerprint"]["identity"]["process_index"] == 0
    assert jbb.load_bundle(path)["rings"] == loaded["rings"]
    assert "KeyError" in pm_tool.render(pm_tool.load_bundle(path))
    pm = [r for r in tel.ring.records if r["type"] == "postmortem"]
    assert pm and pm[-1]["bundle"] == path


def _corrupt(path, how):
    p = Path(path)
    if how == "truncate":
        f = p / "reason.json"
        f.write_bytes(f.read_bytes()[:10])
    elif how == "flip":
        f = p / "reason.json"
        data = bytearray(f.read_bytes())
        data[5] = ord("X") if data[5] != ord("X") else ord("Y")
        f.write_bytes(bytes(data))
    elif how == "manifest":
        (p / "MANIFEST.json").unlink()
    elif how == "format":
        m = json.loads((p / "MANIFEST.json").read_text())
        m["format"] = "other"
        (p / "MANIFEST.json").write_text(json.dumps(m))


@pytest.mark.parametrize("how,err", [("truncate", "BundleTruncated"), ("flip", "BundleTampered"),
                                     ("manifest", "BundleTruncated"),
                                     ("format", "BundleTampered")])
def test_both_packages_reject_a_broken_bundle_alike(run_dir, how, err):
    path, _ = _dump(run_dir)
    _corrupt(path, how)
    for mod in (pbb, jbb):
        with pytest.raises(mod.PostmortemBundleError) as e:
            mod.verify_bundle(path)
        assert type(e.value).__name__ == err


def test_dump_cap_and_no_run_dir(run_dir, monkeypatch):
    monkeypatch.setenv("BIGDL_POSTMORTEM_MAX", "2")
    paths = [_dump(run_dir, f"r{i}")[0] for i in range(3)]
    assert paths[0] and paths[1] and paths[2] is None
    Engine.set_run_dir(None)
    assert pbb.dump_postmortem("x") is None  # never raises


def test_opt_out_and_crash_handler_sweep(run_dir, monkeypatch):
    monkeypatch.setenv("BIGDL_BLACKBOX", "0")
    tel = Telemetry(exporters=[])
    assert not any(isinstance(e, pbb.FlightRecorder) for e in tel.exporters)
    monkeypatch.setenv("BIGDL_BLACKBOX", "1")
    crash = pbb.arm_crash_handler(str(run_dir))
    assert crash == pbb.crash_handler_path() and (Path(crash) / "context.json").exists()
    pbb.disarm_crash_handler()
    assert not Path(crash).exists()  # a clean exit leaves no debris
