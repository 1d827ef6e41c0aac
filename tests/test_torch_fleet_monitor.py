"""The port's ``FleetMonitor`` against the JAX package's, on the CPU.

Each scenario of the JAX ``tests/test_fleet.py`` ``TestFleetMonitor`` (and
``host_left`` from ``test_elastic.py``) runs once: the heartbeat files are
written (by the JAX writer and the port's in turn: the format is shared),
and after every change both monitors check the same directory under the
same fake wall clock. Their event lists must be equal, dict for dict, pass
after pass; the port's snapshot must equal the JAX one's open episodes.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import pytest

from bigdl_tpu.obs import fleet as jfleet
from bigdl_tpu_torch.obs import Telemetry
from bigdl_tpu_torch.obs import fleet as pfleet
from bigdl_tpu_torch.resilience import FaultPlan
from bigdl_tpu_torch.resilience.errors import FaultInjected

REPO = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("obs_report_torch_fleet",
                                               REPO / "tools" / "obs_report.py")
obs_report = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = obs_report
_spec.loader.exec_module(obs_report)


class _Pair:
    """Both monitors over one directory and one clock."""

    def __init__(self, run_dir, clock, **kw):
        self.run_dir, self.clock = run_dir, clock
        self.j = jfleet.FleetMonitor(run_dir, wall_clock=lambda: clock["t"], **kw)
        self.p = pfleet.FleetMonitor(run_dir, wall_clock=lambda: clock["t"], **kw)
        self.passes = []
        self._turn = 0

    def beat(self, k, step, count, age=0.0, leaving=False):
        # the writers take turns: each package reads the other's files
        writer = (jfleet, pfleet)[self._turn % 2].write_heartbeat
        self._turn += 1
        now = self.clock["t"]
        writer(self.run_dir, identity={"process_index": k, "process_count": count,
                                       "host": f"h{k}"},
               step=step, leaving=leaving, clock=lambda: now - age)

    def check(self):
        ej, ep = self.j.check(), self.p.check()
        assert ep == ej
        sj, sp = self.j.snapshot(), self.p.snapshot()
        for key in ("stragglers", "lost", "left", "events"):
            assert sp[key] == sj[key], key
        self.passes.append([(e["reason"], e["process_index"]) for e in ep])
        return ep


def _straggler_rearm(m):
    for k, s in {0: 10, 1: 10, 2: 3}.items():
        m.beat(k, s, 3)
    ev = m.check()
    assert ev[0]["median_step"] == 10 and ev[0]["step"] == 3
    m.check()
    m.beat(2, 9, 3)
    m.check()
    for k, s in ((0, 30), (1, 30), (2, 9)):
        m.beat(k, s, 3)
    m.check()
    return [[("straggler", 2)], [], [], [("straggler", 2)]]


def _host_lost_rearm(m):
    for k in range(3):
        m.beat(k, 10, 3, age=120.0 if k == 2 else 0.0)
    ev = m.check()
    assert ev[0]["stale_s"] == pytest.approx(120.0)
    m.check()
    m.beat(2, 11, 3)
    m.check()
    m.clock["t"] += 120.0
    m.check()
    return [[("host_lost", 2)], [], [], [("host_lost", 0), ("host_lost", 1), ("host_lost", 2)]]


def _stale_excluded_from_median(m):
    for k, s in {0: 100, 1: 100, 2: 10, 3: 0}.items():
        m.beat(k, s, 4, age=999.0 if k == 3 else 0.0)
    m.check()
    return [[("host_lost", 3), ("straggler", 2)]]


def _cold_start_gate(m):
    m.beat(0, 3, 2)
    m.beat(1, 1, 2)
    m.check()
    return [[]]


def _single_process(m):
    m.beat(0, 50, 1)
    m.check()
    return [[]]


def _left_and_lost(m):
    for k in range(3):
        m.beat(k, 1, 3)
    m.check()
    m.beat(1, 1, 3, leaving=True)
    m.clock["t"] += 100.0
    m.beat(0, 2, 3)
    m.check()
    m.check()
    m.beat(1, 3, 3)  # beating again: the departure's episode closes
    m.check()
    return [[], [("host_left", 1), ("host_lost", 2)], [], []]


SCENARIOS = {
    "straggler_rearm": (_straggler_rearm, dict(lag_factor=2.0, min_fleet_steps=4)),
    "host_lost_rearm": (_host_lost_rearm, dict(stale_after_s=60.0, min_fleet_steps=4)),
    "stale_excluded_from_median": (_stale_excluded_from_median,
                                   dict(lag_factor=2.0, stale_after_s=60.0, min_fleet_steps=4)),
    "cold_start_gate": (_cold_start_gate, dict(lag_factor=2.0, min_fleet_steps=8)),
    "single_process": (_single_process, dict(min_fleet_steps=4)),
    "left_and_lost": (_left_and_lost, dict(stale_after_s=5.0, min_fleet_steps=0)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_same_events_as_jax(tmp_path, name):
    fn, kw = SCENARIOS[name]
    m = _Pair(str(tmp_path), {"t": 1000.0}, **kw)
    want = fn(m)
    assert [sorted(p) for p in m.passes] == [sorted(p) for p in want]


def test_warn_records_and_callbacks(tmp_path):
    """The port's warns go through its telemetry (schema-valid, about the
    subject process, ``path="fleet"``) and every callback sees each event;
    a callback that raises does not stop the others."""
    clock = {"t": 1000.0}
    for k, s in {0: 20, 1: 20, 2: 2}.items():
        pfleet.write_heartbeat(str(tmp_path), identity={"process_index": k, "process_count": 3,
                                                        "host": f"h{k}"},
                               step=s, clock=lambda: clock["t"])
    tel = Telemetry(exporters=[], heartbeat_interval_s=None)
    seen = []

    def broken(ev):
        raise RuntimeError("a broken hook")

    mon = pfleet.FleetMonitor(str(tmp_path), telemetry=tel, min_fleet_steps=4,
                              wall_clock=lambda: clock["t"], on_event=broken)
    mon.add_callback(seen.append)
    events = mon.check()
    assert seen == events and len(events) == 1
    warns = [r for r in tel.ring.records if r["type"] == "warn"]
    assert len(warns) == 1
    obs_report.validate_record(warns[0])
    assert warns[0]["reason"] == "straggler" and warns[0]["process_index"] == 2
    assert warns[0]["median_step"] == 20 and warns[0]["path"] == "fleet"


def test_ctor_validation_and_hb_write_seam(tmp_path):
    for mod in (jfleet, pfleet):
        with pytest.raises(ValueError, match="lag_factor"):
            mod.FleetMonitor(str(tmp_path), lag_factor=1.0)
        with pytest.raises(ValueError, match="stale_after_s"):
            mod.FleetMonitor(str(tmp_path), stale_after_s=0.0)
    ident = {"process_index": 1, "process_count": 2, "host": "h1"}
    with FaultPlan().arm("hb_write"):
        with pytest.raises(FaultInjected):
            pfleet.write_heartbeat(str(tmp_path), identity=ident, step=5)
    assert pfleet.read_heartbeats(str(tmp_path)) == {}


def test_telemetry_beat_and_leaving_sentinel(tmp_path):
    """``Telemetry.beat`` (a parked rank's heartbeat) writes this process's
    file with the step; ``close()`` writes the ``leaving`` sentinel, which
    the monitor reads as ``host_left``."""
    from bigdl_tpu_torch.utils.engine import Engine

    prev = Engine.run_dir()
    Engine.set_run_dir(str(tmp_path))
    try:
        tel = Telemetry(exporters=[], heartbeat_interval_s=0.0)
        tel.beat(7)
        beats = pfleet.read_heartbeats(str(tmp_path))
        assert beats[0]["step"] == 7 and not beats[0].get("leaving")
        tel.close()
        assert pfleet.read_heartbeats(str(tmp_path))[0]["leaving"] is True
        mon = pfleet.FleetMonitor(str(tmp_path), wall_clock=lambda: 0.0)
        assert [e["reason"] for e in mon.check()] == ["host_left"]
    finally:
        Engine.set_run_dir(prev)
