"""Flight recorder and postmortem bundles: every abnormal exit leaves a
triageable artifact (counterpart of ``bigdl_tpu/obs/blackbox.py``; the
port's own copy, the same bundle format, so ``tools/postmortem.py`` and the
JAX package's ``verify_bundle`` read a port bundle).

* :class:`FlightRecorder`, a telemetry exporter that keeps the last N
  records of each record type in bounded in-memory rings (an O(1) append
  of host values a record). Every :class:`~bigdl_tpu_torch.obs.telemetry.Telemetry`
  attaches the process-global recorder (:func:`ensure_armed`;
  ``BIGDL_BLACKBOX=0`` opts out).
* :func:`dump_postmortem` freezes the rings, every thread's Python stack,
  the active :class:`~bigdl_tpu_torch.obs.trace.TraceContext`, an
  environment/configuration fingerprint, the fleet heartbeats, the
  comparison with a perf baseline named by ``BIGDL_PERF_BASELINE`` and the
  newest checkpoint's manifest into ``<run_dir>/postmortem/<seq>-<reason>/``
  as a verified bundle: every file first, ``MANIFEST.json`` (sha256 and
  size a file) last, through a temporary name. It never raises.
* :func:`arm_crash_handler` points :mod:`faulthandler` at a pre-opened
  ``<run_dir>/postmortem/hard_crash/stacks.txt``, so a SIGSEGV/SIGABRT
  still leaves the stacks.

The dumps are wired where an abnormal exit is declared: the stall
watchdog's stall (``Telemetry._on_stall``), a failure leaving
``optimize()`` terminally, a preemption, and the serving supervisor.
"""

from __future__ import annotations

import collections
import faulthandler
import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from . import fleet as _fleet
from . import trace as _trace
from .telemetry import TelemetryExporter

__all__ = [
    "FlightRecorder",
    "PostmortemBundleError",
    "BundleTruncated",
    "BundleTampered",
    "arm",
    "disarm",
    "ensure_armed",
    "get_recorder",
    "arm_crash_handler",
    "disarm_crash_handler",
    "crash_handler_path",
    "dump_postmortem",
    "verify_bundle",
    "load_bundle",
    "POSTMORTEM_DIRNAME",
    "MANIFEST_NAME",
    "BUNDLE_FORMAT",
    "HARD_CRASH_DIRNAME",
]

POSTMORTEM_DIRNAME = "postmortem"
MANIFEST_NAME = "MANIFEST.json"
BUNDLE_FORMAT = "bigdl-postmortem-v1"
HARD_CRASH_DIRNAME = "hard_crash"

# Per-run dump budget: forensics are bounded like everything else in the
# stream — a crash-looping run must not fill the disk with bundles.
_DEFAULT_MAX_DUMPS = 16


class PostmortemBundleError(RuntimeError):
    """Base: a postmortem bundle failed verify-on-load."""


class BundleTruncated(PostmortemBundleError):
    """Bundle is incomplete: manifest or a manifest-listed file is missing,
    unreadable, or shorter/longer than recorded — the writer died mid-dump
    (the manifest-written-LAST discipline makes this the ONLY partial
    failure mode) or the bundle was partially copied."""


class BundleTampered(PostmortemBundleError):
    """Bundle content does not match its manifest sha256s (or the format
    tag is foreign): the bytes changed after the manifest sealed them."""


# --------------------------------------------------------------------------
# flight recorder
# --------------------------------------------------------------------------

class FlightRecorder(TelemetryExporter):
    """Per-record-type bounded rings over the whole telemetry stream.

    One deque per record ``type`` (step/serve/span/... — anything the stream
    grows), preallocated for the known types and minted on first sight for
    new ones, so ``emit`` is a dict lookup + deque append under a small
    lock. ``seen``/kept counters per type make truncation explicit in the
    dumped bundle (``truncated = seen - kept``)."""

    #: last-N capacity per record type; unknown types get ``default``.
    CAPACITIES: Dict[str, int] = {
        "step": 512,
        "serve": 512,
        "span": 256,
        "perf": 128,
        "health": 128,
        "warn": 128,
        "compile": 128,
        "warmup": 128,
        "meta": 32,
        "default": 128,
    }

    def __init__(self, capacities: Optional[Dict[str, int]] = None):
        caps = dict(self.CAPACITIES)
        if capacities:
            caps.update(capacities)
        self._caps = caps
        self._lock = threading.Lock()
        self._rings: Dict[str, collections.deque] = {
            t: collections.deque(maxlen=c)
            for t, c in caps.items() if t != "default"
        }
        self._seen: Dict[str, int] = {}

    def emit(self, record: Dict) -> None:
        rtype = record.get("type") or "untyped"
        with self._lock:
            ring = self._rings.get(rtype)
            if ring is None:
                ring = collections.deque(maxlen=self._caps["default"])
                self._rings[rtype] = ring
            ring.append(record)
            self._seen[rtype] = self._seen.get(rtype, 0) + 1

    def snapshot(self) -> Dict[str, List[Dict]]:
        """``{type: [records...]}`` for every non-empty ring (copies)."""
        with self._lock:
            return {t: list(r) for t, r in self._rings.items() if r}

    def counts(self) -> Dict[str, Dict[str, int]]:
        """``{type: {"seen": n, "kept": k}}`` for every type ever emitted."""
        with self._lock:
            return {
                t: {"seen": n, "kept": len(self._rings.get(t, ()))}
                for t, n in self._seen.items()
            }

    def clear(self) -> None:
        with self._lock:
            for r in self._rings.values():
                r.clear()
            self._seen.clear()


_armed_lock = threading.Lock()
_armed: Optional[FlightRecorder] = None


def arm(capacities: Optional[Dict[str, int]] = None) -> FlightRecorder:
    """Arm (or return) the process-global recorder. Idempotent — every
    Telemetry in the process tees into the SAME rings, so a dump sees the
    whole process regardless of which stream triggered it."""
    global _armed
    with _armed_lock:
        if _armed is None:
            _armed = FlightRecorder(capacities)
        return _armed


def ensure_armed() -> Optional[FlightRecorder]:
    """``arm()`` unless opted out via ``BIGDL_BLACKBOX=0`` (then None).
    Called by every ``Telemetry.__init__``; also arms the hard-crash
    faulthandler hook when a run dir already resolves."""
    if os.environ.get("BIGDL_BLACKBOX", "1") == "0":
        return None
    rec = arm()
    try:
        run_dir = _resolve_run_dir(None)
        if run_dir is not None:
            arm_crash_handler(run_dir)
    except Exception:  # the arming context write is best-effort
        pass
    return rec


def get_recorder() -> Optional[FlightRecorder]:
    return _armed


def disarm() -> None:
    """Drop the global recorder (tests). Streams that already attached it
    keep their reference; new Telemetry objects arm a fresh one."""
    global _armed
    with _armed_lock:
        _armed = None


# --------------------------------------------------------------------------
# hard-crash hook (faulthandler on a pre-opened fd)
# --------------------------------------------------------------------------

_crash_lock = threading.Lock()
_crash_state: Dict[str, Any] = {"dir": None, "fh": None}


def arm_crash_handler(run_dir: str) -> Optional[str]:
    """Point :mod:`faulthandler` at a pre-opened
    ``<run_dir>/postmortem/hard_crash/stacks.txt`` so SIGSEGV/SIGABRT/
    SIGBUS/SIGFPE/SIGILL dump per-thread Python stacks even when the
    interpreter cannot run another bytecode. A ``context.json``
    fingerprint is written NOW (arm time) because there is no later.

    Idempotent per ``run_dir``; re-arming a different run dir moves the
    hook. Returns the hard-crash directory (None on failure — forensics
    never break the run they protect)."""
    try:
        crash_dir = os.path.join(
            os.path.abspath(run_dir), POSTMORTEM_DIRNAME, HARD_CRASH_DIRNAME)
        with _crash_lock:
            if _crash_state["dir"] == crash_dir:
                return crash_dir
            os.makedirs(crash_dir, exist_ok=True)
            with open(os.path.join(crash_dir, "context.json"), "w") as f:
                json.dump(_fingerprint(armed_ts=time.time()), f, indent=1,
                          sort_keys=True, default=repr)
            fh = open(os.path.join(crash_dir, "stacks.txt"), "w")
            old = _crash_state["fh"]
            faulthandler.enable(file=fh, all_threads=True)
            _crash_state.update(dir=crash_dir, fh=fh)
            if old is not None:
                try:
                    old.close()
                except Exception:  # arming must not fault the caller
                    pass
        return crash_dir
    except Exception:
        return None


def disarm_crash_handler() -> None:
    """Disable the hook and sweep the debris of a CLEAN exit: an empty
    ``stacks.txt`` means nothing crashed, so the pre-created hard-crash
    dir is removed rather than left to read as a false positive."""
    with _crash_lock:
        fh, crash_dir = _crash_state["fh"], _crash_state["dir"]
        _crash_state.update(dir=None, fh=None)
        if fh is None:
            return
        try:
            faulthandler.disable()
        except Exception:  # teardown is best-effort
            pass
        try:
            fh.close()
        except Exception:  # teardown is best-effort
            pass
        try:
            stacks = os.path.join(crash_dir, "stacks.txt")
            if os.path.getsize(stacks) == 0:
                os.remove(stacks)
                os.remove(os.path.join(crash_dir, "context.json"))
                os.rmdir(crash_dir)
        except OSError:
            pass


def crash_handler_path() -> Optional[str]:
    """The armed hard-crash directory (None when unarmed)."""
    return _crash_state["dir"]


# --------------------------------------------------------------------------
# dump
# --------------------------------------------------------------------------

def _resolve_run_dir(run_dir: Optional[str]) -> Optional[str]:
    if run_dir:
        return os.path.abspath(run_dir)
    try:
        from ..utils.engine import Engine
        rd = Engine.run_dir()
        if rd:
            return rd
    except Exception:  # the probe must not fault the dump
        pass
    env = os.environ.get("BIGDL_RUN_DIR")
    return os.path.abspath(env) if env else None


def _sanitize(reason: str) -> str:
    out = "".join(
        c if (c.isalnum() or c in "-_") else "_" for c in str(reason))
    return (out[:48] or "unknown").strip("_") or "unknown"


def _fingerprint(**extra: Any) -> Dict[str, Any]:
    """The environment and configuration of this process: what a triage
    needs to know of what was running, all host-held."""
    import torch

    fp: Dict[str, Any] = {
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "cwd": os.getcwd(),
        "identity": _fleet.process_identity(),
        "env": {k: v for k, v in sorted(os.environ.items())
                if k.startswith(("BIGDL_", "CUDA_", "TORCH_", "NCCL_"))},
        "torch": torch.__version__,
    }
    fp.update(extra)
    try:
        from ..utils.engine import Engine

        fp["engine"] = {
            "run_dir": Engine.run_dir(),
            "fused_kernels": Engine.fused_kernels(),
            "compute_dtype": Engine.compute_dtype(),
            "backend": Engine.backend(),
            "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                        if torch.cuda.is_available() else []),
        }
    except Exception as e:
        fp["engine_error"] = repr(e)
    return fp


def _thread_stacks() -> str:
    names = {t.ident: t.name for t in threading.enumerate()}
    lines: List[str] = []
    for tid, frame in sorted(sys._current_frames().items()):
        lines.append("Thread %s (ident %d):\n"
                     % (names.get(tid, "<unknown>"), tid))
        lines.extend(traceback.format_stack(frame))
        lines.append("\n")
    return "".join(lines)


def _perf_comparison(rings: Dict[str, List[Dict]]) -> Optional[Dict]:
    """The last step's numbers against the perf baseline file that
    ``BIGDL_PERF_BASELINE`` names (none by default: the repository's
    ``PERF_BASELINE.json`` holds the JAX package's measurements)."""
    path = os.environ.get("BIGDL_PERF_BASELINE")
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        baseline = json.load(f)
    steps = rings.get("step") or []
    last = steps[-1] if steps else {}
    observed = {
        "img_per_sec_per_chip": last.get("records_per_sec"),
        "mfu": last.get("mfu"),
        "step_ms": (round(last["wall_s"] * 1000.0, 3)
                    if isinstance(last.get("wall_s"), (int, float)) else None),
    }
    delta_pct: Dict[str, Optional[float]] = {}
    for name, spec in (baseline.get("metrics") or {}).items():
        base, got = spec.get("value"), observed.get(name)
        if isinstance(base, (int, float)) and base and isinstance(got, (int, float)):
            delta_pct[name] = round(100.0 * (got - base) / base, 2)
        else:
            delta_pct[name] = None
    return {"baseline_path": path, "baseline": baseline, "observed": observed,
            "delta_pct": delta_pct}


def _checkpoint_pointer(checkpoint_dir: Optional[str]) -> Optional[Dict]:
    if not checkpoint_dir or not os.path.isdir(checkpoint_dir):
        return None
    from ..utils import serialization as _ser
    step = _ser.latest_checkpoint_step(checkpoint_dir)
    out: Dict[str, Any] = {
        "directory": os.path.abspath(checkpoint_dir), "step": step}
    if step is not None:
        out["manifest"] = _ser.checkpoint_manifest(checkpoint_dir, step)
        out["verify"] = _ser.verify_checkpoint(checkpoint_dir, step)
    return out


def _trace_section(rings: Dict[str, List[Dict]]) -> Dict[str, Any]:
    ctx = _trace.current_context()
    spans = rings.get("span") or []
    active = None
    if ctx is not None:
        active = dict(ctx.to_fields())
        active["sampled"] = bool(ctx.sampled)
        spans = [s for s in spans if s.get("trace_id") == ctx.trace_id] or spans
    return {"context": active, "spans": spans[-64:]}


_dump_lock = threading.Lock()


def dump_postmortem(reason: str, *,
                    run_dir: Optional[str] = None,
                    telemetry=None,
                    recorder: Optional[FlightRecorder] = None,
                    error: Optional[BaseException] = None,
                    checkpoint_dir: Optional[str] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    max_dumps: Optional[int] = None) -> Optional[str]:
    """Write one verified postmortem bundle; return its path (None when no
    run dir resolves, the per-run budget is spent, or the dump itself
    failed — this function NEVER raises and never adds a device sync).

    Layout (every payload first, ``MANIFEST.json`` sealed LAST):

    - ``rings/<type>.jsonl`` — flight-recorder tails (or, unarmed, the
      telemetry ``.ring`` grouped by type)
    - ``stacks.txt`` — per-thread Python stacks at dump time
    - ``trace.json`` — active :class:`TraceContext` + its recent spans
    - ``fingerprint.json`` — env/config/mesh/XLA-flags identity
    - ``fleet.json`` — heartbeat snapshot of every process in the run dir
    - ``perf_baseline.json`` — last step vs ``PERF_BASELINE.json``
    - ``checkpoint.json`` — newest verified checkpoint's manifest pointer
    - ``reason.json`` — reason, error + traceback, ring/truncation
      counts, dump latency

    When ``telemetry`` is passed, a ``{"type": "postmortem", ...}`` record
    is emitted back into the stream after the bundle seals, so the live
    JSONL's last record names the bundle that explains the death."""
    t0 = time.perf_counter()
    try:
        root = _resolve_run_dir(run_dir)
        if root is None:
            return None
        pm_root = os.path.join(root, POSTMORTEM_DIRNAME)
        with _dump_lock:
            os.makedirs(pm_root, exist_ok=True)
            existing = [
                d for d in os.listdir(pm_root)
                if d != HARD_CRASH_DIRNAME
                and os.path.isdir(os.path.join(pm_root, d))
            ]
            cap = max_dumps if max_dumps is not None else int(
                os.environ.get("BIGDL_POSTMORTEM_MAX", _DEFAULT_MAX_DUMPS))
            if len(existing) >= cap:
                return None
            seq, slug = len(existing), _sanitize(reason)
            bundle = os.path.join(pm_root, "%03d-%s" % (seq, slug))
            while os.path.exists(bundle):
                seq += 1
                bundle = os.path.join(pm_root, "%03d-%s" % (seq, slug))
            os.makedirs(bundle)

        rec = recorder or get_recorder()
        if rec is not None:
            rings = rec.snapshot()
            counts = rec.counts()
        else:
            rings, counts = {}, {}
            ring = getattr(telemetry, "ring", None)
            for r in (ring.records if ring is not None else []):
                rings.setdefault(r.get("type") or "untyped", []).append(r)
            counts = {t: {"seen": len(v), "kept": len(v)}
                      for t, v in rings.items()}

        def _write_json(name: str, payload: Any) -> None:
            try:
                with open(os.path.join(bundle, name), "w") as f:
                    json.dump(payload, f, indent=1, sort_keys=True,
                              default=repr)
            except Exception:  # a partial bundle beats none
                pass

        try:
            rings_dir = os.path.join(bundle, "rings")
            os.makedirs(rings_dir, exist_ok=True)
            for rtype, records in sorted(rings.items()):
                with open(os.path.join(
                        rings_dir, "%s.jsonl" % _sanitize(rtype)), "w") as f:
                    for r in records:
                        f.write(json.dumps(r, default=repr) + "\n")
        except Exception:  # a partial bundle beats none
            pass
        try:
            with open(os.path.join(bundle, "stacks.txt"), "w") as f:
                f.write(_thread_stacks())
        except Exception:  # a partial bundle beats none
            pass
        try:
            _write_json("trace.json", _trace_section(rings))
        except Exception:  # a partial bundle beats none
            pass
        _write_json("fingerprint.json", _fingerprint())
        try:
            beats = _fleet.read_heartbeats(root)
            _write_json("fleet.json",
                        {str(k): v for k, v in sorted(beats.items())})
        except Exception:  # a partial bundle beats none
            pass
        try:
            perf = _perf_comparison(rings)
            if perf is not None:
                _write_json("perf_baseline.json", perf)
        except Exception:  # a partial bundle beats none
            pass
        try:
            ckpt = _checkpoint_pointer(checkpoint_dir)
            if ckpt is not None:
                _write_json("checkpoint.json", ckpt)
        except Exception:  # a partial bundle beats none
            pass

        truncated = sum(
            max(0, c["seen"] - c["kept"]) for c in counts.values())
        records_kept = sum(c["kept"] for c in counts.values())
        reason_payload: Dict[str, Any] = {
            "reason": str(reason),
            "ts": t0,
            "rings": counts,
            "records": records_kept,
            "truncated": truncated,
        }
        if error is not None:
            reason_payload["error"] = {
                "class": type(error).__name__,
                "repr": repr(error),
                "traceback": "".join(traceback.format_exception(
                    type(error), error, error.__traceback__)),
            }
        if extra:
            reason_payload["extra"] = extra
        reason_payload["dump_latency_s"] = round(
            time.perf_counter() - t0, 6)
        _write_json("reason.json", reason_payload)

        # seal: manifest LAST, tmp+rename — the verify-on-load contract
        from ..utils.serialization import file_digest
        files: Dict[str, Dict[str, Any]] = {}
        for dirpath, _dirnames, filenames in os.walk(bundle):
            for fn in sorted(filenames):
                fp = os.path.join(dirpath, fn)
                rel = os.path.relpath(fp, bundle)
                digest, size = file_digest(fp)
                files[rel] = {"sha256": digest, "bytes": size}
        manifest = {
            "format": BUNDLE_FORMAT,
            "reason": str(reason),
            "ts": t0,
            "files": files,
        }
        mpath = os.path.join(bundle, MANIFEST_NAME)
        with open(mpath + ".tmp", "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        os.replace(mpath + ".tmp", mpath)

        if telemetry is not None:
            try:
                telemetry.emit({
                    "type": "postmortem",
                    "reason": str(reason),
                    "bundle": bundle,
                    "dump_latency_s": reason_payload["dump_latency_s"],
                    "rings": len(counts),
                    "records": records_kept,
                    "truncated": truncated,
                })
                telemetry.flush()
            except Exception:  # the bundle is sealed
                pass
        return bundle
    except Exception:
        return None


# --------------------------------------------------------------------------
# verify-on-load
# --------------------------------------------------------------------------

def verify_bundle(path: str) -> Dict[str, Any]:
    """Hash-verify a bundle against its manifest; return the manifest.
    Raises :class:`BundleTruncated` (missing/short) or
    :class:`BundleTampered` (checksum/format mismatch)."""
    mpath = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        raise BundleTruncated(
            "%s: %s is missing (writer died before sealing, or this is a "
            "hard-crash artifact — see %s/)" % (
                path, MANIFEST_NAME, HARD_CRASH_DIRNAME))
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise BundleTruncated("%s: unreadable manifest (%s)" % (path, e))
    if manifest.get("format") != BUNDLE_FORMAT:
        raise BundleTampered(
            "%s: format %r is not %r" % (
                path, manifest.get("format"), BUNDLE_FORMAT))
    from ..utils.serialization import file_digest
    for rel, meta in sorted((manifest.get("files") or {}).items()):
        fp = os.path.join(path, rel)
        if not os.path.exists(fp):
            raise BundleTruncated("%s: %s is missing" % (path, rel))
        digest, size = file_digest(fp)
        if size != meta.get("bytes"):
            raise BundleTruncated(
                "%s: %s is %d bytes, manifest says %s (truncated?)"
                % (path, rel, size, meta.get("bytes")))
        if digest != meta.get("sha256"):
            raise BundleTampered(
                "%s: %s content checksum mismatch" % (path, rel))
    return manifest


def load_bundle(path: str) -> Dict[str, Any]:
    """Verify then load a bundle into memory:
    ``{"path", "manifest", "rings": {type: [records]}, "reason",
    "fingerprint", "trace", "fleet", "perf_baseline", "checkpoint",
    "stacks"}`` (absent sections -> None/{})."""
    manifest = verify_bundle(path)
    out: Dict[str, Any] = {"path": os.path.abspath(path),
                           "manifest": manifest, "rings": {}}
    for rel in manifest.get("files") or {}:
        if rel.startswith("rings" + os.sep) and rel.endswith(".jsonl"):
            rtype = os.path.basename(rel)[:-len(".jsonl")]
            with open(os.path.join(path, rel)) as f:
                out["rings"][rtype] = [
                    json.loads(line) for line in f if line.strip()]
    for name in ("reason", "fingerprint", "trace", "fleet",
                 "perf_baseline", "checkpoint"):
        fp = os.path.join(path, name + ".json")
        if os.path.exists(fp):
            with open(fp) as f:
                out[name] = json.load(f)
        else:
            out[name] = None
    stacks = os.path.join(path, "stacks.txt")
    if os.path.exists(stacks):
        with open(stacks) as f:
            out["stacks"] = f.read()
    else:
        out["stacks"] = None
    return out
