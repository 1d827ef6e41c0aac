"""The scrape endpoint: ``/healthz``, ``/metrics``, ``/telemetry/tail``,
``/trace`` (counterpart of ``bigdl_tpu/obs/export.py``; the port's own copy,
the same routes, status codes and Prometheus text).

One small stdlib ``http.server`` a process: a router polls ``/healthz`` for
each model's readiness (``ModelServer.health()``), Prometheus scrapes
``/metrics`` for the gauges the telemetry ring already holds (step, loss,
throughput, queue depth, breaker state, rolling latency percentiles,
restarts), an operator reads ``/telemetry/tail?n=`` and one causal trace at
``/trace?id=<trace_id>`` (or ``/trace/<trace_id>``).

It serves only host state, the rings' records and the health snapshots, so
a scrape makes no device call and never waits for the card. Its thread is
started through ``serving/resilience.spawn_worker``.

Attach with ``Engine.set_metrics_port(port)`` (every ``Telemetry`` then
attaches its ring) or ``ModelServer(metrics_port=)`` (a replica's health and
serve records). ``port=0`` binds a free port; read it from
:attr:`ObsEndpoint.port`.
"""

from __future__ import annotations

import json
import logging
import threading
import weakref
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger("bigdl_tpu_torch.obs")

__all__ = ["ObsEndpoint", "ensure_default", "default_endpoint",
           "close_default", "render_prometheus"]


def _label_escape(v: object) -> str:
    return (
        str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")
    )


def _fmt(name: str, value, labels: Dict[str, object],
         lines: List[str], types: Dict[str, str], kind: str = "gauge",
         help_text: str = "") -> None:
    if value is None:
        return
    if name not in types:
        types[name] = kind
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
    lab = ",".join(
        f'{k}="{_label_escape(v)}"' for k, v in labels.items() if v is not None
    )
    try:
        num = float(value)
    except (TypeError, ValueError):
        return
    if num == int(num):
        out = str(int(num))
    else:
        out = repr(num)
    lines.append(f"{name}{{{lab}}}" if lab else name)
    lines[-1] += f" {out}"


def _percentile(sorted_vals: List[float], p: float) -> Optional[float]:
    if not sorted_vals:
        return None
    import math

    rank = max(1, math.ceil(p / 100.0 * len(sorted_vals)))
    return sorted_vals[rank - 1]


def render_prometheus(records: List[Dict], health: Optional[Dict],
                      identity: Dict[str, object]) -> str:
    """Prometheus text exposition (0.0.4) of the ring's records and the
    health snapshot. Cumulative counters come from cumulative fields of the
    latest records (iteration, total_compiles, deadline_missed, ...), never
    from summing the ring, which is bounded."""
    base = {
        "process": identity.get("process_index", 0),
        "host": identity.get("host"),
    }
    lines: List[str] = []
    types: Dict[str, str] = {}

    steps = [r for r in records if r.get("type") == "step"]
    if steps:
        last = steps[-1]
        _fmt("bigdl_step", last.get("iteration"), base, lines, types,
             "counter", "latest training iteration")
        _fmt("bigdl_epoch", last.get("epoch"), base, lines, types)
        _fmt("bigdl_loss", last.get("loss"), base, lines, types)
        _fmt("bigdl_records_per_sec", last.get("records_per_sec"),
             base, lines, types)
        _fmt("bigdl_input_qdepth", last.get("input_qdepth"), base, lines,
             types)
        window = steps[-256:]
        walls = sorted(
            float(s["wall_s"]) for s in window if s.get("wall_s")
        )
        for q, p in (("0.5", 50.0), ("0.99", 99.0)):
            _fmt("bigdl_step_wall_seconds", _percentile(walls, p),
                 dict(base, quantile=q), lines, types, "gauge",
                 "rolling step wall percentiles over the ring window")
        waits = [
            (float(s["input_wait_s"]), float(s["wall_s"]))
            for s in window[1:]
            if s.get("input_wait_s") is not None and s.get("wall_s")
        ]
        if waits:
            tot_wall = sum(w for _, w in waits)
            _fmt("bigdl_input_starved_pct",
                 round(100.0 * sum(w for w, _ in waits) / tot_wall, 3)
                 if tot_wall else 0.0,
                 base, lines, types, "gauge",
                 "input-pipeline wait as pct of step wall (ring window)")
        _fmt("bigdl_mfu", last.get("mfu"), base, lines, types, "gauge",
             "model FLOPs utilization of the latest step (None-less on "
             "backends without a peak entry)")
        _fmt("bigdl_achieved_flops_per_sec", last.get("achieved_flops_s"),
             base, lines, types)
        _fmt("bigdl_model_flops", last.get("model_flops"), base, lines,
             types, "gauge", "cost-model flops of one compiled step")
    # latest perf record: the windowed decomposition + roofline surface
    perfs = [r for r in records if r.get("type") == "perf"]
    if perfs:
        lastp = perfs[-1]
        _fmt("bigdl_perf_mfu", lastp.get("mfu"), base, lines, types, "gauge",
             "windowed MFU from the latest perf record")
        _fmt("bigdl_perf_wall_mean_seconds", lastp.get("wall_mean_s"),
             base, lines, types)
        _fmt("bigdl_arithmetic_intensity",
             lastp.get("arithmetic_intensity"), base, lines, types, "gauge",
             "program flops per HBM byte (roofline x-axis)")
        _fmt("bigdl_roofline_compute_bound",
             None if lastp.get("bound") is None
             else (1 if lastp["bound"] == "compute" else 0),
             base, lines, types, "gauge",
             "1 = compute-bound, 0 = bandwidth-bound (absent = unknown)")
        _fmt("bigdl_collective_bytes_per_step",
             lastp.get("collective_bytes"), base, lines, types)
        for comp, v in sorted((lastp.get("breakdown") or {}).items()):
            _fmt("bigdl_step_component_seconds", v,
                 dict(base, component=comp[:-2] if comp.endswith("_s")
                      else comp),
                 lines, types, "gauge",
                 "windowed compute/comms/input/host step-time decomposition")
    compiles = [r for r in records if r.get("type") == "compile"]
    if compiles:
        _fmt("bigdl_compile_total", compiles[-1].get("total_compiles"),
             base, lines, types, "counter")
    _fmt("bigdl_stall_ring_total",
         sum(1 for r in records if r.get("type") == "stall") or None,
         base, lines, types, "counter",
         "stall records currently held by the ring (bounded window)")
    _fmt("bigdl_warn_ring_total",
         sum(1 for r in records if r.get("type") == "warn") or None,
         base, lines, types, "counter",
         "warn records currently held by the ring (bounded window)")

    # latest serve record per model: rolling latency + flush-time gauges
    last_serve: Dict[str, Dict] = {}
    for r in records:
        if r.get("type") == "serve" and r.get("model"):
            last_serve[r["model"]] = r
    for model, r in sorted(last_serve.items()):
        mlab = dict(base, model=model)
        _fmt("bigdl_serve_queue_depth", r.get("queue_depth"), mlab, lines,
             types)
        _fmt("bigdl_serve_batch_fill", r.get("batch_fill"), mlab, lines,
             types)
        _fmt("bigdl_serve_p50_ms", r.get("p50_ms"), mlab, lines, types,
             "gauge", "rolling end-to-end latency p50")
        _fmt("bigdl_serve_p99_ms", r.get("p99_ms"), mlab, lines, types,
             "gauge", "rolling end-to-end latency p99")
        _fmt("bigdl_serve_rps", r.get("rps"), mlab, lines, types)
        _fmt("bigdl_serve_mfu", r.get("mfu"), mlab, lines, types, "gauge",
             "rolling achieved-vs-bucket-cost MFU of this model")
        _fmt("bigdl_serve_achieved_flops_per_sec",
             r.get("achieved_flops_s"), mlab, lines, types)
        _fmt("bigdl_serve_flushes_total", r.get("iteration"), mlab, lines,
             types, "counter")
        _fmt("bigdl_serve_shed_total", r.get("shed"), mlab, lines, types,
             "counter", "submits shed by an open circuit breaker")

    # per-model health snapshot: readiness the sharder routes on
    for model, snap in sorted((health or {}).items()):
        mlab = dict(base, model=model)
        state = snap.get("state")
        _fmt("bigdl_model_ready", 1 if _routable(state) else 0, mlab,
             lines, types, "gauge",
             "1 = a request-stream sharder may route traffic here")
        _fmt("bigdl_model_restarts_total", snap.get("restarts"), mlab,
             lines, types, "counter")
        _fmt("bigdl_model_queue_depth", snap.get("queue_depth"), mlab,
             lines, types)
        _fmt("bigdl_model_pending", snap.get("pending"), mlab, lines, types)
        _fmt("bigdl_deadline_missed_total", snap.get("deadline_missed"),
             mlab, lines, types, "counter")
        _fmt("bigdl_rejected_total", snap.get("rejected"), mlab, lines,
             types, "counter")
        br = snap.get("breaker")
        if br is not None:
            _fmt("bigdl_breaker_open",
                 0 if br.get("state") == "closed" else 1, mlab, lines,
                 types, "gauge", "0 = breaker closed, 1 = open/half-open")
    return "\n".join(lines) + "\n" if lines else "\n"


def _routable(state) -> bool:
    """A model state a router may send traffic to: the serving tier's
    ``ROUTABLE_STATES``."""
    from ..serving.resilience import ROUTABLE_STATES

    return state in ROUTABLE_STATES


class ObsEndpoint:
    """One process's scrape surface; binds ``host:port`` at :meth:`start`.

    Routes:

    * ``GET /healthz`` — readiness/liveness JSON: process identity, attached
      model health (``ModelServer.health()`` snapshots), last-step summary.
      HTTP 200 while routable (every attached model in a routable state, or
      no serving attached), 503 otherwise — a k8s/sharder probe needs only
      the status code.
    * ``GET /metrics`` — Prometheus text (:func:`render_prometheus`).
    * ``GET /telemetry/tail?n=K`` — last K ring records as a JSON array
      (default 50).
    * ``GET /trace?id=<trace_id>`` or ``GET /trace/<trace_id>`` — all
      ring-held ``span`` records of one causal trace (typed 404 on miss,
      400 on a malformed id).

    Everything is served from in-memory state (ring buffers, health
    snapshot callables); a malformed request gets a 4xx and the server
    keeps serving — it must survive any scraper.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._requested_port = int(port)
        self._host = host
        self._lock = threading.Lock()
        # WEAK refs: a long-lived process-default endpoint must not pin
        # every Telemetry a short-lived fit/server ever constructed (each
        # ring holds up to ring_capacity records) — a collected sink simply
        # drops out of the scrape
        self._telemetry: Dict[int, "weakref.ref"] = {}
        self._health_fns: Dict[str, Callable[[], Dict]] = {}
        self._server = None
        self._thread = None

    # ---------------------------------------------------------------- wiring
    def attach_telemetry(self, telemetry, name: str = "train") -> None:
        """Expose a :class:`~bigdl_tpu_torch.obs.telemetry.Telemetry`'s ring on
        this endpoint (idempotent per sink; held weakly). Only the ring is
        read — the endpoint adds no exporter, so the hot emit path is
        untouched."""
        with self._lock:
            # no weakref callback: a GC-time dict mutation could race (or
            # deadlock on) the non-reentrant lock — dead refs are pruned on
            # the next snapshot instead
            self._telemetry[id(telemetry)] = weakref.ref(telemetry)

    def detach_telemetry(self, telemetry) -> None:
        with self._lock:
            self._telemetry.pop(id(telemetry), None)

    def attach_health(self, fn: Callable[[], Dict],
                      name: str = "serve") -> None:
        """Register a health-snapshot callable (``ModelServer.health``):
        called per ``/healthz``/``/metrics`` request on the scrape thread —
        it must be a pure host-side read (the serving contract already
        guarantees this)."""
        with self._lock:
            self._health_fns[name] = fn

    def detach_health(self, name: str = "serve") -> None:
        with self._lock:
            self._health_fns.pop(name, None)

    # -------------------------------------------------------------- snapshot
    def _sinks(self) -> List[object]:
        with self._lock:
            sinks, dead = [], []
            for key, ref in self._telemetry.items():
                tel = ref()
                if tel is None:
                    dead.append(key)  # collected sink: prune on access
                else:
                    sinks.append(tel)
            for key in dead:
                del self._telemetry[key]
        return sinks

    def _records(self) -> List[Dict]:
        out: List[Dict] = []
        for tel in self._sinks():
            for _ in range(3):
                try:
                    out.extend(tel.ring.records)
                    break
                except RuntimeError:  # ring mutated mid-copy: retry
                    continue
        return out

    def _health(self) -> Tuple[Optional[Dict], Optional[str]]:
        with self._lock:
            fns = dict(self._health_fns)
        if not fns:
            return None, None
        merged: Dict[str, Dict] = {}
        for name, fn in fns.items():
            try:
                merged.update(fn() or {})
            except Exception as e:  # surface, never crash the scrape plane
                log.exception("health snapshot %r failed during scrape", name)
                return None, f"{name}: {type(e).__name__}: {e}"
        return merged, None

    def _identity(self) -> Dict[str, object]:
        # THIS process's identity comes from the attached sinks' captured
        # identity — never from scanning ring records, whose tags can name
        # another process (a FleetMonitor straggler warn carries the FLAGGED
        # process's index; taking it here would label every gauge with the
        # straggler's identity)
        for tel in self._sinks():
            ident = getattr(tel, "identity", None)
            if isinstance(ident, dict) and "process_index" in ident:
                return dict(ident)
        from . import fleet

        return fleet.process_identity()

    def healthz(self) -> Tuple[int, Dict]:
        """(status_code, body) of ``/healthz`` — also directly callable in
        tests/REPL without a socket."""
        models, err = self._health()
        identity = self._identity()
        recs = self._records()
        last_step = None
        for r in reversed(recs):
            if r.get("type") == "step":
                last_step = {
                    "iteration": r.get("iteration"),
                    "epoch": r.get("epoch"),
                    "loss": r.get("loss"),
                    "ts": r.get("ts"),
                }
                break
        if err is not None:
            return 500, {"ready": False, "error": err, **identity}
        ready = models is None or all(
            _routable(m.get("state")) for m in models.values()
        )
        body = {
            "ready": bool(ready),
            "models": models,
            "last_step": last_step,
            "records": len(recs),
        }
        body.update(identity)
        return (200 if ready else 503), body

    def metrics_text(self) -> str:
        models, _ = self._health()
        return render_prometheus(self._records(), models, self._identity())

    def tail(self, n: int = 50) -> List[Dict]:
        recs = self._records()
        return recs[-max(0, int(n)):]

    def trace(self, trace_id: str) -> Tuple[int, Dict]:
        """(status_code, body) of ``/trace?id=<trace_id>`` — every ring-held
        ``span`` record of one causal trace, oldest first, plus any flush
        span that LINKS the trace (a serve_flush carries its members in
        ``links``). Typed 404 when no attached ring holds the id; 400 on a
        malformed id — directly callable in tests/REPL without a socket."""
        tid = "" if trace_id is None else str(trace_id)
        # ids are <8 hex>-<8 hex> (obs.trace), but the check only guards
        # against junk (control chars / absurd length) so replayed or
        # foreign streams with their own id scheme still resolve
        if not (0 < len(tid) <= 128) or not all(
            c.isalnum() or c in "-_.:" for c in tid
        ):
            return 400, {"error": "malformed trace id"}
        spans = []
        for r in self._records():
            if r.get("type") != "span":
                continue
            if r.get("trace_id") == tid or any(
                l.get("trace_id") == tid for l in r.get("links") or ()
            ):
                spans.append(r)
        if not spans:
            return 404, {"error": f"trace {tid!r} not held by any "
                                  "attached ring", "trace_id": tid}
        spans.sort(key=lambda r: r.get("ts") or 0)
        return 200, {"trace_id": tid, "spans": spans, "count": len(spans)}

    # ------------------------------------------------------------- lifecycle
    def start(self) -> int:
        """Bind and serve; returns the bound port. Idempotent."""
        with self._lock:
            if self._server is not None:
                return self.port
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import parse_qs, unquote, urlparse

        endpoint = self

        class Handler(BaseHTTPRequestHandler):
            # the scrape plane logs through the obs logger, not stderr
            def log_message(self, fmt, *args):  # noqa: N802
                log.debug("obs endpoint: " + fmt, *args)

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, code: int, obj) -> None:
                self._send(
                    code, json.dumps(obj, default=str).encode("utf-8"),
                    "application/json",
                )

            def do_GET(self):  # noqa: N802
                try:
                    url = urlparse(self.path)
                    if url.path == "/healthz":
                        code, body = endpoint.healthz()
                        self._send_json(code, body)
                    elif url.path == "/metrics":
                        self._send(
                            200, endpoint.metrics_text().encode("utf-8"),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif url.path == "/telemetry/tail":
                        q = parse_qs(url.query)
                        try:
                            n = int(q.get("n", ["50"])[0])
                            if n < 0:
                                raise ValueError(n)
                        except ValueError:
                            self._send_json(
                                400, {"error": "n must be a non-negative int"}
                            )
                            return
                        self._send_json(200, endpoint.tail(n))
                    elif url.path == "/trace":
                        q = parse_qs(url.query)
                        ids = q.get("id", [])
                        if len(ids) != 1:
                            self._send_json(
                                400,
                                {"error": "exactly one id= parameter "
                                          "required"},
                            )
                            return
                        code, body = endpoint.trace(ids[0])
                        self._send_json(code, body)
                    elif url.path.startswith("/trace/"):
                        code, body = endpoint.trace(unquote(url.path[len("/trace/"):]))
                        self._send_json(code, body)
                    else:
                        self._send_json(
                            404,
                            {"error": f"unknown path {url.path!r}",
                             "routes": ["/healthz", "/metrics",
                                        "/telemetry/tail?n=",
                                        "/trace?id=", "/trace/<id>"]},
                        )
                except BrokenPipeError:  # scraper hung up mid-response
                    pass
                except Exception:  # any handler fault: 500, keep serving
                    log.exception("obs endpoint request failed")
                    try:
                        self._send_json(500, {"error": "internal error"})
                    except Exception:  # the socket died mid-response: nothing left to tell
                        log.debug("obs endpoint 500 response failed too")

        server = ThreadingHTTPServer(
            (self._host, self._requested_port), Handler
        )
        server.daemon_threads = True
        with self._lock:
            self._server = server
        from ..serving.resilience import spawn_worker

        self._thread = spawn_worker(
            server.serve_forever, name=f"bigdl-obs-endpoint-{self.port}"
        )
        log.info("obs endpoint serving on http://%s:%d "
                 "(/healthz /metrics /telemetry/tail /trace)",
                 self._host, self.port)
        return self.port

    @property
    def port(self) -> Optional[int]:
        s = self._server
        return None if s is None else s.server_address[1]

    def url(self, path: str = "/") -> str:
        return f"http://{self._host}:{self.port}{path}"

    def close(self) -> None:
        with self._lock:
            server, self._server = self._server, None
            thread, self._thread = self._thread, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)


# --------------------------------------------------------------------------
# process-default endpoint (Engine.set_metrics_port)
# --------------------------------------------------------------------------

_default: Optional[ObsEndpoint] = None
_default_lock = threading.Lock()


def ensure_default(port: int) -> ObsEndpoint:
    """Start (or return) the process-default endpoint — the
    ``Engine.set_metrics_port`` target every new ``Telemetry`` auto-attaches
    its ring to. A port change closes and re-binds."""
    global _default
    with _default_lock:
        if _default is not None and _default._requested_port != int(port):
            _default.close()
            _default = None
        if _default is None:
            _default = ObsEndpoint(port)
        _default.start()
        return _default


def default_endpoint() -> Optional[ObsEndpoint]:
    return _default


def close_default() -> None:
    global _default
    with _default_lock:
        if _default is not None:
            _default.close()
            _default = None
