"""Continuous batching over one :class:`~bigdl_tpu_torch.optim.predictor.Predictor`
(counterpart of ``bigdl_tpu/serving/batcher.py``).

One batching thread per hosted model runs the admit→flush loop: requests
wait in a :class:`~bigdl_tpu_torch.serving.queue.RequestQueue` grouped by
shape bucket; a group flushes when
``Trigger.or_(Trigger.pending_at_least(max_batch), Trigger.waited_ms(max_delay_ms))``
(or a custom trigger) fires, oldest group first. A flush pads each record to
its bucket, stacks, dispatches through ``Predictor.forward_batch`` and
resolves each request's future with its own row of the output, still on the
device. The batching thread never copies a result to the host: each caller
does that for its own row in ``ServeFuture.result``.

Around that loop, the JAX runtime's serving contract: request deadlines
(swept from the queue before every trigger evaluation, checked again at the
flush seam), admission control (``max_pending``), a per-model circuit
breaker consulted on the caller's thread, worker liveness for the
supervisor (heartbeat, restart, fail-pending), hot-swap (:meth:`swap`: the
in-flight batch drains first, every future resolves on the version that
dispatched it, the old predictor is kept until its last future is
materialized), one ``serve`` telemetry record per flush and
:meth:`health_snapshot`. The chaos seams are the JAX package's:
``serve_admission`` in :meth:`ContinuousBatcher.submit` (the caller's
thread), ``serve_worker`` at the top of the batching loop (a raise there
kills the worker), ``serve_assembly`` and ``serve_dispatch`` as spans
around the stack and ``Predictor.forward_batch`` (a raise there fails the
flush's requests), ``serve_materialize`` in ``ServeFuture.result``; the
worker records its spans into the telemetry's collector.

Causal request spans: each request's trace context is rooted at submit on
the caller's thread (a child of the caller's own context when one is
bound); a flush has a context of its own whose ``serve_flush`` span links
its members. When a request is materialized, its ``serve_request`` span and
the four stage spans (queue, assembly, dispatch, materialize: they sum to
the total) are emitted if the trace was sampled or the request was slower
than the slow threshold (promoted). Activation drift: with ``drift`` set,
every ``drift_every`` flushes the predictor's captured state is sampled
(one copy to the host of one small matrix) and a breach is a ``warn``.
Bucket costs (derived by the server at registration) stamp each serve
record with the flush's FLOPs and the rolling achieved FLOP/s and MFU,
plain arithmetic on this thread.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..obs import trace as obs_trace
from ..obs.trace import fault_point, span
from ..optim.trigger import Trigger
from ..resilience.errors import CircuitOpen, DeadlineExceeded
from .queue import (AdmissionRejected, RequestQueue, ServeFuture, ServeRequest,
                    ServerClosed, ServingStopped, WorkerCrashed)
from .resilience import BreakerConfig, CircuitBreaker, spawn_worker

log = logging.getLogger("bigdl_tpu_torch.serving")

__all__ = ["ServeStats", "ContinuousBatcher"]


def _nearest_rank(sorted_vals: List[float], p: float) -> float:
    """Nearest-rank percentile over a sorted list (the JAX package's
    convention, so the serve records and a report agree)."""
    rank = max(1, -(-int(p * len(sorted_vals)) // 100))
    return sorted_vals[rank - 1]


class ServeStats:
    """Rolling window of completed request latencies (enqueue →
    materialized, reported by each future's done-callback on the caller's
    thread): the serve record's p50/p99/requests-per-second."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._window = window
        self._lat: List[Any] = []  # (t_done, latency_s), bounded FIFO
        self.completed = 0

    def complete(self, latency_s: float, now: float) -> None:
        with self._lock:
            self._lat.append((now, latency_s))
            if len(self._lat) > self._window:
                del self._lat[: len(self._lat) - self._window]
            self.completed += 1

    def summary(self, now: float):
        """``(p50_ms, p99_ms, rps)`` over the window; Nones until the first
        completion lands."""
        with self._lock:
            snap = list(self._lat)
        if not snap:
            return None, None, None
        lats = sorted(lat for _, lat in snap)
        span_s = now - snap[0][0]
        rps = len(snap) / span_s if span_s > 1e-9 else None
        return _nearest_rank(lats, 50) * 1e3, _nearest_rank(lats, 99) * 1e3, rps


def _weak_transition(batcher: "ContinuousBatcher"):
    """``batcher._breaker_transition`` without a strong reference to it."""
    ref = weakref.ref(batcher)

    def on_transition(old: str, new: str, info: Dict) -> None:
        b = ref()
        if b is not None:
            b._breaker_transition(old, new, info)

    return on_transition


class ContinuousBatcher:
    """The per-model batching engine (used via ``ModelServer``).

    Args:
        predictor: the dispatch seam (``forward_batch``); its ``batch_size``
            and ``shape_buckets`` define the padding geometry.
        name: model name on the serve records.
        version: model version of the initial predictor.
        max_batch: flush size bound (at most ``predictor.batch_size``, its
            default).
        max_delay_ms: a request never waits longer than this for companions.
        max_pending: admission bound of the queue (``AdmissionRejected``).
        deadline_ms: per-model default request deadline (from enqueue).
        breaker: ``None`` arms ``BreakerConfig`` defaults, ``False`` none,
            or a ``BreakerConfig`` / ``CircuitBreaker``.
        flush_trigger: replaces the default trigger; evaluated per bucket
            group on ``{"pending": n, "waited_ms": t}``.
        telemetry: a :class:`~bigdl_tpu_torch.obs.telemetry.Telemetry` sink.
        drift: an :class:`~bigdl_tpu_torch.obs.health.ActivationDrift`
            (over a ``capture_state=True`` predictor), sampled every
            ``drift_every`` flushes.
        tags: fields merged into every serve record: a flush's record
            carries the tags of the version that dispatched it (``swap``
            replaces them with the predictor).
        bucket_costs: ``{bucket: {"flops", "flops_per_record",
            "peak_flops_total"}}`` (``obs/perf.py``
            ``predictor_bucket_costs``) for the serve records' cost fields.
        clock: monotonic clock of the heartbeat and health timestamps (the
            supervisor's time domain).
    """

    def __init__(self, predictor, *, name: str = "model", version: int = 1,
                 max_batch: Optional[int] = None, max_delay_ms: float = 10.0,
                 max_pending: Optional[int] = None, deadline_ms: Optional[float] = None,
                 breaker=None, flush_trigger: Optional[Trigger] = None, telemetry=None,
                 drift=None, drift_every: int = 32, tags: Optional[Dict] = None,
                 clock=time.monotonic, bucket_costs: Optional[Dict] = None):
        self.predictor = predictor
        self.name = name
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be positive, got {deadline_ms}")
        self.deadline_ms = deadline_ms
        if breaker is False:
            self.breaker: Optional[CircuitBreaker] = None
        elif isinstance(breaker, CircuitBreaker):
            self.breaker = breaker
        else:
            if breaker is not None and not isinstance(breaker, BreakerConfig):
                raise ValueError(f"breaker must be a BreakerConfig, CircuitBreaker, False "
                                 f"or None, got {breaker!r}")
            # the breaker reaches its batcher through a weak reference: a bound
            # method would make batcher -> breaker -> batcher a cycle, leaving
            # the predictor and its model's weights to the cyclic collector
            # after stop()
            self.breaker = CircuitBreaker(breaker, on_transition=_weak_transition(self))
        self._clock = clock
        self.max_batch = int(max_batch or predictor.batch_size)
        if not 0 < self.max_batch <= predictor.batch_size:
            raise ValueError(f"max_batch {max_batch} outside (0, batch_size="
                             f"{predictor.batch_size}]")
        self.max_delay_ms = max_delay_ms
        self._custom_trigger = flush_trigger
        self.flush_trigger = flush_trigger or Trigger.or_(
            Trigger.pending_at_least(self.max_batch), Trigger.waited_ms(max_delay_ms))
        self.telemetry = telemetry
        self.drift = drift
        self.drift_every = max(1, int(drift_every))
        self._drift_warned = False
        self.tags = dict(tags or {})
        self.bucket_costs = dict(bucket_costs or {})
        self.queue = RequestQueue(max_pending)
        self.stats = ServeStats()
        self._version = int(version)
        self._swap_lock = threading.RLock()  # hot-lock: dispatch vs hot-swap exclusion
        self._acct_lock = threading.Lock()
        self._rejected = 0  # cumulative admission rejects
        self._deadline_missed = 0  # cumulative expired requests
        self._swept = 0  # cumulative expired-in-queue sweeps
        self._outstanding: Dict[int, int] = {}  # version -> unmaterialized futures
        self._retired: Dict[int, Any] = {}  # version -> predictor kept alive
        # every admitted, unresolved future: what stop()/fail_pending() walk
        # so no caller is left blocked, popped-in-flight ones included
        self._pending_futs: set = set()
        self.flushes = 0
        self._stop = threading.Event()
        self._drain = True
        self._thread: Optional[threading.Thread] = None
        self._trigger_warned = False
        # supervision state (ServingSupervisor protocol)
        self._last_beat: Optional[float] = None
        self._last_flush_at: Optional[float] = None
        self.restarts = 0
        self._failed: Optional[str] = None
        self._wedged = False
        # with no deadline ever armed, the per-tick sweep is a no-op
        self._deadlines_armed = deadline_ms is not None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        t = self._thread
        if t is not None and t.is_alive():
            return
        # a worker that wedges before its first loop-top beat still ages out
        self._last_beat = self._clock()
        self._thread = spawn_worker(self._run, name=f"bigdl-serve-{self.name}")

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the batching thread; ``drain=True`` serves queued requests
        first. Every future still unresolved when the join window closes is
        failed with :class:`ServerClosed`, never left waiting."""
        self._drain = drain
        self._stop.set()
        self.queue.wake()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self.queue.close()
        self.fail_pending(ServerClosed(f"model {self.name!r} stopped"))

    # --------------------------------------------- supervision (resilience)
    def stopped(self) -> bool:
        return self._stop.is_set()

    def worker_alive(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def last_beat(self) -> Optional[float]:
        """Last loop-top heartbeat, in the ``clock`` domain."""
        return self._last_beat

    def fail_pending(self, exc: BaseException) -> int:
        """Fail every unresolved future (queued and popped in flight) with
        ``exc``; returns how many this call failed."""
        n = 0
        for r in self.queue.pop_all():
            n += r.future.set_exception(exc, self._version)
        with self._acct_lock:
            futs = list(self._pending_futs)
        for f in futs:
            n += f.set_exception(exc, self._version)
        if self.breaker is not None:
            # a half-open probe may be among them: its outcome will never
            # arrive, so free its slot
            self.breaker.probe_aborted()
        return n

    def mark_failed(self, reason: str) -> None:
        """The supervisor gave up on this worker: later submits are refused."""
        self._failed = reason

    def note_wedged(self, wedged: bool) -> None:
        """The supervisor's heartbeat verdict, shown by ``health()``."""
        self._wedged = bool(wedged)

    def restart_worker(self) -> bool:
        """Respawn a dead batching thread; refused once stopped or failed."""
        if self._stop.is_set() or self._failed is not None:
            return False
        self.restarts += 1
        self.start()
        return True

    # -------------------------------------------------------------- admit
    def submit(self, request: ServeRequest) -> ServeFuture:
        """Admit one request (caller thread). Typed fail-fast seams, all on
        this thread: a full queue rejects (:class:`AdmissionRejected`), an
        open breaker sheds (:class:`CircuitOpen`), an expired deadline fails
        (:class:`DeadlineExceeded`), a failed worker refuses
        (:class:`WorkerCrashed`)."""
        if self._stop.is_set():
            raise ServingStopped(f"model {self.name!r} is stopping")
        if self._failed is not None:
            raise WorkerCrashed(f"model {self.name!r} refused: {self._failed}")
        fault_point("serve_admission")  # chaos seam (caller thread)
        fut = request.future
        # the request's trace: a child of the caller's context, else a root
        parent_ctx = obs_trace.current_context()
        fut.trace = parent_ctx.child() if parent_ctx is not None else obs_trace.new_context()
        if fut.deadline_s is None and self.deadline_ms is not None:
            fut.deadline_s = fut.t_enqueue + self.deadline_ms / 1e3
        if fut.deadline_s is not None:
            self._deadlines_armed = True
        if fut.expired():
            exc = fut._deadline_error("admission")
            with self._acct_lock:
                self._deadline_missed += 1
            fut.set_exception(exc, self._version)
            if self.breaker is not None:
                self.breaker.record_deadline_miss(probe=False)
            raise exc
        br = self.breaker
        if br is not None:
            admitted = br.admit()
            if not admitted:
                raise CircuitOpen(self.name,
                                  reason=f"{br.state} after {br.snapshot()['trips']} trip(s)",
                                  retry_in_s=br.retry_in_s())
            # only the tagged probe's outcome may close or re-open the breaker
            fut.probe = admitted == "probe"
        fut._on_done = self._request_completed
        fut._on_resolve = self._future_resolved
        with self._acct_lock:
            self._pending_futs.add(fut)
        try:
            self.queue.put(request)
        except (AdmissionRejected, ServingStopped) as e:
            with self._acct_lock:
                self._rejected += isinstance(e, AdmissionRejected)
                self._pending_futs.discard(fut)
            if br is not None and fut.probe:
                br.probe_aborted()
            raise
        return fut

    def _future_resolved(self, fut: ServeFuture) -> None:
        # fires once, on whichever thread won the resolution race: the one
        # place a deadline miss is counted, whichever seam declared it
        missed = isinstance(fut.error(), DeadlineExceeded)
        with self._acct_lock:
            self._pending_futs.discard(fut)
            self._deadline_missed += missed
        if missed and self.breaker is not None:
            self.breaker.record_deadline_miss(probe=fut.probe)

    def rejected(self) -> int:
        """Cumulative requests rejected by admission control."""
        with self._acct_lock:
            return self._rejected

    # ------------------------------------------------------------ hot swap
    def swap(self, predictor, version: int, tags: Optional[Dict] = None) -> None:
        """Route later flushes to ``predictor``/``version`` (with ``tags``
        updated for their serve records). Blocks while a batch is
        dispatching; the old predictor is kept until its last outstanding
        future is materialized."""
        with self._swap_lock:
            if (predictor.batch_size != self.predictor.batch_size
                    or predictor.shape_buckets != self.predictor.shape_buckets):
                raise ValueError("hot-swap requires identical batch_size and shape_buckets "
                                 "(queued requests are already padded to the old geometry)")
            old, oldv = self.predictor, self._version
            self.predictor = predictor
            self._version = int(version)
            if tags:
                self.tags = {**self.tags, **tags}
            with self._acct_lock:
                if self._outstanding.get(oldv):
                    self._retired[oldv] = old

    @property
    def version(self) -> int:
        return self._version

    def retired_versions(self) -> List[int]:
        """Old versions still kept because some of their futures have not
        been materialized yet."""
        with self._acct_lock:
            return sorted(self._retired)

    def outstanding(self) -> Dict[int, int]:
        with self._acct_lock:
            return dict(self._outstanding)

    # --------------------------------------------------------- accounting
    def _request_completed(self, fut: ServeFuture) -> None:
        # caller's thread, right after its row's copy to the host
        now = time.perf_counter()
        self.stats.complete(now - fut.t_enqueue, now)
        self._version_done(fut.version)
        self._emit_request_trace(fut)

    # the request's stage spans in timeline order: ServeFuture.spans() key ->
    # span name
    _STAGE_SPANS = (("queue_s", "req_queue"), ("assembly_s", "req_assembly"),
                    ("dispatch_s", "req_dispatch"), ("materialize_s", "req_materialize"))

    def _emit_request_trace(self, fut: ServeFuture) -> None:
        """The request's ``serve_request`` span and its stage children
        (caller's thread), when its trace was sampled or the request was
        slower than the slow threshold (promoted, decided here from the
        future's times)."""
        ctx, tel = fut.trace, self.telemetry
        if ctx is None or tel is None or fut.t_materialize is None:
            return
        total_s = fut.t_materialize - fut.t_enqueue
        promoted = not ctx.sampled and total_s >= obs_trace.slow_threshold_s()
        if not (ctx.sampled or promoted):
            return
        thread = threading.current_thread().name
        root = {"name": "serve_request", "dur_s": round(total_s, 6), "model": self.name,
                "thread": thread}
        if promoted:
            root["promoted"] = True
        root.update(ctx.to_fields())
        tel.span_record(root)
        stages = fut.spans()
        for key, name in self._STAGE_SPANS:
            if key not in stages:
                continue
            rec = {"name": name, "dur_s": round(stages[key], 6), "model": self.name,
                   "thread": thread}
            rec.update(ctx.child().to_fields())
            tel.span_record(rec)

    def _version_done(self, version) -> None:
        if version is None:
            return
        with self._acct_lock:
            left = self._outstanding.get(version, 0) - 1
            if left <= 0:
                self._outstanding.pop(version, None)
                self._retired.pop(version, None)  # its last future materialized
            else:
                self._outstanding[version] = left

    def _breaker_transition(self, old: str, new: str, info: Dict) -> None:
        """Open/close transitions become ``warn`` records."""
        if self.telemetry is None or new == "half_open":
            return
        self.telemetry.warn(reason="circuit_open" if new == "open" else "circuit_closed",
                            path="serve", model=self.name, **info)

    # ------------------------------------------------------ deadline sweep
    def _sweep_expired(self) -> None:
        """Fail every expired request in the queue before trigger evaluation
        and assembly: it must never pad a batch or hold its group first."""
        if not self._deadlines_armed:
            return
        expired = self.queue.sweep_expired()
        if not expired:
            return
        for r in expired:
            f = r.future
            if not f.done():
                f.set_exception(f._deadline_error("queue"), self._version)
        n = len(expired)
        with self._acct_lock:
            self._swept += n
            swept = self._swept
        log.warning("model %r: swept %d expired request(s) from the queue (%d total)",
                    self.name, n, swept)
        if self.telemetry is not None:
            self.telemetry.warn(reason="deadline_exceeded", path="serve", model=self.name,
                                count=n, swept_expired=swept)

    # ----------------------------------------------------- the flush loop
    def _run(self) -> None:
        if self.telemetry is not None:
            obs_trace.bind_collector(self.telemetry.collector)
        crashed = False
        try:
            self._loop()
        except Exception:
            # the loop guards every per-batch failure; whatever still escapes
            # kills this worker: fail what is pending typed, and leave the
            # restart to the supervisor
            crashed = True
            log.exception("batching thread for model %r crashed", self.name)
        finally:
            self.fail_pending(
                WorkerCrashed(f"batching thread for model {self.name!r} died")
                if crashed or not self._stop.is_set()
                else ServerClosed(f"model {self.name!r} stopped"))
            if self.telemetry is not None:
                obs_trace.bind_collector(None)

    def _loop(self) -> None:
        while True:
            fault_point("serve_worker")  # chaos seam: kill or wedge the worker
            self._last_beat = self._clock()
            draining = self._stop.is_set()
            if draining and not self._drain:
                return
            self._sweep_expired()
            seen = self.queue.puts()  # arrival snapshot BEFORE the read
            now = time.perf_counter()
            groups = self.queue.groups()
            if not groups:
                if draining:
                    return
                self.queue.wait(0.05, seen)
                continue
            fired = kind = None
            for g in groups:  # oldest group first
                if draining:
                    fired, kind = g, "drain"
                    break
                try:
                    fire = self.flush_trigger({"pending": g.count,
                                               "waited_ms": (now - g.oldest_t) * 1e3})
                except Exception:
                    # a broken user trigger must not kill the thread: flush
                    if not self._trigger_warned:
                        self._trigger_warned = True
                        log.exception("flush_trigger for model %r raised; degrading to "
                                      "flush-on-poll", self.name)
                    fire = True
                if fire:
                    fired = g
                    kind = ("max_batch" if g.count >= self.max_batch
                            else "max_delay" if self._custom_trigger is None else "custom")
                    break
            if fired is None:
                # sleep until the oldest group's delay bound could fire (a
                # custom trigger gets a fixed 5 ms tick); an arrival since
                # `seen` wakes it at once
                if self._custom_trigger is None:
                    remain = self.max_delay_ms / 1e3 - (now - groups[0].oldest_t)
                    self.queue.wait(min(0.05, max(remain, 0.0005)), seen)
                else:
                    self.queue.wait(0.005, seen)
                continue
            reqs = self.queue.pop(fired.bucket, self.max_batch)
            if reqs:
                self._flush(fired.bucket, reqs, kind)

    def _flush(self, bucket, reqs: List[ServeRequest], kind: str) -> None:
        t_batch = time.perf_counter()
        # flush-seam deadline check: a request that expired since the sweep
        # (or that its caller's deadline already resolved) must not pad it
        live: List[ServeRequest] = []
        n_dropped = 0
        for r in reqs:
            if r.future.done():
                n_dropped += 1
            elif r.future.expired(t_batch):
                r.future.set_exception(r.future._deadline_error("flush"), self._version)
                n_dropped += 1
            else:
                live.append(r)
        reqs = live
        if not reqs:
            # no serve record for a fully expired pop: say so in a warn
            if n_dropped and self.telemetry is not None:
                with self._acct_lock:
                    missed = self._deadline_missed
                self.telemetry.warn(reason="deadline_exceeded", path="serve",
                                    model=self.name, count=n_dropped, deadline_missed=missed)
            return
        n = len(reqs)
        # the flush's own trace links its members; a sampled member samples it
        flush_ctx = obs_trace.new_context()
        if not flush_ctx.sampled and any(r.future.trace is not None and r.future.trace.sampled
                                         for r in reqs):
            flush_ctx.sampled = True
        err = x = t_assembled = None
        try:
            # assembly can fail on caller input; it fails THESE requests,
            # never the thread. swap() keeps the geometry, so an unlocked
            # read of pad_record pads as any version would
            with obs_trace.context_scope(flush_ctx), span("serve_assembly"):
                pad = self.predictor.pad_record  # lint: disable=BDL017
                x = np.stack([r.feature if bucket is None else pad(r.feature, bucket)
                              for r in reqs])
            t_assembled = time.perf_counter()
        except Exception as e:
            err = e
        with self._swap_lock:
            # the version's tags, read with it: a swap after the results are
            # handed out must not retag this flush's record
            predictor, version, tags = self.predictor, self._version, self.tags
            for r in reqs:
                r.future.t_batch = t_batch
                r.future.t_assembled = t_assembled
            if err is None:
                try:
                    with obs_trace.context_scope(flush_ctx), span("serve_dispatch"):
                        y = predictor.forward_batch(x)
                except Exception as e:  # resolve, never kill the thread
                    err = e
            t_dispatch = time.perf_counter()
            if err is not None:
                for r in reqs:
                    r.future.t_dispatch = t_dispatch
                    r.future.set_exception(err, version)
            else:
                # outstanding counts the whole batch before any (first-wins)
                # resolution; each future that loses its race gives one back
                with self._acct_lock:
                    self._outstanding[version] = self._outstanding.get(version, 0) + n
                with torch.inference_mode():
                    for i, r in enumerate(reqs):
                        r.future.t_dispatch = t_dispatch
                        if not r.future.set_result(y[i], version):  # device row view
                            self._version_done(version)
        if self.breaker is not None:
            # one failed flush is one failure; a served one n successes
            has_probe = any(r.future.probe for r in reqs)
            if err is not None:
                self.breaker.record_failure(probe=has_probe)
            else:
                self.breaker.record_success(n, probe=has_probe)
        self.flushes += 1
        self._last_flush_at = self._clock()
        # every flush, a failed one too, emits a serve record
        extra: Dict[str, Any] = dict(tags)
        if err is not None:
            extra["error"] = repr(err)
        drift = self.drift
        if (drift is not None and err is None and self.flushes % self.drift_every == 0
                and getattr(predictor, "last_state", None) is not None):
            self._sample_drift(drift, predictor.last_state, extra)
        if self.telemetry is not None:
            p50, p99, rps = self.stats.summary(time.perf_counter())
            cost = self.bucket_costs.get(bucket)
            if cost is not None:
                # this flush's padded-batch cost, and the rolling achieved
                # rate over the completed requests (dispatch is asynchronous:
                # the callers' materialized completions are the honest rate)
                extra["model_flops"] = cost["flops"]
                extra["flops_per_record"] = cost["flops_per_record"]
                if rps:
                    ach = rps * cost["flops_per_record"]
                    extra["achieved_flops_s"] = round(ach, 3)
                    peak = cost.get("peak_flops_total")
                    extra["mfu"] = round(ach / peak, 6) if peak else None
            # the member that waited longest: its trace answers "where did
            # the tail go" at /trace?id=
            slowest = min(reqs, key=lambda r: r.future.t_enqueue)
            extra["trace_id"] = None if slowest.future.trace is None \
                else slowest.future.trace.trace_id
            if flush_ctx.sampled:
                self.telemetry.span_record({
                    "name": "serve_flush", "trace_id": flush_ctx.trace_id,
                    "span_id": flush_ctx.span_id, "dur_s": round(t_dispatch - t_batch, 6),
                    "thread": threading.current_thread().name, "model": self.name,
                    "records": n,
                    "links": [{"trace_id": r.future.trace.trace_id,
                               "span_id": r.future.trace.span_id}
                              for r in reqs if r.future.trace is not None]})
            with self._acct_lock:
                missed, swept = self._deadline_missed, self._swept
            br = self.breaker
            self.telemetry.serve(
                model=self.name, iteration=self.flushes, records=n,
                batch_fill=round(n / self.max_batch, 4), queue_depth=self.queue.depth(),
                rejected=self.rejected(), bucket=bucket, version=version, trigger=kind,
                wall_s=t_dispatch - t_batch,
                queue_wait_ms=sum(t_batch - r.future.t_enqueue for r in reqs) / n * 1e3,
                p50_ms=p50, p99_ms=p99, rps=rps, deadline_missed=missed,
                swept_expired=swept, shed=0 if br is None else br.shed,
                breaker_state=None if br is None else br.state, **extra)

    def _sample_drift(self, drift, state, extra: Dict[str, Any]) -> None:
        """The one sampled copy to the host of the serving loop: the hook
        rows of the captured state (every ``drift_every`` flushes)."""
        try:
            sample = drift.sample(state)
        except Exception:  # a broken monitor must not stop serving
            if not self._drift_warned:
                self._drift_warned = True
                log.exception("drift sampling for model %r raised; skipping", self.name)
            return
        if sample is None:
            return
        extra["drift"] = sample["acts"]
        breach = sample.get("breach")
        if breach is not None and self.telemetry is not None:
            self.telemetry.warn(reason="activation_drift", path="serve", model=self.name,
                                layer=breach["layer"], z=breach["z"],
                                bound=drift.config.warn_z)

    # --------------------------------------------------------------- health
    def health_snapshot(self) -> Dict[str, Any]:
        """Per-model readiness/liveness view (``ModelServer.health()``):
        state, worker liveness and heartbeat age, breaker, queue depth,
        last-flush age, restarts and the cumulative resilience counters."""
        now = self._clock()
        with self._acct_lock:
            missed, swept = self._deadline_missed, self._swept
            pending = len(self._pending_futs)
            rejected = self._rejected
        br = self.breaker.snapshot() if self.breaker is not None else None
        alive = self.worker_alive()
        beat, flushed = self._last_beat, self._last_flush_at
        if self._failed is not None:
            state = "failed"
        elif self._stop.is_set():
            state = "stopped"
        elif not alive:
            state = "down"  # liveness outranks the breaker
        elif br is not None and br["state"] == "open":
            state = "open"
        elif br is not None and br["state"] == "half_open":
            state = "probing"
        elif self._wedged:
            state = "wedged"
        else:
            state = "serving"
        return {
            "state": state, "worker_alive": alive,
            "heartbeat_age_s": None if beat is None else round(now - beat, 6),
            "last_flush_age_s": None if flushed is None else round(now - flushed, 6),
            "queue_depth": self.queue.depth(), "pending": pending,
            "restarts": self.restarts, "breaker": br, "deadline_missed": missed,
            "swept_expired": swept, "rejected": rejected, "version": self._version,
            "failed_reason": self._failed,
        }
