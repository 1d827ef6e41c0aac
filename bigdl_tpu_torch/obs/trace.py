"""Span tracing: host-side timing seams that show up in ``torch.profiler``
traces (counterpart of ``bigdl_tpu/obs/trace.py``; the port's own copy).

A :func:`span` wraps a seam of the training loop (prefetch, pad/mask,
checkpoint, validation, summary flush) in a ``perf_counter`` timing scope on
a thread-local stack and, at the same time, in a
``torch.profiler.record_function`` of the same name, so the seam is a named
range in a trace captured by ``Optimizer.set_profile`` (the JAX package's
``jax.profiler.TraceAnnotation``).

Recording is pull-based and aggregate-first: durations accumulate into a
:class:`SpanCollector`, one per :class:`~bigdl_tpu_torch.obs.telemetry.Telemetry`
run, bound to the run's threads by :func:`bind_collector` (the driver thread
at ``run_started``; the prefetch thread binds its parent's collector). The
telemetry drains it into each step record's ``spans``. On a thread with no
collector only the profiler range remains. A span reads no device value:
it times host work, never waits on the card.

``step_annotation(n)`` wraps each step's dispatch in a range named
``train#<n>``, the step boundaries of a captured trace.

Causal tracing rides the same seams: a :class:`TraceContext`
(``trace_id`` / ``span_id`` / ``parent_id``, derived from the fleet
identity and a process-local counter, no clock or random draw) is bound
per thread by :func:`bind_context` / :func:`context_scope`. When a
*sampled* context is current, :func:`span` also emits one ``span`` record
through the collector's ``on_span`` sink, parented by the nesting. Head
sampling is deterministic (:func:`configure`, ``BIGDL_TRACE_SAMPLE_RATE``,
default 0).

The chaos hook (:func:`set_fault_hook`, installed by a ``FaultPlan``) is
told every span entry and every bare :func:`fault_point`.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import zlib
from typing import Dict, Optional

__all__ = [
    "span",
    "step_annotation",
    "add_sample",
    "SpanCollector",
    "bind_collector",
    "current_collector",
    "drain_aggregates",
    "peek_aggregates",
    "fault_point",
    "set_fault_hook",
    "fault_hook",
    "TraceContext",
    "new_context",
    "bind_context",
    "current_context",
    "context_scope",
    "configure",
    "sampling",
    "slow_threshold_s",
    "emit_span",
]

# thread-local state: .stack (nested span names), .collector, .context
_tls = threading.local()

# process-global chaos hook (resilience.chaos.FaultPlan); None costs one check
_fault_hook = None


def set_fault_hook(hook) -> None:
    """Install (or clear, with None) the process-global fault hook:
    ``hook(seam_name)`` may raise, delay or act (see resilience.chaos)."""
    global _fault_hook
    _fault_hook = hook


def fault_hook():
    return _fault_hook


def fault_point(name: str) -> None:
    """A bare chaos seam where there is no span (the step's dispatch, timed
    around the call and fed through :func:`add_sample`)."""
    if _fault_hook is not None:
        _fault_hook(name)


def _annotation(name: str):
    """The profiler range of a seam."""
    from torch.profiler import record_function

    return record_function(name)


# ---------------------------------------------------------------------------
# causal trace context
# ---------------------------------------------------------------------------

# ids are ``<base8hex>-<seq8hex>``: base the crc32 of this process's fleet
# identity, seq a process-local counter; allocation order alone decides them
_id_lock = threading.Lock()
_id_seq = 0
_id_base: Optional[str] = None


def _identity_base() -> str:
    global _id_base
    if _id_base is None:
        try:
            from . import fleet

            ident = fleet.process_identity()
            key = "%s:%s" % (ident.get("host"), ident.get("process_index"))
        except Exception:  # the identity probe must never stop tracing
            key = "p0"
        _id_base = "%08x" % (zlib.crc32(key.encode("utf-8")) & 0xFFFFFFFF)
    return _id_base


def _reset_identity_base() -> None:
    """Forget the cached identity base (simulated fleets flip
    ``BIGDL_PROCESS_INDEX`` between runs of one process)."""
    global _id_base
    _id_base = None


def _next_seq() -> int:
    global _id_seq
    with _id_lock:
        _id_seq += 1
        return _id_seq


_config = {
    "sample_rate": float(os.environ.get("BIGDL_TRACE_SAMPLE_RATE", "0") or 0.0),
    "slow_ms": float(os.environ.get("BIGDL_TRACE_SLOW_MS", "250") or 250.0),
}


def configure(sample_rate: Optional[float] = None,
              slow_ms: Optional[float] = None) -> Dict[str, float]:
    """Set the head-sampling knobs; returns the previous config
    (``configure(**prev)`` restores it)."""
    prev = dict(_config)
    if sample_rate is not None:
        _config["sample_rate"] = min(1.0, max(0.0, float(sample_rate)))
    if slow_ms is not None:
        _config["slow_ms"] = max(0.0, float(slow_ms))
    return prev


def sampling() -> Dict[str, float]:
    return dict(_config)


def slow_threshold_s() -> float:
    """Latency above which a request trace is always promoted (seconds)."""
    return _config["slow_ms"] / 1000.0


def _sample_decision(n: int) -> bool:
    rate = _config["sample_rate"]
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    period = max(1, int(round(1.0 / rate)))
    return (n % period) == 0


class TraceContext:
    """One node of a causal trace: ``trace_id`` names the request or chunk,
    ``span_id`` this hop, ``parent_id`` the hop that caused it (None at the
    root). ``sampled`` is decided once at the root and inherited."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None, sampled: bool = False):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled

    def child(self) -> "TraceContext":
        """A new span under the same trace, parented on this one."""
        return TraceContext(self.trace_id, "%s-%08x" % (_identity_base(), _next_seq()),
                            parent_id=self.span_id, sampled=self.sampled)

    def to_fields(self) -> Dict[str, object]:
        out: Dict[str, object] = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id is not None:
            out["parent_id"] = self.parent_id
        return out

    def __repr__(self):
        return "TraceContext(trace=%s span=%s parent=%s sampled=%s)" % (
            self.trace_id, self.span_id, self.parent_id, self.sampled)


def new_context(key=None, sampled: Optional[bool] = None) -> TraceContext:
    """A root context (a fresh trace). With ``key`` (e.g. ``(epoch,
    chunk_index)`` of the input pipeline) the trace id and the sampling
    verdict derive from the key's crc32: the same unit of work gets the same
    trace on every run and for any worker count."""
    seq = _next_seq()
    base = _identity_base()
    if key is not None:
        h = zlib.crc32(repr(key).encode("utf-8")) & 0xFFFFFFFF
        trace_word, decide_n = h, h
    else:
        trace_word, decide_n = seq, seq
    if sampled is None:
        sampled = _sample_decision(decide_n)
    return TraceContext(trace_id="%s-%08x" % (base, trace_word & 0xFFFFFFFF),
                        span_id="%s-%08x" % (base, seq), parent_id=None,
                        sampled=bool(sampled))


def bind_context(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Bind ``ctx`` as this thread's trace context; returns the previous."""
    prev = getattr(_tls, "context", None)
    _tls.context = ctx
    return prev


def current_context() -> Optional[TraceContext]:
    return getattr(_tls, "context", None)


@contextlib.contextmanager
def context_scope(ctx: Optional[TraceContext]):
    """Bind ``ctx`` for the block (restored on exit, also on an exception)."""
    prev = bind_context(ctx)
    try:
        yield ctx
    finally:
        bind_context(prev)


def emit_span(name: str, dur_s: float, ctx: TraceContext, **fields) -> None:
    """Emit one externally timed span record for ``ctx`` through this
    thread's collector (a no-op without one or without an ``on_span``
    sink); the caller owns the sampling decision."""
    col = getattr(_tls, "collector", None)
    sink = getattr(col, "on_span", None) if col is not None else None
    if sink is None:
        return
    rec = {"name": name, "dur_s": round(float(dur_s), 6),
           "thread": threading.current_thread().name}
    rec.update(ctx.to_fields())
    rec.update(fields)
    sink(rec)


class SpanCollector:
    """Thread-safe ``{name: (count, total_seconds)}`` table of one run;
    ``on_span`` (set by the owning Telemetry) takes the sampled spans'
    records."""

    __slots__ = ("_lock", "_agg", "on_span")

    def __init__(self):
        self._lock = threading.Lock()
        self._agg: Dict[str, list] = {}
        self.on_span = None

    def add(self, name: str, seconds: float, count: int = 1) -> None:
        with self._lock:
            agg = self._agg.setdefault(name, [0, 0.0])
            agg[0] += count
            agg[1] += seconds

    def drain(self) -> Dict[str, Dict[str, float]]:
        """Return and clear ``{name: {"n": count, "s": seconds}}``: the spans
        between two step records attribute to the later one."""
        with self._lock:
            out = {k: {"n": v[0], "s": round(v[1], 6)} for k, v in self._agg.items()}
            self._agg.clear()
        return out

    def peek(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: {"n": v[0], "s": round(v[1], 6)} for k, v in self._agg.items()}


def bind_collector(collector: Optional[SpanCollector]):
    """Bind ``collector`` as this thread's span sink; returns the previous."""
    prev = getattr(_tls, "collector", None)
    _tls.collector = collector
    return prev


def current_collector() -> Optional[SpanCollector]:
    return getattr(_tls, "collector", None)


def add_sample(name: str, seconds: float) -> None:
    """Record one externally timed sample (the dispatch seam)."""
    col = getattr(_tls, "collector", None)
    if col is not None:
        col.add(name, seconds)


def drain_aggregates() -> Dict[str, Dict[str, float]]:
    """Drain this thread's collector ({} when unbound)."""
    col = getattr(_tls, "collector", None)
    return col.drain() if col is not None else {}


def peek_aggregates() -> Dict[str, Dict[str, float]]:
    col = getattr(_tls, "collector", None)
    return col.peek() if col is not None else {}


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


@contextlib.contextmanager
def span(name: str):
    """Time a host seam under ``name`` and mark it in the profiler trace.

    The duration is recorded also when the body raises. Nested spans record
    under ``"outer/inner"``. With a sampled :class:`TraceContext` bound and
    an ``on_span`` sink, one id-bearing record is emitted on exit (also on
    an exception), a child context bound for the body."""
    if _fault_hook is not None:  # chaos seam (resilience.chaos.FaultPlan)
        _fault_hook(name)
    with _annotation(name):
        col = getattr(_tls, "collector", None)
        if col is None:
            yield
            return
        ctx = getattr(_tls, "context", None)
        child = None
        if ctx is not None and ctx.sampled and col.on_span is not None:
            child = ctx.child()
            _tls.context = child
        stack = _stack()
        qualified = "/".join(stack + [name]) if stack else name
        stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            col.add(qualified, dt)
            if child is not None:
                _tls.context = ctx
                sink = col.on_span
                if sink is not None:
                    rec = {"name": name, "dur_s": round(dt, 6),
                           "thread": threading.current_thread().name}
                    rec.update(child.to_fields())
                    sink(rec)


def step_annotation(step_num: int):
    """A profiler range named ``train#<step_num>`` around one step's
    dispatch: the step boundaries of a captured trace."""
    return _annotation(f"train#{int(step_num)}")
