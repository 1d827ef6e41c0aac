"""``ModelServer``: multi-model serving over Predictor + ContinuousBatcher
(counterpart of ``bigdl_tpu/serving/server.py``).

One process hosts N named models; each gets a fixed-batch ``Predictor``
(one geometry per shape bucket) fed by a continuous batcher with a
latency-bound flush trigger. Registration warms every bucket geometry once,
so the first real request does not pay for first-call setup (the kernel
library's build included). One :class:`~bigdl_tpu_torch.obs.telemetry.Telemetry`
stream carries every model's ``warmup``, per-flush ``serve`` and ``warn``
records; a :class:`~bigdl_tpu_torch.serving.resilience.ServingSupervisor`
restarts dead batching threads and fails wedged ones' pending futures.

Hot-swap: ``update(name, new_model)`` builds and warms the replacement off
the serving path (the old version keeps serving meanwhile), then swaps under
the batcher's dispatch lock: the in-flight batch drains first, every future
resolves on the version that dispatched it, and the old version is kept
until its last future is materialized.

Quantized tiers: a model whose tree holds the quantized twins
(``nn/quantized.py``) is detected and its family (``"int8"`` / ``"fp8"``)
tagged on every serve record; ``register(..., quantize=True)`` (or
``"int8"``) converts a float model into its int8 twin at registration (int32
accumulation), ``quantize="fp8"`` into the float8 tier (float32
accumulation). ``update(..., quantize=...)`` takes the same values.

The server runs each model where its parameters live and never moves it.
Not ported (each raises ``NotImplementedError``): ``artifacts`` /
``warm_start`` / ``export_artifacts`` (AOT bundles), ``drift`` (activation
drift) and ``metrics_port`` (the scrape endpoint).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..obs.telemetry import Telemetry
from ..ops import _build
from ..optim.predictor import Predictor
from .batcher import ContinuousBatcher
from .queue import ServeFuture, ServeRequest
from .resilience import ServingSupervisor

log = logging.getLogger("bigdl_tpu_torch.serving")

__all__ = ["ModelServer"]


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to bigdl_tpu_torch yet")


def _resolve_and_convert(name: str, model, quantize):
    """The quantize contract of ``register`` and ``update``: normalize the
    requested family, refuse one that differs from an already-quantized
    model's, convert a float model when asked. Returns ``(model, tag)``,
    the tag the detected family or ``False`` (the serve records' field)."""
    from ..nn.quantized import quantize as _quantize, quantized_mode

    mode = _resolve_quantize(quantize)
    detected = quantized_mode(model)  # a pre-quantized model is tagged without asking
    if mode is not None and detected is not None and detected != mode:
        raise ValueError(f"model {name!r}: quantize={mode!r} requested but the model is already "
                         f"{detected}-quantized; pass the float model (or "
                         f"quantize={detected!r})")
    if mode is not None and detected is None:
        model = _quantize(model, dtype=mode)
        detected = mode
    return model, (detected or False)


def _resolve_quantize(quantize):
    """``False`` / ``None``: no conversion; ``True``: int8; ``"int8"`` /
    ``"fp8"``: that family. fp8 on a torch build without float8 fails here
    with the probe's reason, at registration."""
    if quantize is None or quantize is False:
        return None
    if quantize is True:
        return "int8"
    if quantize in ("int8", "fp8"):
        if quantize == "fp8":
            from ..utils.compat import probe_float8

            support = probe_float8()
            if not support.available:
                raise ValueError("register(quantize='fp8') requires float8 support, which "
                                 f"this stack lacks ({support.reason})")
        return quantize
    raise ValueError(f"quantize={quantize!r}: expected False, True, 'int8' or 'fp8'")


class _Entry:
    __slots__ = ("name", "model", "predictor", "batcher", "version", "quantized", "sample",
                 "shape_buckets", "batch_size", "max_batch", "max_delay_ms", "max_pending",
                 "flush_trigger", "deadline_ms", "breaker", "supervise", "warmup_s",
                 "warmup_compiles", "warmup_fresh")


class ModelServer:
    """Thread-safe multi-model serving runtime (usable as a context manager).

    ``telemetry``: the sink every model's records go to; ``None`` mints one
    that ``close()`` closes (a caller's sink outlives the server).
    ``supervisor``: ``None`` starts a default ``ServingSupervisor`` on the
    first registration, ``False`` leaves the workers unsupervised, or pass a
    configured one.
    """

    def __init__(self, telemetry: Optional[Telemetry] = None, supervisor=None,
                 metrics_port: Optional[int] = None):
        if metrics_port is not None:
            raise _not_ported("ModelServer(metrics_port=...) (the scrape endpoint)")
        self._owns_telemetry = telemetry is None
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        if supervisor is False:
            self.supervisor: Optional[ServingSupervisor] = None
        elif supervisor is None:
            self.supervisor = ServingSupervisor(telemetry=self.telemetry)
        else:
            self.supervisor = supervisor
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.RLock()  # serving traffic reads the entries under it
        # register/update/unregister/close serialize on this for their whole
        # duration, warmup included; serving traffic never takes it
        self._mgmt_lock = threading.RLock()
        self._run_open = False

    # ----------------------------------------------------------- lifecycle
    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close()

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop every batcher (``drain=True`` serves queued requests first)
        and end the telemetry run; a future still pending afterwards fails
        with ``ServerClosed``."""
        with self._mgmt_lock:
            if self.supervisor is not None:
                # first: the deliberate stops below must not read as crashes
                self.supervisor.stop()
            with self._lock:
                entries = list(self._entries.values())
                self._entries.clear()
            for e in entries:
                if self.supervisor is not None:
                    self.supervisor.unwatch(e.name)
                e.batcher.stop(drain=drain, timeout=timeout)
            if self._run_open:
                self.telemetry.run_ended("serve", models=[e.name for e in entries])
                self._run_open = False
            if self._owns_telemetry:
                self.telemetry.close()

    def _ensure_run(self) -> None:
        if not self._run_open:
            self.telemetry.run_started("serve", warm_start=None)
            self._run_open = True

    def warm_start(self, path: str):
        raise _not_ported("ModelServer.warm_start (AOT artifact bundles)")

    def export_artifacts(self, path: str):
        raise _not_ported("ModelServer.export_artifacts (AOT artifact bundles)")

    # -------------------------------------------------------- registration
    def register(self, name: str, model, *, sample_input=None,
                 batch_size: Optional[int] = None,
                 shape_buckets: Optional[Sequence[int]] = None,
                 max_batch: Optional[int] = None, max_delay_ms: float = 10.0,
                 max_pending: Optional[int] = None, flush_trigger=None, quantize=False,
                 warmup: bool = True, drift=None, artifacts: Optional[str] = None,
                 deadline_ms: Optional[float] = None, breaker=None,
                 supervise: bool = True) -> None:
        """Host ``model`` under ``name``.

        ``sample_input`` is ONE record (no batch dim); it is required when
        the model is unbuilt or ``warmup=True``. Warmup runs one forward per
        bucket (or one at the record's shape) and emits a ``warmup`` record;
        ``warmup=False`` emits ``warn reason=unwarmed_model``.
        ``max_pending`` arms admission control (``AdmissionRejected`` on the
        caller's thread past it); ``deadline_ms`` the model's default
        request deadline (``infer(..., deadline_ms=...)`` overrides it);
        ``breaker`` the circuit breaker (``None``: defaults, ``False``:
        off); ``supervise=False`` keeps the model off the supervisor."""
        if artifacts is not None:
            raise _not_ported("register(artifacts=...) (AOT artifact bundles)")
        if drift not in (None, False):
            raise _not_ported("register(drift=...) (activation drift)")
        with self._mgmt_lock:
            with self._lock:
                if name in self._entries:
                    raise ValueError(f"model {name!r} already registered; use update() "
                                     "to hot-swap a new version")
            e = _Entry()
            e.name = name
            if isinstance(sample_input, torch.Tensor):
                sample_input = sample_input.cpu().numpy()
            e.sample = None if sample_input is None else np.asarray(sample_input)
            if e.sample is None and (warmup or not model.is_built()):
                raise ValueError(f"model {name!r}: pass sample_input (one record) to "
                                 "build and warm it")
            e.shape_buckets = tuple(int(b) for b in shape_buckets) if shape_buckets else None
            e.batch_size = batch_size
            e.max_batch = max_batch
            e.max_delay_ms = max_delay_ms
            e.max_pending = None if max_pending is None else int(max_pending)
            e.flush_trigger = flush_trigger
            e.deadline_ms = deadline_ms
            e.breaker = breaker
            e.supervise = bool(supervise)
            self._ensure_run()
            self._ensure_built(e, model)
            model, e.quantized = _resolve_and_convert(name, model, quantize)
            e.model = model
            e.version = 1
            e.warmup_s, e.warmup_compiles, e.warmup_fresh = 0.0, 0, None
            predictor = Predictor(model, batch_size, e.shape_buckets)
            if warmup:
                e.warmup_s = self._warmup(e, predictor, 1)
            else:
                log.warning("model %r registered with warmup=False; the first request per "
                            "shape pays the setup", name)
                self.telemetry.warn(reason="unwarmed_model", path="serve", model=name)
            e.predictor = predictor
            e.batcher = ContinuousBatcher(
                predictor, name=name, version=1, max_batch=max_batch,
                max_delay_ms=max_delay_ms, max_pending=e.max_pending,
                deadline_ms=deadline_ms, breaker=breaker, flush_trigger=flush_trigger,
                telemetry=self.telemetry, tags={"quantized": e.quantized},
                # heartbeats live in the supervisor's clock domain
                clock=self.supervisor.clock if self.supervisor is not None else time.monotonic)
            with self._lock:
                self._entries[name] = e
            e.batcher.start()
            if e.supervise and self.supervisor is not None:
                self.supervisor.watch(name, e.batcher)
                self.supervisor.start()

    @staticmethod
    def _warm_shapes(e: _Entry):
        if e.shape_buckets:
            return [(b,) + e.sample.shape[1:] for b in e.shape_buckets]
        return [e.sample.shape]

    def _ensure_built(self, e: _Entry, model) -> None:
        if not model.is_built():
            if e.sample is None:
                raise ValueError(f"model {e.name!r} is unbuilt and no sample_input was "
                                 "given; pass one record so the server can build it")
            model._ensure_built(np.zeros((1,) + self._warm_shapes(e)[0], e.sample.dtype))

    def _warmup(self, e: _Entry, predictor: Predictor, version: int) -> float:
        """One forward per bucket shape, waited for on the card; emits the
        ``warmup`` record. ``compiles`` / ``fresh_compiles`` count the kernel
        library's loads and builds this warmup triggered (0 or 1 each)."""
        loads, builds = _build.loads, _build.builds
        t0 = time.perf_counter()
        for shape in self._warm_shapes(e):
            predictor.forward_batch(np.zeros((1,) + shape, e.sample.dtype))
        if predictor.model.device.type == "cuda":
            torch.cuda.synchronize(predictor.model.device)
        warmup_s = time.perf_counter() - t0
        e.warmup_compiles = _build.loads - loads
        e.warmup_fresh = _build.builds - builds
        self.telemetry.warmup(model=e.name, seconds=warmup_s, compiles=e.warmup_compiles,
                              fresh_compiles=e.warmup_fresh, warm_start=False,
                              buckets=list(e.shape_buckets) if e.shape_buckets else None,
                              version=version)
        return warmup_s

    # ------------------------------------------------------------ hot swap
    def update(self, name: str, new_model, *, quantize=False, warmup: bool = True) -> int:
        """Hot-swap ``name`` to ``new_model``; returns the new version. The
        new version is built and warmed while the old one keeps serving;
        the swap drains the in-flight batch, and every future resolves on
        exactly one version."""
        with self._mgmt_lock:
            e = self._entry(name)
            version = e.version + 1
            if not new_model.is_built() and e.sample is None:
                raise ValueError(f"update({name!r}) with an unbuilt model needs the "
                                 "sample_input the original registration provided")
            self._ensure_built(e, new_model)
            new_model, quantized = _resolve_and_convert(name, new_model, quantize)
            predictor = Predictor(new_model, e.predictor.batch_size, e.shape_buckets)
            prior = (e.warmup_s, e.warmup_compiles, e.warmup_fresh)
            try:
                if warmup and e.sample is not None:
                    e.warmup_s = self._warmup(e, predictor, version)
                e.batcher.swap(predictor, version, tags={"quantized": quantized})
            except Exception:
                e.warmup_s, e.warmup_compiles, e.warmup_fresh = prior
                raise
            e.model, e.predictor, e.version, e.quantized = new_model, predictor, version, quantized
            return version

    def unregister(self, name: str) -> None:
        """Stop serving ``name``: its queued requests are served first."""
        with self._mgmt_lock:
            with self._lock:
                e = self._entries.pop(name, None)
            if e is None:
                raise KeyError(f"no model registered as {name!r}")
            if self.supervisor is not None:
                self.supervisor.unwatch(name)  # before the stop: not a crash
            e.batcher.stop(drain=True)

    # ------------------------------------------------------------- serving
    def _entry(self, name: str) -> _Entry:
        with self._lock:
            e = self._entries.get(name)
        if e is None:
            raise KeyError(f"no model registered as {name!r}")
        return e

    def infer(self, name: str, record, deadline_ms: Optional[float] = None) -> ServeFuture:
        """Submit ONE record (no batch dim); returns its future. The record
        is bucket-classified on the calling thread. ``deadline_ms`` overrides
        the model's default deadline."""
        e = self._entry(name)
        feat = np.asarray(record)
        bucket = e.predictor.bucket_of(feat.shape[0]) if e.shape_buckets else None
        return e.batcher.submit(ServeRequest(feat, bucket, deadline_ms=deadline_ms))

    def predict(self, name: str, records, timeout: Optional[float] = None) -> torch.Tensor:
        """Blocking convenience: submit every record, gather in order, stack."""
        futs = [self.infer(name, r) for r in records]
        return torch.stack([f.result(timeout) for f in futs])

    # ---------------------------------------------------------------- info
    def health(self) -> Dict[str, Dict[str, Any]]:
        """Per-model readiness/liveness: state (``serving`` / ``open`` /
        ``probing`` / ``wedged`` / ``down`` / ``failed`` / ``stopped``),
        breaker, queue depth, heartbeat and last-flush ages, restarts and
        the cumulative resilience counters."""
        with self._lock:
            entries = dict(self._entries)
        return {name: e.batcher.health_snapshot() for name, e in entries.items()}

    def models(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            entries = dict(self._entries)
        return {
            name: {
                "version": e.version,
                "quantized": e.quantized,
                "batch_size": e.predictor.batch_size,
                "max_batch": e.batcher.max_batch,
                "max_delay_ms": e.max_delay_ms,
                "shape_buckets": e.shape_buckets,
                "max_pending": e.max_pending,
                "queue_depth": e.batcher.queue.depth(),
                "flushes": e.batcher.flushes,
                "completed": e.batcher.stats.completed,
                "rejected": e.batcher.rejected(),
                "warmup_s": round(e.warmup_s, 6),
                "warmup_compiles": e.warmup_compiles,
                "warmup_fresh_compiles": e.warmup_fresh,
                "retired_versions": e.batcher.retired_versions(),
                "deadline_ms": e.deadline_ms,
                "restarts": e.batcher.restarts,
                "device": str(e.model.device),
            }
            for name, e in entries.items()
        }
