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

Artifact bundles (``utils/aot.py``, ``serving/artifacts.py``):
``export_artifacts(path)`` writes every registered model's signatures and
the kernel library; ``warm_start(path)`` (before ``register``) verifies a
bundle and seeds this process's cache directory with the library, and
``register(..., artifacts=path)`` holds the model against the bundle's
signatures. A bundle that fails any check degrades to a cold boot: a
``warn`` record with ``reason="artifact_incompatible"``, and the
registration goes on (the kernel library is then built or loaded as
without a bundle; a missing ``nvcc`` or a failed build still raises).

``drift=True`` (or an :class:`~bigdl_tpu_torch.obs.health.ActivationDrift`)
hooks the model and samples activation drift every ``drift_every`` flushes;
a hot-swap hooks the new version and releases the old one after the swap.
``metrics_port=`` starts this replica's scrape endpoint (``obs/export.py``:
``/healthz`` serves ``health()``, ``/metrics`` the gauges of this server's
telemetry ring); ``close()`` takes it down first. Each registration derives
its buckets' FLOPs once (``obs/perf.py`` ``predictor_bucket_costs``) for the
serve records' cost fields. An exception escaping ``with ModelServer():``
leaves a postmortem bundle (``obs/blackbox.py``) before the server closes.
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
                 "flush_trigger", "drift", "drift_every", "deadline_ms", "breaker",
                 "supervise", "warmup_s", "warmup_compiles", "warmup_fresh", "aot_modules",
                 "artifacts", "bucket_costs")


class ModelServer:
    """Thread-safe multi-model serving runtime (usable as a context manager).

    ``telemetry``: the sink every model's records go to; ``None`` mints one
    that ``close()`` closes (a caller's sink outlives the server).
    ``supervisor``: ``None`` starts a default ``ServingSupervisor`` on the
    first registration, ``False`` leaves the workers unsupervised, or pass a
    configured one. ``metrics_port``: serve this replica's scrape endpoint
    on that port (0: a free one, read back from :attr:`metrics_port`).
    """

    def __init__(self, telemetry: Optional[Telemetry] = None, supervisor=None,
                 metrics_port: Optional[int] = None):
        self._owns_telemetry = telemetry is None
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        if supervisor is False:
            self.supervisor: Optional[ServingSupervisor] = None
        elif supervisor is None:
            self.supervisor = ServingSupervisor(telemetry=self.telemetry)
        else:
            self.supervisor = supervisor
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.RLock()  # hot-lock: serving traffic reads entries under it
        # register/update/unregister/close serialize on this for their whole
        # duration, warmup included; serving traffic never takes it
        self._mgmt_lock = threading.RLock()  # hot-lock: registry mutations serialize here
        self._run_open = False
        # the verified bundle this server was seeded from (warm_start)
        self._warm_path: Optional[str] = None
        self._warm_manifest: Optional[Dict[str, Any]] = None
        self._endpoint = None
        if metrics_port is not None:
            from ..obs.export import ObsEndpoint

            self._endpoint = ObsEndpoint(metrics_port)
            self._endpoint.attach_telemetry(self.telemetry)
            self._endpoint.attach_health(self.health)
            self._endpoint.start()

    # ----------------------------------------------------------- lifecycle
    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        if exc_type is not None and not issubclass(exc_type, (KeyboardInterrupt, GeneratorExit)):
            # freeze the flight recorder before close() drains the workers
            # and takes the scrape endpoint down: the bundle shows the state
            # the exception left
            try:
                from ..obs import blackbox

                blackbox.dump_postmortem(f"server_{exc_type.__name__}",
                                         telemetry=self.telemetry, error=exc_val)
            except Exception:  # the server's exception propagates; the dump is best effort
                log.debug("server postmortem failed", exc_info=True)
        self.close()

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Take the scrape endpoint down, stop every batcher (``drain=True``
        serves queued requests first), unhook drift, and end the telemetry
        run; a future still pending afterwards fails with ``ServerClosed``."""
        with self._mgmt_lock:
            if self._endpoint is not None:
                # first: a router polling /healthz must see the replica gone,
                # not a half-closed one still reading "serving"
                self._endpoint.close()
                self._endpoint = None
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
                if e.drift is not None:  # the model goes back unhooked
                    e.drift.release(e.model)
            if self._run_open:
                self.telemetry.run_ended("serve", models=[e.name for e in entries])
                self._run_open = False
            if self._owns_telemetry:
                self.telemetry.close()

    def _ensure_run(self) -> None:
        if not self._run_open:
            self.telemetry.run_started("serve", warm_start=self._warm_path)
            self._run_open = True

    # ------------------------------------------------------------ artifacts
    def warm_start(self, path: str) -> Dict[str, Any]:
        """Verify an artifact bundle and seed this process's cache directory
        with its kernel library (manifest, per-file sha256, fingerprint; any
        mismatch raises :class:`~bigdl_tpu_torch.utils.aot.ArtifactIncompatible`
        and nothing is seeded). Call before ``register``; a registration
        naming the same bundle (``artifacts=path``) reuses the verification."""
        from ..utils import aot

        with self._mgmt_lock:
            manifest = aot.warm_start(path, kind="serving")
            self._warm_path, self._warm_manifest = path, manifest
            return manifest

    def export_artifacts(self, path: str) -> Dict[str, Any]:
        """Write the artifact bundle of every registered model: one signature
        per (model, version, bucket), the kernel library, and the manifest
        last. Serving goes on; only management operations wait."""
        from . import artifacts as _artifacts

        with self._mgmt_lock:
            return _artifacts.export_server_artifacts(self, path)

    def _export_entries(self):
        with self._lock:
            return list(self._entries.values())

    def _artifact_manifest(self, path: str, name: str):
        """Verify a bundle for one registration, degrading an incompatible
        one to None with a logged ``warn`` record (the registration then
        boots cold)."""
        from ..utils import aot

        if self._warm_path == path and self._warm_manifest is not None:
            return self._warm_manifest
        try:
            manifest = aot.load_bundle(path)
            if manifest.get("kind") != "serving":
                raise aot.ArtifactIncompatible(
                    path, f"bundle kind {manifest.get('kind')!r} is not a serving bundle")
            aot.seed_from_bundle(path, manifest)
        except aot.ArtifactIncompatible as e:
            log.warning("model %r: artifact bundle rejected (%s); booting cold", name, e.reason)
            self.telemetry.warn(reason="artifact_incompatible", path="serve", model=name,
                                bundle=path, detail=e.reason)
            return None
        self._warm_path, self._warm_manifest = path, manifest
        return manifest

    def _install_artifacts(self, e: _Entry, predictor: Predictor,
                           manifest: Dict[str, Any]) -> int:
        """Hold this model against its modules in the verified bundle and
        record the covered geometries on the predictor; geometry or
        architecture drift is a ``warn`` and 0 (a cold boot)."""
        from ..utils import aot
        from . import artifacts as _artifacts

        bundle = e.artifacts or self._warm_path or "<bundle>"
        try:
            if e.sample is None:
                raise aot.ArtifactIncompatible(
                    bundle, f"model {e.name!r} registered without sample_input: no "
                            "geometry to match the bundle against")
            entry = _artifacts.model_entry(bundle, manifest, e.name)
            _artifacts.check_geometry(bundle, entry, e.name, batch_size=predictor.batch_size,
                                      shape_buckets=e.shape_buckets, sample=e.sample,
                                      capture_state=e.drift is not None)
            return _artifacts.install_modules(bundle, manifest, entry, predictor, e.sample,
                                              e.shape_buckets)
        except aot.ArtifactIncompatible as exc:
            log.warning("model %r: artifacts unusable (%s); booting cold", e.name, exc.reason)
            self.telemetry.warn(reason="artifact_incompatible", path="serve", model=e.name,
                                bundle=bundle, detail=exc.reason)
            return 0

    # -------------------------------------------------------- registration
    def register(self, name: str, model, *, sample_input=None,
                 batch_size: Optional[int] = None,
                 shape_buckets: Optional[Sequence[int]] = None,
                 max_batch: Optional[int] = None, max_delay_ms: float = 10.0,
                 max_pending: Optional[int] = None, flush_trigger=None, quantize=False,
                 warmup: bool = True, drift=None, drift_every: int = 32,
                 artifacts: Optional[str] = None, deadline_ms: Optional[float] = None,
                 breaker=None, supervise: bool = True) -> None:
        """Host ``model`` under ``name``.

        ``sample_input`` is ONE record (no batch dim); it is required when
        the model is unbuilt. Warmup runs one forward per bucket (or one at
        the record's shape) and emits a ``warmup`` record; without a sample
        or with ``warmup=False`` it emits ``warn reason=unwarmed_model``
        instead. ``artifacts`` names a bundle (``export_artifacts``' output)
        to hold the model against (see the module docstring). ``drift``:
        ``True`` or an ``ActivationDrift``, sampled every ``drift_every``
        flushes. ``max_pending`` arms admission control
        (``AdmissionRejected`` on the caller's thread past it);
        ``deadline_ms`` the model's default request deadline
        (``infer(..., deadline_ms=...)`` overrides it); ``breaker`` the
        circuit breaker (``None``: defaults, ``False``: off);
        ``supervise=False`` keeps the model off the supervisor."""
        # the caller's sample comes to the host before the registry lock:
        # a copy from the card under it would stall every management call
        if isinstance(sample_input, torch.Tensor):
            sample_input = sample_input.cpu().numpy()
        sample = None if sample_input is None else np.asarray(sample_input)
        with self._mgmt_lock:
            with self._lock:
                if name in self._entries:
                    raise ValueError(f"model {name!r} already registered; use update() "
                                     "to hot-swap a new version")
            e = _Entry()
            e.name = name
            e.sample = sample
            if e.sample is None and not model.is_built():
                raise ValueError(f"model {name!r} is unbuilt and no sample_input was given; "
                                 "pass one record so the server can build and warm it")
            e.shape_buckets = tuple(int(b) for b in shape_buckets) if shape_buckets else None
            e.batch_size = batch_size
            e.max_batch = max_batch
            e.max_delay_ms = max_delay_ms
            e.max_pending = None if max_pending is None else int(max_pending)
            e.flush_trigger = flush_trigger
            e.drift_every = drift_every
            e.drift = _resolve_drift(drift)
            e.artifacts = artifacts
            e.deadline_ms = deadline_ms
            e.breaker = breaker
            e.supervise = bool(supervise)
            self._ensure_run()
            manifest = self._artifact_manifest(artifacts, name) if artifacts is not None else None
            self._build_entry(e, model, quantize=quantize, warmup=warmup, manifest=manifest)
            if not warmup:
                log.warning("model %r registered with warmup=False; the first request per "
                            "shape pays the setup", name)
                self.telemetry.warn(reason="unwarmed_model", path="serve", model=name)
            with self._lock:
                self._entries[name] = e
            e.batcher.start()
            if e.supervise and self.supervisor is not None:
                self.supervisor.watch(name, e.batcher)
                self.supervisor.start()

    def _build_entry(self, e: _Entry, model, *, quantize, warmup: bool,
               manifest: Optional[Dict[str, Any]]) -> None:
        """Build one registration into ``e``: build the model, quantize,
        hook drift, make the predictor, hold it against the bundle, warm it,
        derive the bucket costs and start nothing yet (the batcher is made
        here, started by the caller)."""
        self._ensure_built(e, model)
        model, e.quantized = _resolve_and_convert(e.name, model, quantize)
        e.model = model
        e.version = 1
        e.warmup_s, e.warmup_compiles, e.warmup_fresh = 0.0, 0, None
        predictor = Predictor(model, e.batch_size, e.shape_buckets,
                              capture_state=e.drift is not None)
        if e.drift is not None:
            # before the bundle check: the exported state carries the hooks'
            # entries, and the registering model's must too
            e.drift.install(model)
        try:
            e.aot_modules = (self._install_artifacts(e, predictor, manifest)
                             if manifest is not None else 0)
            if warmup:
                e.warmup_s = self._warmup(e, predictor, 1)
            e.bucket_costs = self._bucket_costs(e, predictor)
            e.batcher = ContinuousBatcher(
                predictor, name=e.name, version=1, max_batch=e.max_batch,
                max_delay_ms=e.max_delay_ms, max_pending=e.max_pending,
                deadline_ms=e.deadline_ms, breaker=e.breaker, flush_trigger=e.flush_trigger,
                telemetry=self.telemetry, drift=e.drift, drift_every=e.drift_every,
                tags={"quantized": e.quantized}, bucket_costs=e.bucket_costs,
                # heartbeats live in the supervisor's clock domain
                clock=self.supervisor.clock if self.supervisor is not None else time.monotonic)
        except Exception:
            if e.drift is not None:  # a refused registration leaves no hooks
                e.drift.release(model)
            raise
        e.predictor = predictor

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

    def _bucket_costs(self, e: _Entry, predictor: Predictor):
        """The buckets' FLOPs, counted once on the meta device at
        registration (``obs/perf.py``): the batching thread then stamps each
        serve record by arithmetic. None without a sample, or where the
        model cannot be counted (the registration goes on)."""
        if e.sample is None:
            return None
        from ..obs import perf as obs_perf

        try:
            return obs_perf.predictor_bucket_costs(predictor, e.sample, e.shape_buckets) or None
        except Exception:
            log.exception("bucket cost derivation for model %r failed; serve records carry "
                          "no cost fields", e.name)
            return None

    def _warmup(self, e: _Entry, predictor: Predictor, version: int) -> float:
        """One forward per bucket shape, waited for on the card; emits the
        ``warmup`` record. ``compiles`` / ``fresh_compiles`` count the kernel
        library's loads and ``nvcc`` builds this warmup triggered (0 or 1
        each); ``warm_start`` is True, and ``bundle`` names the bundle, when
        a bundle covered the geometries."""
        if e.sample is None:
            log.warning("model %r registered without sample_input; skipping warmup: the "
                        "first request per shape pays the setup", e.name)
            self.telemetry.warn(reason="unwarmed_model", path="serve", model=e.name)
            return 0.0
        loads, builds = _build.loads, _build.builds
        t0 = time.perf_counter()
        for shape in self._warm_shapes(e):
            predictor.forward_batch(np.zeros((1,) + shape, e.sample.dtype))
        if predictor.model.device.type == "cuda":
            torch.cuda.synchronize(predictor.model.device)
        warmup_s = time.perf_counter() - t0
        e.warmup_compiles = _build.loads - loads
        e.warmup_fresh = _build.builds - builds
        covered = bool(predictor.aot_coverage())
        self.telemetry.warmup(model=e.name, seconds=warmup_s, compiles=e.warmup_compiles,
                              fresh_compiles=e.warmup_fresh, warm_start=covered,
                              buckets=list(e.shape_buckets) if e.shape_buckets else None,
                              version=version,
                              **({"bundle": e.artifacts or self._warm_path} if covered else {}))
        return warmup_s

    # ------------------------------------------------------------ hot swap
    def update(self, name: str, new_model, *, quantize=False, warmup: bool = True) -> int:
        """Hot-swap ``name`` to ``new_model``; returns the new version. The
        new version is built and warmed while the old one keeps serving;
        the swap drains the in-flight batch, and every future resolves on
        exactly one version. With drift, the new model is hooked before its
        warmup and the old one released after the swap."""
        with self._mgmt_lock:
            e = self._entry(name)
            old_model = e.model
            version = e.version + 1
            if not new_model.is_built() and e.sample is None:
                raise ValueError(f"update({name!r}) with an unbuilt model needs the "
                                 "sample_input the original registration provided")
            self._ensure_built(e, new_model)
            new_model, quantized = _resolve_and_convert(name, new_model, quantize)
            predictor = Predictor(new_model, e.predictor.batch_size, e.shape_buckets,
                                  capture_state=e.drift is not None)
            if e.drift is not None:
                e.drift.install(new_model)
            if (e.predictor.aot_coverage() and quantized == e.quantized
                    and _apply_geometry(old_model) == _apply_geometry(new_model)):
                # the bundle's signatures hold for a same-architecture version
                predictor._aot.update(e.predictor._aot)
            prior = (e.warmup_s, e.warmup_compiles, e.warmup_fresh)
            try:
                if warmup and e.sample is not None:
                    e.warmup_s = self._warmup(e, predictor, version)
                e.batcher.swap(predictor, version, tags={"quantized": quantized})
            except Exception:
                e.warmup_s, e.warmup_compiles, e.warmup_fresh = prior
                if e.drift is not None and new_model is not old_model:
                    e.drift.release(new_model)
                raise
            # the swapped version's costs (same geometry, maybe another model)
            e.bucket_costs = self._bucket_costs(e, predictor)
            e.batcher.bucket_costs = dict(e.bucket_costs or {})
            if e.drift is not None and old_model is not new_model:
                e.drift.release(old_model)
            e.model, e.predictor, e.version, e.quantized = new_model, predictor, version, quantized
            e.aot_modules = predictor.aot_coverage()
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
            if e.drift is not None:
                e.drift.release(e.model)

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
    @property
    def metrics_port(self) -> Optional[int]:
        """The bound port of this replica's scrape endpoint (None without
        ``metrics_port=``)."""
        return None if self._endpoint is None else self._endpoint.port

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
                "aot_modules": e.aot_modules,
                "retired_versions": e.batcher.retired_versions(),
                "deadline_ms": e.deadline_ms,
                "restarts": e.batcher.restarts,
                "device": str(e.model.device),
            }
            for name, e in entries.items()
        }


def _resolve_drift(drift):
    if drift is None or drift is False:
        return None
    if drift is True:
        from ..obs.health import ActivationDrift

        return ActivationDrift()
    return drift


def _apply_geometry(model):
    """Shape and dtype of every parameter and state leaf: what a bundle's
    signature holds a model to."""
    from ..utils.aot import spec_leaves

    return spec_leaves((model.get_parameters(), model.get_state()))
