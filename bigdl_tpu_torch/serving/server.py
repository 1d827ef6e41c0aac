"""``ModelServer``: multi-model serving over Predictor + ContinuousBatcher
(counterpart of ``bigdl_tpu/serving/server.py``).

One process hosts N named models; each gets a fixed-batch ``Predictor``
(one geometry per shape bucket) fed by a continuous batcher with a
latency-bound flush trigger. Registration warms every bucket geometry once,
so the first real request does not pay for first-call setup (the kernel
build included).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..optim.predictor import Predictor
from .batcher import ContinuousBatcher
from .queue import ServeFuture, ServeRequest

__all__ = ["ModelServer"]


class _Entry:
    __slots__ = ("name", "model", "predictor", "batcher", "sample",
                 "shape_buckets", "max_delay_ms", "warmup_s")


class ModelServer:
    """Thread-safe multi-model serving runtime (usable as a context manager)."""

    def __init__(self):
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()

    def __enter__(self) -> "ModelServer":
        return self

    def __exit__(self, exc_type, exc_val, exc_tb) -> None:
        self.close()

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop every batcher (``drain=True`` serves queued requests first);
        a future still pending afterwards fails with ``ServerClosed``."""
        with self._lock:
            entries = list(self._entries.values())
            self._entries.clear()
        for e in entries:
            e.batcher.stop(drain=drain, timeout=timeout)

    # -------------------------------------------------------- registration
    def register(self, name: str, model, *, sample_input=None,
                 batch_size: Optional[int] = None,
                 shape_buckets: Optional[Sequence[int]] = None,
                 max_batch: Optional[int] = None, max_delay_ms: float = 10.0,
                 warmup: bool = True) -> None:
        """Host ``model`` under ``name``. ``sample_input`` is ONE record (no
        batch dim); it is required when the model is unbuilt or
        ``warmup=True``. Warmup runs one forward per bucket (or one at the
        record's shape)."""
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered")
        e = _Entry()
        e.name = name
        e.model = model
        if isinstance(sample_input, torch.Tensor):
            sample_input = sample_input.cpu().numpy()
        e.sample = None if sample_input is None else np.asarray(sample_input)
        e.shape_buckets = tuple(int(b) for b in shape_buckets) if shape_buckets else None
        e.max_delay_ms = max_delay_ms
        if e.sample is None and (warmup or not model.is_built()):
            raise ValueError(f"model {name!r}: pass sample_input (one record) to "
                             "build and warm it")
        e.predictor = Predictor(model, batch_size, e.shape_buckets)
        e.warmup_s = 0.0
        if warmup:
            t0 = time.perf_counter()
            for shape in self._warm_shapes(e):
                e.predictor.forward_batch(np.zeros((1,) + shape, e.sample.dtype))
            if model.device.type == "cuda":
                torch.cuda.synchronize(model.device)
            e.warmup_s = time.perf_counter() - t0
        elif not model.is_built():
            model._ensure_built(np.zeros((1,) + self._warm_shapes(e)[0], e.sample.dtype))
        e.batcher = ContinuousBatcher(e.predictor, name=name, max_batch=max_batch,
                                      max_delay_ms=max_delay_ms)
        with self._lock:
            if name in self._entries:
                raise ValueError(f"model {name!r} already registered")
            self._entries[name] = e
        e.batcher.start()

    @staticmethod
    def _warm_shapes(e: _Entry):
        if e.shape_buckets:
            return [(b,) + e.sample.shape[1:] for b in e.shape_buckets]
        return [e.sample.shape]

    # ------------------------------------------------------------- serving
    def _entry(self, name: str) -> _Entry:
        with self._lock:
            e = self._entries.get(name)
        if e is None:
            raise KeyError(f"no model registered as {name!r}")
        return e

    def infer(self, name: str, record) -> ServeFuture:
        """Submit ONE record (no batch dim); returns its future. The record
        is bucket-classified on the calling thread."""
        e = self._entry(name)
        feat = np.asarray(record)
        bucket = e.predictor.bucket_of(feat.shape[0]) if e.shape_buckets else None
        return e.batcher.submit(ServeRequest(feat, bucket))

    def predict(self, name: str, records, timeout: Optional[float] = None) -> torch.Tensor:
        """Blocking convenience: submit every record, gather in order, stack."""
        futs = [self.infer(name, r) for r in records]
        return torch.stack([f.result(timeout) for f in futs])

    def models(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            entries = dict(self._entries)
        return {
            name: {
                "batch_size": e.predictor.batch_size,
                "max_batch": e.batcher.max_batch,
                "max_delay_ms": e.max_delay_ms,
                "shape_buckets": e.shape_buckets,
                "queue_depth": e.batcher.queue.depth(),
                "flushes": e.batcher.flushes,
                "warmup_s": e.warmup_s,
                "device": str(e.model.device),
            }
            for name, e in entries.items()
        }
