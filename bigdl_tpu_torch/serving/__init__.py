"""Serving runtime: request queue, continuous batcher, multi-model server,
circuit breakers, the worker supervisor and artifact bundles."""

from ..resilience.errors import CircuitOpen, DeadlineExceeded
from ..utils.aot import ArtifactIncompatible
from .batcher import ContinuousBatcher, ServeStats
from .queue import (AdmissionRejected, RequestQueue, ServeFuture, ServeRequest, ServerClosed,
                    ServingStopped, WorkerCrashed)
from .resilience import BreakerConfig, CircuitBreaker, ServingSupervisor, spawn_worker
from .server import ModelServer

__all__ = ["AdmissionRejected", "ArtifactIncompatible", "BreakerConfig", "CircuitBreaker",
           "CircuitOpen", "ContinuousBatcher", "DeadlineExceeded", "ModelServer", "RequestQueue", "ServeFuture",
           "ServeRequest", "ServeStats", "ServerClosed", "ServingStopped", "ServingSupervisor",
           "WorkerCrashed", "spawn_worker"]
