"""Serving runtime: request queue, continuous batcher, multi-model server."""

from .batcher import ContinuousBatcher
from .queue import RequestQueue, ServeFuture, ServeRequest, ServerClosed, ServingStopped
from .server import ModelServer

__all__ = ["ContinuousBatcher", "ModelServer", "RequestQueue", "ServeFuture",
           "ServeRequest", "ServerClosed", "ServingStopped"]
