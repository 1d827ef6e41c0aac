"""Serving flush triggers (counterpart of ``bigdl_tpu/optim/trigger.py``,
the part the continuous batcher composes): predicates over a state table
``{"pending": <queued requests in a bucket group>, "waited_ms": <oldest
request's wait>}``."""

from __future__ import annotations


class Trigger:
    def __call__(self, state: dict) -> bool:
        raise NotImplementedError

    @staticmethod
    def or_(*ts: "Trigger") -> "Trigger":
        return _Lambda(lambda s: any(t(s) for t in ts))

    @staticmethod
    def pending_at_least(n: int) -> "Trigger":
        """Fires when a batch group holds at least ``n`` queued requests."""
        return _Lambda(lambda s: s.get("pending", 0) >= n)

    @staticmethod
    def waited_ms(ms: float) -> "Trigger":
        """Fires when the oldest queued request has waited at least ``ms``."""
        return _Lambda(lambda s: s.get("waited_ms", 0.0) >= ms)


class _Lambda(Trigger):
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, state) -> bool:
        return bool(self.fn(state))
