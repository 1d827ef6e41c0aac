"""Triggers (counterpart of ``bigdl_tpu/optim/trigger.py``): predicates over
a state table. The training triggers read the optimizer's table (``epoch``,
``neval``, both 1-based; ``loss``, the last loss pulled to the host, one
step late; ``score``, the first validation method's last result); the serving flush triggers read the continuous
batcher's ``{"pending": <queued requests in a bucket group>, "waited_ms":
<oldest request's wait>}``."""

from __future__ import annotations


class Trigger:
    def __call__(self, state: dict) -> bool:
        raise NotImplementedError

    @staticmethod
    def every_epoch() -> "Trigger":
        return _EveryEpoch()

    @staticmethod
    def max_epoch(n: int) -> "Trigger":
        return _Lambda(lambda s: s.get("epoch", 1) > n)

    @staticmethod
    def max_iteration(n: int) -> "Trigger":
        return _Lambda(lambda s: s.get("neval", 1) > n)

    @staticmethod
    def several_iteration(n: int) -> "Trigger":
        return _Lambda(lambda s: (s.get("neval", 1) - 1) % n == 0 and s.get("neval", 1) > 1)

    @staticmethod
    def min_loss(v: float) -> "Trigger":
        return _Lambda(lambda s: s.get("loss") is not None and s["loss"] < v)

    @staticmethod
    def max_score(v: float) -> "Trigger":
        return _Lambda(lambda s: s.get("score") is not None and s["score"] > v)

    @staticmethod
    def and_(*ts: "Trigger") -> "Trigger":
        return _Lambda(lambda s: all(t(s) for t in ts))

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


class _EveryEpoch(Trigger):
    """Fires once whenever the epoch counter advances past the last fire."""

    def __init__(self):
        self._last_epoch = 0

    def __call__(self, state) -> bool:
        e = state.get("epoch", 1)
        # the epoch advances after its last iteration; fire on the change
        if state.get("_epoch_done", False) and e != self._last_epoch:
            self._last_epoch = e
            return True
        return False
