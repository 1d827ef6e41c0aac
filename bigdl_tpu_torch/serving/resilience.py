"""Serving-tier resilience: circuit breakers and supervised workers
(counterpart of ``bigdl_tpu/serving/resilience.py``).

* :class:`CircuitBreaker`: per-model failure isolation. Consecutive flush
  failures, or a deadline-miss rate over a sliding outcome window, trip the
  model ``closed -> open``; an open breaker sheds at submit time with the
  typed :class:`~bigdl_tpu_torch.resilience.errors.CircuitOpen` on the
  caller's thread, half-opens on a seeded-jitter backoff to let one probe
  through, and closes on the probe's success. numpy's generator draws the
  jitter exactly as the JAX package's does, so both give the same schedule
  from the same seed.
* :class:`ServingSupervisor`: a monitor on
  :class:`~bigdl_tpu_torch.obs.watchdog.MonitorBase` that finds a dead
  batching thread (liveness) or a wedged one (heartbeat older than its
  bound), fails that model's pending futures with the typed
  :class:`~bigdl_tpu_torch.serving.queue.WorkerCrashed` and restarts the
  worker after a capped, seeded-jitter backoff.
* :func:`spawn_worker`: the one place serving starts a thread; the worker
  runs under the spawner's causal-trace context (``obs/trace.py``).

Not ported: the flight-recorder dump on a worker's death or wedge
(``obs/blackbox.py``).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..obs.watchdog import MonitorBase
from .queue import WorkerCrashed

log = logging.getLogger("bigdl_tpu_torch.serving")

__all__ = ["BreakerConfig", "CircuitBreaker", "ROUTABLE_STATES", "ServingSupervisor",
           "is_routable", "spawn_worker"]

# The model states a request-stream sharder may route traffic at. "probing"
# is routable: a half-open breaker admits exactly one probe, and shedding at
# the sharder too would starve the breaker of the request that can close it.
ROUTABLE_STATES = ("serving", "probing")


def is_routable(snapshot: Dict[str, Any]) -> bool:
    """Whether a ``ModelServer.health()`` per-model snapshot is routable."""
    return snapshot.get("state") in ROUTABLE_STATES


def spawn_worker(target: Callable[[], None], *, name: str, daemon: bool = True,
                 context: object = "inherit") -> threading.Thread:
    """Start one named serving worker thread (a daemon unless asked): the
    seam the supervisor's restart path shares, so a restarted worker is a
    freshly started one. ``context``: ``"inherit"`` (the default) binds the
    spawner's current :class:`~bigdl_tpu_torch.obs.trace.TraceContext` on
    the worker before ``target`` runs, so its spans parent onto the
    spawner's; pass a context or None to choose another."""
    from ..obs import trace as obs_trace

    ctx = obs_trace.current_context() if context == "inherit" else context

    def _entry():
        obs_trace.bind_context(ctx)
        target()

    t = threading.Thread(target=_entry, name=name, daemon=daemon)
    t.start()
    return t


# --------------------------------------------------------------------------
# circuit breaker
# --------------------------------------------------------------------------

class BreakerConfig:
    """Knobs of the per-model circuit breaker.

    Args:
        failure_threshold: consecutive flush failures that trip the breaker
            (any success resets the streak).
        miss_rate_threshold: deadline-miss fraction over the sliding outcome
            ``window`` that trips it (``None``: off).
        window: length of the per-request outcome window.
        min_samples: the rate stays quiet until the window holds this many.
        probe_backoff_s / probe_backoff_max_s / jitter / seed: the half-open
            schedule, ``min(max, base * 2**(trips-1))`` seconds after each
            trip, stretched by seeded jitter.
    """

    __slots__ = ("failure_threshold", "miss_rate_threshold", "window", "min_samples",
                 "probe_backoff_s", "probe_backoff_max_s", "jitter", "seed")

    def __init__(self, failure_threshold: int = 5,
                 miss_rate_threshold: Optional[float] = 0.5, window: int = 64,
                 min_samples: int = 16, probe_backoff_s: float = 1.0,
                 probe_backoff_max_s: float = 30.0, jitter: float = 0.1, seed: int = 0):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got {failure_threshold}")
        if miss_rate_threshold is not None and not 0 < miss_rate_threshold <= 1:
            raise ValueError(f"miss_rate_threshold must be in (0, 1], got "
                             f"{miss_rate_threshold}")
        if window < 1 or min_samples < 1:
            raise ValueError("window and min_samples must be >= 1")
        if probe_backoff_s <= 0:
            raise ValueError(f"probe_backoff_s must be positive, got {probe_backoff_s}")
        if probe_backoff_max_s <= 0:
            raise ValueError(f"probe_backoff_max_s must be positive, got "
                             f"{probe_backoff_max_s}")
        if jitter < 0:
            raise ValueError(f"jitter must be >= 0, got {jitter}")
        self.failure_threshold = int(failure_threshold)
        self.miss_rate_threshold = (None if miss_rate_threshold is None
                                    else float(miss_rate_threshold))
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.probe_backoff_s = float(probe_backoff_s)
        self.probe_backoff_max_s = float(probe_backoff_max_s)
        self.jitter = float(jitter)
        self.seed = int(seed)


class CircuitBreaker:
    """Per-model state machine: closed -> open -> half_open.

    * closed: requests flow; failures grow a consecutive streak, served
      requests reset it; misses and successes feed the outcome window.
    * open: :meth:`admit` refuses until the probe time.
    * half_open: exactly one probe is admitted; its success closes the
      breaker, its failure or deadline miss re-opens it one backoff step on.

    Thread-safe; the injected ``clock`` makes every transition testable with
    a fake clock. ``on_transition(old, new, info)`` fires outside the lock.
    """

    def __init__(self, config: Optional[BreakerConfig] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable] = None):
        self.config = config if config is not None else BreakerConfig()
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(self.config.seed)
        self._state = "closed"
        self._consecutive = 0
        # sliding per-request outcome window: True = deadline miss
        self._outcomes: collections.deque = collections.deque(maxlen=self.config.window)
        self._trips = 0
        self._probe_at: Optional[float] = None
        self._probe_live = False
        self.shed = 0  # cumulative submits refused while open

    # ----------------------------------------------------------- internals
    def _fire(self, ev) -> None:
        if ev is not None and self._on_transition is not None:
            self._on_transition(*ev)

    def _set_state(self, new: str, info: Dict[str, Any]):
        old, self._state = self._state, new
        if old == new:
            return None
        log.warning("circuit breaker: %s -> %s (%s)", old, new, info)
        return (old, new, info)

    def _open(self, reason: str):
        """Trip (or re-trip) the breaker; the caller holds the lock."""
        self._trips += 1
        backoff = min(self.config.probe_backoff_max_s,
                      self.config.probe_backoff_s * 2 ** (self._trips - 1))
        if self.config.jitter > 0:
            backoff *= 1.0 + self.config.jitter * float(self._rng.random())
        self._probe_at = self._clock() + backoff
        self._consecutive = 0
        self._outcomes.clear()  # recovery judges a fresh window
        self._probe_live = False
        return self._set_state("open", {"cause": reason, "trips": self._trips,
                                        "retry_in_s": round(backoff, 6)})

    def _miss_rate(self) -> Optional[float]:
        if not self._outcomes:
            return None
        return sum(self._outcomes) / len(self._outcomes)

    # ------------------------------------------------------------- surface
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def admit(self):
        """Submit-time gate: truthy admits, ``False`` sheds. An open breaker
        whose probe time has come goes half-open and admits one probe, for
        which the value is the string ``"probe"`` (still truthy)."""
        ev = None
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() < self._probe_at:
                    self.shed += 1
                    return False
                ev = self._set_state("half_open", {"cause": "probe_window",
                                                   "trips": self._trips})
            elif self._probe_live:  # half_open with a probe in flight
                self.shed += 1
                return False
            self._probe_live = True
        self._fire(ev)
        return "probe"

    def probe_aborted(self) -> None:
        """The admitted probe never reached the queue (or its worker died):
        free the slot, so the breaker cannot wait forever on it."""
        with self._lock:
            if self._state == "half_open":
                self._probe_live = False

    def retry_in_s(self) -> Optional[float]:
        """Seconds until the next probe slot (None unless open)."""
        with self._lock:
            if self._state != "open" or self._probe_at is None:
                return None
            return max(0.0, self._probe_at - self._clock())

    def record_success(self, n: int = 1, probe: Optional[bool] = None) -> None:
        """``n`` requests served. ``probe`` says whether the batch carried
        the half-open probe (``None``: unknown, taken as the probe)."""
        ev = None
        with self._lock:
            self._consecutive = 0
            self._outcomes.extend([False] * int(n))
            if self._state == "half_open" and probe is not False:
                ev = self._set_state("closed", {"cause": "probe_success",
                                                "trips": self._trips})
                self._probe_live = False
                self._outcomes.clear()  # misses swept while open must not re-trip
        self._fire(ev)

    def record_failure(self, n: int = 1, probe: Optional[bool] = None) -> None:
        """A failed flush covering ``n`` requests; in half_open only the
        probe's failure re-opens."""
        ev = None
        with self._lock:
            self._consecutive += int(n)
            if self._state == "half_open" and probe is not False:
                ev = self._open("probe_failure")
            elif (self._state == "closed"
                  and self._consecutive >= self.config.failure_threshold):
                ev = self._open(f"{self._consecutive} consecutive failures")
        self._fire(ev)

    def record_deadline_miss(self, n: int = 1, probe: Optional[bool] = None) -> None:
        """``n`` requests expired before they were served; in half_open only
        the probe's own expiry re-opens."""
        ev = None
        with self._lock:
            self._outcomes.extend([True] * int(n))
            if self._state == "half_open" and probe is not False:
                ev = self._open("probe_deadline_miss")
            elif (self._state == "closed" and self.config.miss_rate_threshold is not None
                  and len(self._outcomes) >= self.config.min_samples):
                rate = self._miss_rate()
                if rate >= self.config.miss_rate_threshold:
                    ev = self._open(f"deadline miss rate {rate:.2f}")
        self._fire(ev)

    def snapshot(self) -> Dict[str, Any]:
        """The health surface's view."""
        with self._lock:
            rate = self._miss_rate()
            probe_in = (max(0.0, self._probe_at - self._clock())
                        if self._state == "open" and self._probe_at is not None else None)
            return {"state": self._state, "consecutive_failures": self._consecutive,
                    "trips": self._trips,
                    "miss_rate": None if rate is None else round(rate, 4),
                    "shed": self.shed,
                    "probe_in_s": None if probe_in is None else round(probe_in, 6)}


# --------------------------------------------------------------------------
# worker supervision
# --------------------------------------------------------------------------

class _Watched:
    __slots__ = ("worker", "next_restart_at", "wedged", "gave_up")

    def __init__(self, worker):
        self.worker = worker
        self.next_restart_at: Optional[float] = None  # armed on death
        self.wedged = False
        self.gave_up = False


class ServingSupervisor(MonitorBase):
    """Monitor that keeps every model's batching worker honest.

    * A dead worker: its pending futures fail with ``WorkerCrashed`` the
      moment the death is seen, and the worker restarts after
      ``restart_backoff_base_s * 2**restarts`` (at most
      ``restart_backoff_max_s``) with seeded jitter. After ``max_restarts``
      the model is marked failed: later submits are refused typed.
    * A wedged worker (alive, heartbeat older than ``heartbeat_timeout_s``):
      its pending futures fail on every pass and a ``warn
      reason=worker_wedged`` record fires once an episode.

    :meth:`check` is a pure function of the injected clock and the workers'
    state and returns the actions it took. Worker protocol (implemented by
    ``ContinuousBatcher``): ``stopped()``, ``worker_alive()``,
    ``last_beat()``, ``fail_pending(exc)``, ``restart_worker()``,
    ``mark_failed(reason)``, ``note_wedged(bool)``, ``restarts``.
    """

    def __init__(self, *, poll_interval_s: float = 0.25, heartbeat_timeout_s: float = 30.0,
                 restart_backoff_base_s: float = 0.1, restart_backoff_max_s: float = 5.0,
                 jitter: float = 0.1, max_restarts: int = 5, seed: int = 0, telemetry=None,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(poll_interval_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.restart_backoff_base_s = float(restart_backoff_base_s)
        self.restart_backoff_max_s = float(restart_backoff_max_s)
        self.jitter = float(jitter)
        self.max_restarts = int(max_restarts)
        self.telemetry = telemetry
        # ModelServer plumbs this clock into every batcher's heartbeat, so
        # the supervisor and its workers share one time domain
        self.clock = clock
        self._rng = np.random.default_rng(int(seed))
        self._lock = threading.Lock()
        self._entries: Dict[str, _Watched] = {}

    # ------------------------------------------------------------ registry
    def watch(self, name: str, worker) -> None:
        with self._lock:
            self._entries[name] = _Watched(worker)

    def unwatch(self, name: str) -> None:
        with self._lock:
            self._entries.pop(name, None)

    def watched(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def start(self) -> "ServingSupervisor":
        self._spawn("bigdl-serving-supervisor")
        return self

    # ------------------------------------------------------------- checking
    def _backoff(self, attempt: int) -> float:
        base = min(self.restart_backoff_max_s,
                   self.restart_backoff_base_s * 2 ** max(attempt, 0))
        if self.jitter > 0:
            base *= 1.0 + self.jitter * float(self._rng.random())
        return base

    def _warn(self, reason: str, name: str, **fields) -> None:
        if self.telemetry is not None:
            self.telemetry.warn(reason=reason, path="serve", model=name, **fields)

    def check(self) -> List[Dict[str, Any]]:
        """One supervision pass; returns the actions taken."""
        with self._lock:
            items = list(self._entries.items())
        actions: List[Dict[str, Any]] = []
        now = self.clock()
        for name, w in items:
            worker = w.worker
            if worker.stopped() or w.gave_up:
                continue
            if not worker.worker_alive():
                actions.extend(self._check_dead(name, w, now))
                continue
            w.next_restart_at = None  # restart landed; re-arm death handling
            beat = worker.last_beat()
            if beat is not None and now - beat > self.heartbeat_timeout_s:
                # futures fail every pass (requests arriving mid-wedge cannot
                # hang either); the warn fires once an episode
                n = worker.fail_pending(WorkerCrashed(
                    f"batching thread for model {name!r} wedged: no heartbeat for "
                    f"{now - beat:.1f}s (bound {self.heartbeat_timeout_s:.1f}s)"))
                if not w.wedged:
                    w.wedged = True
                    worker.note_wedged(True)
                    log.warning("supervisor: worker for model %r wedged (no heartbeat "
                                "for %.1fs)", name, now - beat)
                    self._warn("worker_wedged", name, heartbeat_age_s=round(now - beat, 3),
                               failed_pending=n)
                actions.append({"model": name, "action": "wedged", "failed_pending": n})
            elif w.wedged:
                w.wedged = False
                worker.note_wedged(False)  # heartbeat resumed: routable again
        return actions

    def _check_dead(self, name: str, w: _Watched, now: float) -> List[Dict[str, Any]]:
        worker = w.worker
        if w.next_restart_at is None:
            if worker.restarts >= self.max_restarts:
                # refuse new submits first, then fail the stragglers: the
                # other order lets a racing submit queue onto a dead worker
                w.gave_up = True
                worker.mark_failed(f"worker died {worker.restarts + 1} times; restart "
                                   f"budget {self.max_restarts} exhausted")
                n = worker.fail_pending(WorkerCrashed(
                    f"batching thread for model {name!r} died"))
                log.error("supervisor: worker for model %r died and the restart budget "
                          "(%d) is exhausted; model marked failed", name, self.max_restarts)
                self._warn("worker_dead", name, restarts=worker.restarts, failed_pending=n)
                return [{"model": name, "action": "gave_up", "failed_pending": n}]
            # a death within budget: fail what is pending now, schedule the restart
            n = worker.fail_pending(WorkerCrashed(f"batching thread for model {name!r} died"))
            backoff = self._backoff(worker.restarts)
            w.next_restart_at = now + backoff
            return [{"model": name, "action": "fail_pending", "failed_pending": n,
                     "restart_in_s": round(backoff, 6)}]
        if now >= w.next_restart_at:
            restarted = worker.restart_worker()
            w.next_restart_at = None
            if restarted:
                log.warning("supervisor: restarted the batching worker for model %r "
                            "(restart #%d)", name, worker.restarts)
                self._warn("worker_restart", name, restarts=worker.restarts)
                return [{"model": name, "action": "restart", "restarts": worker.restarts}]
        return []
