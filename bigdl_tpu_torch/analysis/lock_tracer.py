"""Opt-in runtime lock sanitizer (counterpart of
``bigdl_tpu/analysis/lock_tracer.py``): the dynamic half of the concurrency
audit.

``analysis/concurrency.py`` proves lock discipline *statically*; this module
checks what the threads actually do. ``instrument_locks(obj)`` swaps an
object's ``threading.Lock``/``RLock`` attributes for named :class:`TracedLock`
proxies that record, per thread, the real acquisition orders and hold times:

- an acquisition order observed in *both* directions for the same lock pair
  (A held while taking B, elsewhere B held while taking A) is a latent
  deadlock — ``warn reason=lock_order_inversion`` telemetry, once per pair;
- an acquisition that contradicts the static lock-order graph
  (:func:`load_static_edges`) is flagged the same way, so the runtime and
  the auditor cross-check each other;
- an outermost hold longer than ``hold_warn_s`` emits
  ``warn reason=lock_hold_exceeded`` — the dynamic analogue of the static
  blocking-under-hot-lock rule (BDL018), and the seam chaos ``delay`` faults
  drive in tests. A hold times the host's clock: a kernel launched under the
  lock counts only as far as the host waited for it.

Everything is **off by default**: unless ``BIGDL_LOCK_DEBUG=1`` is set (or
``force=True`` is passed), :func:`instrument_locks` returns without touching
the object, so production paths keep raw ``threading`` primitives. The
module is pure stdlib; telemetry is duck-typed (anything with a
``warn(*, reason, **f)`` method, i.e. ``obs.telemetry.Telemetry``) and
optional.

Usage (tests / debugging)::

    import os; os.environ["BIGDL_LOCK_DEBUG"] = "1"
    from bigdl_tpu_torch.analysis import lock_tracer

    tr = lock_tracer.LockTracer(
        telemetry=tele,
        static_edges=lock_tracer.load_static_edges(["bigdl_tpu_torch"]),
    )
    lock_tracer.instrument_locks(batcher, tracer=tr)
    ...drive the object from several threads...
    tr.inversions   # [] means observed orders agree with the static graph
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "enabled",
    "instrument_locks",
    "load_static_edges",
    "LockTracer",
    "TracedLock",
]

_LOCK_TYPES = (type(threading.Lock()), type(threading.RLock()))

DEFAULT_HOLD_WARN_S = 0.25

# sys.modules key of the auditor loaded by file path (load_static_edges)
_AUDIT_MODULE_KEY = "_bigdl_torch_conc_audit"


def enabled() -> bool:
    """True iff the sanitizer is armed via ``BIGDL_LOCK_DEBUG=1``."""
    return os.environ.get("BIGDL_LOCK_DEBUG", "") == "1"


class LockTracer:
    """Shared recorder for a set of :class:`TracedLock` proxies.

    Thread-safe; its own bookkeeping lock is a raw ``threading.Lock`` and is
    never held while user code runs (records are computed, then stored)."""

    def __init__(self, telemetry=None,
                 static_edges: Optional[Iterable[Tuple[str, str]]] = None,
                 hold_warn_s: float = DEFAULT_HOLD_WARN_S):
        self.telemetry = telemetry
        self.hold_warn_s = float(hold_warn_s)
        self.static_edges: Set[Tuple[str, str]] = set(static_edges or ())
        self._meta = threading.Lock()
        self._tls = threading.local()
        # observed (held, acquired) name pairs -> first-seen site count
        self.edges: Dict[Tuple[str, str], int] = {}
        self.inversions: List[Dict] = []
        self.hold_breaches: List[Dict] = []
        self._warned_pairs: Set[Tuple[str, str]] = set()

    # ------------------------------------------------------------ held stack
    def _held(self) -> List["TracedLock"]:
        st = getattr(self._tls, "held", None)
        if st is None:
            st = self._tls.held = []
        return st

    # ------------------------------------------------------------- recording
    def note_acquired(self, lock: "TracedLock") -> None:
        held = self._held()
        records: List[Dict] = []
        with self._meta:
            for h in held:
                pair = (h.name, lock.name)
                self.edges[pair] = self.edges.get(pair, 0) + 1
                rev = (lock.name, h.name)
                key = (min(pair), max(pair))
                if key in self._warned_pairs:
                    continue
                if rev in self.edges:
                    self._warned_pairs.add(key)
                    records.append({
                        "kind": "runtime", "held": h.name,
                        "acquired": lock.name,
                    })
                elif rev in self.static_edges:
                    self._warned_pairs.add(key)
                    records.append({
                        "kind": "static", "held": h.name,
                        "acquired": lock.name,
                    })
            self.inversions.extend(records)
        held.append(lock)
        for r in records:
            self._warn(
                reason="lock_order_inversion",
                held=r["held"], acquired=r["acquired"], source=r["kind"],
            )

    def note_released(self, lock: "TracedLock", held_s: float) -> None:
        held = self._held()
        if lock in held:  # release order may not mirror acquire order
            held.remove(lock)
        if held_s > self.hold_warn_s:
            rec = {"lock": lock.name, "held_s": round(held_s, 6),
                   "limit_s": self.hold_warn_s}
            with self._meta:
                self.hold_breaches.append(rec)
            self._warn(reason="lock_hold_exceeded", **rec)

    def _warn(self, *, reason: str, **fields) -> None:
        if self.telemetry is not None:
            self.telemetry.warn(reason=reason, path="serve", **fields)


_default_tracer: Optional[LockTracer] = None
_default_tracer_guard = threading.Lock()


def default_tracer() -> LockTracer:
    """The process-wide tracer used when ``instrument_locks`` gets none."""
    global _default_tracer
    with _default_tracer_guard:
        if _default_tracer is None:
            _default_tracer = LockTracer()
        return _default_tracer


class TracedLock:
    """Context-manager proxy over a ``Lock``/``RLock`` that reports outermost
    acquire/release events (reentrant re-acquisitions are depth-counted and
    not re-recorded) to a :class:`LockTracer`."""

    __slots__ = ("_inner", "name", "_tracer", "_depth", "_t0")

    def __init__(self, inner, name: str, tracer: LockTracer):
        self._inner = inner
        self.name = name
        self._tracer = tracer
        self._depth = threading.local()
        self._t0 = threading.local()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            d = getattr(self._depth, "n", 0)
            self._depth.n = d + 1
            if d == 0:
                self._t0.at = time.perf_counter()
                self._tracer.note_acquired(self)
        return got

    def release(self) -> None:
        d = getattr(self._depth, "n", 0)
        held_s = None
        if d == 1:
            held_s = time.perf_counter() - getattr(self._t0, "at", 0.0)
        self._depth.n = max(0, d - 1)
        self._inner.release()
        # report AFTER the real release so a slow telemetry sink cannot
        # extend the measured (or actual) critical section
        if held_s is not None:
            self._tracer.note_released(self, held_s)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __repr__(self) -> str:
        return f"TracedLock({self.name!r})"


def instrument_locks(obj, telemetry=None, names: Optional[Sequence[str]] = None,
                     tracer: Optional[LockTracer] = None,
                     force: bool = False) -> List[str]:
    """Swap ``obj``'s lock attributes for traced proxies; returns the traced
    names (``ClassName._attr``). No-op (returns ``[]``) unless
    ``BIGDL_LOCK_DEBUG=1`` or ``force=True`` — the zero-overhead-off contract.

    Only plain ``Lock``/``RLock`` attributes are wrapped. ``Condition``
    objects are left alone: their wait/notify protocol needs the *native*
    lock's C-level wait hooks, and the static auditor already covers their
    discipline (BDL018).
    """
    if not (force or enabled()):
        return []
    if tracer is None:
        tracer = default_tracer()
    if telemetry is not None:
        tracer.telemetry = telemetry
    traced: List[str] = []
    cls = type(obj).__name__
    for attr, val in sorted(vars(obj).items()):
        if names is not None and attr not in names:
            continue
        if isinstance(val, TracedLock):
            continue
        if isinstance(val, _LOCK_TYPES):
            proxy = TracedLock(val, f"{cls}.{attr}", tracer)
            setattr(obj, attr, proxy)
            traced.append(proxy.name)
    return traced


def load_static_edges(paths: Sequence[str]) -> Set[Tuple[str, str]]:
    """The static lock-order relation from ``analysis/concurrency.py``,
    loaded by file path under a key of its own (``_bigdl_torch_conc_audit``:
    the JAX package's tracer registers its auditor under another, and one
    process may load both)."""
    import importlib.util
    import sys

    p = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "concurrency.py")
    spec = importlib.util.spec_from_file_location(_AUDIT_MODULE_KEY, p)
    mod = importlib.util.module_from_spec(spec)
    assert spec.loader is not None
    sys.modules[spec.name] = mod  # dataclasses resolve via sys.modules
    spec.loader.exec_module(mod)
    return mod.static_order_edges(paths)
