"""Elastic data-parallel training (counterpart of
``bigdl_tpu/resilience/elastic.py``, docs/resilience.md "Elastic fleet").

When a host stops beating mid-fit, training continues on the survivors;
when it beats again, it rejoins at the next epoch boundary.

* :class:`ElasticCoordinator` takes the
  :class:`~bigdl_tpu_torch.obs.fleet.FleetMonitor` 's ``host_lost``
  verdict, owns the active membership and the fleet generation, and gives
  the optimizer what is shaped by the topology: the survivors' ``[lo, hi)``
  bounds of the padded flat master (``FlatParameter.shard_bounds``, what a
  fleet checkpoint's shards hold), the data mesh and the hybrid mesh over
  them, and each process's reader slice.
* :class:`SimulatedPeer` / :class:`SimulatedFleet` impersonate hosts as
  heartbeat writers under a fake clock (the JAX package's harness).

The JAX runtime has a single controller process that owns every device, a
host is a block of them, and a shrink is a new program over fewer devices.
Here one process is one rank, and one host is one rank. So the runtime
agrees on one decision a boundary across the ranks:

* the lowest active rank's coordinator owns the monitor's verdict. At every
  step boundary it broadcasts the decision (none, shrink these members,
  rejoin these members, done) with the step as a small CPU ``int64``
  tensor over a gloo group of the whole world (:meth:`agree`), which adds
  no device-to-host copy. Every rank of the world takes part, parked ones
  too;
* on a shrink, every rank of the current group writes its shard of the
  emergency fleet checkpoint, the dropped one too, so the checkpoint holds
  the whole master; then every rank of the world makes the survivors'
  groups in the same order (:meth:`group_for`, cached by membership: the
  per-mesh compile cache of the JAX package) and the survivors re-cut the
  flat master for their count and continue;
* a dropped rank parks (:meth:`park`): it follows the decisions until one
  names it in a rejoin (its heartbeat is fresh again at an epoch boundary:
  the survivors write a checkpoint of the next generation, and every
  member restores it on the whole group again) or the fit is done;
* every group made here has ``ElasticConfig.timeout_s`` as its timeout, so
  a rank that really dies makes the others raise within it.

Chaos seams (``FLEET_SEAMS``): ``hb_write`` inside every heartbeat write,
``coordinate`` before the emergency checkpoint, ``reshard`` / ``rejoin``
inside ``Optimizer._apply_remesh``. Nothing here touches a device at
module scope.
"""

from __future__ import annotations

import datetime
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs.fleet import FleetMonitor, process_identity, read_heartbeats, write_heartbeat
from .errors import ElasticFleetExhausted, ElasticRemesh, FaultInjected

log = logging.getLogger("bigdl_tpu_torch.resilience")

__all__ = ["ElasticConfig", "ElasticCoordinator", "SimulatedFleet", "SimulatedPeer"]

# the decision kinds of one boundary (the first word of the broadcast)
NONE, SHRINK, REJOIN, DONE = 0, 1, 2, 3


@dataclass
class ElasticConfig:
    """Knobs of the elastic runtime (``Optimizer.set_elastic``), the JAX
    package's: ``stale_after_s`` / ``poll_interval_s`` / ``min_fleet_steps``
    parameterise the owned :class:`FleetMonitor` (ignored when ``monitor``
    injects one); ``min_processes`` is the floor under which a shrink
    raises :class:`~bigdl_tpu_torch.resilience.errors.ElasticFleetExhausted`;
    ``rejoin=False`` keeps the shrunk group; ``rejoin_fresh_s`` is how
    recent a returning host's heartbeat must be (default
    ``stale_after_s``); ``start_monitor=True`` runs the monitor's own poll
    thread (the default checks inline at the step boundaries);
    ``wall_clock`` is injectable for fake-clock tests. ``timeout_s`` is the
    port's: the timeout of every process group the runtime makes."""

    stale_after_s: float = 60.0
    poll_interval_s: float = 5.0
    min_processes: int = 1
    rejoin: bool = True
    rejoin_fresh_s: Optional[float] = None
    min_fleet_steps: int = 8
    monitor: Optional[FleetMonitor] = None
    start_monitor: bool = False
    wall_clock: Callable[[], float] = time.time
    timeout_s: float = 300.0


class ElasticCoordinator:
    """The membership and topology of an elastic run (module docstring).

    ``note_host_lost`` arrives from the monitor's callback (its thread, or
    the training thread's inline ``check()``); the rest runs on the training thread.
    ``_lock`` guards the membership lists."""

    def __init__(self, config: Optional[ElasticConfig] = None, *, run_dir: Optional[str] = None,
                 telemetry=None):
        self.config = config or ElasticConfig()
        ident = process_identity()
        self.process_index = int(ident["process_index"])
        self.process_count = max(1, int(ident["process_count"]))
        self.run_dir = run_dir
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._active: List[int] = list(range(self.process_count))
        self._pending_lost: List[int] = []  # guarded-by: _lock
        self.generation = 0
        self.reshard_count = 0
        self.monitor = self.config.monitor
        self._monitor_owned = False
        self._monitor_cb_installed = False
        self._next_poll = 0.0
        self._ctl = None  # the world's gloo group of the decisions
        self._groups: Dict[Tuple[int, ...], Any] = {}  # membership -> (group, cpu group)
        self._meshes: Dict[tuple, Any] = {}  # (membership, shape) -> Mesh
        if self.monitor is not None:
            self._install_monitor_cb()

    # ------------------------------------------------------------- lifecycle
    def bind(self, *, run_dir: Optional[str] = None, telemetry=None) -> "ElasticCoordinator":
        """Late-bind the run's directory and telemetry at ``optimize()``
        entry and make the owned monitor once a run directory is known;
        while the membership is pristine the identity is read again (the
        group may be joined between construction and the fit)."""
        with self._lock:
            if (self.generation == 0 and self.reshard_count == 0 and not self._pending_lost
                    and len(self._active) == self.process_count):
                ident = process_identity()
                self.process_index = int(ident["process_index"])
                self.process_count = max(1, int(ident["process_count"]))
                self._active = list(range(self.process_count))
        if run_dir:
            self.run_dir = run_dir
        if telemetry is not None:
            self.telemetry = telemetry
        if self.monitor is None and self.run_dir:
            cfg = self.config
            self.monitor = FleetMonitor(self.run_dir, self.telemetry,
                                        stale_after_s=cfg.stale_after_s,
                                        poll_interval_s=cfg.poll_interval_s,
                                        min_fleet_steps=cfg.min_fleet_steps,
                                        wall_clock=cfg.wall_clock)
            self._monitor_owned = True
        if self.monitor is not None:
            if self.monitor.telemetry is None and self.telemetry is not None:
                self.monitor.telemetry = self.telemetry
            self._install_monitor_cb()
        return self

    def _install_monitor_cb(self) -> None:
        if not self._monitor_cb_installed:
            self.monitor.add_callback(self._on_fleet_event)
            self._monitor_cb_installed = True

    def start(self) -> "ElasticCoordinator":
        if self.monitor is not None and self.config.start_monitor:
            self.monitor.start()
        return self

    def stop(self) -> None:
        if self.monitor is not None and self._monitor_owned and self.config.start_monitor:
            self.monitor.stop()

    # ------------------------------------------------------------ membership
    def _on_fleet_event(self, ev: Dict) -> None:
        if ev.get("reason") != "host_lost":
            return  # host_left (a clean exit) and stragglers reshard nothing
        try:
            self.note_host_lost(int(ev.get("process_index")))
        except (TypeError, ValueError):
            pass

    def note_host_lost(self, k: int) -> None:
        """Queue a shrink for process ``k``, claimed at the next step
        boundary (:meth:`poll`, :meth:`take_shrink`)."""
        with self._lock:
            if k == self.process_index:
                return  # this process is alive
            if k in self._active and k not in self._pending_lost:
                self._pending_lost.append(int(k))
                log.warning("elastic: host p%d flagged lost; survivor reshard pending at the "
                            "next step boundary", k)

    def poll(self) -> List[int]:
        """Drive the unthreaded monitor at its cadence; the pending lost
        hosts."""
        mon = self.monitor
        if mon is not None and not self.config.start_monitor:
            now = self.config.wall_clock()
            if now >= self._next_poll:
                self._next_poll = now + max(0.0, float(self.config.poll_interval_s))
                mon.check()
        with self._lock:
            return [k for k in self._pending_lost if k in self._active]

    def take_shrink(self) -> List[int]:
        """Claim the pending lost hosts (the queue is cleared)."""
        with self._lock:
            lost = [k for k in self._pending_lost if k in self._active]
            self._pending_lost.clear()
            return lost

    def check_viable(self, lost: List[int]) -> None:
        """Raise :class:`ElasticFleetExhausted` (after a postmortem) when
        the shrink would leave fewer than ``min_processes``; called after
        the emergency checkpoint, so the run stays resumable."""
        with self._lock:
            survivors = [k for k in self._active if k not in lost]
        if len(survivors) < max(1, int(self.config.min_processes)):
            exc = ElasticFleetExhausted(survivors, lost, self.config.min_processes)
            self._dump_postmortem(exc, lost)
            raise exc

    def _dump_postmortem(self, exc: BaseException, lost: List[int]) -> None:
        try:
            from ..obs import blackbox

            blackbox.dump_postmortem("elastic_fleet_exhausted", run_dir=self.run_dir,
                                     telemetry=self.telemetry, error=exc,
                                     extra={"lost": list(lost)})
        except Exception:  # the typed error is about to raise; the dump is best-effort
            log.debug("exhaustion postmortem failed", exc_info=True)

    def coordinate(self, step: int, kind: str = "shrink") -> int:
        """The coordination point before a fleet checkpoint (chaos seam
        ``coordinate``): claims the next fleet generation, which the
        checkpoint written right after carries."""
        from ..obs.trace import fault_point, span

        with span("elastic_coordinate"):
            fault_point("coordinate")
            with self._lock:
                self.generation += 1
                gen = self.generation
        log.warning("elastic: coordinated %s at step %d (fleet generation %d)", kind, step, gen)
        return gen

    def apply_shrink(self, lost: List[int]) -> List[int]:
        """The membership without ``lost``; the new active list."""
        with self._lock:
            survivors = [k for k in self._active if k not in lost]
            if len(survivors) < max(1, int(self.config.min_processes)):
                exc = ElasticFleetExhausted(survivors, lost, self.config.min_processes)
                self._dump_postmortem(exc, lost)
                raise exc
            self._active = survivors
            self.reshard_count += 1
            return list(survivors)

    def rejoin_ready(self) -> List[int]:
        """The inactive processes whose heartbeat is fresh again (and not a
        ``leaving`` sentinel)."""
        cfg = self.config
        if not cfg.rejoin or not self.run_dir:
            return []
        with self._lock:
            inactive = [k for k in range(self.process_count) if k not in self._active]
        if not inactive:
            return []
        beats = read_heartbeats(self.run_dir)
        now = cfg.wall_clock()
        fresh_s = cfg.rejoin_fresh_s if cfg.rejoin_fresh_s is not None else cfg.stale_after_s
        joined = []
        for k in inactive:
            hb = beats.get(k)
            if not hb or hb.get("leaving"):
                continue
            ts = hb.get("ts")
            if isinstance(ts, (int, float)) and (now - ts) <= fresh_s:
                joined.append(k)
        return joined

    def apply_rejoin(self, joined: List[int]) -> List[int]:
        """The membership with ``joined`` back; the new active list."""
        with self._lock:
            self._active = sorted(set(self._active) | {int(k) for k in joined})
            return list(self._active)

    def active(self) -> List[int]:
        with self._lock:
            return list(self._active)

    def n_active(self) -> int:
        with self._lock:
            return len(self._active)

    def is_full(self) -> bool:
        with self._lock:
            return len(self._active) == self.process_count

    def is_member(self) -> bool:
        """Whether this process is in the active membership."""
        with self._lock:
            return self.process_index in self._active

    # -------------------------------------------------------------- topology
    def device_blocks(self, devices: List) -> Dict[int, List]:
        """The whole device (here: rank) list in equal contiguous blocks,
        one a process."""
        n, count = len(devices), self.process_count
        if n % count:
            raise ValueError(f"{n} devices do not split evenly over {count} processes")
        per = n // count
        return {k: list(devices[k * per:(k + 1) * per]) for k in range(count)}

    def active_devices(self, devices: List) -> List:
        blocks = self.device_blocks(devices)
        out: List = []
        for k in self.active():
            out.extend(blocks[k])
        return out

    def mesh(self, base_mesh):
        """The 1-D data mesh over the active ranks: ``base_mesh`` itself at
        full strength, else a mesh over the survivors' blocks (its groups
        made on every rank, cached by membership)."""
        if self.is_full():
            return base_mesh
        active = self.active_devices([int(r) for r in base_mesh.devices.reshape(-1)])
        return self._mesh_over(active, {base_mesh.axis_names[0]: len(active)})

    def hybrid_mesh(self, base_mesh, data_axis: str = "data", members: Optional[List[int]] = None):
        """A hybrid mesh's elastic view: only the leading data axis shrinks,
        and the block of the other axes must tile the survivors. ``members``
        (default: the active ones) lets a rank outside them make the same
        groups."""
        from ..parallel.hybrid import ParallelCompositionError

        members = self.active() if members is None else sorted(int(k) for k in members)
        if len(members) == self.process_count:
            return base_mesh
        names = tuple(base_mesh.axis_names)
        if not names or names[0] != data_axis:
            raise ParallelCompositionError(
                f"elastic hybrid training needs the data axis leading the mesh (axes {names}); "
                "only the data axis can shrink")
        shape = tuple(int(base_mesh.shape[n]) for n in names)
        model_block = 1
        for s in shape[1:]:
            model_block *= s
        blocks = self.device_blocks([int(r) for r in base_mesh.devices.reshape(-1)])
        active = [r for k in members for r in blocks[k]]
        if len(active) % model_block:
            raise ParallelCompositionError(
                f"{len(active)} surviving devices do not tile the model-axes block of "
                f"{model_block} (mesh {dict(zip(names, shape))})")
        return self._mesh_over(active, dict(zip(names, (len(active) // model_block,) + shape[1:])))

    def _mesh_over(self, ranks: List[int], axis_sizes: Dict[str, int]):
        from ..parallel.sharding import Mesh

        key = (tuple(ranks), tuple(axis_sizes.items()))
        if key not in self._meshes:
            self._meshes[key] = Mesh(axis_sizes, ranks=ranks, whole_group=self.group_for(ranks))
        return self._meshes[key]

    def process_bounds(self, fp) -> Dict[int, Tuple[int, int]]:
        """Each active process's ``[lo, hi)`` of the padded flat vector of
        codec ``fp`` (what ``shard.p<k>.<step>.npz`` holds)."""
        active = self.active()
        count = len(active)
        if fp.n_shards % count:
            raise ValueError(f"codec n_shards={fp.n_shards} does not split over {count} active "
                             "processes")
        per = fp.n_shards // count
        out: Dict[int, Tuple[int, int]] = {}
        for pos, k in enumerate(active):
            lo, _ = fp.shard_bounds(pos * per)
            _, hi = fp.shard_bounds((pos + 1) * per - 1)
            out[k] = (lo, hi)
        return out

    # --------------------------------------------------------- reader slicing
    def reader_slice(self) -> Optional[Tuple[int, int]]:
        """``(index, count)`` of this process among the active ones under a
        process group (None without one, and for a process outside the
        membership: it must not read the stream while it waits)."""
        from ..utils.engine import Engine

        if Engine.process_slice() is None:
            return None
        with self._lock:
            if self.process_index not in self._active:
                return None
            return self._active.index(self.process_index), len(self._active)

    def reader_slices(self) -> Dict[int, Tuple[int, int]]:
        """Every active process's reader slice."""
        active = sorted(self.active())
        return {k: (i, len(active)) for i, k in enumerate(active)}

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"process_index": self.process_index, "process_count": self.process_count,
                    "active": list(self._active), "pending_lost": list(self._pending_lost),
                    "generation": self.generation, "reshard_count": self.reshard_count}

    # ------------------------------------------------------ the ranks' accord
    def _timeout(self) -> datetime.timedelta:
        return datetime.timedelta(seconds=float(self.config.timeout_s))

    def attach(self) -> None:
        """Make the world's decision group (collective on every rank, once
        a coordinator); a no-op without a process group."""
        import torch.distributed as dist

        from ..utils.engine import Engine

        sl = Engine.process_slice()
        if sl is None and self.process_count > 1:
            raise ValueError(f"elastic membership of {self.process_count} processes needs "
                             "their process group (Engine.init_distributed): one rank a host")
        if self._ctl is not None or sl is None:
            return
        world = sl[1]
        if world != self.process_count:
            raise ValueError(f"elastic membership of {self.process_count} processes does not "
                             f"match the process group's {world} ranks")
        self._ctl = dist.new_group(list(range(world)), backend="gloo", timeout=self._timeout())
        full = tuple(range(world))
        self._groups[full] = (None, self._ctl)

    def group_for(self, members) -> Any:
        """The process group of ``members`` (the default group for the
        whole world); made on every rank of the world in the same order,
        once a membership."""
        return self._group_pair(members)[0]

    def cpu_group_for(self, members) -> Any:
        """A gloo group of ``members`` for host objects (the fleet
        checkpoint's shard entries)."""
        return self._group_pair(members)[1]

    def _group_pair(self, members):
        import torch.distributed as dist

        key = tuple(sorted(int(k) for k in members))
        if key not in self._groups:
            if self._ctl is None:
                self._groups[key] = (None, None)
            else:
                t = self._timeout()
                self._groups[key] = (dist.new_group(list(key), timeout=t),
                                     dist.new_group(list(key), backend="gloo", timeout=t))
        return self._groups[key]

    def activate(self) -> None:
        """Make the active membership the group of ``parallel._comm``."""
        from ..parallel import _comm

        active = self.active()
        if self._ctl is None or len(active) == self.process_count:
            _comm.set_active(None, None)
        else:
            _comm.set_active(self.group_for(active), active)

    def coordinator(self) -> int:
        """The rank whose monitor decides: the lowest active one."""
        return min(self.active())

    def _exchange(self, kind: int = NONE, members=(), step: int = -1
                  ) -> Tuple[int, List[int], int]:
        """The coordinator's decision on every rank of the world (one gloo
        broadcast of a CPU int64 vector); the others' arguments are
        ignored."""
        if self._ctl is None:
            return kind, list(members), step
        import torch
        import torch.distributed as dist

        buf = torch.full((3 + self.process_count,), -1, dtype=torch.int64)
        src = self.coordinator()
        if self.process_index == src:
            buf[0], buf[1], buf[2] = int(kind), int(step), len(members)
            for i, k in enumerate(members):
                buf[3 + i] = int(k)
        dist.broadcast(buf, src=src, group=self._ctl)
        vals = buf.tolist()
        return vals[0], vals[3:3 + vals[2]], vals[1]

    def agree(self, point: str, step: int) -> Tuple[int, List[int]]:
        """Every active rank at a boundary: ``point`` ``"step"`` (the
        coordinator polls the monitor and claims a shrink), ``"epoch"`` (it
        looks for returned hosts) or ``"end"`` (done). Returns the agreed
        ``(kind, members)``."""
        kind, members = NONE, []
        if self.process_index == self.coordinator():
            if point == "step":
                if self.poll():
                    members = self.take_shrink()
                    kind = SHRINK if members else NONE
            elif point == "epoch":
                members = self.rejoin_ready()
                kind = REJOIN if members else NONE
            else:
                kind = DONE
        kind, members, _ = self._exchange(kind, members, step)
        return kind, members

    def sync(self) -> None:
        """Every rank of the world waits here (after a fleet checkpoint's
        manifest is written)."""
        if self._ctl is not None:
            import torch.distributed as dist

            dist.barrier(group=self._ctl)

    def park(self, on_membership: Callable[[List[int]], None], beat=None
             ) -> Optional[ElasticRemesh]:
        """A rank outside the membership follows the decisions: a shrink or
        a rejoin of others changes the membership (``on_membership`` makes
        its groups here as on the members); a rejoin that names this rank
        returns its :class:`ElasticRemesh`; ``done`` returns None. ``beat``,
        when given, is called with the step after every decision (the
        rank's heartbeat while it waits)."""
        log.warning("elastic: process %d parked outside the membership %s", self.process_index,
                    self.active())
        while True:
            kind, members, step = self._exchange()
            if beat is not None:
                beat(step)
            if kind == NONE:
                continue
            if kind == DONE:
                return None
            self.coordinate(step, kind="shrink" if kind == SHRINK else "rejoin")
            self.sync()
            if kind == SHRINK:
                self.check_viable(members)
                on_membership(self.apply_shrink(members))
            elif self.process_index in members:
                return ElasticRemesh("rejoin", members, step=step)
            else:
                on_membership(self.apply_rejoin(members))


# --------------------------------------------------------------------------
# simulated fleet harness
# --------------------------------------------------------------------------

class SimulatedPeer:
    """One impersonated fleet process: a heartbeat writer with the
    ``BIGDL_PROCESS_INDEX`` / ``BIGDL_HOST_TAG`` identity shape.
    ``kill()`` stops its beats silently (``host_lost`` after
    ``stale_after_s``), ``leave()`` writes the ``leaving`` sentinel first
    (``host_left``), ``revive()`` resumes them (the epoch-boundary rejoin).
    Thread-free tests skip :meth:`start` and call :meth:`beat`."""

    def __init__(self, run_dir: str, index: int, count: int, *, interval_s: float = 0.05,
                 host_tag: Optional[str] = None, clock: Callable[[], float] = time.time):
        self.identity = {"process_index": int(index), "process_count": int(count),
                         "host": host_tag or f"sim-host-{int(index)}"}
        self.run_dir = run_dir
        self.interval_s = float(interval_s)
        self.clock = clock
        self.step = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def index(self) -> int:
        return int(self.identity["process_index"])

    def beat(self, step: Optional[int] = None, leaving: bool = False) -> None:
        """Write one heartbeat now (an armed ``hb_write`` seam swallows it:
        the simulated death)."""
        if step is not None:
            self.step = int(step)
        try:
            write_heartbeat(self.run_dir, identity=self.identity, step=self.step,
                            leaving=leaving, clock=self.clock)
        except FaultInjected:
            pass

    def start(self) -> "SimulatedPeer":
        if self._thread is not None:
            return self
        self._stop.clear()

        def run():
            self.beat()
            while not self._stop.wait(self.interval_s):
                self.step += 1
                self.beat()

        self._thread = threading.Thread(target=run, name=f"bigdl-sim-peer-{self.index}",
                                        daemon=True)
        self._thread.start()
        return self

    def kill(self) -> None:
        """Silent death: the heartbeats stop."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def leave(self) -> None:
        """Graceful shutdown: the ``leaving`` sentinel."""
        self.kill()
        self.beat(leaving=True)

    def revive(self) -> None:
        """The heartbeats resume."""
        self.start()


class SimulatedFleet:
    """A stand-in for an N-host fleet: the caller is p0 and peers p1..N-1
    are heartbeat writers. Entering exports ``BIGDL_PROCESS_INDEX=0`` /
    ``BIGDL_PROCESS_COUNT=N`` (restored on exit, when the writers stop);
    ``threads=False`` keeps it thread-free (:meth:`beat_all`). In a run of
    N spawned ranks, the lowest rank holds it and the peers stand for the
    other ranks' hosts: ``kill(k)`` stops rank k's heartbeats while the
    rank goes on living, as the JAX package's peer's devices do."""

    def __init__(self, run_dir: str, count: int, *, interval_s: float = 0.05,
                 threads: bool = True, clock: Callable[[], float] = time.time):
        if count < 2:
            raise ValueError(f"a simulated fleet needs >= 2 processes, got {count}")
        self.run_dir = run_dir
        self.count = int(count)
        self.threads = bool(threads)
        self.clock = clock
        self.peers: Dict[int, SimulatedPeer] = {
            k: SimulatedPeer(run_dir, k, self.count, interval_s=interval_s, clock=clock)
            for k in range(1, self.count)}
        self._saved_env: Optional[Dict[str, Optional[str]]] = None

    def __enter__(self) -> "SimulatedFleet":
        self._saved_env = {n: os.environ.get(n)
                           for n in ("BIGDL_PROCESS_INDEX", "BIGDL_PROCESS_COUNT")}
        os.environ["BIGDL_PROCESS_INDEX"] = "0"
        os.environ["BIGDL_PROCESS_COUNT"] = str(self.count)
        for p in self.peers.values():
            if self.threads:
                p.start()
            else:
                p.beat()
        return self

    def __exit__(self, *exc_info) -> None:
        for p in self.peers.values():
            p.kill()
        for n, v in (self._saved_env or {}).items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v
        self._saved_env = None

    def beat_all(self, step: Optional[int] = None) -> None:
        """One heartbeat from every peer that is not killed."""
        for p in self.peers.values():
            if p._thread is None and not p._stop.is_set():
                p.beat(step)

    def kill(self, k: int) -> None:
        self.peers[k].kill()

    def leave(self, k: int) -> None:
        self.peers[k].leave()

    def revive(self, k: int) -> None:
        p = self.peers[k]
        p._stop.clear()
        if self.threads:
            p.revive()
        else:
            p.beat()
