"""Engine: the process-wide numeric policy and the default device.

Counterpart of ``bigdl_tpu/utils/engine.py`` reduced to what the port uses:
the compute/activation dtype policy (``compute_dtype`` / ``set_compute_dtype``
/ ``activation_dtype`` / ``set_activation_dtype``), the fused-kernel switch
(``fused_kernels`` / ``set_fused_kernels``), device resolution, the
process group of a multi-process run, its default mesh (``mesh()``), the
sequence-parallel registration (``set_sequence_parallel``), the run
directory (``set_run_dir`` / ``run_dir`` / ``run_subdir``), the kernel
library's cache directory (``set_compilation_cache_dir`` /
``ensure_compilation_cache``, ``BIGDL_COMPILE_CACHE_DIR``) and the scrape
endpoint's port (``set_metrics_port`` / ``metrics_port``,
``BIGDL_METRICS_PORT``).

Entry points run on the card: ``Engine.device(None)`` is ``cuda`` and raises
when no CUDA device is present; the CPU is used only when asked for
(``device="cpu"``), as the tests do.

``Engine.init_distributed(coordinator_address, num_processes, process_id)``
joins this process, as one rank, to a ``torch.distributed`` group (the JAX
package's ``jax.distributed.initialize``; one rank a process, where the
JAX package counts devices). Missing arguments come from the JAX package's
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``,
then from torchrun's ``MASTER_ADDR``:``MASTER_PORT`` / ``WORLD_SIZE`` /
``RANK``. The rank's device is the card, ``cuda:LOCAL_RANK`` when every
rank has a card of its own and ``cuda:0`` when more ranks than cards share
one, unless ``device="cpu"``. The backend is fixed there and then: NCCL
when each rank has its own card, gloo on the CPU and when ranks share a
card (NCCL refuses two ranks on one device). ``Engine.backend()`` reads
it; ``device_count()`` (the world size), ``node_number()``,
``core_number()`` and ``process_slice()`` are the JAX package's accessors
over the group.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional, Tuple, Union

import torch

log = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        for name, dt in _DTYPES.items():
            if dt == dtype:
                return name
    elif str(dtype) in _DTYPES:
        return str(dtype)
    raise ValueError(f"unsupported dtype {dtype!r}; expected one of {sorted(_DTYPES)}")


class Engine:
    _lock = threading.Lock()
    _compute_dtype: Optional[str] = None
    _activation_dtype: Optional[str] = None
    _fused_kernels: Optional[bool] = None
    # the data-parallel group: (backend, rank, world size, the rank's device)
    _group: Optional[Tuple[str, int, int, torch.device]] = None
    _mesh = None  # Engine.mesh()'s 1-D data mesh over the group, built at first use
    _sequence_parallel: Optional[tuple] = None  # (mesh, axis name) of the ring route
    _run_dir: Optional[str] = None
    _compilation_cache_dir: Optional[str] = None
    _cache_pruned = False
    _metrics_port: Optional[int] = None
    _metrics_port_env_read = False

    @classmethod
    def device(cls, device: Union[str, torch.device, None] = None) -> torch.device:
        """Resolve an entry point's ``device`` argument: ``None`` means the
        card (``cuda``), which must exist; anything else is taken as asked."""
        dev = torch.device("cuda" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return dev

    @classmethod
    def compute_dtype(cls) -> str:
        """Dtype of matmul OPERANDS in the hot paths (accumulation is fp32).
        Default: bfloat16 where a card is present, float32 otherwise — the
        JAX package's backend rule (bf16 on the accelerator, exact f32 on
        the CPU)."""
        if cls._compute_dtype is not None:
            return cls._compute_dtype
        return "bfloat16" if torch.cuda.is_available() else "float32"

    @classmethod
    def set_compute_dtype(cls, dtype) -> None:
        with cls._lock:
            cls._compute_dtype = None if dtype is None else _dtype_name(dtype)

    @classmethod
    def activation_dtype(cls) -> Optional[str]:
        """Dtype hot-op OUTPUTS keep (None = upcast to float32, the default)."""
        return cls._activation_dtype

    @classmethod
    def set_activation_dtype(cls, dtype) -> None:
        with cls._lock:
            cls._activation_dtype = None if dtype is None else _dtype_name(dtype)

    @classmethod
    def set_fused_kernels(cls, enabled: Optional[bool]) -> None:
        """Opt into (``True``) or out of (``False``) the fused-kernel paths:
        the ``Linear``/``SpatialConvolution`` bias+activation epilogues run
        :func:`bigdl_tpu_torch.ops.fused_epilogue.fused_bias_act` (a CUDA
        kernel on the card, its plain version on the CPU). ``None`` goes back
        to the ``BIGDL_FUSED_KERNELS`` default. The JAX package reads its
        switch at trace time; the port reads it at every call, so a flip
        takes effect at the next forward."""
        with cls._lock:
            cls._fused_kernels = None if enabled is None else bool(enabled)

    @classmethod
    def fused_kernels(cls) -> bool:
        """The fused-kernel switch (default: the ``BIGDL_FUSED_KERNELS`` env
        flag, i.e. off)."""
        if cls._fused_kernels is not None:
            return cls._fused_kernels
        return env_flag("BIGDL_FUSED_KERNELS")

    # ---------------------------------------------------- the compile cache
    @classmethod
    def set_compilation_cache_dir(cls, path: Optional[str]) -> None:
        """Keep the kernel library (``ops/_build.py``: the ``nvcc`` build
        and its source-hash stamp) under ``path`` instead of
        ``build/kernels``: a process started on a directory that already
        holds an up-to-date library loads it and builds nothing. The port's
        counterpart of the JAX package's persistent compilation cache, and
        reachable the same way, through ``BIGDL_COMPILE_CACHE_DIR``. ``None``
        clears it (the environment variable is read again)."""
        if path is not None:
            path = os.path.abspath(path)
            os.makedirs(path, exist_ok=True)
        with cls._lock:
            cls._compilation_cache_dir = path

    @classmethod
    def ensure_compilation_cache(cls) -> Optional[str]:
        """Apply ``BIGDL_COMPILE_CACHE_DIR`` when no directory is set yet
        (re-read while unset), pruning it once a process when
        ``BIGDL_COMPILE_CACHE_MAX_BYTES`` / ``BIGDL_COMPILE_CACHE_MAX_AGE_DAYS``
        are set; returns the directory, or None."""
        if cls._compilation_cache_dir is None:
            env = os.environ.get("BIGDL_COMPILE_CACHE_DIR")
            if env:
                cls.set_compilation_cache_dir(env)
                cls._prune_compilation_cache_once(cls._compilation_cache_dir)
        return cls._compilation_cache_dir

    @classmethod
    def compilation_cache_dir(cls) -> Optional[str]:
        return cls._compilation_cache_dir

    @classmethod
    def _prune_compilation_cache_once(cls, cache_dir: str) -> None:
        if cls._cache_pruned:
            return
        cls._cache_pruned = True
        max_bytes = os.environ.get("BIGDL_COMPILE_CACHE_MAX_BYTES")
        max_age = os.environ.get("BIGDL_COMPILE_CACHE_MAX_AGE_DAYS")
        if not max_bytes and not max_age:
            return
        try:
            max_bytes = int(max_bytes) if max_bytes else None
            max_age = float(max_age) if max_age else None
        except ValueError as e:  # a hygiene knob must not stop a constructor
            log.warning("ignoring a malformed compile-cache prune variable (%s); "
                        "BIGDL_COMPILE_CACHE_MAX_BYTES takes bytes, ..._MAX_AGE_DAYS days", e)
            return
        from .compat import prune_compile_cache

        pruned = prune_compile_cache(cache_dir, max_bytes=max_bytes, max_age_days=max_age)
        if pruned:
            log.info("pruned %d compile-cache entries from %s", len(pruned), cache_dir)

    # ---------------------------------------------------------- metrics port
    @classmethod
    def set_metrics_port(cls, port: Optional[int]):
        """Start (or re-bind) this process's scrape endpoint
        (``obs/export.py``: ``/healthz``, ``/metrics``, ``/telemetry/tail``,
        ``/trace``), served from what the telemetry rings already hold.
        ``port=0`` binds a free port (read it back from the returned
        endpoint's ``.port``); ``None`` closes the endpoint. Every
        ``Telemetry`` constructed while a port is set attaches its ring.
        Also reachable through ``BIGDL_METRICS_PORT``. Returns the endpoint
        (or None)."""
        from ..obs import export as _export

        with cls._lock:
            if port is None:
                cls._metrics_port = None
                _export.close_default()
                return None
            endpoint = _export.ensure_default(int(port))
            cls._metrics_port = endpoint.port  # the bound port, also for port=0
            return endpoint

    @classmethod
    def metrics_port(cls) -> Optional[int]:
        """The scrape port, adopting ``BIGDL_METRICS_PORT`` on first read;
        None when neither is set."""
        if cls._metrics_port is None and not cls._metrics_port_env_read:
            cls._metrics_port_env_read = True
            env = os.environ.get("BIGDL_METRICS_PORT")
            if env:
                try:
                    cls.set_metrics_port(int(env))
                except (ValueError, OSError) as e:  # must not stop a Telemetry constructor
                    log.warning("ignoring BIGDL_METRICS_PORT=%r (%s)", env, e)
        return cls._metrics_port

    # --------------------------------------------------------------- run dir
    @classmethod
    def set_run_dir(cls, path: Optional[str]) -> Optional[str]:
        """Declare the directory of this run's artifacts: telemetry
        (``telemetry/``), profiler traces (``profile/``), checkpoints
        (``checkpoints/``), heartbeats (``fleet/``) and postmortems
        (``postmortem/``) default under it. ``None`` clears it (the
        ``BIGDL_RUN_DIR`` environment variable is read again)."""
        if path is not None:
            path = os.path.abspath(path)
            os.makedirs(path, exist_ok=True)
        with cls._lock:
            cls._run_dir = path
        return path

    @classmethod
    def run_dir(cls) -> Optional[str]:
        """The run directory, adopting ``BIGDL_RUN_DIR`` on first read; None
        when neither is set (artifacts then need explicit paths)."""
        if cls._run_dir is None:
            env = os.environ.get("BIGDL_RUN_DIR")
            if env:
                cls.set_run_dir(env)
        return cls._run_dir

    @classmethod
    def run_subdir(cls, name: str) -> Optional[str]:
        """``<run_dir>/<name>`` (created), or None without a run directory."""
        base = cls.run_dir()
        if base is None:
            return None
        sub = os.path.join(base, name)
        os.makedirs(sub, exist_ok=True)
        return sub


    # ------------------------------------------------------- the process group
    @classmethod
    def init_distributed(cls, coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: Union[str, torch.device, None] = None) -> None:
        """Join this process to the data-parallel group as rank
        ``process_id`` of ``num_processes`` (see the module docstring).
        ``coordinator_address`` is ``host:port`` or an ``init_method`` URL
        (``tcp://...``, ``file://...``)."""
        import torch.distributed as dist

        env = os.environ
        if cls._group is not None or dist.is_initialized():
            raise RuntimeError("Engine.init_distributed: this process is already in a group")
        addr = coordinator_address or env.get("JAX_COORDINATOR_ADDRESS")
        if addr is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
            addr = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world = num_processes if num_processes is not None else env.get(
            "JAX_NUM_PROCESSES", env.get("WORLD_SIZE"))
        rank = process_id if process_id is not None else env.get(
            "JAX_PROCESS_ID", env.get("RANK"))
        if addr is None or world is None or rank is None:
            raise RuntimeError(
                "multi-process initialization needs coordinator_address/num_processes/"
                "process_id (or the JAX_* or torchrun environment variables)")
        world, rank = int(world), int(rank)
        if not 0 <= rank < world:
            raise ValueError(f"process_id {rank} is outside [0, {world})")
        init_method = addr if "://" in addr else f"tcp://{addr}"
        dev = cls.device(device)
        if dev.type == "cuda":
            cards = torch.cuda.device_count()
            local = int(env.get("LOCAL_RANK", rank))
            own = world <= cards and local < cards
            dev = torch.device("cuda", local if own else 0)
            backend = "nccl" if own else "gloo"
            torch.cuda.set_device(dev)
        else:
            backend = "gloo"
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
        with cls._lock:
            cls._group = (backend, rank, world, dev)
        log.info("rank %d of %d joined over %s on %s", rank, world, backend, dev)

    @classmethod
    def shutdown_distributed(cls) -> None:
        """Leave the group (``destroy_process_group``); a no-op without one."""
        import torch.distributed as dist

        with cls._lock:
            group, cls._group, cls._mesh = cls._group, None, None
            cls._sequence_parallel = None
        if group is not None and dist.is_initialized():
            dist.destroy_process_group()

    @classmethod
    def backend(cls) -> Optional[str]:
        """The group's backend (``"nccl"`` or ``"gloo"``), None without one."""
        return None if cls._group is None else cls._group[0]

    @classmethod
    def rank_device(cls) -> Optional[torch.device]:
        """The device ``init_distributed`` gave this rank, None without a group."""
        return None if cls._group is None else cls._group[3]

    @classmethod
    def process_slice(cls) -> Optional[Tuple[int, int]]:
        """``(rank, world size)`` for the per-process reader slice under
        ``init_distributed``, else None."""
        return None if cls._group is None else (cls._group[1], cls._group[2])

    @classmethod
    def device_count(cls) -> int:
        """Devices that one data-parallel step spans: the group's world
        size (one device a rank), 1 without a group."""
        return 1 if cls._group is None else cls._group[2]

    @classmethod
    def mesh(cls):
        """A 1-D ``data`` mesh over the group's ranks (one rank without a
        group), built at the first call (collectively, on every rank)."""
        if cls._mesh is None:
            from ..parallel.sharding import Mesh

            cls._mesh = Mesh({"data": cls.device_count()})
        return cls._mesh

    @classmethod
    def set_sequence_parallel(cls, mesh, axis_name: str = "sp") -> None:
        """Register (or clear, with ``mesh=None``) the sequence-parallel mesh
        axis: while it is registered, ``scaled_dot_product_attention`` with
        ``impl`` ``'auto'`` or ``'ring'`` runs as a ring over
        ``mesh[axis_name]`` when eligible (4-D operands, no additive bias, no
        attention dropout, sequence lengths divisible by the axis size).
        Every rank of the mesh registers it and runs the same program on the
        same inputs."""
        if mesh is None:
            cls._sequence_parallel = None
            return
        if axis_name not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis_name!r}; axes: {tuple(mesh.shape)}")
        cls._sequence_parallel = (mesh, axis_name)

    @classmethod
    def sequence_parallel(cls) -> Optional[tuple]:
        """The registered ``(mesh, axis name)``, or None."""
        return cls._sequence_parallel

    @classmethod
    def node_number(cls) -> int:
        """Reference: ``Engine.nodeNumber``; here the processes of the group."""
        return cls.device_count()

    @classmethod
    def core_number(cls) -> int:
        """Reference: ``Engine.coreNumber``; here devices a process (one)."""
        return 1


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def env_flag(name: str) -> bool:
    """An on/off environment flag: "1", "true", "yes" or "on" (any case) is
    on; anything else, or unset, is off."""
    return os.environ.get(name, "").lower() in ("1", "true", "yes", "on")
