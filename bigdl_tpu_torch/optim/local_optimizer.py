"""Training (counterpart of ``bigdl_tpu/optim/local_optimizer.py``'s
``Optimizer`` facade, ``LocalOptimizer`` and module-level ``validate``).

``Optimizer`` holds the model, dataset, criterion and the run's
configuration, and drives the loop; ``Optimizer.apply(model, dataset,
criterion)`` picks ``DistriOptimizer`` for a ``DistributedDataSet`` and
``LocalOptimizer`` otherwise, as the reference's factory does.
``LocalOptimizer(model, dataset, criterion).set_optim_method(...)
.set_end_when(...).optimize()`` runs the JAX package's drive loop on the
module's device, one eager step per batch:

1. the model is built from the first training batch if it is not yet;
2. each epoch, ``dataset.shuffle(epoch)`` and one pass over its batches
   (after ``resume``, the batches of the checkpoint's epoch that were
   already trained are skipped: ``_iter_in_epoch``);
3. each iteration: ``lr = method.get_learning_rate()`` (the method's
   schedule, :mod:`.schedules`, over the state table), a train-mode
   forward through ``model.apply``, the criterion plus the model's
   regularizer penalties (``model.regularization_loss_tree``; in the
   logged loss too, added once to a padded batch's masked loss and once
   to each micro-batch slice's, so the averaged gradient carries it
   once), ``loss.backward()``
   (torch autograd; the flash attention's gradient is the dQ and dK/dV
   kernels, the max pool's the max-pool backward kernel), the gradients
   clipped (``set_constant_gradient_clipping`` first, then
   ``set_gradient_clipping_by_l2_norm``: one fp32 norm over all leaves),
   ``method.update`` in place, the gradients dropped, and the forward's new
   state (BN running statistics, which carry no autograd history) kept on
   the model. With ``set_micro_batches(n)`` every leaf of the batch (a
   ``Table`` 's too; a ``SparseTensor`` leaf is refused, its entries are
   not rows) is split into n row slices: their gradients are summed and
   divided by n (the full batch's mean), and one update applied; the model
   state is carried from slice to slice, so BN running statistics advance
   n times a step (ghost batch norm, as the JAX package's scan);
4. the loss is read on the host one step late, after the next step has
   been dispatched, so the host never waits on the step it just queued;
5. ``neval``, ``_iter_in_epoch`` and ``epoch`` advance in the method's
   state table; after every iteration and at every epoch end come, in the
   JAX package's order, the validation (``set_validation``: it writes
   ``score``, the first method's result, and counts ``n_validations``), the
   checkpoint (``set_checkpoint``, see :mod:`bigdl_tpu_torch.utils.serialization`)
   and the ``end_when`` check.

The prefetch seam (the JAX package's ``_prefetch_batches``): a daemon
thread pulls each epoch's batches from ``dataset.data(train=True)`` (so the
dataset's gather, or a ``DataPipeline`` 's hand-off, runs there), applies
the ragged seam below, and copies the batch to the device, handing it over
through a depth-2 ``StagingRing``: the next batches are assembled and
copied while the current step runs. On the card the copy is issued on a
side stream the thread owns, from pinned host memory, and an event is
recorded after it; the driver makes its own stream wait on that event
before the step and marks the tensors used there (``record_stream``), so
the copy overlaps the queued step and the caching allocator does not hand
their memory out early. Kernels still launch on the driver's stream. Each
device batch carries the thread's wait for it from the dataset
(``input_wait_s``, in ``history``) and the dataset's staging depth when it
has one. An early stop, an exception on either side or an abandoned resumed
epoch closes the ring (a blocked thread wakes at once), closes the
dataset's stream (a ``DataPipeline`` 's worker pool ends) and joins the
thread, so ``optimize()`` leaves no thread behind.

The ragged-batch seam: the dataset's first training batch fixes the step's
rows. A shorter train batch (from a dataset that yields its epoch tail;
``LocalArrayDataSet`` drops it) is padded back to them by repeating row 0
and its pad rows masked out of the loss exactly (``criterion.unreduced``),
when the criterion has that row-wise form, no BatchNormalization couples
the rows of the forward and no ``SparseTensor`` is in the batch (its
entries are not rows); otherwise it is dropped, as the reference does.
Only a padded batch takes the masked form of the loss: on a full batch it
equals the criterion's own (the JAX package masks every step so that one
compiled step serves both; an eager step has no such reason).

``resume(path)`` restores the newest verified checkpoint (the JAX package's
or the port's): parameters, BN state and optimizer slots are copied into
the existing tensors on the model's device, the state table and the RNG
position are restored, and the next ``optimize()`` continues the run.

``validate=True`` (the default) runs the static analysis
(:mod:`bigdl_tpu_torch.analysis`) as the JAX package does: at construction,
``GraphValidator`` over every ``Graph`` of the model (and ``ParamAudit`` of
a model already built); in ``optimize()``, before the first step and
before the model is built, ``ShapeProp`` against the first batch's spec,
so that a wrong width or wiring stops on the host with the module's path
before any parameter is allocated on the card; then ``ParamAudit`` (one
host transfer) after the build. ``validate=False`` skips all of them.

``flat_update=True`` trains over the flat layout (the JAX package's
``_make_flat_step``): one float32 master vector that the parameters are
views of, one flat gradient buffer that their ``.grad`` s are views of, the
gradient clipped as one vector and one ``update_flat`` of the method over
the vector, with the weight-decay exclusions as a per-element coefficient
vector. The precision policies hang off it: ``comms_dtype`` passes the
gradient through the wire's quantize -> dequantize with error feedback
(``GradCompressor.exchange_local``), ``master_dtype`` / ``slot_dtype``
store the master and the slots narrow (``StatePrecision``; the parameters
stay the float32 decode of the stored master). ``validate=True`` runs
``FlatParamAudit`` over the vector before the first step. Checkpoints of a
flat run stay in the tree layout and in float32, as in the JAX package.
The policies need the flat layout; ``flat_update`` refuses micro-batches
and the methods that are not elementwise.

Each iteration is logged (loss, learning rate, records/s) and kept in
``history``.

Observability and resilience (the JAX package's, ``obs/`` and
``resilience/``): ``set_telemetry`` streams a record a step (the spans of
the seams ``prefetch``, ``pad_mask``, ``dispatch``, ``checkpoint``,
``validation``, ``summary_flush``; ``mfu`` from ``set_perf`` 's once-counted
step FLOPs), ``set_health`` adds the per-layer statistics computed on the
device and read with the loss in its one transfer, ``set_train_summary`` /
``set_val_summary`` write TensorBoard files and ``set_profile`` captures a
``torch.profiler`` window. ``optimize()`` runs the attempts under a
``FailurePolicy`` (``set_failure_policy``, or ``set_retry_times``'s legacy
shim): a failed attempt restores the newest verified checkpoint (the step-0
snapshot before the first one) and replays; a non-finite loss (the
divergence guard on the one-step-late pull) rolls back to the newest
finite checkpoint and backs the LR off or skips a window; a position that
fails twice is skipped (a ``DataPipeline`` never even builds it);
``set_preemption`` turns SIGTERM into an emergency checkpoint and
``TrainingPreempted``; a terminal failure leaves a postmortem bundle.
``donate=False`` writes each update into fresh storage, so tensors taken
from the parameters before a step keep their values (the JAX package's
undonated step). ``export_step_artifact`` writes a step bundle (the kernel
library and the step's argument specs, ``utils/aot.py``) and
``warm_start`` seeds a fresh host's cache directory from one before
``resume``.

``set_elastic`` attaches the elastic fleet (``resilience/elastic.py``): at
each step boundary the ranks agree on the fleet monitor's verdict; on a
lost host they write the coordinated emergency fleet checkpoint, the
survivors re-form their group, restore it and continue
(``ElasticRemesh``, applied in ``optimize()`` outside its ``except``); at an
epoch boundary a host that beats again rejoins the same way. It needs a
resharding-capable optimizer (``DistriOptimizer`` 's ZeRO-1 layout,
``HybridParallelOptimizer``) and ``set_checkpoint``; ``LocalOptimizer``
accepts it and ``optimize()`` refuses it, as in the JAX package.
"""

from __future__ import annotations

import itertools
import logging
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..dataset.dataset import (batch_leaves, device_tensors, map_batch, pad_minibatch,
                               to_device)
from ..dataset.pipeline import RING_CLOSED, StagingRing
from ..nn.module import detach_tree, to_spec
from ..obs import trace as obs_trace
from ..obs.perf import program_cost
from ..obs.telemetry import Metrics, observe_kernel_builds
from ..obs.trace import span
from ..resilience.errors import (DivergenceError, ElasticRemesh, StallEscalation,
                                 TrainingPreempted)
from ..nn.normalization import BatchNormalization
from ..tensor.sparse import SparseTensor
from ..utils.aot import spec_tree
from ..utils.random import RandomGenerator
from ..utils.serialization import (copy_into, flatten_pytree, latest_checkpoint_step,
                                   load_checkpoint, quarantine_nonfinite, save_checkpoint,
                                   tree_items, unflatten_to_like)
from ..utils.table import Table
from .optim_method import SGD, OptimMethod
from .predictor import forward_padded
from .quantization import MASTER_SCALE_KEY, LowPrecisionPolicy
from .trigger import Trigger
from .validation import ValidationMethod, ValidationResult

log = logging.getLogger(__name__)

_staged_lock = threading.Lock()
_staged = [0]  # device bytes the prefetch threads copied that no loop has taken yet


def staged_device_bytes() -> int:
    """Device bytes of batches that prefetch threads have copied (or are
    copying) and that no training loop has taken yet: the input staging a
    reading of ``torch.cuda.memory_allocated()`` includes besides the model's
    own memory (at most two batches and the one a thread holds, a run)."""
    with _staged_lock:
        return _staged[0]


def _host_bytes(tree) -> int:
    """Bytes of a batch leaf tree's arrays (what its copy allocates on the
    device)."""
    if isinstance(tree, Table):
        return sum(_host_bytes(v) for _, v in tree.items())
    if isinstance(tree, SparseTensor):
        return sum(_host_bytes(t) for t in (tree.row_indices, tree.col_indices, tree.values))
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(getattr(tree, "nbytes", 0))


class _DeviceBatch:
    """A training batch on the step's device: input, target, real rows ``n``
    of its ``rows``, the prefetch thread's wait for it from the dataset
    (``wait_s``), the dataset's staging depth then (``qdepth``, None without
    a gauge), the event after its copy on the thread's stream (None off the
    card), the pinned host copies it was made from and the causal trace
    context of its pipeline chunk (``trace``, None off a pipeline)."""

    __slots__ = ("x", "t", "n", "rows", "wait_s", "qdepth", "ready", "pinned", "nbytes",
                 "trace")

    def __init__(self, x, t, n, rows, wait_s, qdepth, ready=None, pinned=(), nbytes=0,
                 trace=None):
        self.x, self.t, self.n, self.rows = x, t, n, rows
        self.wait_s, self.qdepth, self.ready, self.pinned = wait_s, qdepth, ready, pinned
        self.nbytes = nbytes  # its share of staged_device_bytes() until the loop takes it
        self.trace = trace

    def wait_on(self, device: torch.device) -> None:
        """Make ``device`` 's current stream wait for the copy and mark the
        batch's tensors as used there."""
        if self.ready is None:
            return
        stream = torch.cuda.current_stream(device)
        stream.wait_event(self.ready)
        for tensor in (*device_tensors(self.x), *device_tensors(self.t)):
            tensor.record_stream(stream)


def _has_aux(state) -> bool:
    """Whether a state tree holds an ``"_aux_loss"`` key at any depth."""
    if isinstance(state, dict):
        return any(k == "_aux_loss" or _has_aux(v) for k, v in state.items())
    if isinstance(state, (list, tuple)):
        return any(_has_aux(v) for v in state)
    return False


def check_micro_split(x, t, n: int) -> None:
    """Refuse a batch that ``n`` micro-batches cannot split: a leaf of ``x``
    or ``t`` whose length ``n`` does not divide (the JAX step's check and
    message), or a ``SparseTensor`` leaf (``TypeError`` naming it: its
    entries are not rows; the JAX step cuts its COO arrays by entry count,
    after the same check on that count, and its forward then raises
    ``TypeError`` on rows that no longer match the dense leaves')."""
    sparse = None
    for path, leaf in itertools.chain(batch_leaves(x, "input"), batch_leaves(t, "target")):
        size = leaf.nnz if isinstance(leaf, SparseTensor) else leaf.shape[0]
        if size % n:
            raise ValueError(f"batch size {size} not divisible by micro batch count {n}")
        if isinstance(leaf, SparseTensor) and sparse is None:
            sparse = path
    if sparse is not None:
        raise TypeError(f"set_micro_batches cannot split the SparseTensor at {sparse}: its "
                        "entries are not rows; train a batch holding one without micro-batches")


def split_micro_batches(x, t, n: int) -> List[tuple]:
    """``n`` ``(input, target)`` micro-batches: every leaf of ``x`` and
    ``t`` (nested ``Table`` s, lists and dicts) cut into ``n`` row slices,
    the JAX step's ``tree_map(_split, ...)`` (:func:`check_micro_split`
    first)."""
    check_micro_split(x, t, n)

    def part(i):
        def cut(a):
            k = a.shape[0] // n
            return a[i * k:(i + 1) * k]
        return cut

    return [(map_batch(part(i), x), map_batch(part(i), t)) for i in range(n)]


def validate(model, params, model_state, dataset, methods) -> Dict[str, ValidationResult]:
    """One eval-mode sweep of ``methods`` over ``dataset`` with ``params``
    and ``model_state``, their results merged with ``+``: the first batch
    fixes the rows, a shorter one is padded to them on the device
    (``forward_padded``; one holding a ``SparseTensor`` runs at its own
    rows) and its output sliced back before the metrics,
    whose targets stay unpadded. One host transfer a batch: its numerators
    together. Under a process group of more than one rank the sweep is
    sharded (:func:`_validate_sharded`)."""
    from ..parallel import _comm

    if _comm.world() > 1:
        return _validate_sharded(model, params, model_state, dataset, methods)
    return validate_whole(model, params, model_state, dataset, methods)


def validate_whole(model, params, model_state, dataset, methods) -> Dict[str, ValidationResult]:
    """:func:`validate` on this process alone, every batch whole (the
    replicated program of the mesh optimizers, whose modules' collectives
    need every rank on the same rows)."""
    totals: Dict[str, ValidationResult] = {}
    rows: Optional[int] = None
    device = model.device
    for batch in dataset.data(train=False):
        if rows is None:
            rows = batch.size()
        with torch.inference_mode():
            y = forward_padded(model, params, model_state, to_device(batch.get_input(), device),
                               rows)
            t = to_device(batch.get_target(), device)
            pairs = [m.metric(y, t) for m in methods]
            nums = torch.stack([num.reshape(()).to(torch.float64) for num, _ in pairs])
        for m, num, (_, cnt) in zip(methods, nums.tolist(), pairs):
            r = m.make_result(num, int(cnt))
            totals[m.name] = totals[m.name] + r if m.name in totals else r
    return totals


def _validate_sharded(model, params, model_state, dataset, methods
                      ) -> Dict[str, ValidationResult]:
    """:func:`validate` under a group of n ranks: each batch is padded (row 0
    repeated) to the first batch's rows rounded up to a multiple of n, rank
    r forwards rows ``[r·B/n, (r+1)·B/n)`` of it, its metrics take the real
    rows among them, and each method's numerator and count are summed over
    the sweep and then over the ranks (one collective), so every rank holds
    the single-process result."""
    from ..parallel import _comm

    n, r = _comm.world(), _comm.rank()
    device = model.device
    rows: Optional[int] = None
    nums = torch.zeros(len(methods), dtype=torch.float64, device=device)
    cnts = torch.zeros(len(methods), dtype=torch.float64, device=device)
    for batch in dataset.data(train=False):
        if rows is None:
            rows = -(-batch.size() // n) * n
        real = batch.size()
        if real < rows:
            padded = pad_minibatch(batch, rows)
            if padded is None:
                raise ValueError("a sharded validation needs batches that can be row-padded")
            batch = padded[0]
        k = rows // n
        lo, hi = r * k, min((r + 1) * k, real)
        if hi <= lo:
            continue
        part = batch.slice(r * k, k)
        with torch.inference_mode():
            y = forward_padded(model, params, model_state, to_device(part.get_input(), device), k)
            t = to_device(part.get_target(), device)
            y, t = y[:hi - lo], t[:hi - lo]
            for i, m in enumerate(methods):
                num, cnt = m.metric(y, t)
                nums[i] += num.reshape(()).to(torch.float64)
                cnts[i] += cnt
    both = _comm.psum_(torch.cat([nums, cnts]))
    totals: Dict[str, ValidationResult] = {}
    for m, num, cnt in zip(methods, both[:len(methods)].tolist(), both[len(methods):].tolist()):
        res = m.make_result(num, int(cnt))
        totals[m.name] = totals[m.name] + res if m.name in totals else res
    return totals


class Optimizer:
    """The facade: model, dataset, criterion and the run's configuration,
    and the drive loop (see the module docstring); ``apply`` picks the
    concrete optimizer."""

    def __init__(self, model, dataset, criterion, validate: bool = True, donate: bool = True,
                 flat_update: bool = False, comms_dtype=None, error_feedback: bool = True,
                 master_dtype=None, slot_dtype=None):
        from ..obs.perf import PerfAccountant

        policy = LowPrecisionPolicy(comms_dtype=comms_dtype, error_feedback=error_feedback,
                                    master_dtype=master_dtype, slot_dtype=slot_dtype)
        self._precision = policy if policy.active else None
        self.flat_update = bool(flat_update)
        # donate=False: each step's update goes into fresh storage, so a
        # tensor taken from a parameter before a step keeps its values
        self.donate = bool(donate)
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.validate = validate
        if validate:
            self._validate_at_construction()
        self.optim_method: OptimMethod = SGD()
        self.end_when: Trigger = Trigger.max_epoch(1)
        self.validation_trigger: Optional[Trigger] = None
        self.validation_dataset = None
        self.validation_methods: Optional[List[ValidationMethod]] = None
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.checkpoint_keep_last: Optional[int] = None
        self.summary = None  # TrainSummary
        self.val_summary = None  # ValidationSummary
        self.metrics = Metrics()
        self.telemetry = None  # obs.Telemetry (set_telemetry)
        self.health = None  # obs.HealthMonitor (set_health)
        self._perf = PerfAccountant()  # active whenever telemetry is attached
        self._profile: Optional[Dict[str, Any]] = None  # set_profile's window
        self.retry_times = int(os.environ.get("BIGDL_FAILURE_RETRY_TIMES", "0"))
        self.failure_policy = None
        self._active_policy = None  # the policy of the running optimize()
        self._preemption_guard = None
        self._entry_snapshot: Optional[Dict[str, Any]] = None  # the step-0 state
        self._entry_snapshot_taken = False
        self._stall_cb_watchdog = None  # the watchdog our stall forwarder is on
        self._kernel_builds_seen = (0, 0)  # ops/_build.py's (loads, builds) reported
        self._step_health: Optional[Dict[str, torch.Tensor]] = None
        self._grad_clip_norm: Optional[float] = None
        self._grad_clip_const: Optional[tuple] = None
        self._micro_batches = 1
        self._mask_ragged = False  # resolved on the built model in optimize()
        self._step_rows: Optional[int] = None  # rows of the dataset's first training batch
        self._warned_ragged_drop = False
        self._restored_slots: Optional[Dict[str, Any]] = None
        self._resume_skip_iters = 0
        self._copy_stream = None  # the prefetch thread's copy stream on the card
        self._prefetch_thread: Optional[threading.Thread] = None
        self._copy_in_worker = True  # the prefetch thread copies batches to the device
        self._place_span = False  # the batch placement is a "place_batch" seam
        self._flat = None  # the flat layout's state (_FlatState) while one is bound
        self._step_export_info = None  # the step's argument specs, at its first dispatch
        self._warm_start_bundle: Optional[str] = None  # warm_start's bundle
        self._elastic = None  # the ElasticCoordinator of set_elastic
        self._dataset_base = None  # the dataset before a reader slice
        self.history: List[Dict[str, Any]] = []

    # --------------------------------------------------------------- factory
    @staticmethod
    def apply(model, dataset, criterion) -> "Optimizer":
        """``DistriOptimizer`` for a ``DistributedDataSet``, else
        ``LocalOptimizer``."""
        from ..dataset.dataset import DistributedDataSet

        if isinstance(dataset, DistributedDataSet):
            from ..parallel.distri_optimizer import DistriOptimizer

            return DistriOptimizer(model, dataset, criterion)
        return LocalOptimizer(model, dataset, criterion)

    # ----------------------------------------------------------- configuration
    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_validation(self, trigger: Trigger, dataset,
                       methods: Sequence[ValidationMethod]) -> "Optimizer":
        self.validation_trigger = trigger
        self.validation_dataset = dataset
        self.validation_methods = list(methods)
        return self

    def set_checkpoint(self, path: Optional[str] = None, trigger: Optional[Trigger] = None,
                       keep_last: Optional[int] = None) -> "Optimizer":
        """Checkpoint into ``path`` whenever ``trigger`` fires; ``path=None``
        resolves to ``<run_dir>/checkpoints`` (``Engine.set_run_dir``);
        ``keep_last=N`` prunes all but the N newest after each save (None
        keeps all)."""
        if trigger is None:
            raise ValueError("set_checkpoint needs a trigger")
        if path is None:
            from ..utils.engine import Engine

            path = Engine.run_subdir("checkpoints")
            if path is None:
                raise ValueError("set_checkpoint() needs a path (or a run dir via "
                                 "Engine.set_run_dir / BIGDL_RUN_DIR to default under)")
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        self.checkpoint_keep_last = keep_last
        return self

    def set_train_summary(self, summary) -> "Optimizer":
        """A :class:`~bigdl_tpu_torch.visualization.TrainSummary`: ``Loss``,
        ``LearningRate`` and ``Throughput`` every step, parameter histograms
        when its ``"Parameters"`` trigger fires."""
        self.summary = summary
        return self

    def set_val_summary(self, summary) -> "Optimizer":
        """A :class:`~bigdl_tpu_torch.visualization.ValidationSummary`: one
        scalar a validation method at every validation."""
        self.val_summary = summary
        return self

    def set_telemetry(self, telemetry) -> "Optimizer":
        """Attach an :class:`~bigdl_tpu_torch.obs.Telemetry`: one record a
        step (loss, LR, throughput, wall and dispatch seconds, spans, the
        allocator's memory) and the run's other records, from values the
        driver holds on the host: it adds no device sync."""
        self.telemetry = telemetry
        return self

    def set_health(self, config=True) -> "Optimizer":
        """Attach model-health monitoring: each step computes the per-layer
        statistics on the device after its update, read one step late in
        the same transfer as the loss (no second pull); ``health`` records
        every ``every_n_steps`` steps, and the divergence guard names the
        first non-finite layer in its ``rollback`` record. ``config`` is a
        :class:`~bigdl_tpu_torch.obs.HealthConfig`, a ``HealthMonitor``,
        ``True`` for the defaults, or ``None``/``False`` to detach."""
        from ..obs.health import HealthConfig, HealthMonitor

        if self.health is not None and self.health is not config:
            self.health.remove_hooks()
        if config is None or config is False:
            self.health = None
        elif isinstance(config, HealthMonitor):
            self.health = config
        elif isinstance(config, HealthConfig):
            self.health = HealthMonitor(config)
        elif config is True:
            self.health = HealthMonitor(HealthConfig())
        else:
            raise TypeError(f"set_health expects HealthConfig/HealthMonitor/bool, "
                            f"got {type(config).__name__}")
        return self

    def set_perf(self, config=True) -> "Optimizer":
        """Configure the performance accounting (``obs/perf.py``), on by
        default whenever telemetry is attached: each ``step`` record gains
        ``model_flops`` / ``achieved_flops_s`` / ``mfu`` (the step's FLOPs
        counted once on the meta device), a ``perf`` record lands every
        ``every_n_steps`` steps, and the ``PerfMonitor`` warns (and captures
        one bounded trace under ``<run_dir>/profile/``) on a regression.
        ``config`` is a :class:`~bigdl_tpu_torch.obs.PerfConfig`, a
        ``PerfAccountant``, ``True`` for the defaults, or ``None``/``False``
        to turn it off."""
        from ..obs.perf import PerfAccountant, PerfConfig

        if config is None or config is False:
            self._perf = None
        elif isinstance(config, PerfAccountant):
            self._perf = config
        elif isinstance(config, PerfConfig):
            self._perf = PerfAccountant(config)
        elif config is True:
            self._perf = PerfAccountant()
        else:
            raise TypeError(f"set_perf expects PerfConfig/PerfAccountant/bool, "
                            f"got {type(config).__name__}")
        return self

    def _perf_device_count(self) -> int:
        """The cards one step's counted FLOPs run on (the MFU denominator):
        one, as each rank counts its own rows."""
        return 1

    def set_profile(self, trace_dir: Optional[str] = None, start_iteration: int = 10,
                    num_iterations: int = 5) -> "Optimizer":
        """Capture a ``torch.profiler`` trace of steps ``[start_iteration,
        start_iteration + num_iterations)`` into ``trace_dir/trace.json``
        (``None``: ``<run_dir>/profile``); the spans' seams and the kernels
        are named ranges of it."""
        if trace_dir is None:
            from ..utils.engine import Engine

            trace_dir = Engine.run_subdir("profile")
            if trace_dir is None:
                raise ValueError("set_profile() needs a trace_dir (or a run dir via "
                                 "Engine.set_run_dir / BIGDL_RUN_DIR to default under)")
        self._profile = {"dir": trace_dir, "start": start_iteration, "len": num_iterations}
        return self

    def set_retry_times(self, n: int) -> "Optimizer":
        """``n`` automatic restarts from the newest checkpoint on a failure
        (the reference's ``bigdl.failure.retryTimes``; needs
        ``set_checkpoint``): ``FailurePolicy.legacy(n)``, n attempts, any
        fault, no backoff, no divergence guard. :meth:`set_failure_policy`
        attaches the full policy."""
        self.retry_times = int(n)
        return self

    def set_failure_policy(self, policy) -> "Optimizer":
        """Attach a :class:`~bigdl_tpu_torch.resilience.FailurePolicy`:
        classified budgets, seeded backoff, the divergence guard with
        rollback and LR back-off, the poison-batch skip and stall
        escalation. A retry restores from ``set_checkpoint`` 's path (or the
        step-0 snapshot before the first checkpoint)."""
        self.failure_policy = policy
        return self

    def set_preemption(self, signals=None) -> "Optimizer":
        """Handle preemption signals (default SIGTERM): at the next step
        boundary the loop writes an emergency checkpoint, emits a
        ``preempt_checkpoint`` record and raises
        :class:`~bigdl_tpu_torch.resilience.TrainingPreempted`
        (``exit_code == 0``); a later :meth:`resume` continues the run."""
        from ..resilience.preemption import PreemptionGuard

        self._preemption_guard = PreemptionGuard(signals)
        return self

    def set_elastic(self, config=True) -> "Optimizer":
        """Attach elastic data-parallel training (see the module docstring
        and ``resilience/elastic.py``). Needs ``set_checkpoint`` and a
        resharding-capable optimizer (``DistriOptimizer`` 's ZeRO-1 layout,
        ``HybridParallelOptimizer``). ``config`` is an
        :class:`~bigdl_tpu_torch.resilience.ElasticConfig`, an
        :class:`~bigdl_tpu_torch.resilience.ElasticCoordinator` (tests that
        inject monitors and clocks), ``True`` for the defaults, or
        ``None``/``False`` to detach."""
        from ..resilience.elastic import ElasticConfig, ElasticCoordinator

        if config is None or config is False:
            self._elastic = None
        elif isinstance(config, ElasticCoordinator):
            self._elastic = config
        elif isinstance(config, ElasticConfig):
            self._elastic = ElasticCoordinator(config)
        elif config is True:
            self._elastic = ElasticCoordinator(ElasticConfig())
        else:
            raise TypeError(f"set_elastic expects ElasticConfig/ElasticCoordinator/bool, "
                            f"got {type(config).__name__}")
        return self

    def _supports_elastic(self) -> bool:
        """Whether this optimizer can re-cut its training state for another
        membership (the parallel optimizers override it)."""
        return False

    def _effective_policy(self):
        if self.failure_policy is not None:
            return self.failure_policy
        if self.retry_times > 0:
            from ..resilience.policy import FailurePolicy

            return FailurePolicy.legacy(self.retry_times)
        return None

    def set_micro_batches(self, n: int) -> "Optimizer":
        """Split each batch into ``n`` row slices, one update a batch (see the
        module docstring; BN statistics become slice-local)."""
        if n < 1:
            raise ValueError(f"micro batch count must be >= 1, got {n}")
        self._micro_batches = int(n)
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float) -> "Optimizer":
        self._grad_clip_norm = float(clip_norm)
        return self

    def set_constant_gradient_clipping(self, min_v: float, max_v: float) -> "Optimizer":
        self._grad_clip_const = (float(min_v), float(max_v))
        return self

    # ------------------------------------------------------------- the ladder
    def optimize(self):
        """Run until ``end_when`` fires; returns the trained model.

        A failure goes through the attached ``FailurePolicy`` (or the
        ``set_retry_times`` shim): retried within its class's budget after
        the backoff, from the newest verified checkpoint (or the step-0
        snapshot before the first one); a divergence rolls back to the
        newest finite one and backs off the LR. A pending preemption leaves
        behind an emergency checkpoint, and a terminal failure behind a
        verified postmortem bundle."""
        policy = self._active_policy = self._effective_policy()
        if policy is not None:
            policy.reset()
        self._entry_snapshot = None
        self._entry_snapshot_taken = False
        el = self._elastic
        if el is not None:
            if not self._supports_elastic():
                raise ValueError(
                    "elastic training (set_elastic) needs a resharding-capable optimizer — "
                    "DistriOptimizer's flat/ZeRO-1 layout or HybridParallelOptimizer; "
                    f"{type(self).__name__} has no remesh path")
            if self.checkpoint_path is None:
                raise ValueError("elastic training reshards through coordinated fleet "
                                 "checkpoints; call set_checkpoint first")
            from ..utils.engine import Engine

            el.bind(run_dir=Engine.run_dir(), telemetry=self.telemetry)
            el.attach()
            el.activate()
            el.start()
        guard = self._preemption_guard
        if guard is not None:
            guard.clear()
            guard.install()
        self._apply_reader_slice()
        try:
            while True:
                remesh = None
                try:
                    model = self._optimize_impl()
                    if el is not None:
                        el.agree("end", int(self.optim_method.state.get("neval", 0)))
                    return model
                except (KeyboardInterrupt, TrainingPreempted):
                    raise
                except ElasticRemesh as e:
                    remesh = e
                except Exception as e:
                    decision = self._decide_retry(e)
                    if decision is None:
                        self._dump_postmortem_for(e, "optimize")
                        raise
                    self._recover(e, decision)
                # applied outside the except: a fault in the reshard or
                # rejoin seam surfaces typed, not through the retry ladder
                while remesh is not None and not self._apply_remesh(remesh):
                    remesh = el.park(self._remesh_groups, self._parked_beat)
                    if remesh is None:  # the fit ended while this rank was out:
                        self._resume_from_checkpoint()  # the newest checkpoint's weights
                        return self.model
        finally:
            if guard is not None:
                guard.uninstall()
            if el is not None:
                el.stop()
                from ..parallel import _comm

                _comm.set_active(None, None)
            self._active_policy = None

    def _failure_position(self, exc) -> Optional[tuple]:
        """The (epoch, iter_in_epoch) the failure belongs to: the one-step-late
        pull tags its step's position (``_bigdl_position``); a divergence
        carries it; a stall has none."""
        tagged = getattr(exc, "_bigdl_position", None)
        if tagged is not None:
            return tuple(tagged)
        if isinstance(exc, DivergenceError):
            return exc.position
        if isinstance(exc, StallEscalation):
            return None
        st = self.optim_method.state
        return (int(st.get("epoch", 1)), int(st.get("_iter_in_epoch", 0)))

    def _dump_postmortem_for(self, exc: BaseException, trigger: str) -> None:
        """A verified postmortem bundle before ``exc`` leaves this optimizer
        (best-effort: forensics never turn one failure into two)."""
        try:
            from ..obs import blackbox

            blackbox.dump_postmortem("%s_%s" % (trigger, type(exc).__name__),
                                     telemetry=self.telemetry, error=exc,
                                     checkpoint_dir=self.checkpoint_path)
        except Exception:
            log.debug("postmortem dump failed", exc_info=True)

    def _decide_retry(self, exc):
        """The policy's decision, or None to raise (no policy, no checkpoint
        path, or the budget spent)."""
        policy = self._active_policy
        if policy is None or self.checkpoint_path is None:
            return None
        decision = policy.on_failure(exc, position=self._failure_position(exc))
        return decision if decision.retry else None

    def _recover(self, exc, decision) -> None:
        """Backoff, restore (a checkpoint or the step-0 snapshot; a restore
        failure goes back through the policy), then the class's
        after-effect (the LR back-off of a divergence)."""
        policy, tel = self._active_policy, self.telemetry
        log.warning("training failed (%s fault, attempt %d): %r; recovering",
                    decision.fault_class, decision.total_attempts, exc)
        if tel is not None:
            tel.retry_event(attempt=decision.total_attempts, fault_class=decision.fault_class,
                            backoff_s=decision.backoff_s, error=repr(exc),
                            path=type(self).__name__,
                            skip_position=(list(decision.skip_position)
                                           if decision.skip_position else None))
        if decision.backoff_s > 0:
            time.sleep(decision.backoff_s)
        require_finite = isinstance(exc, DivergenceError)
        while True:
            try:
                restored = self._resume_from_checkpoint(require_finite=require_finite)
                break
            except KeyboardInterrupt:
                raise
            except Exception as e2:  # the checkpoint-load seam can fault too
                d2 = policy.on_failure(e2, position=None)
                if not d2.retry:
                    self._dump_postmortem_for(e2, "resume")
                    raise
                log.warning("resume failed (%s fault, attempt %d): %r; retrying resume",
                            d2.fault_class, d2.total_attempts, e2)
                if tel is not None:
                    tel.retry_event(attempt=d2.total_attempts, fault_class=d2.fault_class,
                                    backoff_s=d2.backoff_s, error=repr(e2),
                                    path=type(self).__name__, action="resume_retry")
                if d2.backoff_s > 0:
                    time.sleep(d2.backoff_s)
        if require_finite:
            # a later plain restore must not hand the poisoned weights back
            removed = quarantine_nonfinite(self.checkpoint_path, newer_than=restored)
            if removed:
                log.warning("quarantined non-finite checkpoint(s) %s newer than restored "
                            "step %s", removed, restored)
            scale = policy.lr_scale()
            if scale != 1.0:  # after the restore: the checkpoint's own scale is older
                self.optim_method.state["_lr_scale"] = scale
            if tel is not None:
                tel.rollback_event(reason="non_finite_loss", restored_step=restored,
                                   iteration=exc.iteration, lr_scale=scale,
                                   path=type(self).__name__, layer=getattr(exc, "layer", None),
                                   source=getattr(exc, "source", None),
                                   shard=getattr(exc, "shard", None))

    # ---------------------------------------------------------------- resume
    def resume(self, checkpoint_path: Optional[str] = None) -> "Optimizer":
        """Restore params, BN state, slots, the state table, the RNG position
        and the data position from the newest verified checkpoint, so that
        the next :meth:`optimize` continues the run; builds the model from
        the first training batch first when needed."""
        if checkpoint_path is not None:
            self.checkpoint_path = checkpoint_path
        if self.checkpoint_path is None:
            raise ValueError("resume() needs a checkpoint path (set_checkpoint or argument)")
        if latest_checkpoint_step(self.checkpoint_path) is None:
            raise FileNotFoundError(f"resume(): no checkpoints under {self.checkpoint_path}")
        if not self.model.is_built():
            self.model.build(RandomGenerator.generator(),
                             self.model._as_input(self._build_input(self._first_batch())))
        self._resume_from_checkpoint()
        return self

    # --------------------------------------------------------- artifact bundles
    def export_step_artifact(self, path: str) -> Dict:
        """Write this optimizer's step bundle (``utils/aot.py``): the kernel
        library of the cache directory, and a manifest (written last) whose
        ``step`` records the step's argument specs. The port runs eagerly,
        so ``step.module`` is None and ``step.export_error`` says so; what a
        resumed run on a fresh host needs is the library, which it then
        loads instead of building (:meth:`warm_start`). Call after a step
        has run. The port does not donate buffers, so there is no
        donation-free twin to carry."""
        info = self._step_export_info
        if info is None:
            raise RuntimeError("export_step_artifact: no train step to export; run optimize() "
                               "(at least one step) first")
        from ..utils import aot

        return aot.export_step_bundle(path, fn=None, specs=info,
                                      path_type=type(self).__name__,
                                      extra={"donate": self.donate})

    def warm_start(self, path: str) -> Dict:
        """Verify a step bundle and seed this process's cache directory with
        its kernel library (``utils/aot.py``: manifest, sha256, fingerprint;
        a mismatch, or a serving bundle, raises
        :class:`~bigdl_tpu_torch.utils.aot.ArtifactIncompatible` before
        anything is seeded). The next :meth:`resume` and :meth:`optimize`
        then load the library instead of building it; the run's
        ``run_start`` record names the bundle."""
        from ..utils import aot

        manifest = aot.warm_start(path, kind="train_step")
        self._warm_start_bundle = path
        return manifest

    def _resume_from_checkpoint(self, require_finite: bool = False) -> Optional[int]:
        """Restore from the newest verified checkpoint (``require_finite``:
        the newest finite one); the step-0 entry snapshot when there is none.
        Returns the restored step, None for the snapshot."""
        if latest_checkpoint_step(self.checkpoint_path) is None:
            self._restore_entry_snapshot()
            return None
        el = self._elastic
        try:
            with span("checkpoint_load"):
                params, flat_slots, host, flat_model_state = load_checkpoint(
                    self.checkpoint_path, params_like=self.model.get_parameters(),
                    require_finite=require_finite,
                    # a fleet checkpoint older than the last remesh has the
                    # old bounds: only the current generation or newer
                    min_generation=el.generation if el is not None else None)
        except FileNotFoundError:  # every checkpoint rejected (all non-finite)
            self._restore_entry_snapshot()
            return None
        self._commit_restored(params, flat_model_state, flat_slots,
                              {k: v for k, v in host.items() if not k.startswith("_rng")},
                              (host["_rng_seed"], host["_rng_counter"]),
                              host.get("_iter_in_epoch", 0))
        return int(host.get("neval", 0))

    def _commit_restored(self, flat_params, flat_model_state, flat_slots, host_items, rng,
                         skip_iters) -> None:
        """Copy params and model state into the model's tensors in place
        (``Predictor`` and the optimizer hold references to them); keep the
        slots for ``optimize()``'s fresh ones; restore the state table, the
        RNG position and the mid-epoch data position."""
        copy_into(self.model.get_parameters(), flat_params, "parameter")
        copy_into(self.model.get_state(), flat_model_state, "model state")
        self._restored_slots = flat_slots
        state = self.optim_method.state
        for k, v in host_items.items():
            state[k] = v
        RandomGenerator.restore(rng[0], rng[1])
        self._resume_skip_iters = int(skip_iters)

    def _capture_entry_snapshot(self, slots) -> None:
        """Host copies of the step-0 state, taken before the first step of an
        ``optimize()`` that has a policy and a checkpoint path: the restore
        target of a retry before any checkpoint exists (not the drifted
        current state)."""
        if (self._entry_snapshot_taken or self._active_policy is None
                or self.checkpoint_path is None):
            return
        self._entry_snapshot_taken = True  # once an optimize(): on every rank alike
        def host_copy(tree):  # a copy: a CPU tensor's numpy() shares its memory
            return {k: np.array(v) for k, v in flatten_pytree(tree).items()}

        self._entry_snapshot = {
            "params": host_copy(self.model.get_parameters()),
            "model_state": host_copy(self.model.get_state()),
            "slots": host_copy(self._checkpoint_slots(slots)),
            "host": {k: v for k, v in self.optim_method.state.items()
                     if isinstance(v, (int, float, str, bool)) or v is None},
            "rng": (RandomGenerator.get_seed(), RandomGenerator._counter),
        }

    def _restore_entry_snapshot(self) -> None:
        snap = self._entry_snapshot
        if snap is None:
            log.warning("no checkpoint written yet under %s and no step-0 snapshot captured; "
                        "retrying from current state", self.checkpoint_path)
            return
        log.warning("no checkpoint written yet under %s; resetting to the step-0 entry "
                    "snapshot", self.checkpoint_path)
        host_items = dict(snap["host"])
        host_items["_epoch_done"] = False
        self._commit_restored(snap["params"], snap["model_state"], dict(snap["slots"]),
                              host_items, snap["rng"], host_items.get("_iter_in_epoch", 0))

    def _init_slots(self, method: OptimMethod, params):
        """Fresh slots, or the checkpointed ones copied into them."""
        slots = method.init_slots(params)
        if self._restored_slots is not None:
            copy_into(slots, self._restored_slots, "optimizer slot")
            self._restored_slots = None
        return slots

    # ----------------------------------------------------------- checkpoints
    def _maybe_checkpoint(self, state, slots) -> None:
        if self.checkpoint_path is None or self.checkpoint_trigger is None:
            return
        if self.checkpoint_trigger(state):
            self._checkpoint_now(state, slots)

    def _checkpoint_now(self, state, slots) -> None:
        """One checkpoint under the ``checkpoint`` seam (periodic, emergency);
        a finite one on disk frees the step-0 snapshot."""
        with span("checkpoint"):
            manifest = self._write_checkpoint(state, slots)
        if manifest is not None and manifest.get("finite") and self._entry_snapshot is not None:
            self._entry_snapshot = None

    def _write_checkpoint(self, state, slots) -> Dict[str, Any]:
        """One verified checkpoint at the current step (``neval``): the tree
        layout, the slots as :meth:`_checkpoint_slots` gives them."""
        return save_checkpoint(self.checkpoint_path, step=state["neval"],
                               params=self.model.get_parameters(),
                               optim_slots=self._checkpoint_slots(slots),
                               optim_state=dict(state), model_state=self.model.get_state(),
                               keep_last=self.checkpoint_keep_last)

    def _checkpoint_slots(self, slots):
        """The slots in the tree layout and float32 (the flat layout's
        vectors decoded and viewed per leaf)."""
        fs = self._flat
        if fs is None:
            return slots
        return fs.fp.slots_tree_view(fs.decoded_slots())

    def _on_watchdog_stall(self, info: Dict) -> None:
        pol = self._active_policy
        if pol is not None:
            pol.note_stall(info)

    def _handle_preemption(self, state, slots) -> None:
        """A caught signal is pending: the emergency checkpoint at this step
        boundary, the ``preempt_checkpoint`` record, a postmortem bundle, and
        ``TrainingPreempted`` (never retried)."""
        signum = int(self._preemption_guard.pending())
        step = int(state.get("neval", 0))
        ckpt = None
        if self.checkpoint_path is not None:
            self._checkpoint_now(state, slots)
            ckpt = self.checkpoint_path
        else:
            log.warning("preempted by signal %d with no checkpoint path configured; run state "
                        "is lost", signum)
        if self.telemetry is not None:
            self.telemetry.preempt_event(signal=signum, step=step, checkpoint_dir=ckpt,
                                         path=type(self).__name__)
        exc = TrainingPreempted(signum, step=step, checkpoint_dir=ckpt)
        self._dump_postmortem_for(exc, "preempted")
        raise exc

    # ---------------------------------------------------------- elastic fleet
    def _apply_reader_slice(self) -> None:
        """The reader slice of this process (DistriOptimizer slices a
        dataset with ``shard``; the others read every batch whole)."""

    def _remesh_groups(self, members) -> None:
        """The process groups of a membership, made on every rank of the
        world in the same order (a rank outside ``members`` too)."""
        self._elastic.group_for(members)

    def _parked_beat(self, step: int) -> None:
        """A parked rank's heartbeat after each decision it follows."""
        if self.telemetry is not None:
            self.telemetry.beat(step)

    def _handle_host_lost(self, state, slots, lost) -> None:
        """The ranks agreed a host is lost: claim the next generation
        (chaos seam ``coordinate``), write the emergency fleet checkpoint at
        this step boundary on every rank of the current group, wait for the
        whole world, check viability, and raise :class:`ElasticRemesh` for
        ``optimize()`` to apply."""
        el = self._elastic
        step = int(state.get("neval", 0))
        log.warning("elastic: host(s) %s lost — coordinated emergency checkpoint at step %d, "
                    "resharding onto the survivors", lost, step)
        el.coordinate(step, kind="shrink")
        self._checkpoint_now(state, slots)
        el.sync()
        el.check_viable(lost)
        raise ElasticRemesh("shrink", lost, step=step)

    def _handle_rejoin(self, state, slots, joined) -> None:
        """An epoch-boundary rejoin: the current group checkpoints under the
        next generation, so that every member (the returning ones too)
        restores the same step."""
        el = self._elastic
        step = int(state.get("neval", 0))
        log.warning("elastic: host(s) %s re-registered — re-expanding at the epoch boundary "
                    "(step %d)", joined, step)
        el.coordinate(step, kind="rejoin")
        self._checkpoint_now(state, slots)
        el.sync()
        raise ElasticRemesh("rejoin", joined, step=step)

    def _apply_remesh(self, remesh: ElasticRemesh) -> bool:
        """Apply an agreed remesh (chaos seams ``reshard`` / ``rejoin``):
        flip the membership, make its groups, and on a member re-slice the
        reader, restore the coordinated checkpoint and emit the
        ``mesh_shrunk`` / ``mesh_rejoin`` warn record. Returns False on a
        rank outside the new membership (it parks)."""
        el = self._elastic
        shrink = remesh.kind == "shrink"
        seam = "reshard" if shrink else "rejoin"
        t0 = time.perf_counter()
        with span(f"elastic_{seam}"):
            obs_trace.fault_point(seam)
            active = el.apply_shrink(remesh.members) if shrink else el.apply_rejoin(
                remesh.members)
            self._remesh_groups(active)
            if not el.is_member():
                return False
            el.activate()
            self._apply_reader_slice()
            restored = self._resume_from_checkpoint()
        reshard_s = time.perf_counter() - t0
        log.warning("elastic: %s applied — %d active process(es) %s, generation %d, restored "
                    "step %s (%.3fs)", seam, el.n_active(), el.active(), el.generation,
                    restored, reshard_s)
        if self.telemetry is not None:
            self.telemetry.warn(
                reason="mesh_shrunk" if shrink else "mesh_rejoin", path="elastic",
                iteration=remesh.step, members=list(remesh.members),
                process_count=el.n_active(), processes=el.active(),
                generation=el.generation, restored_step=restored,
                reshard_s=round(reshard_s, 6),
                reader_slices={str(k): list(v) for k, v in el.reader_slices().items()})
        return True

    # ------------------------------------------------------------ validation
    def _run_validation(self) -> Optional[Dict[str, ValidationResult]]:
        state = self.optim_method.state
        if (self.validation_trigger is None or self.validation_dataset is None
                or not self.validation_trigger(state)):
            return None
        with span("validation"):
            results = self._validate_now()
        for name, res in results.items():
            v, n = res.result()
            log.info("%s is %.6f (n=%d)", name, v, n)
        # score feeds max_score triggers
        state["score"] = next(iter(results.values())).result()[0]
        state["n_validations"] = state.get("n_validations", 0) + 1
        if self.val_summary is not None:
            for name, res in results.items():
                self.val_summary.add_scalar(name, res.result()[0], state["neval"])
        return results

    def _validate_now(self) -> Dict[str, ValidationResult]:
        """The validation methods over the validation set, now."""
        return validate(self.model, self.model.get_parameters(), self.model.get_state(),
                        self.validation_dataset, self.validation_methods)

    # ------------------------------------------------------- static analysis
    def _validate_at_construction(self) -> None:
        """Every Graph of the model validated; a built model's parameters
        audited."""
        from ..analysis import GraphValidator, ParamAudit
        from ..nn.graph import Graph

        for m in self.model.walk():
            if isinstance(m, Graph):
                GraphValidator(m).check()
        if self.model.is_built():
            ParamAudit(self.model).check()

    def _validate_before_step(self, x_spec) -> None:
        """The Graphs again and ShapeProp against the first batch's spec."""
        if not self.validate:
            return
        from ..analysis import GraphValidator, ShapeProp
        from ..nn.graph import Graph

        for m in self.model.walk():
            if isinstance(m, Graph):
                GraphValidator(m).check()
        ShapeProp(self.model).infer(x_spec)

    def _audit_params(self) -> None:
        if self.validate:
            from ..analysis import ParamAudit

            ParamAudit(self.model).check()

    # ------------------------------------------------------------- the step
    def _has_batch_coupled_state(self) -> bool:
        """True when the training forward couples rows across the batch
        outside the criterion: BatchNormalization's batch statistics, or a
        batch-derived auxiliary loss in the state tree (``"_aux_loss"``, the
        MoE router's load-balancing term). Pad rows would reach them even
        with the loss masked. Call on a built model."""
        if any(isinstance(m, BatchNormalization) for m in self.model.modules()):
            return True
        return _has_aux(self.model.get_state())

    def _masked_loss(self, y, t, nvalid: float) -> torch.Tensor:
        """The criterion's loss over the first ``nvalid`` rows of a padded
        batch, the pad rows masked out exactly (``criterion.unreduced``)."""
        pair = self.criterion.unreduced(y, t)
        if pair is None:
            raise TypeError(f"{type(self.criterion).__name__}.unreduced() returned None although "
                            "supports_unreduced() claimed a row-wise form")
        per, denom = pair
        b = y.shape[0]
        row = (torch.arange(b, device=per.device) < nvalid).to(per.dtype)
        if per.dim() == 1 and per.shape[0] != b and per.shape[0] % b == 0:
            mask = row.repeat_interleave(per.shape[0] // b)  # (batch*positions,) rows
        else:
            mask = row.reshape((b,) + (1,) * (per.dim() - 1))
        num = torch.sum(per * mask)
        if getattr(self.criterion, "size_average", True):
            return num / torch.clamp(torch.sum(denom * mask), min=1e-8)
        return num

    def _loss(self, model_state, x, t, rng, nvalid: Optional[float], params=None):
        """The training forward's loss (masked past ``nvalid`` real rows when
        given) plus the regularizer penalties, and the new model state; over
        ``params`` (default the model's own)."""
        if params is None:
            params = self.model.get_parameters()
        y, new_state = self.model.apply(params, model_state, x, training=True, rng=rng)
        loss = self._masked_loss(y, t, nvalid) if nvalid is not None else self.criterion._apply(
            y, t)
        reg = self.model.regularization_loss_tree(params)
        if isinstance(reg, torch.Tensor):  # 0.0 when no layer has a regularizer
            loss = loss + reg
        aux = self.model.auxiliary_loss_tree(new_state)
        if isinstance(aux, torch.Tensor):  # 0.0 when no layer left one
            loss = loss + aux
        return loss, new_state

    def _micro_step(self, x, t, rng, nvalid: Optional[float], params=None):
        """The gradients of the leaves of ``params`` (the tree the forward
        reads; default the model's parameters) summed over the micro-batches
        and divided by their count (on a padded batch: weighted by each
        slice's real rows and divided by their sum), the model state carried
        from slice to slice; returns ``(loss, new_state, grads)``, the
        gradients a list in ``tree_items`` order."""
        n = self._micro_batches
        if params is None:
            params = self.model.get_parameters()
        leaves = list(tree_items(params).values())
        slices = split_micro_batches(x, t, n)
        # a micro-batch's rows in the step's whole batch: the first leaf's,
        # as in the JAX step (a mesh rank holds its share of each)
        mb = self._global_rows(next(batch_leaves(x))[1].shape[0] // n)
        ms = self.model.get_state()
        g_acc, losses, l_sum, v_sum = None, [], 0.0, 0.0
        for i, (xm, tm) in enumerate(slices):
            v = None if nvalid is None else float(min(max(nvalid - i * mb, 0.0), mb))
            loss_m, ms = self._loss(ms, xm, tm, rng, v, params=params)
            g = torch.autograd.grad(loss_m, leaves, allow_unused=True)
            g = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(leaves, g)]
            if nvalid is not None:
                g = [gi * v for gi in g]
                l_sum, v_sum = l_sum + loss_m.detach() * v, v_sum + v
            else:
                losses.append(loss_m.detach())
            g_acc = g if g_acc is None else [a + gi for a, gi in zip(g_acc, g)]
        if nvalid is not None:
            v_sum = max(v_sum, 1.0)
            return l_sum / v_sum, ms, [g / v_sum for g in g_acc]
        return torch.stack(losses).mean(), ms, [g / n for g in g_acc]

    def _clip_grads(self, grads):
        if self._grad_clip_const is None and self._grad_clip_norm is None:
            return grads
        flat = tree_items(grads)
        leaves = list(flat.values())
        if self._grad_clip_const is not None:
            lo, hi = self._grad_clip_const
            leaves = [torch.clamp(g, lo, hi) for g in leaves]
        if self._grad_clip_norm is not None:
            total = 0.0
            for g in leaves:
                total = total + torch.sum(g.float() * g.float())
            scale = torch.clamp(self._grad_clip_norm / (torch.sqrt(total) + 1e-12), max=1.0)
            leaves = [g * scale for g in leaves]
        return unflatten_to_like(dict(zip(flat, leaves)), grads)

    def _health_old_params(self, params):
        """The weights before the update (a copy), when health is attached."""
        if self.health is None:
            return None
        with torch.no_grad():
            return torch._foreach_mul(list(tree_items(params).values()), 1.0)

    def _note_tree_health(self, grads, old, params, new_state) -> None:
        """The step's statistics over the tree layout (read with the loss)."""
        if old is not None:
            self._step_health = self.health.tree_stats(
                grads, unflatten_to_like(dict(zip(tree_items(params), old)), params), params,
                new_state)

    def _train_step(self, x, t, nvalid: Optional[float], lr: float, params,
                    slots) -> torch.Tensor:
        """Forward, loss, backward, clipping and the update in place (the
        loss masked past ``nvalid`` real rows of a padded batch); returns the
        loss on the device."""
        model = self.model
        rng = RandomGenerator.generator()
        if self._micro_batches == 1:
            loss, new_state = self._loss(model.get_state(), x, t, rng, nvalid)
            loss.backward()
        else:
            loss, new_state, g = self._micro_step(x, t, rng, nvalid)
            for p, gi in zip(tree_items(model.get_parameters()).values(), g):
                p.grad = gi
        grads = self._clip_grads(model.get_grad_parameters())
        old = self._health_old_params(params)
        self.optim_method.update(grads, params, slots, lr, self.optim_method.state["neval"])
        self._note_tree_health(grads, old, params, new_state)
        model.zero_grad(set_to_none=True)
        model.set_state(detach_tree(new_state))
        return loss.detach()

    def _shadow_params(self, params) -> None:
        """``donate=False``: the coming update writes fresh storage, so a
        tensor taken from a parameter before the step keeps its values (the
        JAX package's undonated step inputs)."""
        if self._flat is not None:
            self._flat.shadow(params)
            return
        with torch.no_grad():
            for p in tree_items(params).values():
                p.data = p.data.clone()

    def _ragged_seam_policy(self) -> str:
        """How the seam treats a train batch shorter than the step's rows:
        ``"pad"`` (padded and masked), ``"drop"`` or ``"pass"`` (handed on
        as it is; DistriOptimizer's)."""
        return "pad" if self._mask_ragged else "drop"

    def _local_rows(self, batch):
        """The rows of a training batch that this process trains on (all of
        them; DistriOptimizer takes its rank's)."""
        return batch

    def _global_rows(self, rows: int) -> int:
        """The rows of the step's whole batch that ``rows`` local rows stand
        for (the same; HybridParallelOptimizer's ranks split the batch)."""
        return rows

    def _build_input(self, first):
        """The input the model is built from: the first batch's (the rank's
        rows of it under DistriOptimizer)."""
        return first.get_input()

    def _ragged_seam(self, batch):
        """``(batch, real rows)``, the batch padded to the step's rows when it
        is short and can be masked, or None to drop it."""
        n = batch.size()
        if n < self._step_rows and self._ragged_seam_policy() != "pass":
            with span("pad_mask"):
                padded = pad_minibatch(batch, self._step_rows) if self._mask_ragged else None
            if padded is None:
                if not self._warned_ragged_drop:
                    self._warned_ragged_drop = True
                    log.warning("dropping ragged %d-row batch (step shape is %d rows and it "
                                "cannot be pad-masked: criterion without a per-sample "
                                "decomposition, BatchNorm in the model, or non-dense leaves)",
                                n, self._step_rows)
                return None
            return padded
        return batch, n

    def _first_batch(self):
        """The dataset's first training batch: it builds the model and fixes
        the step's rows (also when a resume skips it). The stream it opens is
        closed (a ``DataPipeline`` 's pool ends with it)."""
        stream = self.dataset.data(train=True)
        try:
            first = next(iter(stream), None)
        finally:
            close = getattr(stream, "close", None)
            if close is not None:
                close()
        if first is None:
            raise ValueError(
                f"dataset yields no full training batch: size={self.dataset.size()} "
                "is smaller than the batch size (ragged train batches are dropped)")
        return first

    # ------------------------------------------------------- the prefetch seam
    def _prefetch_batches(self, it, device: torch.device, depth: int = 2, close=None,
                          qsize=None):
        """The epoch's batches of ``it`` as ``_DeviceBatch`` es, assembled,
        seamed and copied by a thread ``depth`` batches ahead of the caller
        (see the module docstring). ``close`` is the dataset stream's own
        ``close`` when ``it`` wraps it (the resume path's skip), ``qsize``
        its staging-depth gauge (default: ``it`` 's). The thread's spans go
        to the caller's span collector; a pipeline chunk's trace context
        travels on its batch."""
        ring = StagingRing(depth)
        end = object()
        if qsize is None:
            qsize = getattr(it, "qsize", None)
        on_card = device.type == "cuda"
        mine = [0]  # this call's share of staged_device_bytes()
        collector = obs_trace.current_collector()

        def stage(nbytes: int) -> None:
            with _staged_lock:
                mine[0] += nbytes
                _staged[0] += nbytes

        side = None
        if on_card:  # one copy stream a run: the allocator caches a stream's blocks
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(device=device)
            side = self._copy_stream

        def copy(batch):
            """``(x, t, ready, pinned, nbytes)`` of the batch on the device."""
            if not self._copy_in_worker:  # copied on the driver thread
                return batch.get_input(), batch.get_target(), None, [], 0
            if not on_card:
                return (to_device(batch.get_input(), device),
                        to_device(batch.get_target(), device), None, [], 0)
            pinned: list = []
            nbytes = _host_bytes(batch.get_input()) + _host_bytes(batch.get_target())
            stage(nbytes)  # counted before the allocation, taken off in the loop
            with torch.cuda.stream(side):
                x = to_device(batch.get_input(), device, pinned)
                t = to_device(batch.get_target(), device, pinned)
                ready = torch.cuda.Event()
                ready.record(side)
            return x, t, ready, pinned, nbytes

        def worker():
            obs_trace.bind_collector(collector)
            try:
                src = iter(it)
                while True:
                    t_wait = time.perf_counter()
                    try:
                        batch = next(src)
                    except StopIteration:
                        break
                    wait_s = time.perf_counter() - t_wait
                    qdepth = qsize() if qsize is not None else None
                    if ring.closed:
                        return
                    ctx = getattr(it, "last_context", None)
                    prev_ctx = obs_trace.bind_context(ctx)
                    try:
                        seam = self._ragged_seam(batch)
                        if seam is None:
                            continue
                        batch, n = seam
                        rows = batch.size()
                        with span("prefetch"):
                            batch = self._local_rows(batch)
                            if self._place_span and self._copy_in_worker:
                                with span("place_batch"):
                                    x, t, ready, pinned, nbytes = copy(batch)
                            else:
                                x, t, ready, pinned, nbytes = copy(batch)
                    finally:
                        obs_trace.bind_context(prev_ctx)
                    item = _DeviceBatch(x, t, n, rows, wait_s, qdepth, ready, pinned, nbytes,
                                        ctx)
                    if not ring.put(item):
                        return
                ring.put(end)
            except BaseException as e:  # raised again in the training loop
                ring.put(e)

        thread = threading.Thread(target=worker, name="bigdl-prefetch", daemon=True)
        self._prefetch_thread = thread
        thread.start()
        try:
            while True:
                item = ring.get()
                if item is end or item is RING_CLOSED:
                    return
                if isinstance(item, BaseException):
                    raise item
                stage(-item.nbytes)
                if self._copy_in_worker:
                    item.wait_on(device)
                elif self._place_span:
                    with span("place_batch"):
                        item.x, item.t = to_device(item.x, device), to_device(item.t, device)
                else:
                    item.x, item.t = to_device(item.x, device), to_device(item.t, device)
                yield item
        finally:
            # an early stop, an exception or the epoch's end: a thread blocked
            # on the ring wakes now and the staged batches are dropped; the
            # dataset's stream is closed (a DataPipeline closes its rings
            # first, which wakes the thread if it waits there), the thread is
            # joined (at most the batch it is assembling), and a generator
            # that was running on it is closed after it
            ring.close()
            closer = close if close is not None else getattr(it, "close", None)
            closed = True
            if closer is not None:
                try:
                    closer()
                except ValueError:  # a generator running on the thread
                    closed = False
            thread.join()
            if not closed:
                closer()
            stage(-mine[0])  # the batches the close dropped

    # ----------------------------------------------------------- the loop
    def _check_first_batch(self, first) -> None:
        """Refuse what the step cannot train (DistriOptimizer: a global batch
        that does not divide into its ranks)."""
        if self._precision is not None and not self.flat_update:
            raise ValueError(
                "low-precision policies (comms_dtype/master_dtype/slot_dtype) hang off the "
                "flat master buffer; construct the optimizer with flat_update=True (or use "
                "the ZeRO-1 sharded DistriOptimizer, which always carries the flat layout)")

    def _init_step_state(self, method: OptimMethod, params):
        """The slots the steps carry (fresh, or the checkpoint's)."""
        return self._init_slots(method, params)

    def _bind_health(self, params) -> None:
        """Bind the health monitor's rows to this run's layout and install
        its activation hooks (before the step reads the state)."""
        hm = self.health
        if hm is None:
            return
        hm.prepare(self.model)
        hm.bind_tree(params)
        hm.bind_acts(self.model.get_state())

    def _optimize_impl(self):
        """One attempt of the drive loop (the module docstring)."""
        model, method = self.model, self.optim_method
        state = method.state
        first = self._first_batch()
        self._step_rows = first.size()
        self._check_first_batch(first)
        x0 = self._build_input(first)
        self._validate_before_step(to_spec(x0))
        if not model.is_built():
            model.build(RandomGenerator.generator(), model._as_input(x0))
        self._audit_params()
        self._mask_ragged = (self.criterion.supports_unreduced()
                             and not self._has_batch_coupled_state())
        device = model.device
        self._bind_health(model.get_parameters())
        params = model.get_parameters()
        model.zero_grad(set_to_none=True)
        slots = self._init_step_state(method, params)
        self._capture_entry_snapshot(slots)
        tel = self.telemetry
        pa = self._perf if tel is not None else None
        if tel is not None:
            if pa is not None:
                pa.begin_run(n_devices=self._perf_device_count())
            tel.run_started(type(self).__name__, warm_start=self._warm_start_bundle,
                            low_precision=(self._precision.describe()
                                           if self._precision is not None else None))
            self._kernel_builds_seen = _kernel_builds()
        watchdog = tel.watchdog if tel is not None else None
        if (self._active_policy is not None and watchdog is not None
                and watchdog is not self._stall_cb_watchdog):
            if self._stall_cb_watchdog is not None:
                self._stall_cb_watchdog.remove_callback(self._on_watchdog_stall)
            watchdog.add_callback(self._on_watchdog_stall)
            self._stall_cb_watchdog = watchdog
        try:
            self._drive_epochs(device, params, slots, first, x0, pa)
        finally:
            profile = self._profile
            if profile is not None and profile.get("on"):
                from ..obs import perf as obs_perf

                obs_perf.stop_capture()
                self._profile = None
            if pa is not None:
                pa.end_run()
            if tel is not None:
                tel.run_ended(type(self).__name__, iterations=state.get("neval"))
        return model

    def _drive_epochs(self, device, params, slots, first, x0, pa) -> None:
        from ..parallel import _comm

        model, method = self.model, self.optim_method
        state = method.state
        tel, hm = self.telemetry, self.health
        path = type(self).__name__
        t_start = time.perf_counter()
        mark: Dict[str, Optional[float]] = {"t": None}  # host time of the last loss pull
        t0 = self._local_rows(first).get_target()
        param_trigger = (self.summary.trigger_for("Parameters")
                         if self.summary is not None and hasattr(self.summary, "trigger_for")
                         else None)

        def flush(rec) -> None:
            (neval, epoch, pos, pulled, n, lr, wait_s, qdepth, dispatch_s, hshapes, wire) = rec
            pol = self._active_policy
            try:
                # one step late: the next step is queued already; the health
                # statistics ride the same transfer
                host = pulled.cpu() if hshapes else None
                loss_f = float(host[0]) if host is not None else float(pulled)
            except Exception as e:  # a fault of the step that made the loss
                e._bigdl_position = (epoch, pos)
                raise
            snap = None
            if hshapes:
                parts, off = {}, 1
                for key, shape in hshapes:
                    size = int(np.prod(shape))
                    parts[key] = host[off:off + size].reshape(shape)
                    off += size
                snap = hm.snapshot(parts)
            if pol is not None and pol.divergence_guard and not math.isfinite(loss_f):
                layer = source = shard = None
                if snap is not None:
                    layer, source = hm.attribute_nonfinite(snap)
                    shard = hm.attribute_shard(snap)
                raise DivergenceError(loss_f, neval, position=(epoch, pos), layer=layer,
                                      source=source, shard=shard)
            now = time.perf_counter()
            wall = now - mark["t"]
            mark["t"] = now
            if wall:
                self.metrics.add("computing time for each node average", wall)
            throughput = n / max(wall, 1e-9)
            state["loss"] = loss_f
            self.history.append({"neval": neval, "epoch": epoch, "loss": loss_f, "lr": lr,
                                 "records": n, "wall_s": wall,
                                 "records_per_sec": throughput, "input_wait_s": wait_s})
            log.info("[Epoch %d][Iteration %d][Wall %.3fs] loss is %.6f, lr %.6g, "
                     "throughput is %.1f records/s", epoch, neval, now - t_start,
                     loss_f, lr, throughput)
            with span("summary_flush"):
                if self.summary is not None:
                    self.summary.add_scalar("Loss", loss_f, neval)
                    self.summary.add_scalar("LearningRate", lr, neval)
                    self.summary.add_scalar("Throughput", throughput, neval)
                if tel is None:
                    return
                if pa is not None:
                    pa.ensure_cost((id(model), repr(to_spec(x0)), repr(to_spec(t0))),
                                   lambda: program_cost(self, x0, t0, routes=device.type))
                if pa is not None and wire is not None:
                    pa.note_collectives(wire)
                step_rec = tel.step(path=path, iteration=neval, epoch=epoch, loss=loss_f, lr=lr,
                                    records=n, wall_s=wall, records_per_sec=throughput,
                                    dispatch_s=dispatch_s, input_wait_s=wait_s,
                                    input_qdepth=qdepth, **(wire or {}),
                                    **(pa.step_fields(wall) if pa is not None else {}))
                if pa is not None:
                    for ev in pa.note_step(step_rec):
                        log.warning("perf regression at iteration %d: %s (component=%s)",
                                    neval, ev.get("trigger"), ev.get("component"))
                        tel.warn(path=path, **ev)
                    if pa.should_emit():
                        tel.perf(iteration=neval, epoch=epoch, path=path, **pa.perf_fields())
                if snap is not None and hm.should_emit(neval):
                    fields = hm.record_fields(snap)
                    tel.health(iteration=neval, epoch=epoch, path=path, **fields)
                    guard = hm.lr_guard_event(fields)
                    if guard is not None:
                        log.warning("update/weight ratio %.3g above %.3g for %d consecutive "
                                    "health samples (%s) at iteration %d: learning rate %g "
                                    "may be too high", guard["ratio"], guard["bound"],
                                    guard["consecutive"], guard["layer"] or "global", neval, lr)
                        tel.warn(iteration=neval, path=path, lr=lr, **guard)

        cooperative = bool(getattr(self.dataset, "supports_skip_positions", False))
        pending = None
        stop = False
        while not stop:
            self.dataset.shuffle(state["epoch"])  # the epoch's order, also on resume
            state["_epoch_done"] = False
            pol0 = self._active_policy
            skip_set = (frozenset(pol0.skip_positions) if cooperative and pol0 is not None
                        else frozenset())
            stream = (self.dataset.data(train=True, skip_positions=skip_set)
                      if cooperative and pol0 is not None else self.dataset.data(train=True))
            batches, close = stream, None
            skip = self._resume_skip_iters
            if skip:  # resumed mid-epoch: skip the batches already trained
                self._resume_skip_iters = 0
                # _iter_in_epoch counts slots, holes included; a cooperative
                # dataset never yields its holes
                n_yielded = skip - sum(1 for (e, i) in skip_set
                                       if e == state["epoch"] and i < skip)
                batches = itertools.islice(stream, max(0, n_yielded), None)
                close = getattr(stream, "close", None)
            state["_iter_in_epoch"] = skip
            staged = self._prefetch_batches(batches, device, close=close,
                                            qsize=getattr(stream, "qsize", None))
            try:
                for batch in staged:
                    pol = self._active_policy
                    if cooperative and pol is not None:
                        while (state["epoch"], state["_iter_in_epoch"]) in pol.skip_positions:
                            log.warning("skipping batch at poisoned data position (epoch %d, "
                                        "batch %d): never transformed or placed",
                                        state["epoch"], state["_iter_in_epoch"])
                            state["_iter_in_epoch"] += 1
                    pos = (state["epoch"], state["_iter_in_epoch"])
                    if pol is not None:
                        if pol.stall_pending():
                            info = pol.take_stall()
                            if self.checkpoint_path is None:
                                log.warning("stall escalation ignored (no checkpoint path to "
                                            "restart from): %s", info)
                            else:
                                raise StallEscalation(info)
                        if not cooperative and pos in pol.skip_positions:
                            log.warning("skipping batch at poisoned data position (epoch %d, "
                                        "batch %d)", pos[0], pos[1])
                            state["_iter_in_epoch"] = pos[1] + 1
                            continue
                    guard = self._preemption_guard
                    if guard is not None and guard.pending() is not None:
                        self._handle_preemption(state, slots)
                    el = self._elastic
                    if el is not None:
                        # one decision for every rank: the coordinator's
                        # verdict on the heartbeats, broadcast
                        _, lost = el.agree("step", state["neval"])
                        if lost:
                            self._handle_host_lost(state, slots, lost)
                    lr = method.get_learning_rate() * float(state.get("_lr_scale", 1.0))
                    if mark["t"] is None:
                        mark["t"] = time.perf_counter()
                    self._profile_window(state["neval"])
                    if not self.donate:
                        self._shadow_params(params)
                    self._step_health = None
                    wire = _comm.counts() if tel is not None and _comm.world() > 1 else None
                    t_dispatch = time.perf_counter()
                    obs_trace.fault_point("dispatch")  # chaos seam (timed, no span)
                    if self._step_export_info is None:  # metadata only, once
                        self._step_export_info = spec_tree((params, slots, batch.x, batch.t))
                    with obs_trace.step_annotation(state["neval"]), \
                            torch.profiler.record_function("dispatch"):
                        loss = self._train_step(batch.x, batch.t,
                                                float(batch.n) if batch.n < batch.rows else None,
                                                lr, params, slots)
                    pulled, hshapes = loss, None
                    if self._step_health is not None:  # one device vector, one pull
                        hshapes = [(k, tuple(v.shape)) for k, v in self._step_health.items()]
                        pulled = torch.cat([loss.float().reshape(1)]
                                           + [v.reshape(-1) for v in self._step_health.values()])
                        self._step_health = None
                    dispatch_s = time.perf_counter() - t_dispatch
                    if wire is not None:  # the step's own collectives, counted on the host
                        wire = _wire_fields(wire, _comm.counts())
                    if tel is not None:
                        obs_trace.add_sample("dispatch", dispatch_s)
                        if batch.trace is not None and batch.trace.sampled:
                            obs_trace.emit_span("dispatch", dispatch_s, batch.trace.child(),
                                                iteration=state["neval"])
                        self._kernel_builds_seen = observe_kernel_builds(
                            self._kernel_builds_seen, tel, iteration=state["neval"],
                            seconds=dispatch_s, path=path)
                    prev, pending = pending, (state["neval"], state["epoch"],
                                              state["_iter_in_epoch"], pulled, batch.n, lr,
                                              batch.wait_s, batch.qdepth, dispatch_s, hshapes,
                                              wire)
                    if prev is not None:
                        flush(prev)
                    state["learningrate"] = lr
                    if param_trigger is not None and param_trigger(state):
                        for pname, arr in tree_items(model.get_parameters()).items():
                            self.summary.add_histogram(pname, arr, state["neval"])
                    state["neval"] += 1
                    state["_iter_in_epoch"] += 1
                    self._run_validation()
                    self._maybe_checkpoint(state, slots)
                    if self.end_when(state):
                        stop = True
                        break
            finally:
                staged.close()
            if pending is not None:
                flush(pending)
                pending = None
            if not stop:
                state["_iter_in_epoch"] = 0
                state["epoch"] += 1
                state["_epoch_done"] = True
                self._run_validation()
                self._maybe_checkpoint(state, slots)
                if self.end_when(state):
                    stop = True
                state["_epoch_done"] = False
                el = self._elastic
                if el is not None and not stop:
                    _, joined = el.agree("epoch", state["neval"])
                    if joined:  # re-expansion at the epoch boundary
                        self._handle_rejoin(state, slots, joined)

    def _profile_window(self, neval: int) -> None:
        """Open and close ``set_profile`` 's capture around its steps."""
        profile = self._profile
        if profile is None:
            return
        from ..obs import perf as obs_perf

        if neval >= profile["start"] + profile["len"]:
            if profile.get("on"):
                obs_perf.stop_capture()
            self._profile = None
        elif not profile.get("on") and neval >= profile["start"]:
            profile["on"] = obs_perf.start_capture(profile["dir"])


def _wire_fields(before, after) -> Dict[str, int]:
    """A step's collective bytes from two ``parallel._comm.counts()``
    readings: ``collective_bytes`` and its all-to-all and ppermute parts."""
    from ..obs.profiler import collective_bytes

    delta = {k: {"calls": after[k]["calls"] - before[k]["calls"],
                 "bytes": after[k]["bytes"] - before[k]["bytes"]} for k in after}
    cb = collective_bytes(delta)
    return {"collective_bytes": cb["total_bytes"], "all_to_all_bytes": cb["all_to_all_bytes"],
            "ppermute_bytes": cb["ppermute_bytes"]}


def _kernel_builds():
    from ..ops import _build

    return (_build.loads, _build.builds)


class _FlatState:
    """The flat layout of one run: the codec, the stored master (float32,
    or narrow under ``master_dtype``), the float32 working vector the
    parameters are views of (the master itself when it is float32), the
    flat gradient buffer the ``.grad`` s are views of, the stored slot
    vectors (a shard of each under the ZeRO-1 layout), the error-feedback
    residual, the precision objects and the weight-decay coefficients (of
    the shard under ZeRO-1)."""

    def __init__(self, fp, params, device, precision, method, wd_full, shard=None):
        from ..parallel.compression import GradCompressor
        from .quantization import StatePrecision

        self.fp = fp
        self.work = torch.zeros(fp.padded_total, dtype=torch.float32, device=device)
        fp.bind(params, self.work)
        self.grads = torch.zeros(fp.padded_total, dtype=torch.float32, device=device)
        self.shard = shard  # (rank, lo, hi) under ZeRO-1
        lo, hi = (0, fp.padded_total) if shard is None else shard[1:]
        self.sp = (StatePrecision(fp, precision)
                   if precision is not None and precision.quantizes_state else None)
        self.comp = (GradCompressor(fp, precision)
                     if precision is not None and precision.comms_dtype is not None else None)
        self.err = (self.comp.init_residual(device)
                    if self.comp is not None and self.comp.error_feedback else None)
        self.wd = None if wd_full is None else wd_full[lo:hi]
        self.slots = method.init_flat_slots(
            torch.zeros(hi - lo, dtype=torch.float32, device=device))
        self.master = self.work
        if self.sp is not None:
            self.master, mscale = self.sp.encode_master(self.work)
            self.slots = self.sp.encode_slots(self.slots)
            if mscale is not None:
                self.slots[MASTER_SCALE_KEY] = mscale
            self.decode()

    def shadow(self, params) -> None:
        """``donate=False``: rebind the parameters to a fresh working vector
        (and master), so the coming update leaves the old storage as it is."""
        work = torch.empty_like(self.work)
        self.fp.bind(params, work)
        if self.master is self.work:
            self.master = work
        else:
            self.master = self.master.clone()
        self.work = work

    def decode(self) -> None:
        """The working vector (the parameters) from the stored master."""
        if self.master is not self.work:
            self.sp.decode_master(self.master, self.slots.get(MASTER_SCALE_KEY), out=self.work)

    def decoded_slots(self) -> Dict[str, Any]:
        """The float32 slot vectors, whole (gathered under ZeRO-1)."""
        from ..parallel import _comm

        slots = {k: v for k, v in self.slots.items() if k != MASTER_SCALE_KEY}
        if self.sp is not None:
            slots = self.sp.decode_slots(slots)
        if self.shard is None:
            return slots
        full = {}
        for k, v in slots.items():
            if isinstance(v, torch.Tensor) and v.dim() == 1:
                out = torch.empty(self.fp.padded_total, dtype=v.dtype, device=v.device)
                full[k] = _comm.all_gather_into(out, v.contiguous())
            else:
                full[k] = v
        return full

    def restore_slots(self, restored: Dict[str, Any]) -> None:
        """Copy a checkpoint's tree-layout slots (``{path: array}``) into the
        stored slot vectors (this rank's shard of them under ZeRO-1)."""
        lo, hi = (0, self.fp.padded_total) if self.shard is None else self.shard[1:]
        full = {k: torch.zeros(self.fp.padded_total, dtype=torch.float32,
                               device=self.work.device)
                for k, v in self.slots.items() if k != MASTER_SCALE_KEY and v.dim() == 1}
        copy_into(self.fp.slots_tree_view(full), restored, "optimizer slot")
        for k, vec in full.items():
            self.slots[k].copy_(vec[lo:hi])


def _clip_flat_(opt, g: torch.Tensor, norm_sq_sum=None) -> torch.Tensor:
    """``opt`` 's clipping of a flat gradient (or shard), in place: the
    constant clip, then the L2-norm clip over the vector (``norm_sq_sum``
    sums the squares over the ranks for a shard)."""
    if opt._grad_clip_const is not None:
        g.clamp_(*opt._grad_clip_const)
    if opt._grad_clip_norm is not None:
        sq = torch.sum(g * g)
        if norm_sq_sum is not None:
            sq = norm_sq_sum(sq.reshape(1)).reshape(())
        scale = torch.clamp(opt._grad_clip_norm / (torch.sqrt(sq) + 1e-12), max=1.0)
        g.mul_(scale)
    return g



def _apply_flat_(opt, fs: _FlatState, g: torch.Tensor, lr: float, step: int, shard=None,
                 norm_sq_sum=None, gather=None) -> None:
    """Clip the exchanged flat gradient ``g`` (:func:`_clip_flat_`) and
    update ``fs`` 's master with it in float32, the padding tail re-zeroed:
    the whole vector, or with ``shard = (rank, lo, hi)`` the rank's part of
    it, then ``gather(whole, part)`` puts the parts back together; the
    working vector is then decoded from the stored master."""
    g = _clip_flat_(opt, g, norm_sq_sum)
    method = opt.optim_method
    if shard is None:
        part, pad_zero = slice(None), fs.fp.zero_pad
    else:
        part = slice(shard[1], shard[2])

        def pad_zero(v):
            return fs.fp.zero_pad_shard(v, shard[0])

    if fs.sp is None:
        method.update_flat(g, fs.work[part], fs.slots, lr, step, wd_coeff=fs.wd)
        pad_zero(fs.work[part])
    else:
        master, fs.slots, _ = fs.sp.apply_update(
            method, g, fs.master[part], fs.slots, lr, step, wd_coeff=fs.wd,
            pad_zero=pad_zero, p32=fs.work[part])
        if shard is None:
            fs.master = master
    if shard is not None:
        stored = fs.master if fs.sp is not None else fs.work
        gather(stored, stored[part])
    fs.decode()

class LocalOptimizer(Optimizer):
    """Trains ``model`` on ``dataset`` against ``criterion`` on the model's
    device (see the module docstring); the reference's
    ``$DL/optim/LocalOptimizer.scala``."""

    def _validate_now(self):
        """Every batch whole on this process: under a group every rank runs
        the same program (a mesh's modules, the ring), the validation too."""
        return validate_whole(self.model, self.model.get_parameters(), self.model.get_state(),
                              self.validation_dataset, self.validation_methods)

    def _check_first_batch(self, first) -> None:
        super()._check_first_batch(first)
        if self.flat_update:
            if self._micro_batches != 1:
                raise NotImplementedError(
                    "flat_update does not compose with set_micro_batches; pick one")
            if not getattr(self.optim_method, "elementwise", True):
                raise ValueError(
                    f"{type(self.optim_method).__name__} is layer-structure-aware and cannot "
                    "run on the flat parameter layout; use flat_update=False")

    def _init_step_state(self, method: OptimMethod, params):
        if not self.flat_update:
            self._flat = None
            return super()._init_step_state(method, params)
        from ..parallel.parameter import FlatParameter

        fp = FlatParameter(params, 1)
        self._flat = _bind_flat(self, fp, params, method, None)
        if self.health is not None:
            self.health.bind_flat(fp)
        return self._flat.slots

    def _train_step(self, x, t, nvalid: Optional[float], lr: float, params,
                    slots) -> torch.Tensor:
        if self._flat is None:
            return super()._train_step(x, t, nvalid, lr, params, slots)
        fs, model = self._flat, self.model
        step = self.optim_method.state["neval"]
        rng = RandomGenerator.generator()
        fs.grads.zero_()
        fs.fp.bind_grads(params, fs.grads)
        loss, new_state = self._loss(model.get_state(), x, t, rng, nvalid)
        loss.backward()
        g = fs.grads
        if fs.comp is not None:
            g, fs.err = fs.comp.exchange_local(g, fs.err)
        old = fs.work.clone() if self.health is not None else None
        _apply_flat_(self, fs, g, lr, step)  # g is clipped in place
        if old is not None:
            self._step_health = self.health.flat_stats(fs.fp, g, old, fs.work, new_state)
        model.set_state(detach_tree(new_state))
        return loss.detach()


def _wd_coefficients(method, fp, device):
    """The per-element weight-decay coefficients on ``device`` when the
    method excludes paths from its decay, else None (its own uniform
    term)."""
    wd = float(getattr(method, "weightdecay", 0.0) or 0.0)
    exclude = tuple(getattr(method, "weightdecay_exclude", ()) or ())
    if wd <= 0 or not exclude:
        return None
    return fp.coefficient_vector(lambda path: 0.0 if any(p in path for p in exclude) else wd,
                                 device)


def _bind_flat(opt, fp, params, method, shard) -> _FlatState:
    """Bind ``params`` to a new flat layout of ``fp`` on the model's device,
    audit it (``validate=True``) and put a resumed run's slots in."""
    with span("commit_shardings"):  # the parameters become views of the master
        fs = _FlatState(fp, params, opt.model.device, opt._precision, method,
                        _wd_coefficients(method, fp, opt.model.device), shard)
    if opt.validate:
        from ..analysis import FlatParamAudit

        with span("flat_param_audit"):
            FlatParamAudit(fp, fs.work).check()
    if opt._restored_slots is not None:
        fs.restore_slots(opt._restored_slots)
        opt._restored_slots = None
    return fs
