"""DistriOptimizer: synchronous data-parallel training across processes
(counterpart of ``bigdl_tpu/parallel/distri_optimizer.py``; reference:
``$DL/optim/DistriOptimizer.scala`` with ``AllReduceParameter``, SURVEY.md
§3.1).

One process a rank, joined by ``Engine.init_distributed``; every rank runs
the same loop over the same global batches and trains on its rows of each,
``[r·b/n, (r+1)·b/n)`` (the JAX package's ``P(axis)`` sharding of the
batch). The prefetch thread copies only those rows to the rank's device
(``async_placement=True``; ``False`` copies them on the driver thread).
Without a group the world size is 1 and the collectives are identities
(the JAX package's one-device mesh).

``parameter_sync``:

* ``"sharded"`` (ZeRO-1, ``AllReduceParameter``): the parameters are views
  of one padded float32 master vector (``FlatParameter.bind``) and their
  gradients of one flat gradient buffer. Each step the gradient buffer is
  reduce-scattered and divided by n, the shard clipped by the global norm
  (a sum of the shards' squares over the ranks), ``update_flat`` applied to
  the rank's shard of the master in place with the padding tail re-zeroed,
  and the shards all-gathered back into the master. The slots live
  sharded: each rank holds its shard of each slot vector.
* ``"replicated"``: the gradients averaged over the ranks and the update
  replicated; per leaf over the tree, or with ``flat_update=True`` as one
  mean and one ``update_flat`` over the flat vector.
* ``"auto"``: sharded from 1 M parameters for an elementwise method, else
  replicated.

``gradient_dtype`` narrows the gradient on the wire (bf16: the reference's
fp16 ``CompressedTensor``); the precision policies (``comms_dtype`` with
error feedback, ``master_dtype``, ``slot_dtype``) need a flat layout, and
the fp8 master is refused on the sharded one, as in the JAX package.

After every step the model state (BN running statistics) and the loss are
averaged over the ranks in one collective over their flattened floating
leaves, the JAX package's ``pmean(new_ms)``: each rank normalises its
forward with its own rows' batch statistics, only the running state is
averaged afterwards (neither DDP's ``broadcast_buffers``, which copies rank
0's, nor ``SyncBatchNorm``, which normalises with the global statistics).

Each rank's generator (dropout, ...) is the step's generator folded with
the rank, as ``fold_in(rng, axis_index)``: a ``torch.Generator`` seeded
from the step's seed and the rank, so its draws are torch's, not
``jax.random`` 's. Checkpoints are the classic triple in the tree layout:
the slot shards are gathered and rank 0 writes the files, so a run resumes
at any world size. Validation sums each method's counters over the ranks.
``set_micro_batches`` raises, as in the JAX package. Telemetry, summaries,
the retry ladder, the divergence guard and preemption are the base
``Optimizer`` 's (every rank runs them alike: the step-0 snapshot is taken
once an ``optimize()`` on each rank). ``set_health`` runs on every layout:
on the ZeRO-1 one each rank computes the statistics of its slice of the
clipped gradient and of the update, and one all-reduce of the small
matrix sums them, so every rank reads the same rows with its loss.

``set_elastic`` (``resilience/elastic.py``) rides the ZeRO-1 layout (a
non-``sharded`` ``parameter_sync`` is refused): every checkpoint of the
fit is a fleet checkpoint, each rank writing its ``[lo, hi)`` slice of the
float32 master and of the slots under the coordinator's generation and the
coordinator the manifest. After a shrink the survivors' group takes the
collectives (``parallel._comm``), the flat master is cut again for their
count and the restored checkpoint's slots are cut to their shards; the
layout of each membership is made once (``_distri_step_cache``), so a
shrink and a rejoin make two entries, not three.

:func:`simulate_step` is the plain version of one n-rank step in one
process (n forwards and backwards on the ranks' rows, the gradients
averaged, one tree update, the state averaged); the tests and the card's
smoke run hold the optimizer against it.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import torch

from ..nn.module import detach_tree
from ..optim.local_optimizer import Optimizer, _apply_flat_, _bind_flat
from ..optim.quantization import MASTER_SCALE_KEY
from ..utils.random import RandomGenerator
from ..utils.serialization import tree_items, unflatten_to_like
from . import _comm
from .parameter import FlatParameter

log = logging.getLogger(__name__)

_GRADIENT_DTYPES = {None: None, "bfloat16": torch.bfloat16, torch.bfloat16: torch.bfloat16,
                    "float32": None, torch.float32: None}


def rank_generator(gen: Optional[torch.Generator], rank: int, world: int):
    """The rank's generator from the step's (``fold_in(rng, axis_index)``):
    the step's own at world size 1."""
    if gen is None or world == 1:
        return gen
    return torch.Generator().manual_seed((gen.initial_seed() * 1_000_003 + rank + 1) % (1 << 62))


def _floating_leaves(tree) -> List[torch.Tensor]:
    return [v for v in tree_items(tree).values()
            if isinstance(v, torch.Tensor) and v.is_floating_point()]


def average_state(state, loss: torch.Tensor, mesh=None, axes=None):
    """``state`` 's floating leaves and ``loss`` averaged over the ranks (over
    ``mesh`` 's ``axes`` when given) in one collective; returns ``(state,
    loss)`` (new tensors, the tree's other leaves as they were)."""
    if _comm.world() == 1:
        return state, loss
    leaves = _floating_leaves(state)
    buf = torch.cat([v.reshape(-1).float() for v in leaves] + [loss.reshape(1).float()])
    if mesh is None:
        _comm.pmean_(buf)
    else:
        _comm.axis_pmean_(buf, mesh, axes)
    out, off = {}, 0
    for path, v in tree_items(state).items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            out[path] = buf[off:off + v.numel()].view(v.shape).to(v.dtype)
            off += v.numel()
        else:
            out[path] = v
    return unflatten_to_like(out, state), buf[off].to(loss.dtype)


class DistriOptimizer(Optimizer):
    """Synchronous data-parallel training (see the module docstring)."""

    def __init__(self, model, dataset, criterion, parameter_sync: str = "sharded",
                 gradient_dtype=None, validate: bool = True, donate: bool = True,
                 flat_update: bool = False, async_placement: bool = True, comms_dtype=None,
                 error_feedback: bool = True, master_dtype=None, slot_dtype=None):
        super().__init__(model, dataset, criterion, validate=validate, donate=donate,
                         flat_update=flat_update, comms_dtype=comms_dtype,
                         error_feedback=error_feedback, master_dtype=master_dtype,
                         slot_dtype=slot_dtype)
        if parameter_sync not in ("auto", "sharded", "replicated"):
            raise ValueError(f"unknown parameter_sync {parameter_sync!r}")
        if gradient_dtype not in _GRADIENT_DTYPES:
            raise ValueError(f"gradient_dtype {gradient_dtype!r}: bfloat16 or None")
        self.parameter_sync = parameter_sync
        self.gradient_dtype = _GRADIENT_DTYPES[gradient_dtype]
        self.async_placement = bool(async_placement)
        self._copy_in_worker = self.async_placement
        self._place_span = True  # the rank's rows copied under "place_batch"
        self._sync: Optional[str] = None  # resolved in optimize()
        self._distri_step_cache: Dict[tuple, FlatParameter] = {}  # membership -> layout

    def set_micro_batches(self, n: int) -> "DistriOptimizer":
        raise NotImplementedError(
            "set_micro_batches is LocalOptimizer-only; with DistriOptimizer use nn.Remat "
            "(gradient checkpointing) for activation memory")

    def _supports_elastic(self) -> bool:
        # the remesh rides the flat master layout; _init_step_state refuses
        # a non-sharded parameter_sync under elastic
        return True

    def _ragged_seam_policy(self) -> str:
        # no masked loss across ranks: a padded row would train as real
        # data; DistributedDataSet drops the batches that do not divide
        return "pass"

    def _resolve_parameter_sync(self, method, params) -> str:
        """``"auto"``: sharded from 1 M parameters for an elementwise method."""
        sync = self.parameter_sync
        if sync != "auto":
            return sync
        n_params = sum(int(v.numel()) for v in tree_items(params).values())
        elementwise = getattr(method, "elementwise", True)
        sync = "sharded" if (n_params >= 1_000_000 and elementwise) else "replicated"
        log.info("parameter_sync=auto -> %r (%d params, elementwise=%s)", sync, n_params,
                 elementwise)
        return sync

    # ----------------------------------------------------------- the rows
    def _local_rows(self, batch):
        n = _comm.world()
        if n == 1:
            return batch
        k = batch.size() // n
        return batch.slice(_comm.rank() * k, k)

    def _build_input(self, first):
        return self._local_rows(first).get_input()

    def _apply_reader_slice(self) -> None:
        """Under a group, a dataset with ``shard(index, count)`` is read as
        the rank's slice of its stream (always sliced from the original)."""
        n = _comm.world()
        if n <= 1 or _comm.rank() < 0:
            return
        base = self._dataset_base
        if base is None:
            base = self._dataset_base = self.dataset
        if not hasattr(base, "shard"):
            log.info("rank %d of %d reads the full stream of %s and trains on its rows",
                     _comm.rank(), n, type(base).__name__)
            return
        self.dataset = base.shard(_comm.rank(), n)

    def _check_first_batch(self, first) -> None:
        n = _comm.world()
        if first.size() % n:
            raise ValueError(f"global batch {first.size()} not divisible by {n} devices")

    # ------------------------------------------------------------ the state
    def _init_step_state(self, method, params):
        sync = self._sync = self._resolve_parameter_sync(method, params)
        if self._elastic is not None and sync != "sharded":
            raise ValueError(
                "elastic training rides the ZeRO-1 flat master layout (per-host shard bounds "
                "are FlatParameter arithmetic); use parameter_sync='sharded'")
        flat_mode = sync == "sharded" or self.flat_update
        pol = self._precision
        if pol is not None:
            if not flat_mode:
                raise ValueError(
                    "low-precision policies (comms_dtype/master_dtype/slot_dtype) hang off the "
                    "flat master buffer; use parameter_sync='sharded' (the ZeRO-1 flat "
                    "layout) or flat_update=True on the replicated mode")
            if sync == "sharded" and pol.master_scaled:
                raise ValueError(
                    "master_dtype=float8 (scaled master codes) is not supported on the ZeRO-1 "
                    "sharded layout; use master_dtype='bfloat16' here, or the replicated/local "
                    "flat paths for the experimental fp8 master tier")
        if not flat_mode:
            self._flat = None
            return self._init_slots(method, params)
        if not getattr(method, "elementwise", True):
            raise ValueError(
                f"{type(method).__name__} is layer-structure-aware and cannot run on the flat "
                "parameter layout; use parameter_sync='replicated'"
                + (" without flat_update" if sync != "sharded" else ""))
        n, r = _comm.world(), _comm.rank()
        if sync == "sharded":
            key = _comm.members()
            fp = self._distri_step_cache.get(key)
            if fp is None:
                fp = self._distri_step_cache[key] = FlatParameter(params, n)
            lo, hi = fp.shard_bounds(r)
            self._flat = _bind_flat(self, fp, params, method, (r, lo, hi))
        else:
            self._flat = _bind_flat(self, FlatParameter(params, 1), params, method, None)
        if self.health is not None:
            self.health.bind_flat(self._flat.fp)
        return self._flat.slots

    # ------------------------------------------------------------- the step
    def _train_step(self, x, t, nvalid: Optional[float], lr: float, params,
                    slots) -> torch.Tensor:
        model, method = self.model, self.optim_method
        n, r = _comm.world(), _comm.rank()
        step = method.state["neval"]
        rng = rank_generator(RandomGenerator.generator(), r, n)
        fs = self._flat
        if fs is not None:
            fs.grads.zero_()
            fs.fp.bind_grads(params, fs.grads)
        loss, new_state = self._loss(model.get_state(), x, t, rng, None)
        loss.backward()
        new_state, loss = average_state(detach_tree(new_state), loss.detach())
        if fs is None:
            self._replicated_tree_update(lr, step, params, slots, new_state)
        elif self._sync == "sharded":
            self._sharded_update(fs, lr, step, n, r, new_state)
        else:
            self._replicated_flat_update(fs, lr, step, n, new_state)
        model.set_state(new_state)
        return loss

    def _sharded_update(self, fs, lr, step, n, r, new_state=None) -> None:
        """Reduce-scatter, clip, the shard's update, all-gather (and the
        health statistics of the shard, summed over the ranks)."""
        if fs.comp is not None:
            shard_sum, fs.err = fs.comp.exchange_sharded(fs.grads, fs.err, n, r)
            g_shard = shard_sum / n
        else:
            g = fs.grads if self.gradient_dtype is None else fs.grads.to(self.gradient_dtype)
            g_shard = _comm.psum_scatter(g).float() / n
        lo, hi = fs.shard[1:]
        old = fs.work[lo:hi].clone() if self.health is not None else None
        _apply_flat_(self, fs, g_shard, lr, step, fs.shard, norm_sq_sum=_comm.psum_,
                     gather=_comm.all_gather_into)  # g_shard is clipped in place
        if old is not None:
            self._step_health = self.health.flat_shard_stats(
                fs.fp, g_shard, old, fs.work[lo:hi], lo, _comm.psum_, new_state)

    def _replicated_flat_update(self, fs, lr, step, n, new_state=None) -> None:
        """One mean of the flat gradient, clip, one update of the vector (and
        the health statistics when attached)."""
        if fs.comp is not None:
            g, fs.err = fs.comp.exchange_replicated(fs.grads, fs.err, n)
        else:
            g = fs.grads if self.gradient_dtype is None else fs.grads.to(self.gradient_dtype)
            g = _comm.pmean_(g).float()
        old = fs.work.clone() if self.health is not None else None
        _apply_flat_(self, fs, g, lr, step)  # g is clipped in place
        if old is not None:
            self._step_health = self.health.flat_stats(fs.fp, g, old, fs.work, new_state)

    def _replicated_tree_update(self, lr, step, params, slots, new_state=None) -> None:
        """Each leaf's gradient averaged over the ranks, clipped, the tree
        update (and the health statistics when attached)."""
        model = self.model
        grads = model.get_grad_parameters()
        if _comm.world() > 1:
            flat = tree_items(grads)
            for path, g in flat.items():
                w = g if self.gradient_dtype is None else g.to(self.gradient_dtype)
                flat[path] = _comm.pmean_(w).float()
            grads = unflatten_to_like(flat, grads)
        grads = self._clip_grads(grads)
        old = self._health_old_params(params)
        self.optim_method.update(grads, params, slots, lr, step)
        self._note_tree_health(grads, old, params, new_state)
        model.zero_grad(set_to_none=True)

    # ----------------------------------------------------------- the loop
    def _write_checkpoint(self, state, slots) -> Optional[Dict[str, Any]]:
        """The slot shards gathered on every rank; rank 0 writes the files;
        the ranks wait for it (an elastic fit: the fleet checkpoint)."""
        if self._elastic is not None:
            return self._write_fleet_checkpoint(state)
        tree_slots = self._checkpoint_slots(slots)
        out = None
        if _comm.rank() == 0:
            from ..utils.serialization import save_checkpoint

            out = save_checkpoint(self.checkpoint_path, step=state["neval"],
                                  params=self.model.get_parameters(), optim_slots=tree_slots,
                                  optim_state=dict(state), model_state=self.model.get_state(),
                                  keep_last=self.checkpoint_keep_last)
        _comm.barrier()
        return out

    def _write_fleet_checkpoint(self, state) -> Dict[str, Any]:
        """This rank's ``shard.p<k>.<step>.npz`` (its ``[lo, hi)`` of the
        float32 master and of the slots, the model state whole), the
        entries gathered over the group's gloo twin, the coordinator's
        manifest written last; every rank returns the manifest's fields."""
        import torch.distributed as dist

        from ..utils.serialization import (fleet_codec_info, save_fleet_manifest,
                                           save_fleet_shard, tree_items as items)

        el, fs = self._elastic, self._flat
        fp, me = fs.fp, el.process_index
        bounds = el.process_bounds(fp)
        lo, hi = bounds[me]
        slots = {k: v for k, v in fs.slots.items() if k != MASTER_SCALE_KEY}
        if fs.sp is not None:
            slots = fs.sp.decode_slots(slots)
        vec = {k: v for k, v in slots.items() if isinstance(v, torch.Tensor) and v.dim() == 1}
        entry = save_fleet_shard(
            self.checkpoint_path, state["neval"], me, lo=lo, hi=hi, master_slice=fs.work[lo:hi],
            slot_slices=vec, scalars={k: v for k, v in slots.items() if k not in vec},
            model_state_flat=items(self.model.get_state()))
        cpu = el.cpu_group_for(el.active())
        if cpu is None:
            entries = {me: entry}
        else:
            gathered = [None] * el.n_active()
            dist.all_gather_object(gathered, (me, entry), group=cpu)
            entries = dict(gathered)
        manifest = {"finite": all(e.get("finite", True) for e in entries.values())}
        if me == el.coordinator():
            manifest = save_fleet_manifest(
                self.checkpoint_path, state["neval"], entries, codec=fleet_codec_info(fp),
                mesh_shape=(el.n_active(),), process_count=el.n_active(),
                optim_state=dict(state), generation=el.generation,
                keep_last=self.checkpoint_keep_last)
        if cpu is not None:
            dist.barrier(group=cpu)  # the manifest is down before any rank reads it
        return manifest


def simulate_step(model, criterion, method, slots, x, t, n: int, lr: float, step: int,
                  rng: Optional[torch.Generator] = None, clip_norm: Optional[float] = None,
                  stats: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """The plain version of one n-rank ``DistriOptimizer`` step in one
    process: for each rank r, a training forward and backward on rows
    ``[r·b/n, (r+1)·b/n)`` from the same parameters and state (with
    ``rank_generator(rng, r, n)``); the gradients summed and divided by n,
    clipped by their global L2 norm when ``clip_norm`` is given, one tree
    ``method.update`` in place (the weight-decay exclusions by path); the
    new states averaged (a sum, then a division by n). Returns the mean
    loss; ``stats`` (a dict), when given, receives the averaged gradient's
    L2 norm before clipping as ``"grad_norm"``."""
    params = model.get_parameters()
    items = tree_items(params)
    leaves = list(items.values())
    state0 = model.get_state()
    k = x.shape[0] // n
    g_sum, states, losses = None, [], []
    for r in range(n):
        rows = slice(r * k, (r + 1) * k)
        y, st = model.apply(params, state0, x[rows], training=True,
                            rng=rank_generator(rng, r, n))
        loss = criterion._apply(y, t[rows])
        reg = model.regularization_loss_tree(params)
        if isinstance(reg, torch.Tensor):
            loss = loss + reg
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        g_sum = grads if g_sum is None else [a + b for a, b in zip(g_sum, grads)]
        states.append(tree_items(detach_tree(st)))
        losses.append(loss.detach())
    g_mean = [g / n for g in g_sum]
    if clip_norm is not None or stats is not None:
        total = sum(torch.sum(g * g) for g in g_mean)
        if stats is not None:
            stats["grad_norm"] = float(torch.sqrt(total))
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / (torch.sqrt(total) + 1e-12), max=1.0)
        g_mean = [g * scale for g in g_mean]
    method.update(unflatten_to_like(dict(zip(items, g_mean)), params), params, slots, lr, step)
    mean_state = {}
    for path, v in states[0].items():
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            acc = v.float()
            for other in states[1:]:
                acc = acc + other[path].float()
            mean_state[path] = (acc / n).to(v.dtype)
        else:
            mean_state[path] = v
    model.set_state(unflatten_to_like(mean_state, state0))
    return torch.stack(losses).mean()
