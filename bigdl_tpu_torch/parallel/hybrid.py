"""Hybrid data x tensor parallel training over a sharding plan (counterpart
of ``bigdl_tpu/parallel/hybrid.py``).

The JAX package jits one global-view step, commits each parameter to its
plan's ``NamedSharding`` and lets GSPMD partition every product. Here one
process is one rank of a :class:`~bigdl_tpu_torch.parallel.sharding.Mesh`
such as ``make_mesh({"data": 2, "model": 2})``, and the step computes the
same global-view result with the parameter and slot memory sharded:

* each rank holds only its block of each leaf under the plan (``P(a,
  None)``: the rows split over axis ``a``, the data axis too) and its block
  of each slot, and the update runs on the blocks;
* once a step each sharded leaf is gathered whole along its axes (outside
  autograd) and the forward reads it as a leaf of its own, so the
  gradients come out whole;
* the batch is cut over the data axis: each rank trains on its data row's
  rows ``[d*b/n, (d+1)*b/n)`` and its generator is the step's folded with
  the data coordinate. With ``set_micro_batches(m)`` micro-batch i is the
  global rows ``[i*mb, (i+1)*mb)`` as in the JAX step, and rank d takes
  its share ``[i*mb + d*mb/n, i*mb + (d+1)*mb/n)`` of each (micro-major);
  the micro-batches' forwards and backwards run against the gathered
  leaves, their whole gradients summed, the model state carried from one
  to the next, all before any gradient collective;
* the gradients then go to this rank's blocks in one all-reduce over the
  data axis: a leaf sharded over model axes only is cut to its block first
  (every rank of a model line computed the same gradient on the same
  rows); a leaf sharded over the data axis goes whole, and after the sum
  (the ranks of a data line computed it on different rows) it is cut to
  its block, the transpose of its gather over that axis; every leaf is
  then divided by the data axis size. The loss and model state are
  averaged over the data axis (``average_state``), the JAX package's
  reduce-scatter and ``pmean``;
* a padded ragged batch's loss is the masked sum of this rank's rows over
  the whole batch's denominator (a sum over the data axis), times the data
  axis size, so that the average over the data axis is the whole batch's
  masked mean (under micro-batches, each micro-batch's, weighted by its
  real rows as in the JAX step);
* the clipping norm sums each sharded leaf's blocks over its axes.

Checkpoints are written by rank 0 in the tree layout after the blocks of
the parameters and slots are gathered, and a resumed run cuts the
checkpoint's leaves again, so a run resumes at any mesh and a one-rank
``LocalOptimizer`` reads the file. When ``optimize()`` returns, every
rank's model holds the whole parameters again. Validation runs on the
whole parameters, gathered for it.

Megatron's activation-sharded execution (heads and filter columns computed
where their weights live, one all-reduce on each row-parallel output) is
a speed property of XLA's partitioning, not of the result, and is not done
here (ROADMAP). ``flat_update`` is refused with
:class:`ParallelCompositionError`, as in the JAX package. Telemetry and the
retry ladder are the base ``Optimizer`` 's. Under micro-batches a
micro-batch's rows must divide over the data axis (a ``ValueError`` naming
the batch, the micro-batch count and the data axis size otherwise; the
JAX package lets GSPMD cut uneven rows).
``set_health`` computes each leaf's statistics on this rank's block and
sums a sharded leaf's rows over its axes (the clipping norm's way), and
counts the batch's non-finite inputs and targets by data shard
(``bind_mesh_axis``), so a diverged step names its shard. ``donate=False``
writes each update into fresh blocks. Under ``set_elastic`` only the
leading data axis shrinks and re-expands
(:meth:`~bigdl_tpu_torch.resilience.ElasticCoordinator.hybrid_mesh`): the
emergency checkpoint is the tree layout, and the survivors cut its leaves
again for their mesh (a leaf over the data axis to its larger block).

:class:`_ShardedOptimizer` is the chassis of the sharded leaves (blocks of
the leaves and slots, the clipping norm over the shards, the whole
parameters for validation and checkpoints); this optimizer and the
stacked-parameter ones of
:mod:`~bigdl_tpu_torch.parallel.pipeline_optimizer` each extend it.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..nn.module import detach_tree
from ..optim.local_optimizer import Optimizer, check_micro_split
from ..utils.engine import Engine
from ..obs.trace import span
from ..utils.random import RandomGenerator
from ..utils.serialization import tree_items, unflatten_to_like
from . import _comm
from .distri_optimizer import average_state, rank_generator
from .sharding import Mesh, P, ShardingPlan, gather_block, is_sharded, shard_leaf, spec_axes


class ParallelCompositionError(ValueError):
    """A requested parallelism composition the parameter layouts cannot
    carry (a flat replicated master vector under per-leaf placements),
    raised at construction with the reason and the supported
    alternative."""


def make_mesh(axis_sizes: dict, devices: Optional[Sequence] = None) -> Mesh:
    """An N-D mesh over the group's ranks from ``{'data': 2, 'model': 4}``
    axis sizes (axis order as the dict's; see :class:`Mesh`). ``devices``,
    when given, must be every rank of the group in order: a mesh spans the
    whole group. Every rank builds the same meshes in the same order."""
    world = _comm.world()
    devs = list(devices) if devices is not None else list(range(world))
    total = 1
    for v in axis_sizes.values():
        total *= int(v)
    if total != len(devs):
        raise ValueError(f"mesh {axis_sizes} needs {total} devices, have {len(devs)}")
    if devs != list(range(world)):
        raise ValueError(f"a mesh spans every rank of the group in order (0..{world - 1}); "
                         f"got {devs}")
    return Mesh(axis_sizes)


def _slot_specs(slots, specs: Dict[str, P]) -> Dict[str, P]:
    """Each slot leaf's spec: that of the parameter whose path ends its
    path (the slots mirror the parameter tree under their names)."""
    out = {}
    for path in tree_items(slots):
        best = ""
        for ppath in specs:
            if (path == ppath or path.endswith("/" + ppath)) and len(ppath) > len(best):
                best = ppath
        out[path] = specs.get(best, P()) if best else P()
    return out


class _ShardedOptimizer(Optimizer):
    """The chassis of the mesh optimizers whose ranks hold blocks of the
    leaves: subclasses resolve the mesh (``_resolve_mesh``) and give the
    plan (``_prepare_plan``); this class cuts the leaves and their slots to
    the plan's blocks, clips over the shards, runs the step, and gathers
    the parameters whole for validation, checkpoints and the end of
    ``optimize``. The step's hooks (``_forward_params``,
    ``_average_grads``, ``_step_generator``, ``_average_step``) are the
    identity here: a subclass whose ranks split the batch overrides them."""

    def __init__(self, model, dataset, criterion, mesh: Optional[Mesh] = None,
                 validate: bool = True, donate: bool = True):
        super().__init__(model, dataset, criterion, validate=validate, donate=donate)
        self.plan = ShardingPlan()
        self._mesh = mesh
        self._run_mesh: Optional[Mesh] = None
        self._specs: Dict[str, P] = {}  # sharded parameter paths -> spec
        self._whole_shapes: Dict[str, tuple] = {}  # their whole leaves' shapes
        self._slot_spec: Dict[str, P] = {}
        self.held_bytes: Dict[str, int] = {}
        self._place_span = True  # the batch placement is a "place_batch" seam

    def _resolve_mesh(self) -> Mesh:
        raise NotImplementedError

    def _prepare_plan(self, mesh: Mesh, n_rows: int) -> None:
        """Bind what the plan needs and set ``self.plan``."""
        raise NotImplementedError

    def _check_first_batch(self, first) -> None:
        super()._check_first_batch(first)
        self._run_mesh = self._resolve_mesh()

    # ------------------------------------------------------------ the layout
    def _data_shards(self) -> Optional[tuple]:
        """``(axis, size)`` of the batch's data axis for the health
        monitor's per-shard counts, or None."""
        return None

    def _bind_health(self, params) -> None:
        super()._bind_health(params)
        shards = self._data_shards() if self.health is not None else None
        if shards is not None:
            self.health.bind_mesh_axis(*shards)

    def _init_step_state(self, method, params):
        mesh = self._run_mesh
        self._prepare_plan(mesh, self._step_rows)
        self.plan.validate(params, mesh)
        items = tree_items(params)
        specs = {path: self.plan.spec_for(path, p) for path, p in items.items()}
        self._specs = {path: s for path, s in specs.items() if is_sharded(s)}
        self._whole_shapes = {path: tuple(items[path].shape) for path in self._specs}
        whole = unflatten_to_like({path: p.data for path, p in items.items()}, params)
        with torch.no_grad():
            for path, spec in self._specs.items():
                items[path].data = shard_leaf(items[path].data, spec, mesh)
        if self.validate:
            with span("sharded_param_audit"):
                self._audit_blocks(params, whole, specs)
        if self._restored_slots is not None:
            self._restored_slots = self._cut_restored(self._restored_slots)
        slots = self._init_slots(method, params)
        self._slot_spec = {p: s for p, s in _slot_specs(slots, self._specs).items()
                           if is_sharded(s)}
        self.held_bytes = {
            "params": sum(v.numel() * v.element_size() for v in items.values()),
            "slots": sum(v.numel() * v.element_size() for v in tree_items(slots).values()
                         if isinstance(v, torch.Tensor))}
        return slots

    def _audit_blocks(self, params, whole, specs) -> None:
        """``ShardedParamAudit`` on every rank's blocks; a rank whose audit
        fails raises its findings, and every other rank raises naming it
        (no rank goes on into a step its peers will not join)."""
        from ..analysis import ParamAuditError, ShardedParamAudit

        found = [f for f in ShardedParamAudit(params, aliasing_tree=whole, specs=specs,
                                              mesh=self._run_mesh).findings()
                 if f.severity == "error"]
        flags = _comm.all_gather_stack(torch.tensor([float(bool(found))]))
        if found:
            raise ParamAuditError("; ".join(f.message for f in found))
        bad = [r for r, v in enumerate(flags.reshape(-1).tolist()) if v]
        if bad:
            raise ParamAuditError(f"ShardedParamAudit failed on rank(s) {bad}: their blocks "
                                  "hold findings (see their errors)")

    def _cut_restored(self, flat: Dict[str, Any]) -> Dict[str, Any]:
        """A checkpoint's whole slot leaves cut to this rank's blocks."""
        mesh = self._run_mesh
        specs = _slot_specs(flat, self._specs)
        out = {}
        for path, v in flat.items():
            spec = specs[path]
            if is_sharded(spec) and getattr(v, "ndim", 0) >= len(spec):
                v = shard_leaf(torch.as_tensor(v), spec, mesh).numpy()
            out[path] = v
        return out

    def _gather_tree(self, tree, specs: Dict[str, P]):
        """``tree`` with each sharded leaf gathered whole (collective)."""
        items = tree_items(tree)
        out = {path: (gather_block(v, specs[path], self._run_mesh) if path in specs else v)
               for path, v in items.items()}
        return unflatten_to_like(out, tree)

    @contextlib.contextmanager
    def _whole_params(self):
        """The model's parameters whole for the block (validation,
        checkpoints), this rank's blocks again after it."""
        items = tree_items(self.model.get_parameters())
        kept = {}
        with torch.no_grad():
            for path, spec in self._specs.items():
                kept[path] = items[path].data
                items[path].data = gather_block(kept[path], spec, self._run_mesh)
        try:
            yield
        finally:
            for path, data in kept.items():
                items[path].data = data

    def _resume_from_checkpoint(self, require_finite: bool = False):
        """A checkpoint's whole leaves into the model: the blocks of the
        last mesh are dropped first (their values are the checkpoint's to
        set; the next ``_init_step_state`` cuts them for its mesh)."""
        items = tree_items(self.model.get_parameters())
        with torch.no_grad():
            for path, shape in self._whole_shapes.items():
                if path in self._specs:
                    p = items[path]
                    p.data = torch.empty(shape, dtype=p.dtype, device=p.device)
        self._specs = {}
        return super()._resume_from_checkpoint(require_finite)

    def _unshard(self) -> None:
        """Every rank's model whole again (the end of ``optimize``)."""
        items = tree_items(self.model.get_parameters())
        with torch.no_grad():
            for path, spec in self._specs.items():
                items[path].data = gather_block(items[path].data, spec, self._run_mesh)
        self._specs = {}

    # -------------------------------------------------------------- the step
    def _clip_grads(self, grads):
        if self._grad_clip_norm is None or not self._specs:
            return super()._clip_grads(grads)
        flat = tree_items(grads)
        leaves = dict(flat)
        if self._grad_clip_const is not None:
            lo, hi = self._grad_clip_const
            leaves = {p: torch.clamp(g, lo, hi) for p, g in leaves.items()}
        by_axes: Dict[tuple, torch.Tensor] = {}
        total = None
        for path, g in leaves.items():
            sq = torch.sum(g.float() * g.float())
            spec = self._specs.get(path)
            if spec is None:
                total = sq if total is None else total + sq
            else:
                axes = tuple(a for e in spec for a in spec_axes(e))
                by_axes[axes] = sq if axes not in by_axes else by_axes[axes] + sq
        for axes, sq in by_axes.items():
            sq = _comm.axis_psum_(sq.reshape(1), self._run_mesh, axes).reshape(())
            total = sq if total is None else total + sq
        scale = torch.clamp(self._grad_clip_norm / (torch.sqrt(total) + 1e-12), max=1.0)
        return unflatten_to_like({p: g * scale for p, g in leaves.items()}, grads)

    def _forward_params(self, params):
        """The parameters the forward reads."""
        return params

    def _average_grads(self, grads):
        return grads

    def _step_generator(self) -> torch.Generator:
        return RandomGenerator.generator()

    def _average_step(self, new_state, loss):
        return new_state, loss

    def _train_step(self, x, t, nvalid: Optional[float], lr: float, params,
                    slots) -> torch.Tensor:
        model, method = self.model, self.optim_method
        fwd = self._forward_params(params)
        gen = self._step_generator()
        if self._micro_batches == 1:
            loss, new_state = self._loss(model.get_state(), x, t, gen, nvalid, params=fwd)
            leaves = list(tree_items(fwd).values())
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            g = [torch.zeros_like(p) if gi is None else gi for p, gi in zip(leaves, g)]
        else:
            loss, new_state, g = self._micro_step(x, t, gen, nvalid, fwd)
        grads = unflatten_to_like(dict(zip(tree_items(params), g)), params)
        grads = self._clip_grads(self._average_grads(grads))
        old = self._health_old_params(params)
        method.update(grads, params, slots, lr, method.state["neval"])
        new_state, loss = self._average_step(detach_tree(new_state), loss.detach())
        if old is not None:
            self._step_health = self._mesh_health(grads, old, params, new_state, x, t)
        model.set_state(new_state)
        return loss

    def _mesh_health(self, grads, old, params, new_state, x, t) -> Dict[str, torch.Tensor]:
        """The step's health statistics over this rank's blocks, a sharded
        leaf's rows summed over its axes; the per-data-shard counts of the
        batch when a data axis is bound."""
        mesh = self._run_mesh

        def sum_rows(paths, mat):
            by_axes: Dict[tuple, list] = {}
            for i, path in enumerate(paths):
                spec = self._specs.get(path)
                if spec is not None:
                    axes = tuple(a for e in spec for a in spec_axes(e))
                    by_axes.setdefault(axes, []).append(i)
            for axes, rows in by_axes.items():
                idx = torch.tensor(rows, device=mat.device)
                mat[idx] = _comm.axis_psum_(mat[idx].contiguous(), mesh, axes)
            return mat

        old_tree = unflatten_to_like(dict(zip(tree_items(params), old)), params)
        out = self.health.mesh_tree_stats(grads, old_tree, params, new_state, sum_rows)
        shards = self._shard_counts(x, t)
        if shards is not None:
            out["shards"] = shards
        return out

    def _shard_counts(self, x, t) -> Optional[torch.Tensor]:
        """The batch's non-finite counts by data shard (None without a data
        axis)."""
        return None

    # ------------------------------------------------------------- the loop
    def _validate_now(self):
        with self._whole_params():
            return super()._validate_now()

    def _write_checkpoint(self, state, slots):
        """The blocks gathered on every rank; rank 0 writes the tree
        layout; the ranks wait for it."""
        whole_slots = self._gather_tree(slots, self._slot_spec)
        out = None
        with self._whole_params():
            if _comm.rank() == 0:
                from ..utils.serialization import save_checkpoint

                out = save_checkpoint(self.checkpoint_path, step=state["neval"],
                                      params=self.model.get_parameters(),
                                      optim_slots=whole_slots, optim_state=dict(state),
                                      model_state=self.model.get_state(),
                                      keep_last=self.checkpoint_keep_last)
        _comm.barrier()
        return out

    def optimize(self):
        model = super().optimize()
        self._unshard()
        return model


class HybridParallelOptimizer(_ShardedOptimizer):
    """Data x tensor parallel training over a mesh (see the module
    docstring)."""

    def __init__(self, model, dataset, criterion, plan: Optional[ShardingPlan] = None,
                 mesh: Optional[Mesh] = None, data_axis: str = "data", validate: bool = True,
                 donate: bool = True, flat_update: bool = False):
        if flat_update:
            raise ParallelCompositionError(
                "flat_update is incompatible with sharding plans: a flat master vector cannot "
                "carry per-leaf shardings (use DistriOptimizer parameter_sync='sharded' for "
                "the flat ZeRO-1 layout)")
        super().__init__(model, dataset, criterion, mesh=mesh, validate=validate, donate=donate)
        self.plan = plan or ShardingPlan()
        self.data_axis = data_axis

    def _supports_elastic(self) -> bool:
        return True

    def _base_mesh(self) -> Mesh:
        base = self._mesh
        if base is None:
            base = Engine.mesh()
            if self.data_axis not in base.axis_names:
                raise ValueError(
                    f"Engine mesh axes {base.axis_names} lack data axis {self.data_axis!r}; "
                    "pass mesh= explicitly")
        return base

    def _resolve_mesh(self) -> Mesh:
        """The base mesh, or under elastic its view over the active ranks:
        only the leading data axis shrinks (one mesh a membership, cached)."""
        base = self._base_mesh()
        el = self._elastic
        if el is not None:
            return el.hybrid_mesh(base, self.data_axis)
        return base

    def _remesh_groups(self, members) -> None:
        self._elastic.hybrid_mesh(self._base_mesh(), self.data_axis, members)

    def _data_shards(self) -> Optional[tuple]:
        return self.data_axis, self._data_size()

    def _shard_counts(self, x, t) -> Optional[torch.Tensor]:
        mesh, n = self._run_mesh, self._data_size()
        counts = self.health.mesh_shard_stats(x, t, n, mesh.coords.get(self.data_axis, 0))
        if n == 1:
            return counts
        return _comm.axis_psum_(counts, mesh, (self.data_axis,))
    def _prepare_plan(self, mesh: Mesh, n_rows: int) -> None:
        pass  # the plan is the caller's

    def _data_size(self) -> int:
        mesh = self._run_mesh
        return mesh.shape[self.data_axis] if self.data_axis in mesh.shape else 1

    # ------------------------------------------------------------- the rows
    def _check_first_batch(self, first) -> None:
        super()._check_first_batch(first)
        n_data, n_micro, b = self._data_size(), self._micro_batches, first.size()
        if b % n_data:
            raise ValueError(f"global batch {b} not divisible by data axis {n_data}")
        if n_micro > 1:
            if b % n_micro:
                raise ValueError(f"batch size {b} not divisible by micro batch count {n_micro}")
            if (b // n_micro) % n_data:
                raise ValueError(
                    f"a micro-batch's {b // n_micro} rows (batch {b} / {n_micro} micro-batches) "
                    f"do not divide over data axis {n_data}; size the batch to micro-batches x "
                    "data axis")

    def _local_rows(self, batch):
        """This rank's rows of a global batch: its data row's contiguous
        share, or under micro-batches its share of each micro-batch, micro
        by micro."""
        n = self._data_size()
        if n == 1:
            return batch
        d, n_micro = self._run_mesh.coords[self.data_axis], self._micro_batches
        if n_micro == 1:
            k = batch.size() // n
            return batch.slice(d * k, k)
        check_micro_split(batch.get_input(), batch.get_target(), n_micro)
        mb = batch.size() // n_micro
        k = mb // n
        return batch.take(np.concatenate([np.arange(i * mb + d * k, i * mb + (d + 1) * k)
                                          for i in range(n_micro)]))

    def _global_rows(self, rows: int) -> int:
        return rows * self._data_size()

    # -------------------------------------------------------------- the step
    def _forward_params(self, params):
        """The parameters the forward reads: each sharded leaf gathered whole
        along its axes, once a step, as a leaf of its own (its gradient
        comes out whole; :meth:`_average_grads` takes it to the block)."""
        if not self._specs:
            return params
        items = tree_items(params)
        with torch.no_grad():
            for path, spec in self._specs.items():
                whole = gather_block(items[path], spec, self._run_mesh)
                items[path] = whole.detach().requires_grad_(True)
        return unflatten_to_like(items, params)

    def _masked_loss(self, y, t, nvalid: float) -> torch.Tensor:
        if self._data_size() == 1:
            return super()._masked_loss(y, t, nvalid)
        pair = self.criterion.unreduced(y, t)
        if pair is None:
            raise TypeError(f"{type(self.criterion).__name__}.unreduced() returned None although "
                            "supports_unreduced() claimed a row-wise form")
        per, denom = pair
        b = y.shape[0]
        first = self._run_mesh.coords[self.data_axis] * b  # this rank's rows in the batch
        row = ((torch.arange(b, device=per.device) + first) < nvalid).to(per.dtype)
        if per.dim() == 1 and per.shape[0] != b and per.shape[0] % b == 0:
            mask = row.repeat_interleave(per.shape[0] // b)
        else:
            mask = row.reshape((b,) + (1,) * (per.dim() - 1))
        num = torch.sum(per * mask) * self._data_size()
        if getattr(self.criterion, "size_average", True):
            den = torch.sum(denom * mask).detach().reshape(1).float()
            den = _comm.axis_psum_(den, self._run_mesh, (self.data_axis,)).reshape(())
            return num / torch.clamp(den.to(num.dtype), min=1e-8)
        return num

    def _average_grads(self, grads):
        """The whole gradients (the forward read whole leaves) as this
        rank's blocks of the batch's mean gradient, in one all-reduce over
        the data axis: a leaf sharded over model axes only is cut to its
        block first; a leaf sharded over the data axis is summed whole and
        then cut (sum, then block: the transpose of its gather over that
        axis); every leaf is divided by the data axis size once."""
        mesh, n = self._run_mesh, self._data_size()
        items = tree_items(grads)
        on_data = {}
        for path, spec in self._specs.items():
            if n > 1 and self.data_axis in {a for e in spec for a in spec_axes(e)}:
                on_data[path] = spec
            else:
                items[path] = shard_leaf(items[path], spec, mesh)
        if n == 1:
            return unflatten_to_like(items, grads)
        buf = torch.cat([g.reshape(-1).float() for g in items.values()])
        _comm.axis_pmean_(buf, mesh, (self.data_axis,))
        out, off = {}, 0
        for path, g in items.items():
            v = buf[off:off + g.numel()].view(g.shape).to(g.dtype)
            off += g.numel()
            out[path] = shard_leaf(v, on_data[path], mesh) if path in on_data else v
        return unflatten_to_like(out, grads)

    def _step_generator(self) -> torch.Generator:
        return rank_generator(RandomGenerator.generator(),
                              self._run_mesh.coords.get(self.data_axis, 0), self._data_size())

    def _average_step(self, new_state, loss):
        if self._data_size() == 1:
            return new_state, loss
        return average_state(new_state, loss, self._run_mesh, (self.data_axis,))
