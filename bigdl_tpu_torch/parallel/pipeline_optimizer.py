"""Pipeline and expert parallel training (counterpart of
``bigdl_tpu/parallel/pipeline_optimizer.py``).

Both optimizers extend the sharded-leaf chassis of
:mod:`~bigdl_tpu_torch.parallel.hybrid` (``_ShardedOptimizer``): every rank
reads the whole batch and runs the same program, as the JAX package's one
jitted step does; the stacked leaves of the parallel modules (a
``PipelinedBlocks`` stack's ``stages``, an ``MoE`` 's expert FFN) are cut
over their mesh axis, so each rank holds only its stage's or expert's
block of them and of their slots, and the modules run their schedule on
those blocks (``pipeline_local``, ``moe_ffn(local_experts=True)``), which
they tell from the whole stack by the leaf's leading dim (1, not S or E). The
gradients leave the modules' backward already whole for what a rank holds
(the stacked blocks' summed over the data rows, the replicated leaves
computed alike on every rank), so the update needs no collective. The
drive loop (a padded ragged tail with its masked loss, checkpoints in the
tree layout read by any mesh) is the chassis'; validation runs every
batch whole on every rank, on the whole parameters.

Composition: ``data_axis`` cuts the batch over a second mesh axis inside
the parallel module (each data row runs its own pipeline, or its own
expert group); the layers around it run on the whole batch on every rank.
``flat_update`` and ``comms_dtype`` are refused with
:class:`~bigdl_tpu_torch.parallel.hybrid.ParallelCompositionError`;
``set_micro_batches`` raises, as in the JAX package. ``set_health`` and
``donate=False`` are the chassis' (a stacked leaf's rows summed over its
axis; with ``data_axis`` the per-data-shard counts of the whole batch every
rank reads). The pipeline stamps its schedule's idle fraction,
``(S-1)/(n_micro+S-1)``, on every ``step`` and ``perf`` record as
``pipe_bubble_frac``.
"""

from __future__ import annotations

import re
from typing import Optional

from ..utils.engine import Engine
from .hybrid import ParallelCompositionError, _ShardedOptimizer
from .sharding import P, ShardingPlan


class _StackedParallelOptimizer(_ShardedOptimizer):
    """The chassis of the stacked-parameter parallelisms (pp/ep):
    subclasses name the axis, bind their modules, check the batch against
    the schedule's grid and give the rules that cut the stacked leaves."""

    _kind = "stacked-parallel"

    def __init__(self, model, dataset, criterion, mesh=None, axis="",
                 data_axis: Optional[str] = None, validate: bool = True, donate: bool = True,
                 flat_update: bool = False, comms_dtype: Optional[str] = None):
        if flat_update:
            raise ParallelCompositionError(
                f"flat_update is incompatible with {self._kind} training: the stacked leaves "
                f"are cut over P({axis!r}) and one replicated flat master vector cannot "
                "represent them (only a fully-replicated tree could compose, which would "
                "disable the parallelism). Use the tree-path update here, or DistriOptimizer "
                "parameter_sync='sharded' for the flat ZeRO-1 layout.")
        if comms_dtype is not None:
            raise ParallelCompositionError(
                f"comms_dtype={comms_dtype!r} is incompatible with {self._kind} training: "
                "compressed gradient collectives ride the flat codec (GradCompressor over a "
                f"FlatParameter), which cannot carry the stacked P({axis!r}) leaf layout. "
                "Gradient reduction over the data axis runs at full precision on this path.")
        super().__init__(model, dataset, criterion, mesh=mesh, validate=validate, donate=donate)
        self.axis = axis
        self.data_axis = data_axis  # None: no dp composition

    # ------------------------------------------------------- subclass hooks
    def _bind_modules(self, mesh):
        """The parallel modules of the built model, bound to ``mesh``;
        raises when there is none."""
        raise NotImplementedError

    def _check_batch(self, mesh, n_rows: int) -> None:
        raise NotImplementedError

    def _stacked_rules(self, modules):
        raise NotImplementedError

    # ------------------------------------------------------------- plumbing
    def set_micro_batches(self, n: int):
        raise NotImplementedError(
            f"gradient-accumulation micro batches are not supported on the {self._kind} path "
            "(and would be confused with the GPipe schedule's n_micro); size the global batch "
            "to the mesh instead")

    def _resolve_mesh(self):
        mesh = self._mesh if self._mesh is not None else Engine.mesh()
        if self.axis not in mesh.shape:
            raise ValueError(
                f"{type(self).__name__} needs a mesh carrying the {self.axis!r} axis (have "
                f"{tuple(mesh.shape)}); pass mesh=make_mesh({{'{self.axis}': S}}) or include "
                f"a {self.axis!r} axis in the mesh")
        if self.data_axis is not None and self.data_axis not in mesh.shape:
            raise ValueError(f"data_axis {self.data_axis!r} not in mesh axes {tuple(mesh.shape)}")
        return mesh

    def _data_shards(self):
        if self.data_axis is None:
            return None
        return self.data_axis, self._run_mesh.shape[self.data_axis]

    def _shard_counts(self, x, t):
        if self.data_axis is None:
            return None
        return self.health.mesh_shard_stats(x, t, self._run_mesh.shape[self.data_axis])

    def _prepare_plan(self, mesh, n_rows: int) -> None:
        modules = self._bind_modules(mesh)
        self._check_batch(mesh, n_rows)
        self.plan = ShardingPlan(self._stacked_rules(modules))

    def _validate_now(self):
        """The replicated program's validation: every rank over every batch
        whole, on the whole parameters."""
        from ..optim.local_optimizer import validate_whole

        with self._whole_params():
            return validate_whole(self.model, self.model.get_parameters(),
                                  self.model.get_state(), self.validation_dataset,
                                  self.validation_methods)


class PipelineOptimizer(_StackedParallelOptimizer):
    """GPipe pipeline-parallel training over a ``pipe`` mesh axis: every
    ``PipelinedBlocks`` of the model is bound to the mesh (``n_stages``
    equal to the axis size), its stacked leaves cut so that each rank holds
    its stage; ``data_axis`` composes dp x pp; ``n_micro`` overrides every
    stack's microbatch count."""

    _kind = "pipeline-parallel"

    def __init__(self, model, dataset, criterion, mesh=None, pipe_axis: str = "pipe",
                 data_axis: Optional[str] = None, n_micro: Optional[int] = None,
                 validate: bool = True, donate: bool = True, flat_update: bool = False,
                 comms_dtype: Optional[str] = None):
        super().__init__(model, dataset, criterion, mesh=mesh, axis=pipe_axis,
                         data_axis=data_axis, validate=validate, donate=donate,
                         flat_update=flat_update, comms_dtype=comms_dtype)
        if n_micro is not None and n_micro < 1:
            raise ValueError(f"n_micro must be >= 1, got {n_micro}")
        self.n_micro = n_micro

    def _bind_modules(self, mesh):
        from ..nn.pipelined import PipelinedBlocks

        mods = [m for m in self.model.walk() if isinstance(m, PipelinedBlocks)]
        if not mods:
            raise ValueError(
                "PipelineOptimizer: the model carries no PipelinedBlocks — wrap the repeated "
                "stage in nn.PipelinedBlocks(stage, n_stages) (head/tail layers stay outside "
                "the stack)")
        s = mesh.shape[self.axis]
        for m in mods:
            if m.n_stages != s:
                raise ValueError(f"{m.name()}: n_stages={m.n_stages} != {self.axis!r} mesh "
                                 f"axis size {s} — size the stack to the mesh")
            if self.n_micro is not None:
                m.n_micro = self.n_micro
            m.pipeline_parallel = True
            m.mesh_axis = self.axis
            m.batch_axis = self.data_axis
            m.set_mesh(mesh)
        if self._perf is not None:  # one schedule for every stack
            self._perf.note_pipeline_schedule(s, self.n_micro or mods[0].n_micro or s)
        return mods

    def _check_batch(self, mesh, n_rows: int) -> None:
        s = mesh.shape[self.axis]
        dp = mesh.shape[self.data_axis] if self.data_axis is not None else 1
        if n_rows % dp:
            raise ValueError(f"global batch {n_rows} not divisible by data axis "
                             f"{self.data_axis!r} size {dp}")
        n_micro = self.n_micro or s
        if (n_rows // dp) % n_micro:
            raise ValueError(
                f"per-data-shard batch {n_rows // dp} not divisible by n_micro {n_micro} — "
                f"the GPipe grid needs batch = data({dp}) x n_micro({n_micro}) x microbatch "
                "rows")

    def _stacked_rules(self, modules):
        # each stack's leaves live under "<module name>/stages/..."; their
        # leading dim S is cut over the pipe axis, the rest is replicated
        return [(re.escape(m.name()) + r"/stages/", P(self.axis)) for m in modules]


class ExpertParallelOptimizer(_StackedParallelOptimizer):
    """Switch/GShard expert-parallel training over an ``expert`` mesh axis:
    every ``MoE`` of the model is bound to the mesh (``n_experts`` equal to
    the axis size), its expert-stacked FFN leaves cut so that each rank
    holds one expert, the router replicated; ``data_axis`` composes dp x ep
    (the tokens cut over both axes). Pad rows of a ragged batch are masked
    out of the loss but still route: budget ``capacity_factor`` headroom."""

    _kind = "expert-parallel"

    def __init__(self, model, dataset, criterion, mesh=None, expert_axis: str = "expert",
                 data_axis: Optional[str] = None, validate: bool = True, donate: bool = True,
                 flat_update: bool = False, comms_dtype: Optional[str] = None):
        super().__init__(model, dataset, criterion, mesh=mesh, axis=expert_axis,
                         data_axis=data_axis, validate=validate, donate=donate,
                         flat_update=flat_update, comms_dtype=comms_dtype)

    def _bind_modules(self, mesh):
        from ..nn.moe import MoE

        mods = [m for m in self.model.walk() if isinstance(m, MoE)]
        if not mods:
            raise ValueError("ExpertParallelOptimizer: the model carries no nn.MoE — add an "
                             "MoE FFN (or use a data-parallel optimizer)")
        e = mesh.shape[self.axis]
        for m in mods:
            if m.n_experts != e:
                raise ValueError(f"{m.name()}: n_experts={m.n_experts} != {self.axis!r} mesh "
                                 f"axis size {e} — size the layer to the mesh")
            m.expert_parallel = True
            m.mesh_axis = self.axis
            m.batch_axis = self.data_axis
            m.set_mesh(mesh)
        return mods

    def _check_batch(self, mesh, n_rows: int) -> None:
        e = mesh.shape[self.axis]
        dp = mesh.shape[self.data_axis] if self.data_axis is not None else 1
        if n_rows % (dp * e):
            raise ValueError(f"global batch {n_rows} not divisible by data({dp}) x "
                             f"experts({e}) = {dp * e} — the token shards must tile the mesh")

    def _stacked_rules(self, modules):
        # the expert-stacked FFN leaves (leading dim E) are cut over the
        # expert axis; the router and every other layer stay replicated
        return [(re.escape(m.name()) + r"/(w1|b1|w2|b2)$", P(self.axis)) for m in modules]
