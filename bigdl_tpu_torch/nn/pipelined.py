"""``PipelinedBlocks`` (counterpart of ``bigdl_tpu/nn/pipelined.py``): S
independently initialised copies of one stage module applied in turn,
``x -> stage^S(x)``, on the JAX package's sequential path.

Parameters are stage-stacked, as in the JAX package: the tree is
``{"stages": stage_tree}`` whose every leaf has a leading dim of S (the
JAX ``lax.scan`` layout), so ``PipelinedBlocks_1/stages/FeedForwardNetwork_1/
filter_w`` is one (S, 2048, 512) parameter. Each stage runs on its slice of
the stacked tensors, so autograd accumulates every stage's gradient into
that one parameter and an optimizer sees one tensor per leaf.

The stage must be stateless and map its input to the same shape and dtype
(build raises otherwise). Every stage is handed the same random stream, as
the JAX package hands every stage the same key: one seed is drawn from
``rng`` per call and each stage draws from a fresh generator on that seed.
``remat_stages`` checkpoints each stage call
(``torch.utils.checkpoint``, non-reentrant): the backward recomputes the
stage's activations; outputs and gradients keep their bits.

The GPipe schedule (``pipeline_parallel=True`` with a mesh carrying
``mesh_axis``, from ``set_mesh`` or ``Engine.mesh()``) runs the stack as
:func:`bigdl_tpu_torch.parallel.pipeline.pipeline_apply` over the ranks of
that axis, one stage a rank, ``batch_axis`` cutting the batch over a second
axis. Under ``PipelineOptimizer`` each rank holds only its stage's block
of every stacked leaf (a leading dim of 1, not S) and runs the
schedule on it (its training batches fill the grid: the optimizer checks
them; its validation runs on the whole stacks). A batch that cannot fill
the microbatch grid (an inference row, a ragged tail) takes the sequential
path, as in the JAX package.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .module import AbstractModule, _map_tree, _register_tree, _to_device, import_torch_dynamo


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _stack(trees):
    """One tree whose leaves stack the trees' leaves along a new dim 0."""
    first = trees[0]
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k].detach() for t in trees]))
            for k, v in first.items()}


class PipelinedBlocks(AbstractModule):
    """``x -> stage^S(x)`` over S stage-stacked parameter sets (see the
    module docstring)."""

    def __init__(self, stage: AbstractModule, n_stages: int, n_micro: Optional[int] = None,
                 pipeline_parallel: bool = False, mesh_axis: str = "pipe",
                 batch_axis: Optional[str] = None, remat_stages: bool = False, device=None):
        super().__init__(device)
        if not isinstance(stage, AbstractModule):
            raise TypeError(f"stage must be a module, got {type(stage)}")
        if n_stages < 2:
            raise ValueError(f"n_stages must be >= 2, got {n_stages}")
        # the template is no registered child: its parameters are not the
        # stack's, which live under "stages"
        object.__setattr__(self, "stage", stage)
        self.n_stages = n_stages
        self.n_micro = n_micro
        self.pipeline_parallel = pipeline_parallel
        self.mesh_axis = mesh_axis
        self.batch_axis = batch_axis
        self.remat_stages = remat_stages
        self._stage_state = None
        self._mesh = None  # runtime state, never serialized

    def set_mesh(self, mesh) -> "PipelinedBlocks":
        """The mesh of the pipeline path (runtime state, not serialized)."""
        self._mesh = mesh
        return self

    def infer_shape(self, in_spec):
        """The stage's contract (the unbuilt template on meta tensors), which
        must keep the spec."""
        from .module import infer_module_shape

        out = infer_module_shape(self.stage, in_spec)
        if not (isinstance(out, torch.Tensor) and out.shape == in_spec.shape
                and out.dtype == in_spec.dtype):
            raise ValueError(f"{self.name()}: stage maps {_spec(in_spec)} -> {_spec(out)}; the "
                             "pipelined stack needs a shape-preserving stage (put reshaping "
                             "head/tail layers outside)")
        return out

    def _fits_grid(self, mesh, batch: int) -> bool:
        """Does this batch fill the dp x microbatch grid?"""
        n_micro = self.n_micro or mesh.shape[self.mesh_axis]
        if self.batch_axis is not None and self.batch_axis in mesh.shape:
            dp = mesh.shape[self.batch_axis]
            return batch % dp == 0 and (batch // dp) % n_micro == 0
        return batch % n_micro == 0

    def _resolve_mesh(self):
        if self._mesh is not None:
            return self._mesh
        from ..utils.engine import Engine

        mesh = Engine.mesh()
        return mesh if self.mesh_axis in mesh.shape else None

    def build(self, generator: torch.Generator, sample) -> None:
        """Build S copies of the template from ``sample`` (independent
        initialisations from ``generator``) and stack their parameters."""
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        if self.stage.is_built():
            raise ValueError(f"{self.name()}: the stage template must be unbuilt; each of the "
                             f"{self.n_stages} stages is built from it")
        per_stage = []
        with torch.no_grad():
            for _ in range(self.n_stages):
                m = copy.deepcopy(self.stage)
                m.build(generator, sample)
                out = m._apply_params(m.get_parameters(), m.get_state(), sample, False, None)[0]
                if any(True for _ in _leaves(m.get_state())):
                    raise ValueError(
                        f"{self.name()}: stage carries mutable state (running statistics) "
                        "- pipelined stages must be stateless")
                if not (isinstance(out, torch.Tensor) and isinstance(sample, torch.Tensor)
                        and out.shape == sample.shape and out.dtype == sample.dtype):
                    raise ValueError(
                        f"{self.name()}: stage maps {_spec(sample)} -> {_spec(out)}; the "
                        "pipelined stack needs a shape-preserving stage (put reshaping "
                        "head/tail layers outside)")
                per_stage.append(m.get_parameters())
        # the last copy runs every stage, on each stage's slice of the stack
        object.__setattr__(self, "_runner", m)
        self._stage_state = m.get_state()
        self._param_tree = _register_tree(
            self, _to_device({"stages": _stack(per_stage)}, self.device))
        self._state = {}
        self._built = True

    def _apply_params(self, params, state, x, training, rng):
        stacked = params["stages"]
        seed = None if rng is None else int(torch.randint(0, 2 ** 62, (1,), generator=rng))

        def stage_fn(p, h):
            gen = None if seed is None else torch.Generator().manual_seed(seed)
            return self._runner._apply_params(p, self._stage_state, h, training, gen)[0]

        # shape inference runs the stack on meta tensors: sequentially
        on_mesh = self.pipeline_parallel and x.device.type != "meta"
        mesh = self._resolve_mesh() if on_mesh else None
        if mesh is not None and self._fits_grid(mesh, x.shape[0]):
            from ..parallel.pipeline import pipeline_apply, pipeline_local

            remat = self.remat_stages and torch.is_grad_enabled()
            kw = dict(axis=self.mesh_axis, n_micro=self.n_micro, batch_axis=self.batch_axis,
                      remat_stages=remat)
            if _leading_dim(stacked) == 1:  # this rank's stage alone (PipelineOptimizer)
                return pipeline_local(stage_fn, _map_tree(lambda t: t[0], stacked), x, mesh,
                                      **kw), state
            return pipeline_apply(stage_fn, stacked, x, mesh, **kw), state

        def run(i, h):
            return stage_fn(_map_tree(lambda t: t[i], stacked), h)

        remat = self.remat_stages and torch.is_grad_enabled()
        if remat:
            import_torch_dynamo()  # checkpoint's first call imports it: not in this stack
        for i in range(self.n_stages):
            x = checkpoint(run, i, x, use_reentrant=False) if remat else run(i, x)
        return x, state


def _leading_dim(tree) -> int:
    return next(iter(_leaves(tree))).shape[0]


def _spec(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"{tuple(x.shape)} {x.dtype}"
    return type(x).__name__
