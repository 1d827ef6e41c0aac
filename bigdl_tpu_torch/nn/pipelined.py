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

The GPipe schedule over a device mesh (``pipeline_parallel=True`` with a
mesh) is not ported yet: without a mesh the stack runs sequentially, as the
JAX package does, and ``set_mesh`` raises.
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

    def set_mesh(self, mesh) -> "PipelinedBlocks":
        raise NotImplementedError(
            "PipelinedBlocks.set_mesh: the GPipe schedule over a device mesh is not ported "
            "yet (ROADMAP Queue 1, parallel/pipeline*.py); without a mesh the stack runs "
            "its stages sequentially")

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

        def run(i, h):
            gen = None if seed is None else torch.Generator().manual_seed(seed)
            p = _map_tree(lambda t: t[i], stacked)
            return self._runner._apply_params(p, self._stage_state, h, training, gen)[0]

        remat = self.remat_stages and torch.is_grad_enabled()
        if remat:
            import_torch_dynamo()  # checkpoint's first call imports it: not in this stack
        for i in range(self.n_stages):
            x = checkpoint(run, i, x, use_reentrant=False) if remat else run(i, x)
        return x, state


def _spec(x) -> str:
    if isinstance(x, torch.Tensor):
        return f"{tuple(x.shape)} {x.dtype}"
    return type(x).__name__
