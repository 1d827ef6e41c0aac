"""Pipeline parallelism: the GPipe microbatch schedule over a ``pipe`` mesh
axis (counterpart of ``bigdl_tpu/parallel/pipeline.py``).

One process a rank; rank s along ``pipe`` runs stage s. The batch (the
same on every rank, or this rank's data block of it under ``batch_axis``)
is cut into ``n_micro`` microbatches; the schedule has
``T = n_micro + S - 1`` ticks, and at tick t stage s works on microbatch
``t - s``: stage 0 reads it from the batch, a later stage from what the
stage before sent at tick t - 1 (:func:`~bigdl_tpu_torch.parallel._comm.
ppermute`, one hop ``s -> s + 1``). The last stage banks each finished
microbatch and its outputs are broadcast to the other stages, so every
rank returns the whole (B, ...) result, as the JAX package's masked
``psum`` of them gives.

The schedule and its reverse are one autograd ``Function``: the forward
keeps each microbatch's stage graph (or, with ``remat_stages``, only its
input, and the backward runs the stage again), and the backward walks the
ticks in reverse, hopping each input gradient one stage back. This makes
every rank take part in the same hops in the same order, which autograd's
own traversal would not promise, since stage 0 reads no hop. The
transposes at the boundaries are the JAX package's: the gradient of the
whole input ``x`` (a ``P()`` input, or ``P(batch_axis)``) is stage 0's,
given to every stage (a sum over the axis in which the other terms are
zeros) and gathered over the data rows; the stage parameters' gradients
are summed over the data rows; the output's gradient is taken as the
last stage holds it (the ``psum`` 's transpose after the division by the
axis size that ``shard_map`` puts on a replicated output).

Deliberate differences from the JAX package: bubble ticks compute nothing
(the JAX package runs them on ones and masks them out; outputs and
gradients are the same), and a hop carries only what a stage will read
(the wrap-around ``S-1 -> 0`` of the JAX ring, which stage 0 discards, is
not sent).

``pipeline_apply`` takes the stage-stacked parameters whole (leading dim
S, cut to this rank's stage; their gradients are gathered back);
``pipeline_apply_hetero`` per-stage parameter trees and activation
shapes (each rank runs its own stage's function on its own tree; the
trees' gradients are gathered as one padded flat vector a stage).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

from ..utils.serialization import tree_items, unflatten_to_like
from . import _comm


def _leaves_of(tree):
    items = tree_items(tree)
    return list(items), list(items.values())


class _Schedule:
    """One call's static schedule on this rank."""

    def __init__(self, run, mesh, axis: str, n_micro: int, batch_axis: Optional[str],
                 remat: bool, in_specs, n_out_rows: int):
        self.run = run  # (leaf aliases, h) -> h of this rank's stage
        self.mesh, self.axis, self.batch_axis = mesh, axis, batch_axis
        self.line = mesh.line((axis,))
        self.s, self.n_stages = self.line.index, self.line.size
        self.n_micro, self.remat = n_micro, remat
        self.in_specs = in_specs  # (shape, dtype) of each stage's microbatch input, and the last output
        self.n_out_rows = n_out_rows

    def valid(self, t: int, stage: int) -> bool:
        return 0 <= t - stage < self.n_micro

    def like(self, stage: int, device) -> torch.Tensor:
        shape, dtype = self.in_specs[stage]
        return torch.empty(shape, dtype=dtype, device=device)


def _run_stage(sched, aliases, h_in):
    with torch.enable_grad():
        return sched.run(aliases, h_in)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, x, *leaves):
        s, n_stages, m = sched.s, sched.n_stages, sched.n_micro
        mesh, axis = sched.mesh, sched.axis
        x_loc = _comm.axis_block(x, mesh, (sched.batch_axis,), 0) if sched.batch_axis else x
        micro = x_loc.reshape((m, x_loc.shape[0] // m) + tuple(x_loc.shape[1:]))
        aliases = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        want_dx = x.requires_grad and x.is_floating_point()
        saved, outs, recv = {}, [], None
        ticks = m + n_stages - 1
        for t in range(ticks):
            h_out = None
            if sched.valid(t, s):
                mb = t - s
                h_in = (micro[mb] if s == 0 else recv).detach()
                h_in.requires_grad_(s > 0 or want_dx)
                if sched.remat:
                    with torch.no_grad():
                        h_out = sched.run(aliases, h_in)
                    saved[mb] = (h_in, None)
                else:
                    h_out = _run_stage(sched, aliases, h_in)
                    saved[mb] = (h_in, h_out)
                if s == n_stages - 1:
                    outs.append(h_out.detach())
            pairs = [(i, i + 1) for i in range(n_stages - 1) if sched.valid(t, i)]
            if pairs and t < ticks - 1:
                send = h_out.detach() if (s, s + 1) in pairs else None
                recv = _comm.ppermute(send, mesh, axis, pairs,
                                      recv_like=sched.like(max(s, 1), x.device))
        if s == n_stages - 1:
            out = torch.cat(outs, 0)
        else:
            shape, dtype = sched.in_specs[n_stages]
            out = torch.empty((sched.n_out_rows,) + tuple(shape[1:]), dtype=dtype,
                              device=x.device)
        _comm.axis_broadcast_(out, mesh, axis, n_stages - 1)
        ctx.sched, ctx.saved, ctx.aliases, ctx.want_dx = sched, saved, aliases, want_dx
        ctx.x_meta = (x_loc.shape, x.dtype, x.device)
        if sched.batch_axis:
            out = _comm.axis_all_gather(out, mesh, (sched.batch_axis,), 0)
        return out

    @staticmethod
    def backward(ctx, g_out):
        sched, saved, aliases = ctx.sched, ctx.saved, ctx.aliases
        s, n_stages, m = sched.s, sched.n_stages, sched.n_micro
        mesh, axis = sched.mesh, sched.axis
        x_loc_shape, x_dtype, dev = ctx.x_meta
        if sched.batch_axis:
            g_out = _comm.axis_block(g_out, mesh, (sched.batch_axis,), 0)
        g_micro = g_out.reshape((m, g_out.shape[0] // m) + tuple(g_out.shape[1:]))
        trainable = [a for a in aliases if a.requires_grad]
        acc: List[Optional[torch.Tensor]] = [None] * len(trainable)
        dx, g_recv = [None] * m, None
        for t in reversed(range(m + n_stages - 1)):
            g_in = None
            if sched.valid(t, s):
                mb = t - s
                g_h = g_micro[mb] if s == n_stages - 1 else g_recv
                h_in, h_out = saved.pop(mb)
                if h_out is None:  # remat: the stage again, from its input
                    h_out = _run_stage(sched, aliases, h_in)
                inputs = ([h_in] if h_in.requires_grad else []) + trainable
                grads = torch.autograd.grad(h_out, inputs, g_h.to(h_out.dtype), allow_unused=True)
                if h_in.requires_grad:
                    g_in, grads = grads[0], grads[1:]
                for i, g in enumerate(grads):
                    if g is not None:
                        acc[i] = g if acc[i] is None else acc[i] + g
                if s == 0:
                    dx[mb] = g_in
            pairs = [(i, i - 1) for i in range(1, n_stages) if sched.valid(t, i)]
            if pairs and t > 0:
                send = g_in if (s, s - 1) in pairs else None
                g_recv = _comm.ppermute(send, mesh, axis, pairs, recv_like=sched.like(s + 1, dev))
        g_x = None
        if ctx.want_dx:
            if s == 0:
                g_x = torch.cat(dx, 0).reshape(x_loc_shape).to(x_dtype)
            else:
                g_x = torch.empty(x_loc_shape, dtype=x_dtype, device=dev)
            _comm.axis_broadcast_(g_x, mesh, axis, 0)
            if sched.batch_axis:
                g_x = _comm.axis_all_gather(g_x, mesh, (sched.batch_axis,), 0)
        out_grads = []
        it = iter(acc)
        for a in aliases:
            if not a.requires_grad:
                out_grads.append(None)
                continue
            g = next(it)
            g = torch.zeros_like(a) if g is None else g
            if sched.batch_axis:
                g = _comm.axis_psum_(g.contiguous(), mesh, (sched.batch_axis,))
            out_grads.append(g)
        return (None, g_x, *out_grads)


def _check_batch_axis(mesh, axis, batch_axis, n_rows):
    if batch_axis == axis:
        raise ValueError(
            f"batch_axis must differ from the pipeline axis {axis!r}: sharding the batch over "
            "the stage axis would feed each stage only its own shard (silently wrong output)")
    if batch_axis not in mesh.shape:
        raise ValueError(f"batch_axis {batch_axis!r} not in mesh axes {tuple(mesh.shape)}")
    dp = mesh.shape[batch_axis]
    if n_rows % dp:
        raise ValueError(f"batch {n_rows} not divisible by {batch_axis!r} mesh axis size {dp}")
    return n_rows // dp


def _grid(mesh, axis: str, n_micro: Optional[int], batch_axis: Optional[str], n_rows: int):
    """The JAX package's checks of the microbatch grid; returns
    ``(n_micro, per-shard rows)``."""
    if n_micro is None:
        n_micro = mesh.shape[axis]
    b_local = n_rows
    if batch_axis is not None:
        b_local = _check_batch_axis(mesh, axis, batch_axis, n_rows)
    if b_local % n_micro:
        raise ValueError(f"per-shard batch {b_local} not divisible by n_micro {n_micro}")
    return n_micro, b_local


def pipeline_local(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], local_params,
                   x: torch.Tensor, mesh, axis: str = "pipe", n_micro: Optional[int] = None,
                   batch_axis: Optional[str] = None,
                   remat_stages: bool = False) -> torch.Tensor:
    """The GPipe schedule over this rank's own stage parameters (the tree
    of one stage, unstacked): what ``pipeline_apply`` runs once it has cut
    the rank's stage out of the stack, and what ``nn.PipelinedBlocks``
    runs under ``PipelineOptimizer``, where each rank holds only its
    stage. Checks and arguments as :func:`pipeline_apply`."""
    s_stages = mesh.shape[axis]
    n_micro, b_local = _grid(mesh, axis, n_micro, batch_axis, x.shape[0])
    paths, leaves = _leaves_of(local_params)

    def run(aliases, h):
        return stage_fn(unflatten_to_like(dict(zip(paths, aliases)), local_params), h)

    mb_shape = (b_local // n_micro,) + tuple(x.shape[1:])
    specs = [(mb_shape, x.dtype)] * (s_stages + 1)
    sched = _Schedule(run, mesh, axis, n_micro, batch_axis, remat_stages, specs, b_local)
    return _GPipe.apply(sched, x, *leaves)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params,
                   x: torch.Tensor, mesh, axis: str = "pipe", n_micro: Optional[int] = None,
                   batch_axis: Optional[str] = None, remat_stages: bool = False) -> torch.Tensor:
    """Run ``x`` through S stages of ``stage_fn`` on the GPipe schedule.

    ``stage_fn(params_one_stage, h) -> h`` keeps the activation's shape;
    ``stage_params`` is a tree whose every leaf has a leading dim of S
    (the ``pipe`` axis size); ``x`` (B, ...) is the whole batch. ``n_micro``
    (default S) divides the per-shard batch; ``batch_axis`` names a second
    mesh axis the batch is cut over, each data row running its own
    pipeline over the same stage weights; ``remat_stages`` runs each stage
    again in the backward instead of keeping its activations (outputs and
    gradients keep their bits). Returns (B, ...) on every rank;
    differentiable in ``x`` and ``stage_params``."""
    s_stages = mesh.shape[axis]
    for leaf in tree_items(stage_params).values():
        if leaf.shape[0] != s_stages:
            raise ValueError(
                f"stage_params leading dim {leaf.shape[0]} != pipeline stages {s_stages} — a "
                "mismatched stack would silently run only a subset of stages")
    _grid(mesh, axis, n_micro, batch_axis, x.shape[0])
    paths, leaves = _leaves_of(stage_params)
    mine = [_comm.block(p, mesh, (axis,), 0)[0] for p in leaves]
    return pipeline_local(stage_fn, unflatten_to_like(dict(zip(paths, mine)), stage_params), x,
                          mesh, axis=axis, n_micro=n_micro, batch_axis=batch_axis,
                          remat_stages=remat_stages)


def stack_stage_params(per_stage_params):
    """A list of S trees of one structure -> one tree of leaves stacked
    along a new dim 0."""
    paths, _ = _leaves_of(per_stage_params[0])
    items = [tree_items(t) for t in per_stage_params]
    stacked = {p: torch.stack([it[p] for it in items]) for p in paths}
    return unflatten_to_like(stacked, per_stage_params[0])


# --------------------------------------------------------------------- hetero


def _eval_spec(fn, params, shape, dtype):
    """The (shape, dtype) of ``fn(params, h)`` for an ``h`` of ``shape``,
    from the function run on meta tensors (nothing computed)."""
    paths, leaves = _leaves_of(params)
    meta = unflatten_to_like({p: v.detach().to("meta") for p, v in zip(paths, leaves)}, params)
    with torch.no_grad():
        y = fn(meta, torch.empty(shape, dtype=dtype, device="meta"))
    if not isinstance(y, torch.Tensor):
        raise ValueError("stage_fns must map array -> array")
    return tuple(y.shape), y.dtype


def pipeline_apply_hetero(stage_fns: Sequence[Callable], per_stage_params, x: torch.Tensor,
                          mesh, axis: str = "pipe", n_micro: Optional[int] = None,
                          skip_bubble_compute: bool = True) -> torch.Tensor:
    """The GPipe schedule over heterogeneous stages: ``stage_fns[i]`` on
    ``per_stage_params[i]`` (trees that may differ), each free to change
    the activation's shape but not its leading (microbatch) dim. ``x``
    (B, ...) is the whole batch; returns the last stage's (B, ...) on every
    rank. Bubble ticks never compute here, whatever ``skip_bubble_compute``
    says (the JAX package's ``False`` runs them on ones and masks them
    out: the same outputs and gradients)."""
    s_stages = mesh.shape[axis]
    if len(stage_fns) != s_stages or len(per_stage_params) != s_stages:
        raise ValueError(f"got {len(stage_fns)} stage_fns / {len(per_stage_params)} param "
                         f"trees for a {s_stages}-stage {axis!r} mesh axis")
    if n_micro is None:
        n_micro = s_stages
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    mb = b // n_micro
    specs = [((mb,) + tuple(x.shape[1:]), x.dtype)]
    for fn, p in zip(stage_fns, per_stage_params):
        shape, dtype = _eval_spec(fn, p, *specs[-1])
        if shape[0] != mb:
            raise ValueError(f"stage output leading dim {shape[0]} != microbatch {mb} — stages "
                             "must preserve the batch dim")
        specs.append((shape, dtype))
    act_dtypes = {d for _, d in specs}
    if len(act_dtypes) != 1:
        raise ValueError(f"activations must share one dtype, got {act_dtypes}")
    trees = [_leaves_of(p) for p in per_stage_params]
    flat_dtypes = set()
    for _, leaves in trees:
        dt = leaves[0].dtype if leaves else torch.float32
        for v in leaves[1:]:
            dt = torch.promote_types(dt, v.dtype)
        flat_dtypes.add(dt)
    if len(flat_dtypes) != 1:
        raise ValueError(f"stacked stage params must share one flat dtype, got {flat_dtypes}")
    flat_dtype = flat_dtypes.pop()
    me = mesh.line((axis,)).index
    my_paths, _ = trees[me]

    def run(aliases, h):
        return stage_fns[me](unflatten_to_like(dict(zip(my_paths, aliases)),
                                               per_stage_params[me]), h)

    sizes = [sum(v.numel() for v in leaves) for _, leaves in trees]
    l_p = max(sizes) if sizes else 0
    all_leaves = [v for _, leaves in trees for v in leaves]
    mine_at = sum(len(leaves) for _, leaves in trees[:me])

    def gather_grads(own):
        """Every stage's gradients from their owners, as one padded flat
        vector a stage (the JAX package's stacked flat layout)."""
        flat = torch.zeros(l_p, dtype=flat_dtype, device=x.device)
        if own:
            vec = torch.cat([g.reshape(-1).to(flat_dtype) for g in own])
            flat[:vec.numel()] = vec
        every = _comm.axis_all_gather(flat[None], mesh, (axis,), 0)
        out = []
        for i, (_, leaves) in enumerate(trees):
            off = 0
            for v in leaves:
                out.append(every[i, off:off + v.numel()].reshape(v.shape).to(v.dtype))
                off += v.numel()
        return out

    sched = _Schedule(run, mesh, axis, n_micro, None, False, specs, b)
    n_mine = len(trees[me][1])

    class _Hetero(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x_, *every_leaf):
            ctx.inner = (x_, every_leaf[mine_at:mine_at + n_mine])
            with torch.enable_grad():
                xd = x_.detach().requires_grad_(x_.requires_grad)
                mine = [v.detach().requires_grad_(v.requires_grad)
                        for v in every_leaf[mine_at:mine_at + n_mine]]
                y = _GPipe.apply(sched, xd, *mine)
            ctx.graph = (xd, mine, y)
            return y.detach()

        @staticmethod
        def backward(ctx, g):
            xd, mine, y = ctx.graph
            inputs = ([xd] if xd.requires_grad else []) + [v for v in mine if v.requires_grad]
            grads = list(torch.autograd.grad(y, inputs, g, allow_unused=True)) if inputs else []
            g_x = grads.pop(0) if xd.requires_grad else None
            own = [grads.pop(0) if v.requires_grad else torch.zeros_like(v) for v in mine]
            own = [torch.zeros_like(v) if gi is None else gi for v, gi in zip(mine, own)]
            return (g_x, *gather_grads(own))

    return _Hetero.apply(x, *all_leaves)
