"""One-shot model introspection: the per-layer memory breakdown and a step's
cost summary (counterpart of ``bigdl_tpu/obs/profiler.py``; the port's own
copy, the same tables).

The byte counts come from shapes and dtypes (no data touched; slot trees
are counted on meta tensors, nothing is allocated); the cost is the
step-cost count of :func:`bigdl_tpu_torch.obs.perf.program_cost` on the
meta device, where the JAX package reads XLA's cost analysis of the
compiled step. :func:`collective_bytes` reads the port's collective
counters (``parallel/_comm.py``) where the JAX package parses the lowered
program's collectives; :func:`lowered_cost_summary` formats a counted
:class:`~bigdl_tpu_torch.obs.perf.StepCost` (the port has no lowered
program). ``profile_optimizer`` is the library entry point.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from .health import flat_leaf_path, pretty_path

__all__ = [
    "memory_breakdown",
    "flat_memory_breakdown",
    "cost_summary",
    "lowered_cost_summary",
    "collective_bytes",
    "profile_optimizer",
]


def _leaf_bytes(leaf) -> int:
    """Bytes of one tensor or array from its shape and itemsize."""
    shape = tuple(getattr(leaf, "shape", ()))
    size = getattr(leaf, "element_size", None)
    itemsize = size() if callable(size) else np.dtype(getattr(leaf, "dtype", np.float32)).itemsize
    return int(np.prod(shape, dtype=np.int64)) * itemsize if shape else itemsize


def _leaves(tree):
    from ..parallel.parameter import tree_leaves_with_path

    return tree_leaves_with_path(tree)


def memory_breakdown(params, slots=None) -> Dict[str, Any]:
    """Per-layer parameter and optimizer-slot bytes of the tree layout.
    ``slots`` is a slot tree whose top level names the slot
    (``{"velocity": <param tree>}``); each slot leaf counts toward its layer
    by sub-path."""
    layers: Dict[str, Dict[str, Any]] = {}
    total_p = total_s = 0
    for path, leaf in _leaves(params):
        b = _leaf_bytes(leaf)
        entry = layers.setdefault(pretty_path(path), {"param_bytes": 0, "slot_bytes": 0})
        entry["param_bytes"] += b
        total_p += b
    for path, leaf in (_leaves(slots) if slots else ()):
        b = _leaf_bytes(leaf)
        parts = pretty_path(path).split("/")
        layer = "/".join(parts[1:]) if len(parts) > 1 else parts[0]
        entry = layers.setdefault(layer, {"param_bytes": 0, "slot_bytes": 0})
        entry["slot_bytes"] += b
        total_s += b
    return {"layout": "tree", "layers": layers,
            "totals": {"param_bytes": total_p, "slot_bytes": total_s,
                       "total_bytes": total_p + total_s}}


def flat_memory_breakdown(fp, method=None) -> Dict[str, Any]:
    """Per-layer bytes of the flat master layout: ``fp`` the
    :class:`~bigdl_tpu_torch.parallel.parameter.FlatParameter` codec,
    ``method`` (when given) sets the slot-vector count (its slots of a
    meta flat vector)."""
    n_slot_vecs = 0
    if method is not None:
        spec = torch.empty(fp.padded_total, dtype=torch.float32, device="meta")
        n_slot_vecs = sum(1 for v in method.init_flat_slots(spec).values()
                          if isinstance(v, torch.Tensor) and v.dim() == 1)
    layers: Dict[str, Dict[str, Any]] = {}
    for raw_path, size, dtype in zip(fp.paths, fp.sizes, fp.dtypes):
        itemsize = torch.empty((), dtype=dtype).element_size() if isinstance(
            dtype, torch.dtype) else np.dtype(dtype).itemsize
        layers[flat_leaf_path(raw_path)] = {"param_bytes": size * itemsize,
                                            "slot_bytes": size * 4 * n_slot_vecs}
    shard_b = fp.shard_size * 4
    master_b = fp.padded_total * 4
    param_b = sum(e["param_bytes"] for e in layers.values())
    slot_b = fp.padded_total * 4 * n_slot_vecs
    return {
        "layout": "flat_zero1",
        "layers": layers,
        "totals": {"param_bytes": param_b, "slot_bytes": slot_b, "master_bytes": master_b,
                   "total_bytes": param_b + slot_b + master_b},
        "flat": {"n_shards": fp.n_shards, "shard_size": fp.shard_size,
                 "padded_total": fp.padded_total, "flat_vector_bytes": master_b,
                 "master_vector_bytes": master_b, "master_carried": True,
                 "slot_vectors": n_slot_vecs,
                 "slot_shard_bytes_per_device": shard_b * n_slot_vecs},
    }


def lowered_cost_summary(cost) -> Optional[Dict[str, Any]]:
    """The summary schema (``flops`` / ``bytes_accessed`` /
    ``arithmetic_intensity``) of a counted
    :class:`~bigdl_tpu_torch.obs.perf.StepCost`; None without FLOPs."""
    if cost is None or not cost.flops:
        return None
    return {"flops": float(cost.flops), "bytes_accessed": cost.bytes_accessed,
            "arithmetic_intensity": cost.arithmetic_intensity}


def cost_summary(optimizer, x, t, routes: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """FLOPs of one training step of ``optimizer`` on a batch shaped as
    ``x`` / ``t``, counted on the meta device
    (:func:`~bigdl_tpu_torch.obs.perf.program_cost`): nothing runs on the
    card. None when the step cannot be counted."""
    from .perf import program_cost

    return lowered_cost_summary(program_cost(optimizer, x, t, routes))


# the port's collectives and the XLA ops the JAX package's parser names
_OP_OF = {"psum": "all_reduce", "pmean": "all_reduce", "pmax": "all_reduce",
          "psum_scatter": "reduce_scatter", "all_gather": "all_gather",
          "all_to_all": "all_to_all", "ppermute": "collective_permute",
          "broadcast": "broadcast"}


def collective_bytes(counts=None) -> Dict[str, Any]:
    """Per-rank collective operand bytes by op kind, in the JAX package's
    schema, from the port's collective counters (``counts`` a
    ``parallel._comm.counts()`` reading; default: the counters now, since
    their last reset)."""
    if counts is None:
        from ..parallel import _comm

        counts = _comm.counts()
    by_op: Dict[str, int] = {}
    ops = []
    for name, c in counts.items():
        if not c.get("calls"):
            continue
        op = _OP_OF.get(name, name)
        by_op[op] = by_op.get(op, 0) + int(c["bytes"])
        ops.append({"op": op, "operand_bytes": int(c["bytes"]), "calls": int(c["calls"])})
    return {
        "ops": ops,
        "by_op": by_op,
        "grad_exchange_bytes": by_op.get("reduce_scatter", 0) + by_op.get("all_to_all", 0),
        "all_reduce_bytes": by_op.get("all_reduce", 0),
        "all_gather_bytes": by_op.get("all_gather", 0),
        "all_to_all_bytes": by_op.get("all_to_all", 0),
        "ppermute_bytes": by_op.get("collective_permute", 0),
        "total_bytes": sum(by_op.values()),
    }


def profile_optimizer(opt, cost: bool = True) -> Dict[str, Any]:
    """One-shot profile of an optimizer's training setup: builds the model
    from the dataset's first batch when needed, then the per-layer memory
    breakdown (the ZeRO-1 flat geometry for a sharded ``DistriOptimizer``,
    the tree layout otherwise) and, for the tree step, the counted cost of
    one step (``cost=False`` skips it). Dispatches no step on the card."""
    from ..nn.module import _map_tree, _meta_like
    from ..parallel.distri_optimizer import DistriOptimizer
    from ..parallel.parameter import FlatParameter
    from ..utils.random import RandomGenerator
    from ..utils.serialization import tree_items

    first = opt._first_batch()
    if not opt.model.is_built():
        opt.model.build(RandomGenerator.generator(),
                        opt.model._as_input(opt._build_input(first)))
    params = opt.model.get_parameters()
    method = opt.optim_method
    out: Dict[str, Any] = {"path": type(opt).__name__,
                           "n_params": sum(int(p.numel()) for p in tree_items(params).values())}
    flat_sharded = False
    if isinstance(opt, DistriOptimizer):
        sync = opt._resolve_parameter_sync(method, params)
        flat_sharded = sync == "sharded"
        out["parameter_sync"] = sync
    if flat_sharded:
        from ..parallel import _comm

        out["memory"] = flat_memory_breakdown(FlatParameter(params, _comm.world()), method)
    else:
        out["memory"] = memory_breakdown(params, method.init_slots(_map_tree(_meta_like, params)))
    out["cost"] = None
    if cost and not isinstance(opt, DistriOptimizer):
        out["cost"] = cost_summary(opt, opt._build_input(first), first.get_target())
    return out


def render_memory(report: Dict[str, Any], top: int = 0) -> str:
    """A human table of a :func:`memory_breakdown` /
    :func:`flat_memory_breakdown` result."""
    lines = []
    rows = sorted(report["layers"].items(),
                  key=lambda kv: -(kv[1]["param_bytes"] + kv[1]["slot_bytes"]))
    shown = rows[:top] if top else rows
    width = max((len(p) for p, _ in shown), default=10)
    for path, e in shown:
        lines.append(f"  {path:<{width}}  params {_fmt_bytes(e['param_bytes']):>10}  "
                     f"slots {_fmt_bytes(e['slot_bytes']):>10}")
    if top and len(rows) > top:
        lines.append(f"  ... {len(rows) - top} more layers")
    t = report["totals"]
    lines.append(f"  {'TOTAL':<{width}}  params {_fmt_bytes(t['param_bytes']):>10}  "
                 f"slots {_fmt_bytes(t['slot_bytes']):>10}")
    flat = report.get("flat")
    if flat:
        lines.append("  flat ZeRO-1: %d shards x %s flat-vector slice; %s of sharded slot "
                     "state per device (%d slot vector(s))" % (
                         flat["n_shards"], _fmt_bytes(flat["shard_size"] * 4),
                         _fmt_bytes(flat["slot_shard_bytes_per_device"]),
                         flat["slot_vectors"]))
    return "\n".join(lines)


def _fmt_bytes(n: float) -> str:
    if not n:
        return "0"
    units = ("B", "KiB", "MiB", "GiB", "TiB")
    i = min(int(math.log(abs(n), 1024)), len(units) - 1)
    return f"{n / 1024 ** i:.1f}{units[i]}"
