"""ParamAudit — parameter-tree hygiene checks on a built model (counterpart
of ``bigdl_tpu/analysis/param_audit.py``'s ``ParamAudit`` and
``FlatParamAudit``).

Three audits over each module's own parameters, with no forward pass:

* **accidental sharing** — two parameter leaves (of two modules, or of one)
  over the same memory. The JAX package keys on the array object, since its
  arrays are immutable; in torch the aliasing that matters is shared
  storage, where an in-place update through one leaf writes the other, so
  leaves are grouped by their storage and overlapping byte ranges (a view
  of another leaf aliases it). One module at several graph nodes is
  intentional sharing: it registers once, each module is audited once, and
  it never trips this. Two layers handed one tensor do. Suppress a
  deliberate alias by listing either module's name in ``allow_shared``.
* **dtype policy** — master parameters must be float32 (the bf16 policy
  casts compute operands and activations, never the stored weights).
  Non-float leaves are exempt.
* **non-finite initializers** — NaN/Inf in a floating leaf, read with one
  host transfer for the whole tree.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch

from ..utils.serialization import tree_items
from .errors import Finding, ParamAuditError


def _raise_on_errors(found: List[Finding]) -> List[Finding]:
    errors = [f for f in found if f.severity == "error"]
    if errors:
        raise ParamAuditError("; ".join(f.message for f in errors))
    return found


def _leaf_paths(model) -> Iterable[Tuple[str, str, torch.Tensor]]:
    """(module name, leaf path, leaf) over every module's OWN parameters,
    each module once."""
    seen = set()
    for m in model.walk():
        if id(m) in seen or not m._param_tree:
            continue
        seen.add(id(m))
        for path, leaf in tree_items(m._param_tree).items():
            yield m.name(), "".join(f"['{k}']" for k in path.split("/")), leaf


def _alias_groups(entries) -> List[list]:
    """Groups of entries whose leaves overlap in memory: by storage, then by
    overlapping byte ranges within it."""
    by_storage: Dict[Tuple, list] = {}
    for e in entries:
        t = e[2]
        if t.numel() == 0:
            continue
        size = t.element_size()
        span = sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride())) + 1
        start = t.storage_offset() * size
        key = (t.device, t.untyped_storage().data_ptr())
        by_storage.setdefault(key, []).append((start, start + span * size, e))
    groups = []
    for ranges in by_storage.values():
        ranges.sort(key=lambda r: r[0])
        cur, end = [], -1
        for lo, hi, e in ranges:
            if cur and lo < end:
                cur.append(e)
                end = max(end, hi)
            else:
                if len(cur) > 1:
                    groups.append(cur)
                cur, end = [e], hi
        if len(cur) > 1:
            groups.append(cur)
    return groups


class ParamAudit:
    def __init__(self, model, allow_shared: Iterable[str] = ()):
        if not model.is_built():
            raise ValueError("ParamAudit needs a built model (params exist only after "
                             "build/init); run ShapeProp for pre-build checks")
        self.model = model
        self.allow_shared = frozenset(allow_shared)

    def findings(self) -> List[Finding]:
        found: List[Finding] = []
        entries = list(_leaf_paths(self.model))
        floats = [e for e in entries if e[2].is_floating_point()]
        for mod_name, leaf_path, leaf in floats:
            if leaf.dtype != torch.float32:
                name = str(leaf.dtype).replace("torch.", "")
                found.append(Finding(
                    "param-dtype-policy", "error",
                    f"{mod_name}{leaf_path} is {name}; master parameters must stay float32 "
                    "(the precision policy casts compute operands, never the stored "
                    "weights — utils/precision.py)", path=mod_name))
        if floats:
            with torch.no_grad():  # one host transfer for the whole tree
                finite = torch.stack([torch.isfinite(e[2]).all().to(floats[0][2].device)
                                      for e in floats]).tolist()
            for (mod_name, leaf_path, _), ok in zip(floats, finite):
                if not ok:
                    found.append(Finding(
                        "param-nonfinite", "error",
                        f"{mod_name}{leaf_path} contains NaN/Inf values at initialization",
                        path=mod_name))
        for group in _alias_groups(entries):
            if not any(m in self.allow_shared for m, _, _ in group):
                sites = ", ".join(f"{m}{p}" for m, p, _ in group)
                found.append(Finding(
                    "param-shared", "error",
                    f"one parameter array is aliased at {len(group)} sites: {sites}; updates "
                    "through one site clobber the other (pass allow_shared=[name] if "
                    "intentional)", path=group[0][0]))
        return found

    def check(self) -> List[Finding]:
        return _raise_on_errors(self.findings())


class FlatParamAudit:
    """ParamAudit of the flat layout (the JAX package's ``FlatParamAudit``),
    run before the first flat step: the codec's geometry (leaf sizes sum to
    ``total``, ``n_shards`` equal shards tile ``padded_total``, the vector
    has the padded length), the dtype policy (the leaves the codec
    round-trips and the vector are float32) and finiteness (the first
    non-finite offset named by its parameter path). The JAX package checks
    the addressable shards of a sharded array; each rank here holds the
    whole vector, which it checks."""

    def __init__(self, fp, flat):
        self.fp = fp
        self.flat = flat

    def findings(self) -> List[Finding]:
        found: List[Finding] = []
        fp = self.fp
        if sum(fp.sizes) != fp.total or fp.shard_size * fp.n_shards != fp.padded_total:
            found.append(Finding(
                "flat-param-geometry", "error",
                f"FlatParameter codec geometry is inconsistent: sum(sizes)={sum(fp.sizes)} vs "
                f"total={fp.total}, {fp.n_shards} shards x {fp.shard_size} vs "
                f"padded_total={fp.padded_total}"))
        for path, dt in zip(fp.paths, fp.dtypes):
            if dt.is_floating_point and dt != torch.float32:
                found.append(Finding(
                    "flat-param-dtype-policy", "error",
                    f"{path} is {str(dt).replace('torch.', '')}; the flat update computes on a "
                    "float32 vector and the parameters are its views: a bf16 master would lose "
                    "every update's low bits (bf16 belongs on the gradient wire, or to "
                    "master_dtype, not the stored weights)", path=path))
        shape = tuple(getattr(self.flat, "shape", ()))
        if shape != (fp.padded_total,):
            found.append(Finding(
                "flat-param-geometry", "error",
                f"flat vector has shape {shape}; the codec expects ({fp.padded_total},)"))
            return found
        if self.flat.dtype != torch.float32:
            found.append(Finding(
                "flat-param-dtype-policy", "error",
                f"flat master vector is {str(self.flat.dtype).replace('torch.', '')}; the "
                "optimizer update runs on float32 masters"))
        finite = torch.isfinite(self.flat)
        if not bool(finite.all()):
            off = int(torch.argmin(finite.to(torch.uint8)))
            found.append(Finding(
                "flat-param-nonfinite", "error",
                f"non-finite value at flat offset {off} ({fp.path_of_offset(off)})",
                path=fp.path_of_offset(off)))
        return found

    def check(self) -> List[Finding]:
        return _raise_on_errors(self.findings())


class ShardedParamAudit:
    """ParamAudit of a tree that a ``ShardingPlan`` has cut into blocks (the
    JAX package's ``ShardedParamAudit``), run by the hybrid, pipeline and
    expert-parallel optimizers before the first step, on every rank:

    * **finiteness** on this rank's own blocks (the other ranks' are never
      gathered for it), naming the path, the block's index in the whole leaf
      (from ``specs``, ``{path: spec}``, and ``mesh``, when given) and the
      rank;
    * **dtype policy**: floating leaves are float32 masters;
    * **aliasing** over ``aliasing_tree``, the tree before it was cut (each
      block is a copy, so two tied leaves would become two independent
      blocks with nothing to show it), keyed on storage as ``ParamAudit``
      keys it; ``allow_shared`` substrings of a path suppress a finding.
    """

    def __init__(self, params, allow_shared: Iterable[str] = (), aliasing_tree=None,
                 specs=None, mesh=None):
        self.params = params
        self.allow_shared = frozenset(allow_shared)
        self.aliasing_tree = aliasing_tree
        self.specs = specs
        self.mesh = mesh

    def _where(self, path: str, leaf: torch.Tensor) -> str:
        from ..parallel._comm import rank

        if self.specs is None or self.mesh is None:
            return f" (rank {rank()})"
        from ..parallel.sharding import spec_axes

        spec = self.specs.get(path, ())
        index = []
        for dim, k in enumerate(leaf.shape):
            axes = spec_axes(spec[dim]) if dim < len(spec) else ()
            i = self.mesh.index(axes)
            index.append(f"{i * k}:{(i + 1) * k}")
        return f" (shard [{', '.join(index)}] on rank {rank()})"

    def findings(self) -> List[Finding]:
        found: List[Finding] = []
        items = tree_items(self.params)
        floats = []
        for path, leaf in items.items():
            name = "".join(f"['{k}']" for k in path.split("/"))
            if not leaf.is_floating_point():
                continue  # int8 weights and index tables are exempt
            if leaf.dtype != torch.float32:
                found.append(Finding(
                    "sharded-param-dtype-policy", "error",
                    f"{name} is {str(leaf.dtype).replace('torch.', '')}; master parameters "
                    "must stay float32 under a ShardingPlan too (the precision policy casts "
                    "compute operands, never stored weights)", path=name))
                continue
            floats.append((path, name, leaf))
        if floats:
            with torch.no_grad():  # one host transfer for the rank's blocks
                finite = torch.stack([torch.isfinite(v).all().to(floats[0][2].device)
                                      for _, _, v in floats]).tolist()
            for (path, name, leaf), ok in zip(floats, finite):
                if not ok:
                    found.append(Finding(
                        "sharded-param-nonfinite", "error",
                        f"non-finite value in {name}{self._where(path, leaf)}: a poisoned "
                        "shard seeds a divergence every later step inherits", path=name))
        tree = self.params if self.aliasing_tree is None else self.aliasing_tree
        entries = [(p, "".join(f"['{k}']" for k in p.split("/")), v)
                   for p, v in tree_items(tree).items() if isinstance(v, torch.Tensor)]
        for group in _alias_groups(entries):
            names = [n for _, n, _ in group]
            if not any(a in n for a in self.allow_shared for n in names):
                found.append(Finding(
                    "sharded-param-shared", "error",
                    f"one committed parameter array is aliased at {len(names)} tree paths: "
                    f"{', '.join(names)}; the first in-place update through one path clobbers "
                    "the other (pass allow_shared=[substring] if intentional)",
                    path=names[0]))
        return found

    def check(self) -> List[Finding]:
        return _raise_on_errors(self.findings())
