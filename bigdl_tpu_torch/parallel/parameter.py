"""The flat parameter layout (counterpart of ``bigdl_tpu/parallel/parameter.py``;
reference: ``$DL/parameters/AllReduceParameter.scala``, which compacts every
layer's weights into one vector, split into one slice a partition).

:class:`FlatParameter` is the tree <-> vector codec: leaves in the order of
``jax.tree_util`` (dict keys sorted, at every depth), paths spelled as its
``keystr`` (``['block0']['conv_w']``) and the vector padded with zeros to
``padded_total``, a multiple of ``n_shards``, so that it splits into equal
shards of ``shard_size``. The geometry (``segment_ids``, ``path_of_offset``,
``coefficient_vector``, the shard bounds) is the JAX package's element for
element, so a JAX fleet checkpoint's vectors and the weight-decay
exclusions mean the same in both packages.

The port's idiom is one contiguous float32 master buffer that IS the
parameters: :meth:`FlatParameter.bind` copies the model's parameters into
it and makes each parameter's ``.data`` a view of its segment, and
:meth:`FlatParameter.bind_grads` makes each ``.grad`` a view of one flat
gradient buffer, into which autograd accumulates in place. A reduce-scatter
of the gradient buffer and an all-gather into the master then act on the
model's own tensors, with no per-step copy between the tree and the vector.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def tree_leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(keystr path, leaf)`` pairs in ``jax.tree_util`` 's order: dict keys
    sorted at every depth, lists and tuples in order, None skipped."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, prefix, out)
    return out


def _walk(node, path: str, out: List[Tuple[str, Any]]) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _walk(node[k], f"{path}[{k!r}]", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, f"{path}[{i}]", out)
    elif node is not None:
        out.append((path, node))


def _rebuild(node, leaves: Dict[str, Any], path: str):
    if isinstance(node, dict):
        return {k: _rebuild(v, leaves, f"{path}[{k!r}]") for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, leaves, f"{path}[{i}]") for i, v in enumerate(node))
    if node is None:
        return None
    return leaves[path]


class FlatParameter:
    """Static tree <-> vector codec, padded so the vector splits evenly into
    ``n_shards`` shards (see the module docstring)."""

    def __init__(self, params_tree: Any, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        pairs = tree_leaves_with_path(params_tree)
        self.paths = [p for p, _ in pairs]
        self.shapes = [tuple(leaf.shape) for _, leaf in pairs]
        self.dtypes = [leaf.dtype for _, leaf in pairs]
        self.sizes = [int(np.prod(s, dtype=np.int64)) for s in self.shapes]
        self.total = int(sum(self.sizes))
        self.n_shards = int(n_shards)
        self.padded_total = -(-self.total // self.n_shards) * self.n_shards
        self.shard_size = self.padded_total // self.n_shards
        self._offsets = np.cumsum([0] + self.sizes[:-1]).tolist() if self.sizes else []
        self._like = params_tree
        self._segment_ids: Optional[np.ndarray] = None
        self._seg_tensors: Dict[torch.device, torch.Tensor] = {}

    # ------------------------------------------------------------ geometry
    def segment_ids(self) -> np.ndarray:
        """Per-element int32 leaf index over the padded layout (the padding
        tail is ``len(sizes)``, one past the last leaf)."""
        if self._segment_ids is None:
            seg = np.repeat(np.arange(len(self.sizes), dtype=np.int32), self.sizes)
            pad = self.padded_total - self.total
            if pad:
                seg = np.concatenate([seg, np.full((pad,), len(self.sizes), np.int32)])
            self._segment_ids = seg
        return self._segment_ids

    def segment_ids_on(self, device) -> torch.Tensor:
        """:meth:`segment_ids` as an int64 tensor on ``device`` (cached)."""
        device = torch.device(device)
        seg = self._seg_tensors.get(device)
        if seg is None:
            seg = self._seg_tensors[device] = torch.from_numpy(
                self.segment_ids().astype(np.int64)).to(device)
        return seg

    def coefficient_vector(self, leaf_fn: Callable[[str], float], device="cpu") -> torch.Tensor:
        """Per-element float32 vector of ``leaf_fn(path)``, 0 on the padding
        tail (per-segment hyperparameters such as weight-decay exclusions),
        made on ``device`` (no host copy of a parameter-sized vector)."""
        per_leaf = torch.tensor([float(leaf_fn(p)) for p in self.paths] + [0.0],
                                dtype=torch.float32, device=device)
        counts = torch.tensor(self.sizes + [self.padded_total - self.total], device=device)
        return torch.repeat_interleave(per_leaf, counts)

    def shard_bounds(self, i: int) -> Tuple[int, int]:
        """``[start, stop)`` of shard ``i`` in the padded vector."""
        if not 0 <= i < self.n_shards:
            raise IndexError(f"shard {i} out of range [0, {self.n_shards})")
        return i * self.shard_size, (i + 1) * self.shard_size

    def path_of_offset(self, offset: int) -> str:
        """The path owning flat ``offset`` (``'<padding>'`` for the tail)."""
        if not 0 <= offset < self.padded_total:
            raise IndexError(f"offset {offset} out of range [0, {self.padded_total})")
        if offset >= self.total:
            return "<padding>"
        j = int(np.searchsorted(np.asarray(self._offsets), offset, side="right")) - 1
        return self.paths[j]

    def leaf_pieces(self, part: torch.Tensor, lo: int) -> List[torch.Tensor]:
        """Each leaf's piece (a view, empty where they do not meet) of
        ``part``, the slice ``[lo, lo + len(part))`` of a padded vector; the
        padding tail belongs to no leaf."""
        hi = lo + part.numel()
        out = []
        for off, size in zip(self._offsets, self.sizes):
            a, b = max(off, lo), min(off + size, hi)
            out.append(part[a - lo:b - lo] if a < b else part[:0])
        return out

    # ---------------------------------------------------------- the padding
    def zero_pad(self, vec: torch.Tensor) -> torch.Tensor:
        """Re-zero the padding tail of a padded vector, in place (an update
        rule may turn the inert tail's zeros into NaN: Adamax's 1e-38 guard
        flushes to 0 on some devices)."""
        if self.padded_total != self.total:
            vec[self.total:].zero_()
        return vec

    def zero_pad_shard(self, shard: torch.Tensor, index: int) -> torch.Tensor:
        """:meth:`zero_pad` for shard ``index`` of the vector, in place."""
        start = self.total - index * self.shard_size
        if start < self.shard_size:
            shard[max(start, 0):].zero_()
        return shard

    # ------------------------------------------------------ tree <-> vector
    def flatten(self, tree) -> torch.Tensor:
        """Tree -> padded 1-D float32 vector (a new tensor, on the leaves'
        device)."""
        leaves = [leaf for _, leaf in tree_leaves_with_path(tree)]
        device = leaves[0].device if leaves and isinstance(leaves[0], torch.Tensor) else "cpu"
        vec = torch.zeros(self.padded_total, dtype=torch.float32, device=device)
        with torch.no_grad():
            for off, size, leaf in zip(self._offsets, self.sizes, leaves):
                src = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
                vec[off:off + size].copy_(src.reshape(-1))
        return vec

    def unflatten(self, vec: torch.Tensor, like=None):
        """Padded vector -> tree of ``like`` (this codec's tree by default):
        views of ``vec`` where the leaf's dtype is the vector's, casts
        otherwise."""
        leaves = {}
        for path, off, size, shape, dtype in zip(self.paths, self._offsets, self.sizes,
                                                  self.shapes, self.dtypes):
            leaves[path] = vec[off:off + size].view(shape).to(dtype)
        return _rebuild(self._like if like is None else like, leaves, "")

    def slots_tree_view(self, slots: Dict[str, Any]) -> Dict[str, Any]:
        """Flat slot vectors -> per-leaf trees of the parameter tree (scalar
        slot state passes through): the layout checkpoints persist."""
        return {k: self.unflatten(v) if tuple(getattr(v, "shape", ())) == (self.padded_total,)
                else v for k, v in slots.items()}

    # ------------------------------------------------------- binding a model
    def _params(self, params_tree) -> List[torch.Tensor]:
        leaves = [leaf for _, leaf in tree_leaves_with_path(params_tree)]
        if len({id(p) for p in leaves}) != len(leaves):
            raise ValueError("a parameter appears at two paths; the flat layout gives each "
                             "segment its own storage")
        for path, p in zip(self.paths, leaves):
            if p.dtype != torch.float32:
                raise ValueError(f"{path} is {p.dtype}; the flat layout binds float32 "
                                 "parameters only")
        return leaves

    def bind(self, params_tree, master: torch.Tensor) -> None:
        """Copy the parameters into ``master`` (float32, ``padded_total``
        elements) and make each one's ``.data`` the view of its segment."""
        with torch.no_grad():
            for off, size, shape, p in zip(self._offsets, self.sizes, self.shapes,
                                           self._params(params_tree)):
                seg = master[off:off + size].view(shape)
                seg.copy_(p)
                p.data = seg
            self.zero_pad(master)

    def bind_grads(self, params_tree, grads: torch.Tensor) -> None:
        """Make each parameter's ``.grad`` the view of its segment of the
        flat ``grads`` buffer (where it is not already)."""
        for off, size, shape, p in zip(self._offsets, self.sizes, self.shapes,
                                       self._params(params_tree)):
            g = p.grad
            if g is None or g.data_ptr() != grads[off:].data_ptr() or tuple(g.shape) != shape:
                p.grad = grads[off:off + size].view(shape)
