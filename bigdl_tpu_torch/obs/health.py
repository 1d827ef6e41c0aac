"""Model-health observability: per-layer statistics on the device and NaN
attribution (counterpart of ``bigdl_tpu/obs/health.py``; the port's own
copy, the same channels, record fields and attribution).

* :class:`HealthConfig` + :class:`HealthMonitor`, attached by
  ``Optimizer.set_health(...)``. After each step's update the monitor
  computes, on the device, one small float32 matrix: per parameter leaf
  (rows in ``jax.tree_util`` 's order, the JAX package's, so both name the
  same first layer) the channels Σg² of the clipped gradient, Σw² of the
  updated weights, Σ(Δw)², and the non-finite counts of the gradient and
  of the updated weights; the five come from a handful of ``torch._foreach``
  launches over the leaves, never one launch a leaf and channel.
* Activation statistics (mean / std / zero fraction of each leaf module's
  output) ride the forward hooks (``AbstractModule.register_forward_hook``):
  a hook stashes a 3-vector under ``'_health_act'`` in the module's state,
  seeded with zeros at install.
* On the sharded layouts each rank holds a part of the statistics' inputs:
  ZeRO-1 a slice of the flat vectors (:meth:`flat_shard_stats`), the mesh
  optimizers blocks of the leaves (:meth:`mesh_tree_stats`). Their partial
  sums are summed over the ranks that hold the parts (one all-reduce of
  the matrix, the clipping norm's way), so every rank holds the same rows.
  ``bind_mesh_axis`` / :meth:`mesh_shard_stats` add per-data-shard
  non-finite counts of the batch's inputs and targets, which
  :meth:`attribute_shard` reads to name the shard of a diverged step.
* The driver packs the matrix with the loss into one device vector and
  reads it in the one transfer it makes for the loss anyway, one step late
  (:meth:`HealthMonitor.snapshot` takes the host copy): no second pull. A
  ``health`` record goes out every ``every_n_steps`` steps; when the
  divergence guard trips, :meth:`attribute_nonfinite` names the first
  non-finite layer and whether the gradients or the weights poisoned it.

* :class:`ActivationDrift` (serving's ``drift=``) installs the same hooks
  on a served model: each non-container module's forward writes its
  (mean, std, zero fraction) f32 3-vector into the new state on the device,
  which a ``Predictor(capture_state=True)`` keeps. Every ``drift_every``
  flushes the batcher calls :meth:`ActivationDrift.sample`, which stacks
  the rows into one tensor and reads it in one copy, then scores each
  statistic against an EMA baseline: a |z| past ``warn_z`` names the layer.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["HealthConfig", "HealthMonitor", "ACT_STATE_KEY", "DriftConfig", "ActivationDrift"]

# state key under which forward hooks stash activation statistics
ACT_STATE_KEY = "_health_act"

# per-layer stat channels, in matrix column order
STAT_CHANNELS = ("grad_sq", "weight_sq", "update_sq", "nonfinite_grads", "nonfinite_params")

_KEY = re.compile(r"\[(?:'((?:[^'\\]|\\.)*)'|(\d+))\]")


def pretty_path(path: str) -> str:
    """A ``keystr`` leaf path (``['Linear_0']['weight']``, the spelling of
    ``parallel.parameter.tree_leaves_with_path``) as ``Linear_0/weight``: the
    JAX package's spelling of health rows and memory tables."""
    return "/".join(a if a or not b else b for a, b in _KEY.findall(path))


def flat_leaf_path(raw: str) -> str:
    """Flat codec path (``['Linear_0']['weight']``) -> ``Linear_0/weight``."""
    return raw.replace("['", "").replace("']", "/").rstrip("/")


def _sorted_leaves(tree) -> List[Tuple[str, torch.Tensor]]:
    from ..parallel.parameter import tree_leaves_with_path

    return [(pretty_path(p), leaf) for p, leaf in tree_leaves_with_path(tree)]


@dataclass
class HealthConfig:
    """Knobs of :class:`HealthMonitor`.

    Args:
        every_n_steps: a ``health`` record every N completed steps (the
            statistics are computed every step, so the diverged step's
            counters are always there for attribution).
        per_layer: per-leaf rows (the default); ``False`` sums them into
            one global row.
        activations: install forward hooks that record each leaf module's
            output mean / std / zero fraction (off by default: it adds a
            state entry to every hooked module).
        activation_filter: ``f(path, module) -> bool`` choosing the hooked
            modules (default: every non-container module).
        update_ratio_warn: the auto-LR guard's bound (None: off): a
            per-layer update/weight ratio above it for
            ``update_ratio_patience`` consecutive records gives one ``warn``.
        update_ratio_patience: the consecutive samples that arm the warning.
    """

    every_n_steps: int = 1
    per_layer: bool = True
    activations: bool = False
    activation_filter: Optional[Callable] = None
    update_ratio_warn: Optional[float] = None
    update_ratio_patience: int = 3

    def __post_init__(self):
        if self.every_n_steps < 1:
            raise ValueError(f"every_n_steps must be >= 1, got {self.every_n_steps}")
        if self.update_ratio_patience < 1:
            raise ValueError(
                f"update_ratio_patience must be >= 1, got {self.update_ratio_patience}")


def _sq_norms(ts: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(ts)).square()


def _nonfinite_counts(ts: List[torch.Tensor]) -> torch.Tensor:
    # t - t is 0 where t is finite and NaN elsewhere; the 0-"norm" counts
    # the non-zero elements
    return torch.stack(torch._foreach_norm(torch._foreach_sub(ts, ts), 0))


class HealthMonitor:
    """Computes the statistics on the device and owns the host half: the
    stride, the record's fields and the non-finite attribution. One monitor
    serves one optimizer; the layout is bound again at every
    ``optimize()`` entry."""

    def __init__(self, config: Optional[HealthConfig] = None):
        self.config = config or HealthConfig()
        self._paths: List[str] = []
        self._act_paths: List[str] = []
        self._hook_handles: list = []
        self._hooked_modules: list = []
        self._hooked_model_id: Optional[int] = None
        self._ratio_breaches = 0
        self._mesh_axis: Optional[tuple] = None  # (axis name, n shards)

    # ------------------------------------------------------- layout binding
    def bind_tree(self, params) -> None:
        """Bind the row labels to the parameter tree's leaves."""
        self._paths = [p for p, _ in _sorted_leaves(params)]

    def bind_flat(self, fp) -> None:
        """Bind the row labels to a flat codec's leaves (the same order)."""
        self._paths = [flat_leaf_path(p) for p in fp.paths]

    def bind_mesh_axis(self, axis_name: str, n_shards: int) -> None:
        """Label the ``shards`` rows ``<axis_name>[i]`` (the data axis of a
        mesh optimizer)."""
        self._mesh_axis = (str(axis_name), int(n_shards))

    def bind_acts(self, state) -> None:
        """The row labels of the hook entries seeded into ``state``."""
        self._act_paths = [p for p, _ in self._act_leaves(state)]

    @staticmethod
    def _act_leaves(state) -> List[Tuple[str, torch.Tensor]]:
        out = []
        for path, leaf in _sorted_leaves(state):
            head, _, key = path.rpartition("/")
            if key == ACT_STATE_KEY:
                out.append((head, leaf))
        return out

    # ----------------------------------------------------- activation hooks
    def prepare(self, model) -> None:
        """Install the activation hooks on ``model`` (idempotent per model),
        before the step reads the state."""
        if not self.config.activations:
            return
        if self._hooked_model_id == id(model):
            return
        self.remove_hooks()
        accept = self.config.activation_filter or (lambda path, m: True)
        for path, m in _walk_with_paths(model):
            if _is_container(m) or not accept(path, m):
                continue
            self._hook_handles.append(m.register_forward_hook(_activation_stat_hook))
            _seed_act_state(m)
            self._hooked_modules.append(m)
        self._hooked_model_id = id(model)

    def remove_hooks(self) -> None:
        """Undo :meth:`prepare`: the hooks and their state entries go."""
        for h in self._hook_handles:
            h.remove()
        for m in self._hooked_modules:
            m._state.pop(ACT_STATE_KEY, None)
        self._hook_handles = []
        self._hooked_modules = []
        self._hooked_model_id = None

    # ----------------------------------------------------------- the device
    def leaf_stats(self, grads: List[torch.Tensor], old: List[torch.Tensor],
                   new: List[torch.Tensor], new_state=None) -> Dict[str, torch.Tensor]:
        """The statistics of one step over leaf lists (the clipped gradient,
        the weights before and after the update, in row order): ``{"layers":
        (L, 5)[, "acts": (A, 3)]}`` float32 on the weights' device."""
        return self._finish(self._leaf_matrix(grads, old, new), new_state)

    @staticmethod
    def _leaf_matrix(grads, old, new) -> torch.Tensor:
        """The (L, 5) per-leaf channels."""
        with torch.no_grad():
            g = [t.float() for t in grads]
            o = [t.float() for t in old]
            n = [t.float() for t in new]
            return torch.stack([_sq_norms(g), _sq_norms(n), _sq_norms(torch._foreach_sub(n, o)),
                                _nonfinite_counts(g), _nonfinite_counts(n)], dim=1)

    def _finish(self, mat: torch.Tensor, new_state) -> Dict[str, torch.Tensor]:
        """The step's statistics from the per-leaf matrix: one summed row
        without ``per_layer``, the activation rows beside."""
        with torch.no_grad():
            if not self.config.per_layer:
                mat = mat.sum(dim=0, keepdim=True)
            out = {"layers": mat}
            acts = self.act_stats(new_state)
            if acts is not None:
                out["acts"] = acts
        return out

    def tree_stats(self, grads, old_params, new_params, new_state=None):
        """:meth:`leaf_stats` over parameter trees."""
        return self.leaf_stats([t for _, t in _sorted_leaves(grads)],
                               [t for _, t in _sorted_leaves(old_params)],
                               [t for _, t in _sorted_leaves(new_params)], new_state)

    def flat_stats(self, fp, g_vec, old_vec, new_vec, new_state=None):
        """:meth:`leaf_stats` over the flat layout's whole vectors."""
        def leaves(vec):
            return [t for _, t in _sorted_leaves(fp.unflatten(vec))]

        return self.leaf_stats(leaves(g_vec), leaves(old_vec), leaves(new_vec), new_state)

    def flat_shard_stats(self, fp, g_shard, old_shard, new_shard, lo: int, psum,
                         new_state=None):
        """:meth:`leaf_stats` from this rank's slice ``[lo, lo + k)`` of the
        flat ZeRO-1 vectors: each leaf's piece of it, the partial matrix
        summed over the ranks by ``psum`` (in place), so every rank returns
        the same rows."""
        mat = self._leaf_matrix(fp.leaf_pieces(g_shard, lo), fp.leaf_pieces(old_shard, lo),
                                fp.leaf_pieces(new_shard, lo))
        return self._finish(psum(mat), new_state)

    def mesh_tree_stats(self, grads, old_params, new_params, new_state, sum_rows):
        """:meth:`tree_stats` over a mesh optimizer's blocks of the leaves:
        ``sum_rows(paths, mat)`` sums the rows of the sharded leaves over
        their axes (``paths`` the rows' leaf paths, in order)."""
        leaves = _sorted_leaves(grads)
        mat = self._leaf_matrix([t for _, t in leaves],
                                [t for _, t in _sorted_leaves(old_params)],
                                [t for _, t in _sorted_leaves(new_params)])
        return self._finish(sum_rows([p for p, _ in leaves], mat), new_state)

    @staticmethod
    def mesh_shard_stats(x, t, n_shards: int, index: Optional[int] = None) -> torch.Tensor:
        """The ``(n_shards, 2)`` non-finite counts of the batch's inputs and
        targets by data shard (contiguous row blocks): of the whole batch,
        or with ``index`` of this rank's rows only, in row ``index`` (the
        caller sums the rows over the data axis)."""
        def nonfinite(tree, blocks):
            from ..utils.serialization import tree_items

            leaves = [v for v in tree_items(tree).values() if isinstance(v, torch.Tensor)]
            dev = leaves[0].device if leaves else "cpu"
            tot = torch.zeros(blocks, dtype=torch.float32, device=dev)
            for a in leaves:
                if a.dim() == 0 or a.shape[0] % blocks:
                    continue  # not led by the batch
                nf = (~torch.isfinite(a.float())).float()
                tot = tot + nf.reshape(blocks, -1).sum(dim=1)
            return tot

        with torch.no_grad():
            if index is None:
                return torch.stack([nonfinite(x, n_shards), nonfinite(t, n_shards)], dim=1)
            row = torch.stack([nonfinite(x, 1), nonfinite(t, 1)], dim=1)
            out = torch.zeros((n_shards, 2), dtype=torch.float32, device=row.device)
            out[index] = row[0]
            return out

    def act_stats(self, state) -> Optional[torch.Tensor]:
        """The hook-stashed rows of ``state`` stacked (None without any)."""
        if state is None:
            return None
        rows = [leaf for _, leaf in self._act_leaves(state)]
        if not rows:
            return None
        return torch.stack(rows).float()

    # ------------------------------------------------------------- the host
    def should_emit(self, iteration: int) -> bool:
        return iteration % self.config.every_n_steps == 0

    def snapshot(self, health) -> Dict[str, np.ndarray]:
        """The step's statistics as host arrays: ``health`` holds the views
        of the driver's one host copy (the loss's transfer)."""
        return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
                for k, v in health.items()}

    def record_fields(self, snap: Dict[str, np.ndarray]) -> Dict:
        """A snapshot as the ``health`` record's fields."""
        mat = snap["layers"]
        g_sq = float(mat[:, 0].sum())
        w_sq = float(mat[:, 1].sum())
        u_sq = float(mat[:, 2].sum())
        fields: Dict = {
            "stride": self.config.every_n_steps,
            "global": {
                "grad_norm": math.sqrt(g_sq) if g_sq >= 0 else float("nan"),
                "weight_norm": math.sqrt(w_sq) if w_sq >= 0 else float("nan"),
                "update_ratio": _ratio(u_sq, w_sq),
                "nonfinite_grads": int(mat[:, 3].sum()),
                "nonfinite_params": int(mat[:, 4].sum()),
            },
        }
        if self.config.per_layer and len(self._paths) == mat.shape[0]:
            fields["layers"] = {
                path: {"grad_norm": _sqrt(row[0]), "weight_norm": _sqrt(row[1]),
                       "update_ratio": _ratio(float(row[2]), float(row[1])),
                       "nonfinite_grads": int(row[3]), "nonfinite_params": int(row[4])}
                for path, row in zip(self._paths, mat)
            }
        acts = snap.get("acts")
        if acts is not None and len(self._act_paths) == acts.shape[0]:
            fields["acts"] = {
                path: {"mean": float(row[0]), "std": float(row[1]), "zero_frac": float(row[2])}
                for path, row in zip(self._act_paths, acts)
            }
        shards = snap.get("shards")
        if shards is not None and self._mesh_axis is not None:
            name = self._mesh_axis[0]
            fields["shards"] = {f"{name}[{i}]": {"nonfinite_inputs": int(row[0]),
                                                 "nonfinite_targets": int(row[1])}
                                for i, row in enumerate(shards)}
        return fields

    def lr_guard_event(self, fields: Dict) -> Optional[Dict]:
        """The ``update_ratio`` auto-LR guard: the warn payload once a
        breach streak reaches ``update_ratio_patience`` samples, else None."""
        bound = self.config.update_ratio_warn
        if bound is None:
            return None
        ratio = float(fields["global"]["update_ratio"])
        worst_layer = None
        layers = fields.get("layers")
        if layers:
            worst_layer, worst = max(layers.items(),
                                     key=lambda kv: _guard_key(kv[1]["update_ratio"]))
            ratio = float(worst["update_ratio"])
        if math.isfinite(ratio) and ratio > bound:
            self._ratio_breaches += 1
        else:
            self._ratio_breaches = 0
            return None
        if self._ratio_breaches != self.config.update_ratio_patience:
            return None
        return {"reason": "update_ratio", "ratio": ratio, "bound": bound,
                "consecutive": self._ratio_breaches, "layer": worst_layer}

    def attribute_nonfinite(self, snap: Dict[str, np.ndarray]) -> Tuple[Optional[str], str]:
        """The first layer (tree order) whose counters went non-finite and
        whether the gradients or the weights poisoned it; ``(None,
        "loss")`` when every counter is clean."""
        mat = snap["layers"]
        if self.config.per_layer and len(self._paths) == mat.shape[0]:
            for path, row in zip(self._paths, mat):
                if row[3] > 0:
                    return path, "grads"
                if row[4] > 0:
                    return path, "weights"
        else:
            if mat[:, 3].sum() > 0:
                return None, "grads"
            if mat[:, 4].sum() > 0:
                return None, "weights"
        return None, "loss"

    def attribute_shard(self, snap: Dict[str, np.ndarray]) -> Optional[str]:
        """The first data shard (``"data[3]"``) whose inputs or targets held
        non-finite values on the diverged step; None without per-shard
        counts or when every shard was clean (the NaN was born in the
        computation)."""
        shards = snap.get("shards")
        if shards is None or self._mesh_axis is None:
            return None
        name = self._mesh_axis[0]
        for i, row in enumerate(shards):
            if row[0] > 0 or row[1] > 0:
                return f"{name}[{i}]"
        return None


@dataclass
class DriftConfig:
    """Knobs of serving's activation-drift monitor (the JAX package's):
    ``ema_decay`` the baseline's history weight, ``warn_z`` the |z| that
    flags a layer, ``min_samples`` the samples before a breach counts."""

    ema_decay: float = 0.9
    warn_z: float = 6.0
    min_samples: int = 3

    def __post_init__(self):
        if not 0.0 < self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0,1), got {self.ema_decay}")
        if self.min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got {self.min_samples}")


class ActivationDrift:
    """Serving's activation-drift monitor (the JAX package's): the hooks of
    :class:`HealthMonitor` on a served model, and an EMA baseline of each
    hooked module's mean, std and zero fraction that :meth:`sample` scores
    the current rows against (see the module docstring)."""

    def __init__(self, config: Optional[DriftConfig] = None):
        self.config = config or DriftConfig()
        # {id(model): (model, handles, modules)}: a hot-swap hooks the new
        # model while the old one still serves; the server releases the old
        # one after the swap
        self._installs: Dict[int, tuple] = {}
        self._ema_mean: Optional[np.ndarray] = None  # (A, 3)
        self._ema_sq: Optional[np.ndarray] = None  # (A, 3)
        self.samples = 0
        # the row of a model that is not a container (the LM) sits at the
        # state's root, whose path is empty: it is named by the model's class
        self._root_label = ""

    def install(self, model) -> None:
        """Hook every non-container module of ``model`` (idempotent per
        model) and seed its state entry; other hooked models are left as
        they are. The baseline is shared across versions."""
        if id(model) in self._installs:
            return
        self._root_label = type(model).__name__
        handles, modules = [], []
        for _path, m in _walk_with_paths(model):
            if _is_container(m):
                continue
            handles.append(m.register_forward_hook(_activation_stat_hook))
            _seed_act_state(m)
            modules.append(m)
        self._installs[id(model)] = (model, handles, modules)

    def release(self, model) -> None:
        """Unhook one model and drop its seeded state entries."""
        entry = self._installs.pop(id(model), None)
        if entry is None:
            return
        _model, handles, modules = entry
        for h in handles:
            h.remove()
        for m in modules:
            m._state.pop(ACT_STATE_KEY, None)

    def remove(self) -> None:
        """Release every hooked model."""
        for mid in list(self._installs):
            self.release(self._installs[mid][0])

    def sample(self, state) -> Optional[Dict]:
        """Score the hook rows of a captured state tree against the baseline,
        fold them in, and return ``{"acts": {path: {mean, std, zero_frac,
        mean_z, std_z}}, "breach": {"layer", "z"} | None, "samples": n}``;
        None when the state holds no hook entry. The rows are stacked where
        they live and copied to the host in one transfer."""
        if state is None:
            return None
        paths: List[str] = []
        rows = []
        for path, leaf in _sorted_leaves(state):
            head, _, key = path.rpartition("/")
            if key == ACT_STATE_KEY:
                paths.append(head or self._root_label)
                rows.append(torch.as_tensor(leaf))
        if not rows:
            return None
        with torch.no_grad():
            mat = torch.stack(rows).float().cpu().numpy().astype(np.float64)
        d = self.config.ema_decay
        if self._ema_mean is None or self._ema_mean.shape != mat.shape:
            self._ema_mean = mat.copy()
            self._ema_sq = mat * mat
            self.samples = 1
            z = np.zeros_like(mat)
        else:
            var = np.maximum(self._ema_sq - self._ema_mean ** 2, 0.0)
            # a relative floor on sigma: a steady stream collapses the EMA
            # variance, and an absolute epsilon would turn a rounding wobble
            # into an enormous z
            sigma = np.maximum(np.sqrt(var), 1e-3 * np.abs(self._ema_mean) + 1e-6)
            z = (mat - self._ema_mean) / sigma
            self._ema_mean = d * self._ema_mean + (1.0 - d) * mat
            self._ema_sq = d * self._ema_sq + (1.0 - d) * mat * mat
            self.samples += 1
        acts = {p: {"mean": float(row[0]), "std": float(row[1]), "zero_frac": float(row[2]),
                    "mean_z": round(float(zr[0]), 3), "std_z": round(float(zr[1]), 3)}
                for p, row, zr in zip(paths, mat, z)}
        breach = None
        if self.samples > self.config.min_samples:
            worst_i = int(np.argmax(np.max(np.abs(z[:, :2]), axis=1)))
            worst_z = float(np.max(np.abs(z[worst_i, :2])))
            if worst_z > self.config.warn_z and math.isfinite(worst_z):
                breach = {"layer": paths[worst_i], "z": round(worst_z, 3)}
        return {"acts": acts, "breach": breach, "samples": self.samples}


def _guard_key(v: float) -> float:
    v = float(v)
    return v if math.isfinite(v) else float("-inf")


def _sqrt(v) -> float:
    v = float(v)
    return math.sqrt(v) if v >= 0 else float("nan")


def _ratio(u_sq: float, w_sq: float) -> float:
    """sqrt(update² / weight²), 0 for an all-zero weight."""
    if w_sq <= 0:
        return 0.0
    if u_sq < 0 or not math.isfinite(u_sq) or not math.isfinite(w_sq):
        return float("nan")
    return math.sqrt(u_sq / w_sq)


def _is_container(m) -> bool:
    from ..nn.module import Container

    return isinstance(m, Container)


def _walk_with_paths(model, prefix: str = ""):
    """``(path, module)`` over the module tree (``Sequential_0/Linear_1``)."""
    path = f"{prefix}/{model.name()}" if prefix else model.name()
    yield path, model
    if _is_container(model):
        for child in model._layers:
            yield from _walk_with_paths(child, path)


def _activation_stat_hook(module, x, y):
    """Mean / std / zero fraction of the output's first tensor, one f32
    3-vector under ``'_health_act'``."""
    from ..utils.serialization import tree_items

    a = next(iter(tree_items(y).values())) if not isinstance(y, torch.Tensor) else y
    a = a.detach().float()
    return {ACT_STATE_KEY: torch.stack([a.mean(), a.std(correction=0),
                                        (a == 0).float().mean()])}


def _seed_act_state(module) -> None:
    if ACT_STATE_KEY not in module._state:
        module._state[ACT_STATE_KEY] = torch.zeros(3, dtype=torch.float32, device=module.device)
