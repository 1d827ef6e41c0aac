"""Carry a JAX model's weights into the port.

``load_jax_params(module, tree)`` takes the JAX model's parameter tree as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
model.get_parameters())`` on the JAX side), so this package never imports
JAX. Paths map one to one (``tree["block0"]["self_q_w"]`` ->
``module.block0.self_q_w``); ``Linear``-style weights are (out, in) in both
packages, so every copy is a plain copy.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = val
    return out


def load_jax_params(module, tree: Dict[str, Any]) -> None:
    """Copy ``tree`` into ``module``'s parameters in place; raises on any
    missing key, extra key or shape mismatch (nothing is copied then)."""
    if not module.is_built():
        raise ValueError(f"{module.name()} is not built; build it (init / a "
                         "first forward) before loading weights")
    src = _flatten(tree)
    dst = dict(module.named_parameters())
    missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"parameter paths differ: missing {missing}, extra {extra}")
    bad = [(p, tuple(np.shape(src[p])), tuple(dst[p].shape)) for p in sorted(dst)
           if tuple(np.shape(src[p])) != tuple(dst[p].shape)]
    if bad:
        raise ValueError(f"shape mismatch (path, source, port): {bad}")
    with torch.no_grad():
        for path, param in dst.items():
            param.copy_(torch.from_numpy(np.array(src[path], dtype=np.float32)).to(param.dtype))
