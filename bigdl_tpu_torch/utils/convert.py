"""Carry a JAX model's weights and state into the port.

``load_jax_params(module, tree)`` takes the JAX model's parameter tree as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
model.get_parameters())`` on the JAX side), so this package never imports
JAX. Paths map one to one (``tree["block0"]["self_q_w"]`` ->
``module.block0.self_q_w``, and through containers
``tree["stem_seq"]["stem_s2d_seq"]["stem"]["stem_conv"]["weight"]`` ->
``module.stem_seq.stem_s2d_seq.stem.stem_conv.weight``; a translation
Transformer's ``dec_block0.cross_q_w``, ``dec_block0.ln3_g`` and ``dec_ln_g``
likewise, a rotary one's tree is the sinusoidal one's, NeuralCF's
``mlp_tower.mlp_fc0.weight`` and ``TimeDistributed``'s
``td_decoder.decoder.weight`` nest as in the JAX tree, as do the cells'
gates (``GRU``'s ``i2rz``/``h2rz``/``bias_rz``/``i2n``/``h2n``/``bias_n``,
``ConvLSTMPeephole``'s OIHW ``i2g``/``h2g`` and ``peep``), the table
containers' children (``ConcatTable``/``ParallelTable`` per branch,
``MapTable``'s one child), the learned activations and math layers
(``PReLU``, ``SReLU``, ``Mul``, ``CMul``, ``Bilinear``, ``Scale``, ...) and
MaskRCNN's children (``backbone_level0.SpatialConvolution_0.weight``,
``fpn.SpatialConvolution_4.weight`` (the smoothing convolutions follow the
laterals), ``rpn.SpatialConvolution_1.bias``, ``box_head.Linear_3.weight``,
``mask_head.SpatialFullConvolution_2.weight``, whose deconvolution weight
is (in, out, kH, kW) in both packages), the volumetric, locally connected
and separable convolutions' (``VolumetricConvolution``'s OIDHW ``weight``,
``LocallyConnected2D``'s per-position (oH·oW, out, C·kH·kW) bank and (out,
oH, oW) bias, ``SpatialSeparableConvolution``'s ``depth_weight`` and
``point_weight``), ``Maxout``'s and ``Highway``'s ``Linear_<i>`` children,
and a keras model's, whose wrappers nest ``{child name: child tree}`` of
the core layers they made (``Dense_5.Linear_0.weight``,
``Convolution2D_0.SpatialConvolution_0.bias``));
``Linear``-style weights are (out, in) and convolution weights OIHW in
both packages, so every copy is a plain copy. ``load_jax_state(module, tree)`` does the same
for the state tree (``model.get_state()``: BN running statistics).
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
    _load(module, tree, dict(module.named_parameters()), "parameter")


def load_jax_state(module, tree: Dict[str, Any]) -> None:
    """Copy ``tree`` into ``module``'s state tensors in place, with the same
    checks as :func:`load_jax_params`."""
    _load(module, tree, _flatten(module.get_state()), "state")


def _load(module, tree: Dict[str, Any], dst: Dict[str, torch.Tensor], what: str) -> None:
    if not module.is_built():
        raise ValueError(f"{module.name()} is not built; build it (init / a "
                         "first forward) before loading weights")
    src = _flatten(tree)
    missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"{what} paths differ: missing {missing}, extra {extra}")
    bad = [(p, tuple(np.shape(src[p])), tuple(dst[p].shape)) for p in sorted(dst)
           if tuple(np.shape(src[p])) != tuple(dst[p].shape)]
    if bad:
        raise ValueError(f"shape mismatch (path, source, port): {bad}")
    with torch.no_grad():
        for path, t in dst.items():
            t.copy_(torch.from_numpy(np.array(src[path], dtype=np.float32)).to(t.dtype))
