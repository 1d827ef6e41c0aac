"""``BinaryTreeLSTM`` over padded tree encodings (counterpart of
``bigdl_tpu/nn/tree_lstm.py``; reference: ``$DL/example/treeLSTMSentiment``
and ``BinaryTreeLSTM.scala``, Tai et al. 2015).

A batch of binary trees is a padded tensor encoding: the nodes are numbered
so that children precede their parents (leaves first); ``children`` (N, M,
2) holds each slot's 1-based child slots, 0 for none; leaf slots read their
embedded input ``x`` (N, M, D), internal slots a zero input. Slot 0 of the
state buffers is a frozen zero state, so padding and missing children need
no branch, only a gather.

The JAX package's ``lax.scan`` over slots is a Python loop here. Each step
gathers the children's states from the buffer as it stands, runs the cell
and writes its slot; the write makes a new buffer (``torch.where`` over the
slot) rather than writing in place, because an earlier step's gather still
holds the old one for the backward.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import precision
from ..utils.table import Table
from .initialization import Xavier
from .module import AbstractModule


class BinaryTreeLSTM(AbstractModule):
    """Binary child-combining tree LSTM: ``forward(Table(x (N, M, D),
    children (N, M, 2) int))`` gives the hidden states (N, M, H) of every
    slot, in the encoding's order (score the root's slot for a sentence)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

    def __init__(self, input_size: Optional[int], hidden_size: int, device=None):
        super().__init__(device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.weight_init = Xavier()

    def _build(self, generator, sample):
        x_spec = sample.to_list()[0] if isinstance(sample, Table) else sample[0]
        d = x_spec.shape[-1]
        if self.input_size is not None and self.input_size != d:
            raise ValueError(f"{self.name()}: declared input size {self.input_size}, got {d}")
        self.input_size = d
        h = self.hidden_size
        return {
            # input -> [i, o, u, f] stacked
            "wx": self.weight_init(generator, (d, 4 * h), d, 4 * h),
            # left/right child hidden -> [i, o, u, f_left, f_right]
            "wh_l": self.weight_init(generator, (h, 5 * h), h, 5 * h),
            "wh_r": self.weight_init(generator, (h, 5 * h), h, 5 * h),
            "bias": torch.zeros((4 * h,), dtype=torch.float32),
        }, {}

    def _apply_params(self, params, state, inp, training, rng):
        x, children = (inp.to_list() if isinstance(inp, Table) else list(inp))[:2]
        n, m, _ = x.shape
        h = self.hidden_size
        children = torch.as_tensor(children, device=x.device).to(torch.int64)
        if tuple(children.shape[:2]) != (n, m):
            # a mismatched encoding would gather out of bounds: fail loudly
            raise ValueError(f"children {tuple(children.shape[:2])} does not match x slots "
                             f"{(n, m)}")
        x_proj = precision.einsum("nmd,dk->nmk", x, params["wx"]) + params["bias"]
        # slot 0: the frozen zero state (padding, missing children)
        hbuf = x_proj.new_zeros((n, m + 1, h))
        cbuf = x_proj.new_zeros((n, m + 1, h))
        slots = torch.arange(m + 1, device=x.device)[None, :, None]

        def gather(buf, idx):
            return torch.gather(buf, 1, idx[:, None, None].expand(n, 1, h))[:, 0]

        for slot in range(m):
            li, ri = children[:, slot, 0], children[:, slot, 1]
            hl, hr = gather(hbuf, li), gather(hbuf, ri)
            cl, cr = gather(cbuf, li), gather(cbuf, ri)
            zl = precision.einsum("nh,hk->nk", hl, params["wh_l"])
            zr = precision.einsum("nh,hk->nk", hr, params["wh_r"])
            z = x_proj[:, slot]
            i = torch.sigmoid(z[:, :h] + zl[:, :h] + zr[:, :h])
            o = torch.sigmoid(z[:, h:2 * h] + zl[:, h:2 * h] + zr[:, h:2 * h])
            u = torch.tanh(z[:, 2 * h:3 * h] + zl[:, 2 * h:3 * h] + zr[:, 2 * h:3 * h])
            fl = torch.sigmoid(z[:, 3 * h:] + zl[:, 3 * h:4 * h] + zr[:, 4 * h:])
            fr = torch.sigmoid(z[:, 3 * h:] + zl[:, 4 * h:] + zr[:, 3 * h:4 * h])
            c = i * u + fl * cl + fr * cr
            hh = o * torch.tanh(c)
            at = slots == slot + 1
            hbuf = torch.where(at, hh[:, None], hbuf)
            cbuf = torch.where(at, c[:, None], cbuf)
        return hbuf[:, 1:], state


def encode_tree(children_lists, max_nodes: int) -> np.ndarray:
    """Per-node (left, right) pairs (topological order, 0-based, -1 for
    none) as one padded 1-based encoding row for :class:`BinaryTreeLSTM`."""
    out = np.zeros((max_nodes, 2), np.int32)
    for i, (left, right) in enumerate(children_lists):
        out[i, 0] = left + 1 if left >= 0 else 0
        out[i, 1] = right + 1 if right >= 0 else 0
    return out
