"""Weight regularizers (counterpart of ``bigdl_tpu/optim/regularizer.py``;
reference: ``$DL/optim/Regularizer.scala``: ``L1Regularizer``,
``L2Regularizer``, ``L1L2Regularizer``).

A regularizer is a penalty function of one weight tensor. The layers that
take one (``Linear`` and ``SparseLinear``, ``SpatialConvolution``,
``LookupTable``, ``LSTM``) sum theirs in ``regularization_loss(params)``,
containers sum their children's (``regularization_loss_tree``) and
``LocalOptimizer`` adds the total to the training loss, so autograd gives
the penalty's gradient (the reference adds d(penalty)/dw inside
``accGradParameters``: the same gradient).
"""

from __future__ import annotations

import torch


class Regularizer:
    def __call__(self, w: torch.Tensor):
        raise NotImplementedError


class L1L2Regularizer(Regularizer):
    """``l1·Σ|w| + 0.5·l2·Σw²``; a zero coefficient drops its term, and
    both zero give the Python float 0.0, as in the JAX package. ``|w|`` has
    the JAX package's gradient, +1 at w = 0 (``jnp.abs``'s), where
    ``torch.abs``'s is 0: a zero-initialised bias under an L1 term moves
    as it does in the JAX package."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1, self.l2 = l1, l2

    def __call__(self, w):
        loss = 0.0
        if self.l1:
            loss = loss + self.l1 * torch.sum(torch.where(w >= 0, w, -w))
        if self.l2:
            loss = loss + 0.5 * self.l2 * torch.sum(w * w)
        return loss


class L1Regularizer(L1L2Regularizer):
    def __init__(self, l1: float):
        super().__init__(l1=l1)


class L2Regularizer(L1L2Regularizer):
    def __init__(self, l2: float):
        super().__init__(l2=l2)
