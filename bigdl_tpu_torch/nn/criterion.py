"""Criterions (losses) of the port: counterpart of the LM-training part of
``bigdl_tpu/nn/criterion.py`` (``ClassNLLCriterion``,
``CrossEntropyCriterion``, ``TimeDistributedCriterion``).

``forward(input, target) -> loss`` (a 0-d tensor that autograd can
differentiate), ``backward(input, target) -> grad_input``; ``size_average``
means a mean over the (weighted) rows, ``False`` a sum. Labels are 0-based
unless ``one_based_label=True`` (Torch's 1-based convention). Targets may be
numpy arrays or tensors; an (N, T) target against (N, T, C) scores is
flattened with them, as the language model passes it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import precision


def _as_target(target, device) -> torch.Tensor:
    if isinstance(target, np.ndarray):
        target = torch.from_numpy(target)
    return torch.as_tensor(target, device=device)


class AbstractCriterion:
    """Loss base: ``forward(input, target) -> loss``, ``backward -> grad_input``."""

    def __init__(self):
        self.output = None
        self.grad_input = None

    def _apply(self, input, target) -> torch.Tensor:  # the scalar loss
        raise NotImplementedError

    def unreduced(self, input, target):
        """Per-row loss decomposition ``(per, denom)`` with the loss equal to
        ``sum(per) / max(sum(denom), eps)`` under ``size_average`` and to
        ``sum(per)`` otherwise, or ``None`` when the criterion has no
        row-wise form."""
        return None

    def supports_unreduced(self) -> bool:
        return type(self).unreduced is not AbstractCriterion.unreduced

    def forward(self, input, target) -> torch.Tensor:
        self.output = self._apply(input, target)
        return self.output

    def __call__(self, input, target) -> torch.Tensor:
        return self.forward(input, target)

    def backward(self, input, target) -> torch.Tensor:
        x = input.detach().requires_grad_(True)
        with torch.enable_grad():
            (self.grad_input,) = torch.autograd.grad(self._apply(x, target), x)
        return self.grad_input


class ClassNLLCriterion(AbstractCriterion):
    """NLL over log-probabilities (``log_prob_as_input=False`` takes
    probabilities). ``weights`` is per class; targets equal to
    ``padding_value`` add nothing (weight 0). The loss head is fp32. An
    out-of-range label gives a NaN loss instead of an exception, as in the
    JAX package (where it cannot raise under jit)."""

    def __init__(self, weights=None, size_average: bool = True,
                 log_prob_as_input: bool = True, one_based_label: bool = False,
                 padding_value: Optional[int] = None):
        super().__init__()
        self.weights = None if weights is None else torch.as_tensor(
            np.asarray(weights, np.float32))
        self.size_average = size_average
        self.log_prob_as_input = log_prob_as_input
        self.one_based_label = one_based_label
        self.padding_value = padding_value

    def unreduced(self, input, target):
        input = precision.to_float(input)
        logp = input if self.log_prob_as_input else torch.log(torch.clamp(input, min=1e-8))
        target = _as_target(target, logp.device).reshape(-1).to(torch.int64)
        idx = target - 1 if self.one_based_label else target
        logp = logp.reshape(-1, logp.shape[-1])
        n_classes = logp.shape[-1]
        safe_idx = torch.clamp(idx, 0, n_classes - 1)
        per = -torch.gather(logp, 1, safe_idx[:, None])[:, 0]
        w = (torch.ones_like(per) if self.weights is None
             else self.weights.to(per.device)[safe_idx])
        if self.padding_value is not None:
            padded = target == self.padding_value
            w = torch.where(padded, 0.0, w)
        else:
            padded = torch.zeros_like(target, dtype=torch.bool)
        invalid = ~padded & ((idx < 0) | (idx >= n_classes))
        per = torch.where(invalid, float("nan"), per * w)
        return per, w

    def _apply(self, input, target) -> torch.Tensor:
        per, w = self.unreduced(input, target)
        if self.size_average:
            return torch.sum(per) / torch.clamp(torch.sum(w), min=1e-8)
        return torch.sum(per)


class CrossEntropyCriterion(AbstractCriterion):
    """LogSoftMax + ClassNLL. ``label_smoothing`` ε mixes the one-hot target
    with the uniform distribution: ``(1-ε)·NLL + ε·mean_c(-log p_c)``."""

    def __init__(self, weights=None, size_average: bool = True,
                 one_based_label: bool = False, label_smoothing: float = 0.0):
        super().__init__()
        self.label_smoothing = float(label_smoothing)
        self._nll = ClassNLLCriterion(weights=weights, size_average=size_average,
                                      one_based_label=one_based_label)

    @property
    def size_average(self) -> bool:
        return self._nll.size_average

    def supports_unreduced(self) -> bool:
        return not (self.label_smoothing != 0.0 and self._nll.weights is not None)

    def unreduced(self, input, target):
        eps = self.label_smoothing
        if eps != 0.0 and self._nll.weights is not None:
            # the uniform term is an unweighted row mean while the NLL term is
            # divided by the sum of class weights: no single (per, denom) pair
            return None
        logp = torch.log_softmax(precision.to_float(input), dim=-1)
        per, w = self._nll.unreduced(logp, target)
        if eps == 0.0:
            return per, w
        uniform = -torch.mean(logp.reshape(-1, logp.shape[-1]), dim=-1)
        return (1.0 - eps) * per + eps * uniform, w

    def _apply(self, input, target) -> torch.Tensor:
        logp = torch.log_softmax(precision.to_float(input), dim=-1)
        nll = self._nll._apply(logp, target)
        eps = self.label_smoothing
        if eps == 0.0:
            return nll
        uniform = -torch.mean(logp, dim=-1)
        uniform = torch.mean(uniform) if self._nll.size_average else torch.sum(uniform)
        return (1.0 - eps) * nll + eps * uniform


class TimeDistributedCriterion(AbstractCriterion):
    """The inner criterion applied at each time step of (N, T, ...) scores
    against (N, T, ...) targets; the steps' losses summed, and divided by T
    with ``size_average`` (reference: TimeDistributedCriterion.scala).
    ``dimension`` is accepted and, as in the JAX package, the time dim is 1.

    The JAX package loops over T in Python, which its jit compiles away. An
    eager loop would launch a few kernels per step, so an inner criterion
    with a row-wise form (``unreduced``) is reduced in one call instead:
    each step over N as the inner criterion reduces it (the weighted sum
    over the weight sum with its ``size_average``, else the sum), then the
    steps summed in order. Other inner criteria run the loop."""

    def __init__(self, criterion: AbstractCriterion, size_average: bool = False,
                 dimension: int = 2):
        super().__init__()
        self.criterion = criterion
        self.size_average = size_average
        self.dimension = dimension

    def _steps(self, input, target) -> Optional[torch.Tensor]:
        """The (T,) per-step losses in one call, or None without a row-wise form."""
        inner = self.criterion
        dec = inner.unreduced(input, target)
        if dec is None:
            return None
        n, t = input.shape[:2]
        per, w = (a.reshape(n, t) for a in dec)
        if inner.size_average:
            return per.sum(0) / torch.clamp(w.sum(0), min=1e-8)
        return per.sum(0)

    def _apply(self, input, target) -> torch.Tensor:
        t_steps = input.shape[1]
        steps = self._steps(input, target)
        if steps is not None:
            total = torch.cumsum(steps, 0)[-1]  # the steps added in order, as the loop adds them
        else:
            target = _as_target(target, input.device)
            total = 0.0
            for t in range(t_steps):
                total = total + self.criterion._apply(input[:, t], target[:, t])
        return total / t_steps if self.size_average else total
