"""Criterions (losses) of the port: counterpart of
``bigdl_tpu/nn/criterion.py`` (reference: ``$DL/nn/abstractnn/
AbstractCriterion.scala`` and one file per criterion under ``$DL/nn/``).

``forward(input, target) -> loss`` (a 0-d tensor that autograd can
differentiate), ``backward(input, target) -> grad_input`` (a ``Table`` of
gradients for a ``Table`` input); ``size_average`` means a mean over the
(weighted) rows, ``False`` a sum. Labels are 0-based unless
``one_based_label=True`` (Torch's 1-based convention);
``MultiLabelMarginCriterion``'s and ``ClassSimplexCriterion``'s targets are
1-based, as in the JAX package. Targets may be numpy arrays or tensors; an
(N, T) target against (N, T, C) scores is flattened with them, as the
language model passes it. A two-input criterion reads ``input[1]`` and
``input[2]`` of a ``Table``, ``input[0]`` and ``input[1]`` of a list.

Each loss is the JAX package's expression: ``BCECriterion`` is
``log(p + 1e-12)`` (``F.binary_cross_entropy`` clamps the log at -100
instead), ``DistKLDivCriterion`` divides by the batch, not by the element
count, and ``jnp.maximum``'s half gradient at a tie and ``jnp.abs``'s
gradient of 1 at 0 are kept (``torch.maximum``, not ``relu``; not
``torch.abs``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..utils import precision
from ..utils.table import T, Table
from .math_ops import _abs, _clip_min, _norm, _relu


def _as_target(target, device) -> torch.Tensor:
    if isinstance(target, np.ndarray):
        target = torch.from_numpy(target)
    return torch.as_tensor(target, device=device)


def _float_target(target, device) -> torch.Tensor:
    """A regression target as a tensor; float64 becomes float32, as the JAX
    package's arrays are without x64."""
    t = _as_target(target, device)
    return t.float() if t.dtype == torch.float64 else t


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

    def backward(self, input, target):
        if isinstance(input, (Table, list, tuple)):
            xs = [v.detach().requires_grad_(True) for v in _entries(input)]
            x = T(*xs) if isinstance(input, Table) else type(input)(xs)
        else:
            xs = [input.detach().requires_grad_(True)]
            x = xs[0]
        with torch.enable_grad():
            grads = torch.autograd.grad(self._apply(x, target), xs)
        if isinstance(input, Table):
            self.grad_input = T(*grads)
        elif isinstance(input, (list, tuple)):
            self.grad_input = type(input)(grads)
        else:
            self.grad_input = grads[0]
        return self.grad_input


def _entries(x) -> List:
    return x.to_list() if isinstance(x, Table) else list(x)


def _pair(input):
    """The two entries of a two-input criterion's input: 1-based in a
    ``Table``, 0-based in a list or tuple."""
    return (input[1], input[2]) if isinstance(input, Table) else (input[0], input[1])


def _reduce(x: torch.Tensor, size_average: bool) -> torch.Tensor:
    return torch.mean(x) if size_average else torch.sum(x)


def _weights(w) -> Optional[torch.Tensor]:
    return None if w is None else torch.as_tensor(np.asarray(w, np.float32))


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


class MSECriterion(AbstractCriterion):
    """Mean (``size_average``) or sum of the squared differences over every
    element. Its row-wise form is the squared differences with a ones
    denominator, so a padded batch's mean counts only its real rows'
    elements."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def unreduced(self, input, target):
        per = (input - _float_target(target, input.device)) ** 2
        return per, torch.ones_like(per)

    def _apply(self, input, target) -> torch.Tensor:
        per = (input - _float_target(target, input.device)) ** 2
        return torch.mean(per) if self.size_average else torch.sum(per)


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


class AbsCriterion(AbstractCriterion):
    """Mean (``size_average``) or sum of |input - target|."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def unreduced(self, input, target):
        per = _abs(input - _float_target(target, input.device))
        return per, torch.ones_like(per)

    def _apply(self, input, target) -> torch.Tensor:
        return _reduce(_abs(input - _float_target(target, input.device)),
                       self.size_average)


class SmoothL1Criterion(AbstractCriterion):
    """Huber loss with delta 1 (reference: $DL/nn/SmoothL1Criterion.scala):
    0.5·d² where |d| < 1, else |d| - 0.5."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    @staticmethod
    def _per(input, target):
        d = input - _float_target(target, input.device)
        a = _abs(d)
        return torch.where(a < 1.0, 0.5 * d * d, a - 0.5)

    def unreduced(self, input, target):
        per = self._per(input, target)
        return per, torch.ones_like(per)

    def _apply(self, input, target) -> torch.Tensor:
        return _reduce(self._per(input, target), self.size_average)


class BCECriterion(AbstractCriterion):
    """Binary cross-entropy on probabilities,
    -(t·log(p + 1e-12) + (1 - t)·log(1 - p + 1e-12)), optionally weighted
    (reference: $DL/nn/BCECriterion.scala)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = _weights(weights)
        self.size_average = size_average

    def _apply(self, input, target) -> torch.Tensor:
        t = _float_target(target, input.device)
        eps = 1e-12
        per = -(t * torch.log(input + eps) + (1 - t) * torch.log(1 - input + eps))
        if self.weights is not None:
            per = per * self.weights.to(per.device)
        return _reduce(per, self.size_average)


class BCECriterionWithLogits(AbstractCriterion):
    """Sigmoid + binary cross-entropy on logits, in the stable form
    max(x, 0) - x·t + log(1 + exp(-|x|))."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def _apply(self, input, target) -> torch.Tensor:
        t = _float_target(target, input.device)
        per = _relu(input) - input * t + torch.log1p(torch.exp(-_abs(input)))
        return _reduce(per, self.size_average)


class DistKLDivCriterion(AbstractCriterion):
    """KL(target || exp(input)) on log-probability inputs: the sum of
    t·(log t - input) where t > 0, divided by the batch (``input.shape[0]``
    for a batched input) under ``size_average``."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def _apply(self, input, target) -> torch.Tensor:
        t = _float_target(target, input.device)
        per = torch.where(t > 0, t * (torch.log(torch.clamp(t, min=1e-12)) - input), 0.0)
        n = input.shape[0] if input.dim() > 1 else 1
        return torch.sum(per) / n if self.size_average else torch.sum(per)


class MarginRankingCriterion(AbstractCriterion):
    """max(0, -y·(x1 - x2) + margin) over Table(x1, x2) and y in {1, -1}."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def _apply(self, input, target) -> torch.Tensor:
        x1, x2 = _pair(input)
        y = _float_target(target, x1.device)
        return _reduce(_relu(-y * (x1 - x2) + self.margin), self.size_average)


class HingeEmbeddingCriterion(AbstractCriterion):
    """x where y == 1, else max(0, margin - x)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def _apply(self, input, target) -> torch.Tensor:
        y = _as_target(target, input.device)
        per = torch.where(y == 1, input, _relu(self.margin - input))
        return _reduce(per, self.size_average)


class CosineEmbeddingCriterion(AbstractCriterion):
    """Over Table(x1, x2): 1 - cos where y == 1, else max(0, cos - margin);
    the cosine's denominator, the norms' product, clipped at 1e-12."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def _apply(self, input, target) -> torch.Tensor:
        x1, x2 = _pair(input)
        y = _as_target(target, x1.device).reshape(-1)
        cos = torch.sum(x1 * x2, -1) / _clip_min(_norm(x1) * _norm(x2), 1e-12)
        per = torch.where(y == 1, 1 - cos, _relu(cos - self.margin))
        return _reduce(per, self.size_average)


class MultiLabelSoftMarginCriterion(AbstractCriterion):
    """The logistic loss of every label (``BCECriterionWithLogits``' terms),
    optionally weighted, averaged over the labels of a row."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = _weights(weights)
        self.size_average = size_average

    def _apply(self, input, target) -> torch.Tensor:
        t = _float_target(target, input.device)
        per = _relu(input) - input * t + torch.log1p(torch.exp(-_abs(input)))
        if self.weights is not None:
            per = per * self.weights.to(per.device)
        return _reduce(torch.mean(per, dim=-1), self.size_average)


class L1Cost(AbstractCriterion):
    """sum |input|; the target is ignored (reference: $DL/nn/L1Cost.scala)."""

    def _apply(self, input, target) -> torch.Tensor:
        return torch.sum(_abs(input))


class ParallelCriterion(AbstractCriterion):
    """The weighted sum of criterion i on input entry i and target entry i
    (the same target for each with ``repeat_target``) (reference:
    $DL/nn/ParallelCriterion.scala)."""

    def __init__(self, repeat_target: bool = False):
        super().__init__()
        self.criterions: List[AbstractCriterion] = []
        self.crit_weights: List[float] = []
        self.repeat_target = repeat_target

    def add(self, criterion: AbstractCriterion, weight: float = 1.0) -> "ParallelCriterion":
        self.criterions.append(criterion)
        self.crit_weights.append(weight)
        return self

    def _apply(self, input, target) -> torch.Tensor:
        inputs = _entries(input)
        targets = [target] * len(inputs) if self.repeat_target else _entries(target)
        total = 0.0
        for c, w, i, t in zip(self.criterions, self.crit_weights, inputs, targets):
            total = total + w * c._apply(i, t)
        return total


class MultiCriterion(AbstractCriterion):
    """The weighted sum of several criterions over the same input and target."""

    def __init__(self):
        super().__init__()
        self.criterions: List[AbstractCriterion] = []
        self.crit_weights: List[float] = []

    def add(self, criterion: AbstractCriterion, weight: float = 1.0) -> "MultiCriterion":
        self.criterions.append(criterion)
        self.crit_weights.append(weight)
        return self

    def _apply(self, input, target) -> torch.Tensor:
        total = 0.0
        for c, w in zip(self.criterions, self.crit_weights):
            total = total + w * c._apply(input, target)
        return total


class MarginCriterion(AbstractCriterion):
    """Two-class hinge loss, max(0, margin - x·y) with y in {1, -1},
    squared with ``squared`` (L2-SVM) (reference: MarginCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True, squared: bool = False):
        super().__init__()
        self.margin = margin
        self.size_average = size_average
        self.squared = squared

    def _apply(self, input, target) -> torch.Tensor:
        t = _as_target(target, input.device).to(input.dtype).reshape(input.shape)
        per = _relu(self.margin - input * t)
        if self.squared:
            per = per ** 2
        return _reduce(per, self.size_average)


class MultiLabelMarginCriterion(AbstractCriterion):
    """Multi-class multi-label hinge loss (Torch semantics; reference:
    MultiLabelMarginCriterion.scala). A target row lists 1-based class
    indices, zero-padded at its end: only the indices before its first 0
    count. Per row: the sum over its targets j and its non-target classes i
    of max(0, 1 - (x[j] - x[i])), over the class count."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def _apply(self, input, target) -> torch.Tensor:
        t = _as_target(target, input.device).to(torch.int64)
        n, d = input.shape
        first_zero = torch.argmax(torch.cat([t == 0, torch.ones((n, 1), dtype=torch.bool,
                                                                  device=t.device)], dim=1)
                                  .to(torch.int32), dim=1)
        valid = torch.arange(t.shape[1], device=t.device)[None, :] < first_zero[:, None]
        idx0 = torch.clamp(t - 1, 0, d - 1)
        onehot = torch.nn.functional.one_hot(idx0, d).bool() & valid[..., None]
        is_target = torch.any(onehot, dim=1)  # (N, D)
        x_tgt = torch.gather(input, 1, idx0)  # (N, K)
        hinge = _relu(1.0 - (x_tgt[:, :, None] - input[:, None, :]))  # (N, K, D)
        mask = valid[:, :, None] & ~is_target[:, None, :]
        per = torch.sum(torch.where(mask, hinge, 0.0), dim=(1, 2)) / d
        return _reduce(per, self.size_average)


class DiceCoefficientCriterion(AbstractCriterion):
    """1 - (2·sum(x·y) + eps) / (sum(x) + sum(y) + eps) per sample (reference:
    DiceCoefficientCriterion.scala)."""

    def __init__(self, size_average: bool = True, epsilon: float = 1.0):
        super().__init__()
        self.size_average = size_average
        self.epsilon = epsilon

    def _apply(self, input, target) -> torch.Tensor:
        t = _as_target(target, input.device).to(input.dtype).reshape(input.shape)
        axes = tuple(range(1, input.dim()))
        inter = torch.sum(input * t, dim=axes)
        denom = torch.sum(input, dim=axes) + torch.sum(t, dim=axes)
        per = 1.0 - (2.0 * inter + self.epsilon) / (denom + self.epsilon)
        return _reduce(per, self.size_average)


def simplex_coordinates(n: int) -> torch.Tensor:
    """The vertices of a regular (n-1)-simplex in R^n, one row per class: the
    one-hot vectors centred on their mean, each row normalised (the
    reference ClassSimplexCriterion's target embedding)."""
    eye = np.eye(n, dtype=np.float32)
    verts = eye - np.mean(eye, axis=0, keepdims=True)
    return torch.from_numpy(verts / np.linalg.norm(verts, axis=1, keepdims=True))


class ClassSimplexCriterion(AbstractCriterion):
    """MSE against the regular-simplex embedding of 1-based class ids
    (reference: ClassSimplexCriterion.scala)."""

    def __init__(self, n_classes: int, size_average: bool = True):
        super().__init__()
        if n_classes < 2:
            raise ValueError("ClassSimplexCriterion needs n_classes >= 2")
        self.n_classes = n_classes
        self.size_average = size_average
        self._simplex = simplex_coordinates(n_classes)

    def _apply(self, input, target) -> torch.Tensor:
        t = _as_target(target, input.device).to(torch.int64).reshape(input.shape[0])
        goal = self._simplex.to(input.device)[torch.clamp(t - 1, 0, self.n_classes - 1)]
        return _reduce((input - goal) ** 2, self.size_average)
