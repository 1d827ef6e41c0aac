"""Validation methods and results (counterpart of
``bigdl_tpu/optim/validation.py``: ``Top1Accuracy``, ``Top5Accuracy``,
``Loss``, ``MAE``, ``HitRatio``, ``NDCG``, ``TreeNNAccuracy``; results merge
with ``+``).

``metric(output, target) -> (numerator, count)`` runs on torch tensors on
the output's device: the numerator is a 0-d tensor there and the count a
Python int taken from the shapes, so a batch hands the host two scalars per
method and nothing else. ``make_result`` and the results' ``+`` merging are
the JAX package's host-side API.

Ties are decided as the JAX package decides them: ``Top1Accuracy`` takes the
first maximum (``torch.argmax``, like ``jnp.argmax``); ``Top5Accuracy``
takes the last five positions of a stable ascending sort (``jnp.argsort``),
so among equal scores the higher class indices are in the top five.
Targets are used as given (0-based, no shift).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..dataset.dataset import to_device


class ValidationResult:
    def result(self) -> Tuple[float, int]:
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError


class AccuracyResult(ValidationResult):
    def __init__(self, correct: float, count: int, name: str = "Accuracy"):
        self.correct = float(correct)
        self.count = int(count)
        self.name = name

    def result(self):
        return (self.correct / max(1, self.count), self.count)

    def __add__(self, other):
        return AccuracyResult(self.correct + other.correct, self.count + other.count, self.name)

    def __repr__(self):
        v, n = self.result()
        return f"{self.name}: {v:.4f} ({int(self.correct)}/{n})"


class LossResult(ValidationResult):
    def __init__(self, loss_sum: float, count: int, name: str = "Loss"):
        self.loss_sum = float(loss_sum)
        self.count = int(count)
        self.name = name

    def result(self):
        return (self.loss_sum / max(1, self.count), self.count)

    def __add__(self, other):
        return LossResult(self.loss_sum + other.loss_sum, self.count + other.count, self.name)

    def __repr__(self):
        v, n = self.result()
        return f"{self.name}: {v:.4f} (n={n})"


class ValidationMethod:
    name = "ValidationMethod"

    def metric(self, output: torch.Tensor, target: torch.Tensor):
        """``(numerator, count)``: a 0-d tensor on the output's device and an int."""
        raise NotImplementedError

    def make_result(self, numerator: float, count: int) -> ValidationResult:
        return AccuracyResult(numerator, count, self.name)

    def __call__(self, output, target) -> ValidationResult:
        output = to_device(output)
        num, cnt = self.metric(output, to_device(target, output.device))
        return self.make_result(float(num), int(cnt))

    def __repr__(self):
        return self.name


class Top1Accuracy(ValidationMethod):
    name = "Top1Accuracy"

    def metric(self, output, target):
        pred = torch.argmax(output, dim=-1)
        t = target.to(torch.int64).reshape(pred.shape)
        return torch.sum(pred == t).to(torch.float32), t.numel()


class Top5Accuracy(ValidationMethod):
    name = "Top5Accuracy"

    def metric(self, output, target):
        top5 = torch.sort(output, dim=-1, stable=True).indices[..., -5:]
        t = target.to(torch.int64).reshape(output.shape[0], 1)
        return torch.sum(torch.any(top5 == t, dim=-1)).to(torch.float32), output.shape[0]


class Loss(ValidationMethod):
    """The criterion's loss times the batch's rows, so that the merged
    result is the mean over records."""

    name = "Loss"

    def __init__(self, criterion):
        self.criterion = criterion

    def metric(self, output, target):
        n = output.shape[0]
        return self.criterion._apply(output, target) * n, n

    def make_result(self, numerator, count):
        return LossResult(numerator, count, self.name)


class MAE(ValidationMethod):
    name = "MAE"

    def metric(self, output, target):
        n = output.shape[0]
        return torch.mean(torch.abs(output - target)) * n, n

    def make_result(self, numerator, count):
        return LossResult(numerator, count, self.name)


def _rank_of_positive(output, neg_num: int) -> torch.Tensor:
    """Each row's rank of its column 0 among (1 positive + ``neg_num``
    negatives) scores: 1 + the negatives scored strictly higher."""
    scores = output.reshape(-1, neg_num + 1)
    return torch.sum(scores[:, 1:] > scores[:, 0:1], dim=-1) + 1


class HitRatio(ValidationMethod):
    """HR@k for recommendation: output holds the scores of (1 positive +
    ``neg_num`` negatives) per row, the positive first."""

    name = "HitRatio"

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k
        self.neg_num = neg_num

    def metric(self, output, target):
        rank = _rank_of_positive(output, self.neg_num)
        return torch.sum(rank <= self.k).to(torch.float32), rank.shape[0]


class NDCG(ValidationMethod):
    name = "NDCG"

    def __init__(self, k: int = 10, neg_num: int = 100):
        self.k = k
        self.neg_num = neg_num

    def metric(self, output, target):
        rank = _rank_of_positive(output, self.neg_num)
        gain = torch.where(rank <= self.k, 1.0 / torch.log2(rank.to(torch.float32) + 1), 0.0)
        return torch.sum(gain), rank.shape[0]


class TreeNNAccuracy(ValidationMethod):
    """Top-1 accuracy of the tree's root node: output is (N, nNodes,
    nClasses) per-node scores, of which only node 0 is scored."""

    name = "TreeNNAccuracy"

    def metric(self, output, target):
        root = output[:, 0] if output.dim() == 3 else output
        pred = torch.argmax(root, dim=-1)
        t = target.to(torch.int64).reshape(pred.shape)
        return torch.sum(pred == t).to(torch.float32), t.numel()
