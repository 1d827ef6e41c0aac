"""Batched inference (counterpart of ``bigdl_tpu/optim/predictor.py``'s
``Predictor`` and ``Evaluator``).

Every dispatch runs the model at ONE fixed batch size: a short batch is
padded by repeating row 0 and the outputs are sliced back to the real rows
(a batch holding a ``SparseTensor``, which cannot be row-padded, runs at its
own rows).
``shape_buckets`` zero-pads variable-length records (pad id 0, the
framework's masking convention) up to the smallest bucket that fits, so a
sweep over mixed lengths sees one geometry per bucket. Forwards run under
``torch.inference_mode()`` on the model's device; ``forward_batch`` leaves
its outputs there, and the caller decides where to copy them to the host.

``capture_state=True`` keeps each forward's new model state (still on the
device) as ``last_state``: the rows the activation-drift hooks write come
out through it (``obs/health.py`` ``ActivationDrift``). The artifact seam
(``aot_key``, ``install_aot_call``, ``aot_coverage``) records the input
geometries a verified bundle covers (``serving/artifacts.py``); the port
runs eagerly, so a covered geometry dispatches as any other.
:class:`PredictionService` serves one model to many threads.

``Evaluator(model).evaluate(dataset, methods)`` folds each validation
method's ``(numerator, count)`` over an eval sweep with ``+``: the first
batch fixes the batch size, a shorter last batch goes through the same
padded forward (:func:`forward_padded`) and its output rows are sliced back
to the real ones before the metrics, whose targets are never padded: the
sweep of ``LocalOptimizer``'s validation (``local_optimizer.validate``).
Each call runs its own methods, so same-named methods with other parameters
(``HitRatio(k=5)`` and ``k=10``) never share a step. ``Evaluator(model,
batch_size)`` takes the JAX package's ``batch_size``, which sizes its
predictor: the sweep runs the dataset's batches in both packages. Under a
process group (``Engine.init_distributed``) the sweep is sharded: each
rank forwards its rows of each padded batch and the counters are summed
over the ranks, so every rank holds the single-process result.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..dataset.dataset import AbstractDataSet, pad_rows, rows_of, to_device
from ..tensor.sparse import SparseTensor
from ..utils.table import Table
from .validation import ValidationMethod, ValidationResult


def forward_padded(model, params, state, x, rows: int, with_state: bool = False):
    """Eval-mode forward of ``x`` padded to ``rows`` rows by repeating row 0
    (on ``x``'s device); the output's real rows (and the new state, with
    ``with_state``). A batch holding a ``SparseTensor`` is not row-padded: a
    short one runs at its own rows."""
    n = rows_of(x)
    if n > rows:
        raise ValueError(f"batch of {n} rows exceeds the fixed batch size {rows}")
    padded = x if n == rows else pad_rows(x, n, rows)
    with torch.inference_mode():
        y, new_state = model.apply(params, state, x if padded is None else padded,
                                   training=False, rng=None)
        return (y[:n], new_state) if with_state else y[:n]


def _slice_rows(x, lo: int, hi: int):
    """Rows [lo, hi) of a batch: each dense leaf's leading dim, a
    ``SparseTensor``'s entries in those rows (renumbered from 0)."""
    if isinstance(x, Table):
        return Table({k: _slice_rows(v, lo, hi) for k, v in x.items()})
    if isinstance(x, SparseTensor):
        keep = (x.row_indices >= lo) & (x.row_indices < hi)
        return SparseTensor(x.row_indices[keep] - lo, x.col_indices[keep], x.values[keep],
                            (min(hi, x.shape[0]) - lo, x.shape[1]))
    return x[lo:hi]


class Predictor:
    """Fixed-batch inference over one model."""

    def __init__(self, model, batch_size: Optional[int] = None,
                 shape_buckets: Optional[Sequence[int]] = None, capture_state: bool = False):
        self.model = model
        self.capture_state = bool(capture_state)
        self.last_state = None  # the last forward's new state (capture_state)
        self._aot: Dict[tuple, Any] = {}  # input geometry -> bundle signature
        self.batch_size = int(32 if batch_size is None else batch_size)
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if shape_buckets is not None:
            b = [int(x) for x in shape_buckets]
            if not b or b != sorted(set(b)):
                raise ValueError(
                    f"shape_buckets must be ascending and unique, got {shape_buckets}")
            shape_buckets = tuple(b)
        self.shape_buckets = shape_buckets

    def forward_batch(self, x) -> torch.Tensor:
        """Forward one batch of AT MOST ``batch_size`` rows (padded to the
        fixed size); returns the real rows, still on the device."""
        x = to_device(x, self.model.device)
        self.model._ensure_built(x)
        out = forward_padded(self.model, self.model.get_parameters(), self.model.get_state(),
                             x, self.batch_size, with_state=self.capture_state)
        if not self.capture_state:
            return out
        y, self.last_state = out  # on the device: no copy here
        return y

    # ------------------------------------------------------- artifact seam
    @staticmethod
    def aot_key(x) -> tuple:
        """Shape/dtype signature of a padded input batch (tensors, arrays or
        specs with ``.shape`` and ``.dtype``): the key a bundle's module is
        installed under."""
        leaves = list(x.values()) if isinstance(x, dict) else (
            list(x) if isinstance(x, (list, tuple)) and not hasattr(x, "shape") else [x])
        return tuple((tuple(a.shape), str(a.dtype).replace("torch.", "")) for a in leaves)

    def install_aot_call(self, key: tuple, exported) -> None:
        """Record that a verified bundle covers the padded geometry ``key``
        (``exported``: its :class:`~bigdl_tpu_torch.utils.aot.ExportedSignature`).
        The port has no per-shape program: the covered geometry dispatches
        through the same eager forward, whose kernels the bundle's library
        serves."""
        self._aot[key] = exported

    def aot_coverage(self) -> int:
        return len(self._aot)

    # ----------------------------------------------------- shape bucketing
    def bucket_of(self, length: int) -> int:
        """Smallest shape bucket that fits a length-``length`` record."""
        if self.shape_buckets is None:
            raise ValueError("predictor has no shape_buckets")
        for b in self.shape_buckets:
            if length <= b:
                return b
        raise ValueError(f"record length {length} > largest shape bucket "
                         f"{self.shape_buckets[-1]}; extend shape_buckets")

    @staticmethod
    def pad_record(feat: np.ndarray, bucket: int) -> np.ndarray:
        """Zero-pad one record's leading dim up to ``bucket``."""
        return np.pad(feat, [(0, bucket - feat.shape[0])] + [(0, 0)] * (feat.ndim - 1))

    def _predict_bucketed(self, feats: List[np.ndarray]) -> torch.Tensor:
        """Pad each record to its bucket, batch per bucket, restore order."""
        buckets: Dict[int, List[int]] = {}
        for i, f in enumerate(feats):
            buckets.setdefault(self.bucket_of(f.shape[0]), []).append(i)
        out: List[Optional[torch.Tensor]] = [None] * len(feats)
        bs = self.batch_size
        for b in sorted(buckets):
            idx = buckets[b]
            padded = np.stack([self.pad_record(feats[i], b) for i in idx])
            for s in range(0, len(idx), bs):
                y = self.forward_batch(padded[s:s + bs]).cpu()
                for row, i in enumerate(idx[s:s + bs]):
                    out[i] = y[row]
        try:
            return torch.stack(out)
        except RuntimeError as e:
            raise ValueError(
                "bucketed predict outputs differ in shape across buckets — "
                "shape_buckets needs a model whose per-record output shape "
                "is length-independent") from e

    def _chunks(self, data):
        """Input chunks of at most ``batch_size`` rows over a dataset's eval
        batches (re-chunked), a ``Table`` of columns or an array."""
        bs = self.batch_size
        if isinstance(data, AbstractDataSet):
            for batch in data.data(train=False):
                x = batch.get_input()
                for i in range(0, batch.size(), bs):
                    yield _slice_rows(x, i, i + bs)
            return
        x = data if isinstance(data, Table) else np.asarray(data)
        for i in range(0, rows_of(x), bs):
            yield _slice_rows(x, i, i + bs)

    def predict(self, data) -> torch.Tensor:
        """Forward every record of a dataset, an array or a list of records;
        returns the stacked outputs on the host."""
        if self.shape_buckets is not None and isinstance(data, (list, tuple)):
            feats = [np.asarray(r) for r in data]
            if len({f.shape[0] for f in feats}) > 1:
                return self._predict_bucketed(feats)
        return torch.cat([self.forward_batch(x).cpu() for x in self._chunks(data)], dim=0)

    def predict_class(self, data) -> torch.Tensor:
        """Argmax class per record, 1-based like the reference's Torch
        convention (``predictClass``)."""
        return torch.argmax(self.predict(data), dim=-1) + 1


class Evaluator:
    """``model.evaluate(dataset, methods)`` (counterpart of the JAX package's
    ``Evaluator``): one eval-mode sweep folding each method's counters with
    ``+`` (see the module docstring)."""

    def __init__(self, model, batch_size: Optional[int] = None):
        # batch_size sizes the JAX package's predictor; the sweep runs the
        # dataset's batches in both packages
        self.model = model

    def evaluate(self, dataset, methods: Sequence[ValidationMethod]
                 ) -> Dict[str, ValidationResult]:
        from .local_optimizer import validate

        if not methods:
            raise ValueError("evaluate(dataset) needs validation methods, e.g. [Top1Accuracy()]")
        if not isinstance(dataset, AbstractDataSet):
            raise TypeError("Evaluator.evaluate expects an AbstractDataSet")
        model = self.model
        if not model.is_built():
            first = next(iter(dataset.data(train=False)), None)
            if first is None:
                return {}
            model._ensure_built(first.get_input())
        return validate(model, model.get_parameters(), model.get_state(), dataset, list(methods))


class PredictionService:
    """Thread-safe local serving (reference: ``$DL/optim/PredictionService.scala``,
    a pool of model clones): one :class:`Predictor` serves every thread,
    since a forward under ``torch.inference_mode()`` shares no state between
    calls; the lock guards only the lazy build. ``pool_size`` is kept for the
    JAX package's signature."""

    def __init__(self, model, pool_size: int = 1):
        self.pool_size = pool_size
        self._predictor = Predictor(model)
        self._lock = threading.Lock()

    def predict(self, x, single: bool = False) -> torch.Tensor:
        """Outputs on the host; ``single=True`` takes ``x`` as one record
        (adds and strips the batch dim)."""
        arr = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        batched = arr[None] if single else arr
        with self._lock:
            model = self._predictor.model
            model._ensure_built(to_device(batched[:1], model.device))
        out = self._predictor.predict(batched)
        return out[0] if single else out
