"""Batched inference (counterpart of ``bigdl_tpu/optim/predictor.py``'s
``Predictor``).

Every dispatch runs the model at ONE fixed batch size: a short batch is
padded by repeating row 0 and the outputs are sliced back to the real rows.
``shape_buckets`` zero-pads variable-length records (pad id 0, the
framework's masking convention) up to the smallest bucket that fits, so a
sweep over mixed lengths sees one geometry per bucket. Forwards run under
``torch.inference_mode()`` on the model's device; ``forward_batch`` leaves
its outputs there, and the caller decides where to copy them to the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _pad_batch(x: torch.Tensor, n: int, total: int) -> torch.Tensor:
    """Pad the leading dim from n to total by repeating row 0."""
    if n == total:
        return x
    return torch.cat([x, x[:1].expand((total - n,) + tuple(x.shape[1:]))], dim=0)


class Predictor:
    """Fixed-batch inference over one model."""

    def __init__(self, model, batch_size: Optional[int] = None,
                 shape_buckets: Optional[Sequence[int]] = None):
        self.model = model
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

    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return torch.as_tensor(x).to(self.model.device)

    def _forward_padded(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if n > self.batch_size:
            raise ValueError(f"batch of {n} rows exceeds the predictor's fixed "
                             f"batch_size {self.batch_size}")
        xp = _pad_batch(x, n, self.batch_size)
        with torch.inference_mode():
            y, _ = self.model.apply(self.model.get_parameters(),
                                    self.model.get_state(), xp,
                                    training=False, rng=None)
            return y[:n]

    def forward_batch(self, x) -> torch.Tensor:
        """Forward one batch of AT MOST ``batch_size`` rows (padded to the
        fixed size); returns the real rows, still on the device."""
        x = self._to_device(x)
        self.model._ensure_built(x)
        return self._forward_padded(x)

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

    def predict(self, data) -> torch.Tensor:
        """Forward every record of an array (or a list of records); returns
        the stacked outputs on the host."""
        if self.shape_buckets is not None and isinstance(data, (list, tuple)):
            feats = [np.asarray(r) for r in data]
            if len({f.shape[0] for f in feats}) > 1:
                return self._predict_bucketed(feats)
        arr = np.asarray(data)
        outs = [self.forward_batch(arr[i:i + self.batch_size]).cpu()
                for i in range(0, arr.shape[0], self.batch_size)]
        return torch.cat(outs, dim=0)
