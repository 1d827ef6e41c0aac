"""Compressed gradient exchange with error feedback for the flat layout
(counterpart of ``bigdl_tpu/parallel/compression.py``; reference: the fp16
``CompressedTensor`` wire of ``AllReduceParameter``).

The ``comms_dtype`` policy narrows the flat gradient before the exchange
and widens it into the float32 update:

* ``bfloat16``: a plain cast; the reduce-scatter (or the mean) runs on the
  bf16 operands and sums in bf16;
* ``int8`` / ``float8``: per-segment symmetric scales from one segment-wise
  amax over ``FlatParameter.segment_ids()``, ``pmax`` -shared so every rank
  quantizes against the same scales; the codes cross as an
  ``all_to_all`` (the reduce-scatter shape) or an ``all_gather`` (the
  replicated shape) and are summed in float32 after dequantizing (a sum in
  the wire dtype would overflow int8 and saturate float8).

Error feedback (EF-SGD): each rank carries ``e <- (g + e) -
dequant(quant(g + e))``, what its quantizer did not send this step, and
adds it back the next step; the residual has the padded master's geometry
and its padding tail is re-zeroed. The quantizer's health statistics of the
JAX package are not ported (nor is its health monitor).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..optim.quantization import (LowPrecisionPolicy, quant_range_max, scales_from_amax,
                                  segment_amax)
from . import _comm

__all__ = ["GradCompressor"]


class GradCompressor:
    """One codec-bound compressed exchange, shared by the ZeRO-1 step, the
    replicated flat step and the local flat step."""

    def __init__(self, fp, policy: LowPrecisionPolicy):
        if policy.comms_dtype is None:
            raise ValueError("GradCompressor needs a comms_dtype policy")
        self.fp = fp
        self.policy = policy
        self.dtype = policy.comms_dtype
        self.cast_only = self.dtype == torch.bfloat16
        self.qmax = None if self.cast_only else quant_range_max(self.dtype)
        self.error_feedback = policy.error_feedback
        self.n_rows = len(fp.sizes) + 1  # + the padding tail's segment

    def init_residual(self, device) -> torch.Tensor:
        """This rank's zero error-feedback residual (the padded geometry)."""
        return torch.zeros(self.fp.padded_total, dtype=torch.float32, device=device)

    # ------------------------------------------------------------- pieces
    def _carry_in(self, flat_g: torch.Tensor, err: Optional[torch.Tensor]) -> torch.Tensor:
        g32 = flat_g.float()
        return g32 if err is None else g32 + err

    def _quantize(self, g_work: torch.Tensor, shared: bool):
        """float32 working gradient -> (codes, per-element scale or None);
        ``shared`` takes the scales' max over the ranks."""
        if self.cast_only:
            return g_work.to(self.dtype), None
        seg = self.fp.segment_ids_on(g_work.device)
        amax = segment_amax(g_work, seg, self.n_rows)
        if shared:
            _comm.pmax_(amax)
        scale_elem = scales_from_amax(amax, self.qmax)[seg]
        y = g_work / scale_elem
        if self.dtype == torch.int8:
            q = torch.clamp(torch.round(y), -self.qmax, self.qmax).to(self.dtype)
        else:  # float8: round to nearest
            q = y.to(self.dtype)
        return q, scale_elem

    @staticmethod
    def _dequant(q: torch.Tensor, scale_elem) -> torch.Tensor:
        deq = q.float()
        return deq if scale_elem is None else deq * scale_elem

    def _residual_out(self, g_work, q, scale_elem) -> Optional[torch.Tensor]:
        if not self.error_feedback:
            return None
        return self.fp.zero_pad(g_work - self._dequant(q, scale_elem))

    # ----------------------------------------------------------- exchanges
    def exchange_sharded(self, flat_g, err, n: int, me: int
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Reduce-scatter shape: the local flat gradient in, this rank's
        SUMMED float32 shard out (the caller divides by ``n``); returns
        ``(shard sum, new residual)``."""
        g_work = self._carry_in(flat_g, err)
        q, scale_elem = self._quantize(g_work, shared=True)
        if self.cast_only:
            shard_sum = _comm.psum_scatter(q).float()
        else:
            k = self.fp.shard_size
            recv = _comm.all_to_all(q).view(n, k).float()
            shard_sum = recv.sum(0) * scale_elem[me * k:(me + 1) * k]
        return shard_sum, self._residual_out(g_work, q, scale_elem)

    def exchange_replicated(self, flat_g, err, n: int
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """All-reduce shape: the local flat gradient in, the MEAN float32
        gradient out; returns ``(mean, new residual)``."""
        g_work = self._carry_in(flat_g, err)
        q, scale_elem = self._quantize(g_work, shared=True)
        if self.cast_only:
            g_mean = _comm.pmean_(q.clone() if q is flat_g else q).float()
        else:
            recv = _comm.all_gather_stack(q).float()
            g_mean = recv.sum(0) * scale_elem / n
        return g_mean, self._residual_out(g_work, q, scale_elem)

    def exchange_local(self, flat_g, err) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One device (``flat_update=True`` ``LocalOptimizer``): no
        collective, the gradient still through quantize -> dequantize with
        error feedback, the distributed wire's numerics."""
        g_work = self._carry_in(flat_g, err)
        q, scale_elem = self._quantize(g_work, shared=False)
        return self._dequant(q, scale_elem), self._residual_out(g_work, q, scale_elem)
