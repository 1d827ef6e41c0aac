"""Normalization layers (counterpart of ``bigdl_tpu/nn/normalization.py``):
``BatchNormalization`` / ``SpatialBatchNormalization``, ``LayerNormalization``
and ``RMSNorm``.

Batch normalization is in torch ops with the JAX package's semantics, which
are not cuDNN's:

* statistics are float32 even for a bf16 input;
* training updates ``running_mean`` and ``running_var`` with momentum 0.1
  (``new = (1-m)·old + m·batch``), ``running_var`` with the UNBIASED batch
  variance, while the output uses the biased one;
* a reduced-precision input is normalized by one fp32 per-channel (scale,
  shift) folded from mean, var, γ and β and applied in the input's dtype.

The running statistics a train-mode forward returns are computed without
autograd history (detached batch statistics, under ``torch.no_grad()``):
state is never differentiated, and a state that held the step's graph would
keep every saved activation of that step alive for as long as the state
lives.

``LayerNormalization`` (eps 1e-5) and ``RMSNorm`` (eps 1e-6) normalize over
the last dim. With the fused-kernel switch off they run the JAX package's
chains op for op: LayerNorm's mean and population variance in ``x``'s
dtype, then ``· weight + bias`` (fp32 masters, so the output is fp32);
RMSNorm in fp32 with the gain applied before one cast back to ``x``'s dtype.
Under ``Engine.set_fused_kernels(True)`` they run
:func:`bigdl_tpu_torch.ops.fused_norm.fused_layer_norm` /
``fused_rms_norm`` (the CUDA kernels on the card, their plain versions on
the CPU), whose statistics are fp32 for every input dtype: for a bf16
``x`` LayerNorm's two routes differ, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.fused_common import fused_kernels_active
from ..ops.fused_norm import fused_layer_norm, fused_rms_norm
from .module import AbstractModule


class BatchNormalization(AbstractModule):
    """BN over (N, C) or (N, C, ...) with C at dim 1; ``affine`` adds the
    learnable weight (γ) and bias (β)."""

    def __init__(self, n_output: Optional[int] = None, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True, device=None):
        super().__init__(device)
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine

    def _build(self, generator, sample):
        c = sample.shape[1]
        if self.n_output is not None and self.n_output != c:
            raise ValueError(f"{self.name()}: expected {self.n_output} channels, got {c}")
        self.n_output = c
        params = {"weight": torch.ones(c), "bias": torch.zeros(c)} if self.affine else {}
        return params, {"running_mean": torch.zeros(c), "running_var": torch.ones(c)}

    def _apply_params(self, params, state, x, training, rng):
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        xf = x.float()
        if training:
            var, mean = torch.var_mean(xf, dim=dims, correction=0)
            n = x.numel() / x.shape[1]
            m = self.momentum
            with torch.no_grad():
                new_state = {
                    "running_mean": (1 - m) * state["running_mean"] + m * mean.detach(),
                    "running_var": (1 - m) * state["running_var"]
                    + m * var.detach() * (n / max(n - 1, 1)),
                }
        else:
            mean, var = state["running_mean"], state["running_var"]
            new_state = state
        if x.dtype == torch.float32:
            y = (x - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + self.eps)
            if self.affine:
                y = y * params["weight"].reshape(shape) + params["bias"].reshape(shape)
            return y, new_state
        scale = torch.rsqrt(var + self.eps)
        if self.affine:
            scale = scale * params["weight"]
            shift = params["bias"] - mean * scale
        else:
            shift = -mean * scale
        y = x * scale.reshape(shape).to(x.dtype) + shift.reshape(shape).to(x.dtype)
        return y, new_state


class SpatialBatchNormalization(BatchNormalization):
    """BN over NCHW, per-channel statistics."""


class _LastDimNorm(AbstractModule):
    """A norm over the last dim with a declared (or inferred) hidden size."""

    def __init__(self, hidden_size: Optional[int], eps: float, device=None):
        super().__init__(device)
        self.hidden_size = hidden_size
        self.eps = eps

    def _hidden(self, x) -> int:
        h = x.shape[-1]
        if self.hidden_size is not None and h != self.hidden_size:
            raise ValueError(f"{self.name()}: declared hidden size {self.hidden_size}, got "
                             f"last dim {h} (input shape {tuple(x.shape)})")
        return h


class LayerNormalization(_LastDimNorm):
    """LayerNorm over the last dim (reference: LayerNormalization.scala)."""

    def __init__(self, hidden_size: Optional[int] = None, eps: float = 1e-5, device=None):
        super().__init__(hidden_size, eps, device)

    def _build(self, generator, sample):
        self.hidden_size = h = self._hidden(sample)
        return {"weight": torch.ones(h), "bias": torch.zeros(h)}, {}

    def _apply_params(self, params, state, x, training, rng):
        self._hidden(x)
        if fused_kernels_active():
            return fused_layer_norm(x, params["weight"], params["bias"], self.eps), state
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * params["weight"] + params["bias"], state


class RMSNorm(_LastDimNorm):
    """Root-mean-square norm over the last dim (Zhang & Sennrich 2019):
    ``x · rsqrt(mean(x²) + eps) · g``, LayerNorm without centring or bias;
    fp32 statistics, the output in ``x``'s dtype."""

    def __init__(self, hidden_size: Optional[int] = None, eps: float = 1e-6, device=None):
        super().__init__(hidden_size, eps, device)

    def _build(self, generator, sample):
        self.hidden_size = h = self._hidden(sample)
        return {"weight": torch.ones(h)}, {}

    def _apply_params(self, params, state, x, training, rng):
        self._hidden(x)
        if fused_kernels_active():
            return fused_rms_norm(x, params["weight"], self.eps), state
        xf = x.float()
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(ms + self.eps) * params["weight"]).to(x.dtype), state
