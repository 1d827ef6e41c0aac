"""Normalization layers (counterpart of ``bigdl_tpu/nn/normalization.py``):
``BatchNormalization`` / ``SpatialBatchNormalization``, ``LayerNormalization``,
``RMSNorm``, ``SpatialCrossMapLRN``, ``SpatialWithinChannelLRN`` and
``Normalize``.

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

``Normalize`` divides by the Lp norm of the LAST dim plus ``eps`` (not
``F.normalize``'s ``max(norm, eps)`` over dim 1), and
``SpatialWithinChannelLRN`` divides by ``(1 + alpha/size² · the sum of x²
over a size×size window)^beta``, the window zero-padded (size//2,
size-1-size//2) on H and W, as the JAX package's ``reduce_window``; both in
torch ops (XLA's in the JAX package, no Pallas kernel).

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
import torch.nn.functional as F

from ..ops.fused_common import fused_kernels_active
from ..ops.fused_norm import fused_layer_norm, fused_rms_norm
from .module import AbstractModule, spec


class BatchNormalization(AbstractModule):
    """BN over (N, C) or (N, C, ...) with C at dim 1; ``affine`` adds the
    learnable weight (γ) and bias (β)."""

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) <= 1:
            raise ValueError(f"{self.name()}: needs a channel dim at axis 1, got shape {shape}")
        if self.n_output is not None and shape[1] != self.n_output:
            raise ValueError(f"{self.name()}: expected {self.n_output} channels, got "
                             f"{shape[1]} (input shape {shape})")
        return spec(shape, in_spec.dtype)

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

    def infer_shape(self, in_spec):
        self._hidden(in_spec)
        return spec(tuple(in_spec.shape), torch.promote_types(in_spec.dtype, torch.float32))

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

    def infer_shape(self, in_spec):
        self._hidden(in_spec)
        return spec(tuple(in_spec.shape), in_spec.dtype)

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


class SpatialCrossMapLRN(AbstractModule):
    """Local response norm across the channels of NCHW input (reference:
    SpatialCrossMapLRN; AlexNet, Inception-v1):
    ``y = x / (k + alpha/size · sum of x² over a window of size channels)^beta``,
    the window padded (size//2, size-1-size//2) with zeros, as the JAX
    package's ``reduce_window``. Torch's ``local_response_norm``, not a
    kernel (the JAX package computes it with XLA, outside Pallas). Computed
    in fp32 and rounded once
    to ``x``'s dtype: for bf16 that is more exact than the JAX package, whose
    square, window sum, power and divide each round to bf16."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75, k: float = 1.0,
                 device=None):
        super().__init__(device)
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k

    def _apply_params(self, params, state, x, training, rng):
        if x.dim() != 4:
            raise ValueError(f"{self.name()}: expects NCHW input, got shape {tuple(x.shape)}")
        # torch's pads the window (size//2, (size-1)//2), the same as the JAX one's
        y = F.local_response_norm(x.float(), self.size, self.alpha, self.beta, self.k)
        return y.to(x.dtype), state


class Normalize(AbstractModule):
    """Lp-normalize over the last dim (reference: ``$DL/nn/Normalize.scala``):
    ``x / (||x||_p + eps)``, ``p = inf`` the largest magnitude."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, p: float = 2.0, eps: float = 1e-10, device=None):
        super().__init__(device)
        self.p = p
        self.eps = eps

    def _apply_params(self, params, state, x, training, rng):
        if self.p == float("inf"):
            norm = torch.amax(torch.abs(x), dim=-1, keepdim=True)
        else:
            norm = torch.sum(torch.abs(x) ** self.p, dim=-1, keepdim=True) ** (1.0 / self.p)
        return x / (norm + self.eps), state


class SpatialWithinChannelLRN(AbstractModule):
    """Local response norm within each channel over a size×size spatial
    window of NCHW input (reference: ``SpatialWithinChannelLRN``)."""

    infer_shape = AbstractModule._infer_shape_via_apply  # parameter-less

    def __init__(self, size: int = 5, alpha: float = 1.0, beta: float = 0.75, device=None):
        super().__init__(device)
        self.size = size
        self.alpha = alpha
        self.beta = beta

    def _apply_params(self, params, state, x, training, rng):
        if x.dim() != 4:
            raise ValueError(f"{self.name()}: expects NCHW input, got shape {tuple(x.shape)}")
        half, rest = self.size // 2, self.size - 1 - self.size // 2
        summed = F.avg_pool2d(F.pad(x * x, (half, rest, half, rest)), self.size, 1,
                              divisor_override=1)
        denom = (1.0 + self.alpha / (self.size * self.size) * summed) ** self.beta
        return x / denom, state
