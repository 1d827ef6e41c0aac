"""Attention layers of the port, the language-model path (counterpart of
``bigdl_tpu/nn/attention.py``).

Ported: the head helpers, the sinusoidal position signal, the flat dense /
norm / FFN helpers, ``scaled_dot_product_attention`` (dense path and the
flash route), ``FeedForwardNetwork`` and ``Transformer(mode="lm")``.
Translation mode, rotary positions, the decode cache and beam search wait
for a later slice of the port and raise here.

Parameters are the JAX package's flat per-block dicts (``self_q_w``,
``filter_w``, ``ln1_g``, ...), so a JAX model's parameter tree loads path for
path (:func:`bigdl_tpu_torch.utils.convert.load_jax_params`).
"""

from __future__ import annotations

import math
import os
from functools import partial
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention
from ..utils import precision
from .initialization import Xavier, Zeros
from .module import AbstractModule

NEG_INF = -1e9


# --------------------------------------------------------------------- helpers
def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(N, T, H) -> (N, heads, T, H/heads), a strided view."""
    n, t, h = x.shape
    return x.reshape(n, t, num_heads, h // num_heads).transpose(1, 2)


def combine_heads(x: torch.Tensor) -> torch.Tensor:
    """(N, heads, T, Hh) -> (N, T, heads*Hh)."""
    n, heads, t, hh = x.shape
    return x.transpose(1, 2).reshape(n, t, heads * hh)


def get_position_encoding(length: int, hidden_size: int,
                          min_timescale: float = 1.0,
                          max_timescale: float = 1.0e4,
                          device=None) -> torch.Tensor:
    """Sinusoidal position signal (T, H), float32."""
    position = torch.arange(length, dtype=torch.float32, device=device)
    num_timescales = hidden_size // 2
    log_increment = math.log(max_timescale / min_timescale) / max(num_timescales - 1, 1)
    inv_timescales = min_timescale * torch.exp(
        torch.arange(num_timescales, dtype=torch.float32, device=device) * -log_increment)
    scaled = position[:, None] * inv_timescales[None, :]
    signal = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)
    if hidden_size % 2:
        signal = F.pad(signal, (0, 1))
    return signal


def scaled_dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dropout_p: float = 0.0,
    rng: Optional[torch.Generator] = None,
    impl: str = "auto",
    causal: bool = False,
    lengths: Optional[torch.Tensor] = None,
    mask_q: Optional[bool] = None,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v over (..., T, d) operands.

    ``impl='flash'`` runs 4-D operands with no additive bias and no attention
    dropout through :func:`bigdl_tpu_torch.ops.flash_attention.flash_attention`
    (the CUDA kernel for CUDA tensors, its plain version for CPU tensors) and
    raises for anything else. ``impl='auto'`` takes that route for CUDA
    tensors once ``min(Tq, Tk) >= 1024`` and the dense path otherwise;
    ``'dense'`` forces the dense path. The ``BIGDL_ATTN_IMPL`` environment
    variable overrides ``'auto'``, as in the JAX package. ``causal`` masks
    with the aligned-at-end convention; ``lengths`` (N,) masks keys past
    each sequence's length and, with ``mask_q`` (default Tq == Tk), zeroes
    the query rows past it.
    """
    if mask_q is None:
        mask_q = q.shape[-2] == k.shape[-2]
    structural = bias is None and dropout_p == 0.0 and q.dim() == 4
    if impl == "auto":
        impl = os.environ.get("BIGDL_ATTN_IMPL", "auto")
    if impl == "auto":
        # The JAX package's routing rule (flash from T=1024, chosen there for
        # its TPU kernel), kept here as a rule; it is not a measurement on
        # this card.
        impl = ("flash" if structural and q.is_cuda
                and min(q.shape[-2], k.shape[-2]) >= 1024 else "dense")
    if impl == "flash":
        if not structural:
            raise ValueError(
                "impl='flash' needs 4-D operands, no additive bias and no "
                f"attention dropout; got shape {tuple(q.shape)}, "
                f"bias={bias is not None}, dropout_p={dropout_p}")
        out = flash_attention(precision.cast_compute(q), precision.cast_compute(k),
                              precision.cast_compute(v), causal,
                              lengths=lengths, mask_q=mask_q)
        return out.to(q.dtype)
    if impl != "dense":
        raise ValueError(f"impl must be 'auto', 'flash' or 'dense', got {impl!r}")
    tq, tk = q.shape[-2], k.shape[-2]
    if lengths is not None:
        key_mask = torch.arange(tk, device=q.device)[None, :] < lengths[:, None]
        mid = (1,) * (q.dim() - 2)
        len_bias = torch.zeros(key_mask.shape, device=q.device).masked_fill(
            ~key_mask, NEG_INF).reshape((lengths.shape[0],) + mid + (tk,))
        bias = len_bias if bias is None else bias + len_bias
    if causal:
        rows = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        cols = torch.arange(tk, device=q.device)[None, :]
        causal_bias = torch.zeros((tq, tk), device=q.device).masked_fill(
            rows < cols, NEG_INF)
        bias = causal_bias if bias is None else bias + causal_bias
    logits = precision.einsum("...qd,...kd->...qk", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        logits = logits + bias
    weights = torch.softmax(logits, dim=-1)
    weights = _dropout(rng, dropout_p, weights)
    out = precision.einsum("...qk,...kd->...qd", weights, v)
    if lengths is not None and mask_q:
        row_valid = (torch.arange(tq, device=q.device)[None, :] + (tk - tq)
                     < lengths[:, None]).reshape(
            (lengths.shape[0],) + (1,) * (q.dim() - 3) + (tq, 1))
        out = out.masked_fill(~row_valid, 0.0)
    return out


def _dropout(rng: Optional[torch.Generator], p: float, x: torch.Tensor) -> torch.Tensor:
    """Inverted dropout; identity when rng is None or p == 0. The mask is
    drawn on ``x``'s device, from a generator there seeded from ``rng`` (one
    host draw of a seed, no host-sized mask or copy)."""
    if p <= 0.0 or rng is None:
        return x
    keep = 1.0 - p
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=rng))
    gen = torch.Generator(device=x.device).manual_seed(seed)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return x * mask / keep


def _dense(params: Dict[str, Any], name: str, x: torch.Tensor) -> torch.Tensor:
    y = precision.einsum("...i,oi->...o", x, params[f"{name}_w"])
    b = params.get(f"{name}_b")
    return y if b is None else y + b


def _layer_norm(params: Dict[str, Any], name: str, x: torch.Tensor,
                eps: float = 1e-6, kind: str = "layer") -> torch.Tensor:
    """LayerNorm, or RMSNorm for ``kind='rms'`` (fp32 statistics and gain,
    one narrowing cast), as in the JAX package."""
    g = params[f"{name}_g"]
    if kind == "rms":
        xf = x.float()
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        return (xf * torch.rsqrt(ms + eps) * g).to(x.dtype)
    b = params[f"{name}_b"]
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


_gelu = partial(F.gelu, approximate="tanh")  # jax.nn.gelu's default


def _ffn_hidden(params, x, activation: str):
    """One FFN hidden computation, shared by FeedForwardNetwork and the
    Transformer block (gated variants use a bias-less ``gate`` projection)."""
    if activation in FeedForwardNetwork._GATED:
        act = FeedForwardNetwork._GATED[activation]
        return act(_dense(params, "gate", x)) * _dense(params, "filter", x)
    return FeedForwardNetwork._PLAIN[activation](_dense(params, "filter", x))


# ---------------------------------------------------------------------- layers
class FeedForwardNetwork(AbstractModule):
    """Position-wise FFN: act(x W1 + b1) W2 + b2; gated variants compute
    ``(act(x Wg) * (x W1 + b1)) W2 + b2``."""

    _GATED = {"swiglu": F.silu, "geglu": _gelu}
    _PLAIN = {"relu": F.relu, "gelu": _gelu, "silu": F.silu}

    def __init__(self, hidden_size: Optional[int] = None, filter_size: int = 2048,
                 relu_dropout: float = 0.0, activation: str = "relu", device=None):
        super().__init__(device)
        if activation not in {**self._PLAIN, **self._GATED}:
            raise ValueError(
                f"activation must be one of "
                f"{sorted({**self._PLAIN, **self._GATED})}, got {activation!r}")
        self.hidden_size = hidden_size
        self.filter_size = filter_size
        self.relu_dropout = relu_dropout
        self.activation = activation
        self.weight_init = Xavier()
        self.bias_init = Zeros()

    def _build(self, generator, sample):
        h = sample.shape[-1]
        if self.hidden_size is None:
            self.hidden_size = h
        w, b, f = self.weight_init, self.bias_init, self.filter_size
        params = {
            "filter_w": w(generator, (f, h), h, f),
            "filter_b": b(generator, (f,), h, f),
            "out_w": w(generator, (self.hidden_size, f), f, self.hidden_size),
            "out_b": b(generator, (self.hidden_size,), f, self.hidden_size),
        }
        if self.activation in self._GATED:
            params["gate_w"] = w(generator, (f, h), h, f)
        return params, {}

    def _apply_params(self, params, state, x, training, rng):
        hdn = _ffn_hidden(params, x, self.activation)
        if training:
            hdn = _dropout(rng, self.relu_dropout, hdn)
        return _dense(params, "out", hdn), state


def _block_params(generator, hidden_size: int, filter_size: int, weight_init,
                  ffn_activation: str = "relu", norm: str = "layer") -> Dict[str, Any]:
    """Params for one pre-norm self-attention + FFN block."""
    h, f = hidden_size, filter_size
    p: Dict[str, Any] = {}
    for name in ("q", "k", "v", "out"):
        p[f"self_{name}_w"] = weight_init(generator, (h, h), h, h)
    p["filter_w"] = weight_init(generator, (f, h), h, f)
    p["filter_b"] = torch.zeros((f,))
    if ffn_activation in FeedForwardNetwork._GATED:
        p["gate_w"] = weight_init(generator, (f, h), h, f)
    p["out_w"] = weight_init(generator, (h, f), f, h)
    p["out_b"] = torch.zeros((h,))
    for ln in ("ln1", "ln2"):
        p[f"{ln}_g"] = torch.ones((h,))
        if norm == "layer":  # rms: no shift param at all
            p[f"{ln}_b"] = torch.zeros((h,))
    return p


def _mha(params, prefix: str, xq, ym, bias, num_heads: int, dropout_p: float,
         rng, causal: bool = False, lengths: Optional[torch.Tensor] = None,
         is_self: bool = True):
    """Multi-head attention from flat block params (no decode cache here)."""
    q = split_heads(_dense(params, f"{prefix}_q", xq), num_heads)
    k = split_heads(_dense(params, f"{prefix}_k", ym), num_heads)
    v = split_heads(_dense(params, f"{prefix}_v", ym), num_heads)
    ctx = scaled_dot_product_attention(q, k, v, bias, dropout_p, rng,
                                       causal=causal, lengths=lengths,
                                       mask_q=is_self)
    return _dense(params, f"{prefix}_out", combine_heads(ctx))


class Transformer(AbstractModule):
    """Transformer language model (``mode='lm'``): int ids (N, T) -> logits
    (N, T, vocab), causal self-attention, pre-norm blocks, sinusoidal
    positions, embedding scaled by sqrt(H) and tied to the output head."""

    def __init__(self, vocab_size: int, hidden_size: int = 512, num_heads: int = 8,
                 filter_size: int = 2048, num_hidden_layers: int = 6,
                 postprocess_dropout: float = 0.1, attention_dropout: float = 0.1,
                 relu_dropout: float = 0.1, mode: str = "lm",
                 ffn_activation: str = "relu",
                 position_encoding: str = "sinusoidal", norm: str = "layer",
                 device=None):
        super().__init__(device)
        if mode != "lm":
            raise NotImplementedError(
                f"mode={mode!r}: only mode='lm' is ported so far")
        if position_encoding != "sinusoidal":
            raise NotImplementedError(
                f"position_encoding={position_encoding!r}: only 'sinusoidal' "
                "is ported so far")
        if norm not in ("layer", "rms"):
            raise ValueError(f"norm must be 'layer' or 'rms', got {norm!r}")
        acts = {**FeedForwardNetwork._PLAIN, **FeedForwardNetwork._GATED}
        if ffn_activation not in acts:
            raise ValueError(f"ffn_activation must be one of {sorted(acts)}, "
                             f"got {ffn_activation!r}")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.filter_size = filter_size
        self.num_hidden_layers = num_hidden_layers
        self.postprocess_dropout = postprocess_dropout
        self.attention_dropout = attention_dropout
        self.relu_dropout = relu_dropout
        self.mode = mode
        self.ffn_activation = ffn_activation
        self.position_encoding = position_encoding
        self.norm = norm
        self.weight_init = Xavier()

    def _build(self, generator, sample):
        h = self.hidden_size
        params: Dict[str, Any] = {
            "embedding": torch.randn((self.vocab_size, h), generator=generator) * (h ** -0.5)
        }
        for i in range(self.num_hidden_layers):
            params[f"block{i}"] = _block_params(
                generator, h, self.filter_size, self.weight_init,
                ffn_activation=self.ffn_activation, norm=self.norm)
        params["ln_g"] = torch.ones((h,))
        if self.norm == "layer":
            params["ln_b"] = torch.zeros((h,))
        return params, {}

    def _embed(self, params, ids):
        x = params["embedding"][ids] * math.sqrt(self.hidden_size)
        return x + get_position_encoding(ids.shape[1], self.hidden_size,
                                         device=x.device)[None]

    def _post_dropout(self, x, training, rng):
        return _dropout(rng, self.postprocess_dropout, x) if training else x

    def _run_block(self, bp, x, training, rng):
        drop = self.attention_dropout if training else 0.0
        y = _layer_norm(bp, "ln1", x, kind=self.norm)
        attn = _mha(bp, "self", y, y, None, self.num_heads, drop,
                    rng if training else None, causal=True)
        x = x + self._post_dropout(attn, training, rng)
        y = _layer_norm(bp, "ln2", x, kind=self.norm)
        hdn = _ffn_hidden(bp, y, self.ffn_activation)
        if training:
            hdn = _dropout(rng, self.relu_dropout, hdn)
        return x + self._post_dropout(_dense(bp, "out", hdn), training, rng)

    def _apply_params(self, params, state, x, training, rng):
        out = self._post_dropout(self._embed(params, x), training, rng)
        for i in range(self.num_hidden_layers):
            out = self._run_block(params[f"block{i}"], out, training, rng)
        out = _layer_norm(params, "ln", out, kind=self.norm)
        return precision.einsum("nth,vh->ntv", out, params["embedding"]), state
