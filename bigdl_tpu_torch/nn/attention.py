"""Attention layers of the port (counterpart of ``bigdl_tpu/nn/attention.py``).

The head and mask helpers, the sinusoidal position signal, rotary positions
(``apply_rotary``), the flat dense / norm / FFN helpers,
``scaled_dot_product_attention`` (dense path and the flash route), the
standalone ``Attention`` and ``FeedForwardNetwork`` modules, the
``Transformer`` (language model and translation mode, with its incremental
decode cache) and length-normalized beam search (``sequence_beam_search``,
``SequenceBeamSearch``).

Parameters are the JAX package's flat per-block dicts (``self_q_w``,
``cross_k_w``, ``filter_w``, ``ln1_g``, ...), so a JAX model's parameter tree
loads path for path (:func:`bigdl_tpu_torch.utils.convert.load_jax_params`).
"""

from __future__ import annotations

import math
import os
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention
from ..utils import precision
from ..utils.engine import Engine
from .dropout import dropout as _dropout
from .initialization import Xavier, Zeros
from .module import AbstractModule, _map_tree

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


def attention_bias_lower_triangle(length: int, device=None) -> torch.Tensor:
    """Causal bias (1, 1, T, T): 0 on/below the diagonal, -1e9 above."""
    mask = torch.tril(torch.ones((length, length), dtype=torch.float32, device=device))
    return (1.0 - mask)[None, None, :, :] * NEG_INF


def padding_attention_bias(padding: torch.Tensor) -> torch.Tensor:
    """(N, T) 1-where-pad -> (N, 1, 1, T) additive bias."""
    return padding[:, None, None, :].to(torch.float32) * NEG_INF


def lengths_from_ids(ids: torch.Tensor, pad_id: int = 0, strict: bool = False) -> torch.Tensor:
    """(N, T) int ids -> (N,) int32 valid lengths = last non-pad position + 1.

    The structural form of ``padding_attention_bias(ids == pad_id)`` for
    TRAILING-padded batches: an interior pad-id token counts as visible
    here, where a per-token bias would mask it. ``strict=True`` raises
    ``ValueError`` when any row holds an interior pad. The port runs
    eagerly, so the check always runs on the concrete ids (a host
    synchronisation on the card); the JAX package can check only concrete
    inputs and raises under ``jit`` instead."""
    nz = ids != pad_id
    pos = torch.arange(1, ids.shape[1] + 1, device=ids.device)
    lens = (nz * pos).amax(dim=1).to(torch.int32)
    if strict and not bool((nz.sum(dim=1) == lens).all()):
        raise ValueError(
            "lengths_from_ids: interior pad-id tokens found (padding is not "
            "trailing); the lengths representation would silently attend to "
            "them. Use padding_attention_bias / Transformer(pad_masking='bias') "
            "for this batch layout.")
    return lens


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


def apply_rotary(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary position embedding (RoPE, Su et al. 2021) over the last dim.

    ``x`` (..., T, d) with d even; ``positions`` (T,) absolute positions.
    Rotates feature pairs (i, i+d/2) by ``positions * 10000^{-2i/d}``: the
    angles and the rotation in float32, one cast back to ``x``'s dtype."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError(f"rotary needs an even feature dim, got {d}")
    half = d // 2
    freqs = 10000.0 ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(device=x.device, dtype=torch.float32)[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _scaled_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q·kᵀ / sqrt(d)`` under the policy, the divisor ``sqrt(d)`` in the
    logits' dtype (the JAX package's ``jnp.sqrt(jnp.asarray(d, q.dtype))``)
    and the division rounded once on every device (``precision.true_div``:
    on the card ATen would multiply by the reciprocal, inexact at head
    widths that are not a power of 4)."""
    logits = precision.einsum("...qd,...kd->...qk", q, k)
    return precision.true_div(logits, math.sqrt(q.shape[-1]))


def _on_card(q: torch.Tensor) -> bool:
    """A CUDA tensor, or a meta tensor of a step-cost count that takes the
    card's routes (``obs/perf.py``'s ``program_cost``)."""
    if q.is_cuda:
        return True
    if q.device.type != "meta":
        return False
    from ..obs.perf import cost_routes_like

    return cost_routes_like() == "cuda"


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

    With ``Engine.set_sequence_parallel(mesh, axis)`` registered, ``'auto'``
    and ``'ring'`` run an eligible call (4-D operands, no bias, no dropout,
    both lengths divisible by the axis size) as the ring of
    :func:`bigdl_tpu_torch.parallel.sequence.ring_attention` on the
    policy's compute dtype, cast back to ``q`` 's; ``'auto'`` takes the
    other routes for an ineligible one, ``'ring'`` raises.
    """
    if mask_q is None:
        mask_q = q.shape[-2] == k.shape[-2]
    structural = bias is None and dropout_p == 0.0 and q.dim() == 4
    if impl == "auto":
        impl = os.environ.get("BIGDL_ATTN_IMPL", "auto")
    sp = Engine.sequence_parallel() if q.device.type != "meta" else None  # shape inference
    if impl in ("auto", "ring") and sp is not None:
        mesh, axis = sp
        n_sp = mesh.shape[axis]
        if structural and q.shape[-2] % n_sp == 0 and k.shape[-2] % n_sp == 0:
            from ..parallel.sequence import ring_attention

            out = ring_attention(precision.cast_compute(q), precision.cast_compute(k),
                                 precision.cast_compute(v), mesh, axis_name=axis,
                                 causal=causal, lengths=lengths, mask_q=mask_q)
            return out.to(q.dtype)
        if impl == "ring":
            raise ValueError(
                "impl='ring' needs 4-D operands, no additive bias, no attention dropout, and "
                f"sequence lengths divisible by the registered axis (size {n_sp}); got "
                f"bias={bias is not None}, dropout_p={dropout_p}, "
                f"shape={tuple(q.shape)}/{tuple(k.shape)}")
    elif impl == "ring":
        raise ValueError("impl='ring' requires Engine.set_sequence_parallel(mesh, axis) to be "
                         "registered first")
    if impl == "auto":
        # The JAX package's routing rule (flash from T=1024, chosen there for
        # its TPU kernel), kept here as a rule; it is not a measurement on
        # this card.
        impl = ("flash" if structural and _on_card(q)
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
        raise ValueError(f"impl must be 'auto', 'flash', 'dense' or 'ring', got {impl!r}")
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
    logits = _scaled_logits(q, k)
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
class Attention(AbstractModule):
    """Multi-head dot-product attention with bias-less q/k/v/out weights.

    Input: ``[x, y]`` or ``[x, y, bias]`` (a list or ``Table``) with x
    (N, Tq, H) queries, y (N, Tk, H) memory (``None`` means x: self-attention)
    and bias broadcastable to (N, heads, Tq, Tk); or x alone. Output
    (N, Tq, hidden)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

    def __init__(self, hidden_size: Optional[int] = None, num_heads: int = 8,
                 attention_dropout: float = 0.0, device=None):
        super().__init__(device)
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.attention_dropout = attention_dropout
        self.weight_init = Xavier()

    def _as_input(self, x):
        if isinstance(x, (list, tuple)) and any(v is None for v in x):
            return [None if v is None else super(Attention, self)._as_input(v) for v in x]
        return super()._as_input(x)

    def _build(self, generator, sample):
        x = sample if isinstance(sample, torch.Tensor) else list(sample)[0]
        h = x.shape[-1]
        if self.hidden_size is None:
            self.hidden_size = h
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"{self.name()}: hidden {self.hidden_size} % heads {self.num_heads} != 0")
        hs, w = self.hidden_size, self.weight_init
        params = {f"{name}_w": w(generator, (hs, h), h, hs) for name in ("q", "k", "v")}
        params["out_w"] = w(generator, (hs, hs), hs, hs)
        return params, {}

    def _apply_params(self, params, state, x, training, rng):
        if isinstance(x, torch.Tensor):
            xq, ym, bias = x, x, None
        else:
            x = list(x)
            xq = x[0]
            ym = x[1] if len(x) > 1 and x[1] is not None else x[0]
            bias = x[2] if len(x) > 2 else None
        q = split_heads(_dense(params, "q", xq), self.num_heads)
        k = split_heads(_dense(params, "k", ym), self.num_heads)
        v = split_heads(_dense(params, "v", ym), self.num_heads)
        drop = self.attention_dropout if training else 0.0
        ctx = scaled_dot_product_attention(q, k, v, bias, drop, rng if training else None)
        return _dense(params, "out", combine_heads(ctx)), state


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
                  cross: bool = False, ffn_activation: str = "relu",
                  norm: str = "layer") -> Dict[str, Any]:
    """Params for one pre-norm block: self-attention [+ cross-attention and
    its ``ln3``] + FFN."""
    h, f = hidden_size, filter_size
    p: Dict[str, Any] = {}
    for prefix in ("self", "cross") if cross else ("self",):
        for name in ("q", "k", "v", "out"):
            p[f"{prefix}_{name}_w"] = weight_init(generator, (h, h), h, h)
    p["filter_w"] = weight_init(generator, (f, h), h, f)
    p["filter_b"] = torch.zeros((f,))
    if ffn_activation in FeedForwardNetwork._GATED:
        p["gate_w"] = weight_init(generator, (f, h), h, f)
    p["out_w"] = weight_init(generator, (h, f), f, h)
    p["out_b"] = torch.zeros((h,))
    for ln in ("ln1", "ln2") + (("ln3",) if cross else ()):
        p[f"{ln}_g"] = torch.ones((h,))
        if norm == "layer":  # rms: no shift param at all
            p[f"{ln}_b"] = torch.zeros((h,))
    return p


def _mha(params, prefix: str, xq, ym, bias, num_heads: int, dropout_p: float, rng,
         cache: Optional[Dict[str, torch.Tensor]] = None,
         kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
         causal: bool = False, lengths: Optional[torch.Tensor] = None,
         is_self: bool = True, rope: bool = False):
    """Multi-head attention from flat block params. ``cache`` is a growing
    decode K/V (returned grown beside the output); ``kv`` a precomputed
    static K/V (the encoder's projections during incremental decode).
    ``is_self`` states whether queries share the key horizon: cross-attention
    passes ``False`` so padded query rows are not zeroed.

    ``rope`` rotates q/k. Keys are rotated at PROJECTION time, at
    ``prev + arange``, before they enter the cache (a cached key keeps its
    slot's position; rotating after the concatenation would rotate the
    cached keys again). Queries rotate per call at the aligned-at-end
    position ``Tk - Tq + t``."""
    q = split_heads(_dense(params, f"{prefix}_q", xq), num_heads)
    if kv is not None:
        k, v = kv
    else:
        k = split_heads(_dense(params, f"{prefix}_k", ym), num_heads)
        v = split_heads(_dense(params, f"{prefix}_v", ym), num_heads)
        if rope:
            prev = cache["k"].shape[2] if cache is not None else 0
            k = apply_rotary(k, prev + torch.arange(k.shape[2], device=k.device))
    if cache is not None:
        # a float32 zero-length cache promotes bf16 keys to float32, as
        # jnp.concatenate does in the JAX package
        k = torch.cat([cache["k"], k], dim=2)
        v = torch.cat([cache["v"], v], dim=2)
        cache = {"k": k, "v": v}
    if rope:
        tq, tk = q.shape[-2], k.shape[-2]
        q = apply_rotary(q, torch.arange(tq, device=q.device) + (tk - tq))
    ctx = scaled_dot_product_attention(q, k, v, bias, dropout_p, rng,
                                       causal=causal, lengths=lengths, mask_q=is_self)
    y = _dense(params, f"{prefix}_out", combine_heads(ctx))
    return (y, cache) if cache is not None else y


class Transformer(AbstractModule):
    """Transformer (reference: ``$DL/nn/Transformer.scala``).

    ``mode='lm'``: int ids (N, T) -> logits (N, T, vocab), causal
    self-attention. ``mode='translation'``: ``[src_ids, tgt_ids]`` -> logits
    over the target positions (encoder-decoder with cross-attention).
    Pre-norm blocks, embedding scaled by sqrt(H) and tied to the output head
    (``with_lm_head=False`` returns the final hidden states).
    ``position_encoding``: ``'sinusoidal'`` (additive table) or ``'rope'``
    (q/k rotation in self-attention). ``pad_masking`` (translation):
    ``'lengths'`` masks source pads (id 0, trailing) by per-sequence lengths,
    which keeps attention flash-eligible; ``'bias'`` by an additive bias over
    every id-0 token (the dense route)."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

    def __init__(self, vocab_size: int, hidden_size: int = 512, num_heads: int = 8,
                 filter_size: int = 2048, num_hidden_layers: int = 6,
                 postprocess_dropout: float = 0.1, attention_dropout: float = 0.1,
                 relu_dropout: float = 0.1, mode: str = "lm",
                 with_lm_head: bool = True, pad_masking: str = "lengths",
                 ffn_activation: str = "relu",
                 position_encoding: str = "sinusoidal", norm: str = "layer",
                 device=None):
        super().__init__(device)
        if mode not in ("lm", "translation"):
            raise ValueError(f"mode must be 'lm' or 'translation', got {mode!r}")
        if norm not in ("layer", "rms"):
            raise ValueError(f"norm must be 'layer' or 'rms', got {norm!r}")
        if position_encoding not in ("sinusoidal", "rope"):
            raise ValueError(f"position_encoding must be 'sinusoidal' or 'rope', "
                             f"got {position_encoding!r}")
        if position_encoding == "rope" and (hidden_size // num_heads) % 2:
            raise ValueError("rope needs an even head dim; got "
                             f"hidden_size/num_heads = {hidden_size}/{num_heads}")
        acts = {**FeedForwardNetwork._PLAIN, **FeedForwardNetwork._GATED}
        if ffn_activation not in acts:
            raise ValueError(f"ffn_activation must be one of {sorted(acts)}, "
                             f"got {ffn_activation!r}")
        if pad_masking not in ("lengths", "bias"):
            raise ValueError(f"pad_masking must be 'lengths' or 'bias', got {pad_masking!r}")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.filter_size = filter_size
        self.num_hidden_layers = num_hidden_layers
        self.postprocess_dropout = postprocess_dropout
        self.attention_dropout = attention_dropout
        self.relu_dropout = relu_dropout
        self.mode = mode
        self.with_lm_head = with_lm_head
        self.pad_masking = pad_masking
        self.ffn_activation = ffn_activation
        self.position_encoding = position_encoding
        self.norm = norm
        self.weight_init = Xavier()

    def _build(self, generator, sample):
        h, layers = self.hidden_size, self.num_hidden_layers
        params: Dict[str, Any] = {
            "embedding": torch.randn((self.vocab_size, h), generator=generator) * (h ** -0.5)
        }
        prefixes = [("block", False)] + ([("dec_block", True)]
                                         if self.mode == "translation" else [])
        for prefix, cross in prefixes:
            for i in range(layers):
                params[f"{prefix}{i}"] = _block_params(
                    generator, h, self.filter_size, self.weight_init, cross=cross,
                    ffn_activation=self.ffn_activation, norm=self.norm)
        for ln in ("dec_ln", "ln") if self.mode == "translation" else ("ln",):
            params[f"{ln}_g"] = torch.ones((h,))
            if self.norm == "layer":
                params[f"{ln}_b"] = torch.zeros((h,))
        return params, {}

    # ------------------------------------------------------------------ pieces
    @property
    def _rope(self) -> bool:
        return self.position_encoding == "rope"

    @property
    def _prefix(self) -> str:
        return "dec_block" if self.mode == "translation" else "block"

    def _embed(self, params, ids):
        x = params["embedding"][ids] * math.sqrt(self.hidden_size)
        if self._rope:
            return x  # positions enter via q/k rotation in self-attention
        return x + get_position_encoding(ids.shape[1], self.hidden_size,
                                         device=x.device)[None]

    def _post_dropout(self, x, training, rng):
        return _dropout(rng, self.postprocess_dropout, x) if training else x

    def _run_block(self, bp, x, self_bias, training, rng, enc_out=None, enc_bias=None,
                   cache=None, cross_kv=None, self_causal=False, self_lengths=None,
                   enc_lengths=None):
        drop = self.attention_dropout if training else 0.0
        arng = rng if training else None
        y = _layer_norm(bp, "ln1", x, kind=self.norm)
        if cache is not None:
            attn, cache = _mha(bp, "self", y, y, self_bias, self.num_heads, drop, arng,
                               cache, causal=self_causal, rope=self._rope)
        else:
            attn = _mha(bp, "self", y, y, self_bias, self.num_heads, drop, arng,
                        causal=self_causal, lengths=self_lengths, rope=self._rope)
        x = x + self._post_dropout(attn, training, rng)
        if enc_out is not None or cross_kv is not None:
            y = _layer_norm(bp, "ln3", x, kind=self.norm)
            cross = _mha(bp, "cross", y, enc_out, enc_bias, self.num_heads, drop, arng,
                         kv=cross_kv, lengths=enc_lengths, is_self=False)
            x = x + self._post_dropout(cross, training, rng)
        y = _layer_norm(bp, "ln2", x, kind=self.norm)
        hdn = _ffn_hidden(bp, y, self.ffn_activation)
        if training:
            hdn = _dropout(rng, self.relu_dropout, hdn)
        x = x + self._post_dropout(_dense(bp, "out", hdn), training, rng)
        return (x, cache) if cache is not None else x

    def _encode(self, params, ids, training, rng, pad_bias=None, lengths=None):
        x = self._post_dropout(self._embed(params, ids), training, rng)
        for i in range(self.num_hidden_layers):
            x = self._run_block(params[f"block{i}"], x, pad_bias, training, rng,
                                self_lengths=lengths)
        return _layer_norm(params, "ln", x, kind=self.norm)

    # ------------------------------------------------------------------- apply
    def _apply_params(self, params, state, x, training, rng):
        if self.mode == "lm":
            out = self._post_dropout(self._embed(params, x), training, rng)
            for i in range(self.num_hidden_layers):
                out = self._run_block(params[f"block{i}"], out, None, training, rng,
                                      self_causal=True)
            out = _layer_norm(params, "ln", out, kind=self.norm)
        else:
            src, tgt = x
            if self.pad_masking == "bias":
                enc_bias = padding_attention_bias((src == 0).to(torch.float32))
                src_lengths = None
            else:
                src_lengths, enc_bias = lengths_from_ids(src), None
            enc = self._encode(params, src, training, rng, pad_bias=enc_bias,
                               lengths=src_lengths)
            out = self._post_dropout(self._embed(params, tgt), training, rng)
            for i in range(self.num_hidden_layers):
                out = self._run_block(params[f"dec_block{i}"], out, None, training, rng,
                                      enc_out=enc, enc_bias=enc_bias,
                                      enc_lengths=src_lengths, self_causal=True)
            out = _layer_norm(params, "dec_ln", out, kind=self.norm)
        if self.with_lm_head:
            out = precision.einsum("nth,vh->ntv", out, params["embedding"])
        return out, state

    # ------------------------------------------------------- decode (beam use)
    def init_decode_cache(self, batch_beam: int) -> Dict[str, Any]:
        """Empty per-block K/V cache (float32, zero length) for incremental
        decoding."""
        hh = self.hidden_size // self.num_heads
        shape = (batch_beam, self.num_heads, 0, hh)
        return {f"{self._prefix}{i}": {"k": torch.zeros(shape, device=self.device),
                                        "v": torch.zeros(shape, device=self.device)}
                for i in range(self.num_hidden_layers)}

    def decode_step_fn(self, params, enc_out=None, enc_bias=None,
                       max_len: int = 512) -> Callable:
        """``symbols_to_logits_fn(ids, i, cache) -> (logits, cache)`` for
        :func:`sequence_beam_search`: one new token per row at position
        ``i``. The sinusoidal position row is ``i`` of a ``max_len`` table,
        and ``i >= max_len`` raises ``IndexError`` (the JAX package's
        ``dynamic_slice`` clamps to the last row there); rotary positions
        have no such limit. In translation mode the encoder's cross K/V are
        projected once here, not once a step."""
        prefix = self._prefix
        pos_table = (None if self._rope
                     else get_position_encoding(max_len, self.hidden_size, device=self.device))
        cross_kvs = None
        if self.mode == "translation" and enc_out is not None:
            cross_kvs = [(split_heads(_dense(params[f"{prefix}{b}"], "cross_k", enc_out),
                                      self.num_heads),
                          split_heads(_dense(params[f"{prefix}{b}"], "cross_v", enc_out),
                                      self.num_heads))
                         for b in range(self.num_hidden_layers)]

        def fn(ids, i, cache):
            x = params["embedding"][ids[:, -1:]] * math.sqrt(self.hidden_size)
            if pos_table is not None:
                if not 0 <= i < max_len:
                    raise IndexError(f"decode step {i} is past the position table's "
                                     f"max_len={max_len}")
                x = x + pos_table[i:i + 1][None]
            new_cache = dict(cache)
            for b in range(self.num_hidden_layers):
                name = f"{prefix}{b}"
                x, new_cache[name] = self._run_block(
                    params[name], x, None, False, None, enc_bias=enc_bias, cache=cache[name],
                    cross_kv=None if cross_kvs is None else cross_kvs[b])
            ln = "dec_ln" if self.mode == "translation" else "ln"
            x = _layer_norm(params, ln, x, kind=self.norm)
            logits = precision.einsum("nth,vh->ntv", x, params["embedding"])[:, 0]
            return logits, new_cache

        return fn


# ----------------------------------------------------------------- beam search
def _length_penalty(length, alpha: float):
    """``((5 + length) / 6) ** alpha``, the division rounded once on every
    device (``precision.true_div``): on the card ATen would multiply by
    1/6, a unit in the last place off the CPU's and the JAX package's
    quotient, and finished beams make rows of near ties."""
    return torch.pow(precision.true_div(5.0 + length, 6.0), alpha)


def _expand_to_beam(t: torch.Tensor, beam_size: int) -> torch.Tensor:
    """(N, ...) -> (N*beam, ...), each row repeated ``beam_size`` times."""
    return torch.repeat_interleave(t, beam_size, dim=0)


def _gather_beams(t: torch.Tensor, indices: torch.Tensor, batch: int, beam: int) -> torch.Tensor:
    """Select new beams: t (N*B, ...), indices (N, B') over beams -> (N*B', ...)."""
    shaped = t.reshape(batch, beam, *t.shape[1:])
    rows = torch.arange(batch, device=t.device)[:, None]
    picked = shaped[rows, indices.to(device=t.device, dtype=torch.long)]
    return picked.reshape(batch * indices.shape[1], *t.shape[1:])


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: the k largest, the lower index first
    among equal values (a stable descending sort; ``torch.topk`` promises
    no order among ties, and finished beams make rows of exact ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def sequence_beam_search(
    symbols_to_logits_fn: Callable,
    initial_ids: torch.Tensor,
    initial_cache: Dict[str, Any],
    vocab_size: int,
    beam_size: int = 4,
    alpha: float = 0.6,
    max_decode_length: int = 32,
    eos_id: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Length-normalized beam search (reference: ``$DL/nn/SequenceBeamSearch.scala``,
    a port of the TF official ``sequence_beam_search``).

    ``symbols_to_logits_fn(ids, i, cache) -> (logits (N*B, vocab), cache)``.
    Returns (sequences (N, B, T+1), scores (N, B)), beams ordered by score,
    the lower beam first among equal scores. The search is a choice of
    indices, not a differentiable function, so it runs under ``no_grad``.
    """
    with torch.no_grad():
        batch, dev = initial_ids.shape[0], initial_ids.device
        ids = _expand_to_beam(initial_ids[:, None], beam_size)  # (N*B, 1)
        cache = _map_tree(lambda t: _expand_to_beam(t, beam_size), initial_cache)
        # first beam live, the rest dead, so step 0 doesn't pick duplicates
        log_probs = torch.tensor([0.0] + [NEG_INF] * (beam_size - 1),
                                 device=dev).repeat(batch).reshape(batch, beam_size)
        finished = torch.zeros((batch, beam_size), dtype=torch.bool, device=dev)
        # decoded length per beam, fixed at the step a beam emits EOS; beams
        # that never finish score with the full max_decode_length
        lengths = torch.full((batch, beam_size), float(max_decode_length), device=dev)
        frozen = torch.full((vocab_size,), NEG_INF, device=dev)
        frozen[eos_id] = 0.0
        for i in range(max_decode_length):
            logits, cache = symbols_to_logits_fn(ids, i, cache)
            cand = torch.log_softmax(logits, dim=-1).reshape(batch, beam_size, vocab_size)
            # finished beams only extend with EOS at no cost; others add log-probs
            cand = torch.where(finished[:, :, None], frozen, cand)
            total = log_probs[:, :, None] + cand
            top_lp, top_idx = _top_k(total.reshape(batch, beam_size * vocab_size), beam_size)
            beam_idx = top_idx // vocab_size
            token_idx = top_idx % vocab_size
            ids = _gather_beams(ids, beam_idx, batch, beam_size)
            cache = _map_tree(lambda t: _gather_beams(t, beam_idx, batch, beam_size), cache)
            finished = torch.gather(finished, 1, beam_idx)
            lengths = torch.gather(lengths, 1, beam_idx)
            ids = torch.cat([ids, token_idx.reshape(batch * beam_size, 1).to(ids.dtype)], dim=1)
            is_eos = token_idx == eos_id
            lengths = torch.where((~finished) & is_eos, float(i + 1), lengths)
            finished = finished | is_eos
            log_probs = top_lp
        scores = log_probs / _length_penalty(lengths, alpha)
        # re-rank by length-normalized score (finished short beams stopped
        # accumulating log-prob); stable, as the JAX package's argsort is
        order = torch.argsort(-scores, dim=1, stable=True)
        scores = torch.gather(scores, 1, order)
        seqs = _gather_beams(ids, order, batch, beam_size)
        return seqs.reshape(batch, beam_size, -1), scores


class SequenceBeamSearch(AbstractModule):
    """Beam-search decode layer (reference: ``$DL/nn/SequenceBeamSearch.scala``).

    Wraps a ``Transformer`` (a registered child, so it moves with ``.to()``).
    Input: the prompt-less batch's ids (N, T) (only N is read in LM mode);
    for a translation model the source ids, encoded with
    ``padding_attention_bias`` (the dense route, whatever the model's
    ``pad_masking``), then beam-decoded from id 0. Output: ``[sequences,
    scores]``."""

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

    def __init__(self, model: Transformer, beam_size: int = 4, alpha: float = 0.6,
                 max_decode_length: int = 32, eos_id: int = 1):
        super().__init__(model.device)
        self.model = model
        self.beam_size = beam_size
        self.alpha = alpha
        self.max_decode_length = max_decode_length
        self.eos_id = eos_id

    def _build(self, generator, sample):
        if not self.model.is_built():
            ids = torch.zeros((1, 1), dtype=torch.long, device=self.model.device)
            if self.model.mode == "translation":
                src = sample if getattr(sample, "dim", lambda: 0)() == 2 else ids
                self.model.build(generator, [src, ids])
            else:
                self.model.build(generator, ids)
        return {}, {}

    def _apply_params(self, params, state, x, training, rng):
        mp = self.model.get_parameters()
        batch, beam = x.shape[0], self.beam_size
        max_len = self.max_decode_length + 1
        with torch.no_grad():
            if self.model.mode == "translation":
                pad_bias = padding_attention_bias((x == 0).to(torch.float32))
                enc = _expand_to_beam(self.model._encode(mp, x, False, None, pad_bias), beam)
                step_fn = self.model.decode_step_fn(
                    mp, enc_out=enc, enc_bias=_expand_to_beam(pad_bias, beam), max_len=max_len)
            else:
                step_fn = self.model.decode_step_fn(mp, max_len=max_len)
            seqs, scores = sequence_beam_search(
                step_fn, torch.zeros((batch,), dtype=torch.long, device=x.device),
                self.model.init_decode_cache(batch), self.model.vocab_size, beam,
                self.alpha, self.max_decode_length, self.eos_id)
        return [seqs, scores], state
