"""The low-precision policy of the flat layout (counterpart of
``bigdl_tpu/optim/quantization.py``).

Three knobs, resolved and checked when the optimizer is built:

* ``comms_dtype``: the wire format of the flat gradient exchange
  (:class:`bigdl_tpu_torch.parallel.compression.GradCompressor`, which uses
  the per-segment scale arithmetic here);
* ``slot_dtype``: the storage dtype of the flat optimizer slots
  (``"bfloat16"``), widened to float32 for the update and narrowed back
  with stochastic rounding;
* ``master_dtype``: the storage dtype of the flat master weights,
  ``"bfloat16"`` or the experimental ``"float8_e4m3"`` tier (codes plus a
  per-segment float32 scale vector carried under the reserved slot key
  :data:`MASTER_SCALE_KEY`).

Every narrowing is stochastically rounded from a ``torch.Generator`` on the
vector's device seeded from (a base seed, the step, a salt): a pure
function of the step counter, never the host stream, so a policy leaves
dropout and shuffling as they were and a resumed run rounds as the
uninterrupted one. The draws are torch's, not ``jax.random`` 's: the bit
trick itself is :func:`sr_bf16`, which a test holds against the JAX
package's with the same bits. Checkpoints stay in the tree layout and
float32: the cold seams decode first.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["LowPrecisionPolicy", "StatePrecision", "stochastic_round", "sr_bf16",
           "segment_amax", "scales_from_amax", "quant_range_max", "resolve_precision_dtype",
           "MASTER_SCALE_KEY"]

# reserved slot key of the fp8 master's per-segment scale vector
MASTER_SCALE_KEY = "_master_scale"

# base seed of the stochastic-rounding streams (the JAX package's PRNG base)
_SR_BASE_SEED = 0x0B5EED

_PRECISION_DTYPES = {
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "float8_e4m3": torch.float8_e4m3fn,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}

# largest finite magnitude of each quantized wire/storage format
_QUANT_RANGE = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}

# relative dither half-width of float8 stochastic rounding: one ulp
_F8_REL_ULP = {torch.float8_e4m3fn: 2.0 ** -3, torch.float8_e5m2: 2.0 ** -2}


def resolve_precision_dtype(name, knob: str = "comms_dtype") -> Optional[torch.dtype]:
    """A knob's dtype spelling (``"bfloat16"``, ``"int8"``,
    ``"float8_e4m3"``/``"float8_e4m3fn"``, ``"float8_e5m2"`` or a torch
    dtype) -> the torch dtype; None passes through (policy off)."""
    if name is None:
        return None
    if isinstance(name, torch.dtype):
        if name in _PRECISION_DTYPES.values():
            return name
        name = str(name).replace("torch.", "")
    dt = _PRECISION_DTYPES.get(str(name).lower())
    if dt is None:
        raise ValueError(f"{knob}={name!r} is not a supported low-precision dtype; choose one "
                         f"of {sorted(set(_PRECISION_DTYPES))}")
    return dt


def quant_range_max(dtype: torch.dtype) -> float:
    try:
        return _QUANT_RANGE[dtype]
    except KeyError:
        raise ValueError(f"no quantization range for dtype {dtype}") from None


def segment_amax(vec: torch.Tensor, seg_ids: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Per-segment max |v| in float32, ``(n_segments,)``; an empty segment
    is -inf, as ``jax.ops.segment_max`` leaves it."""
    out = torch.full((n_segments,), float("-inf"), dtype=torch.float32, device=vec.device)
    return out.scatter_reduce_(0, seg_ids, vec.float().abs(), reduce="amax", include_self=True)


def scales_from_amax(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """Symmetric scales, 1.0 where a segment is all zero (or empty)."""
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


def sr_seed(*parts: int) -> int:
    """A stochastic-rounding seed from the base seed and ``parts`` (the
    step, then salts): ``fold_in`` as integer arithmetic."""
    s = _SR_BASE_SEED
    for p in parts:
        s = (s * 1_000_003 + int(p)) % (1 << 62)
    return s


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def sr_bf16(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The bf16 stochastic-rounding bit trick: ``noise`` (int32 in
    [0, 65536), one a value) added below the bf16 mantissa boundary of the
    float32 ``x``'s bits, then the low 16 bits truncated. Unbiased:
    E[SR(x)] == x."""
    bits = x.contiguous().view(torch.int32)
    r = ((bits + noise) >> 16) & 0xFFFF
    r = r - (r >= 32768).to(torch.int32) * 65536  # into int16's range
    return r.to(torch.int16).view(torch.bfloat16)


def stochastic_round(x: torch.Tensor, dtype: torch.dtype, seed: int) -> torch.Tensor:
    """``x`` (float32) stochastically rounded to ``dtype`` with the stream
    of ``seed`` on ``x`` 's device: the bit trick for bf16, a symmetric
    half-ulp relative dither before the round-to-nearest cast for float8
    (saturated at the format's max first: float8 has no inf), the identity
    for float32."""
    if dtype == torch.float32:
        return x
    gen = _generator(seed, x.device)
    if dtype == torch.bfloat16:
        noise = torch.randint(0, 1 << 16, x.shape, generator=gen, device=x.device,
                              dtype=torch.int32)
        return sr_bf16(x, noise)
    if dtype in _F8_REL_ULP:
        u = torch.rand(x.shape, generator=gen, device=x.device, dtype=torch.float32) - 0.5
        y = x * (1.0 + u * (2.0 * _F8_REL_ULP[dtype]))
        qmax = _QUANT_RANGE[dtype]
        return torch.clamp(y, -qmax, qmax).to(dtype)
    raise ValueError(f"stochastic_round: unsupported target dtype {dtype}")


class LowPrecisionPolicy:
    """The resolved and checked knobs of one optimizer."""

    def __init__(self, comms_dtype=None, error_feedback: bool = True, master_dtype=None,
                 slot_dtype=None):
        self.comms_dtype = resolve_precision_dtype(comms_dtype, "comms_dtype")
        self.master_dtype = resolve_precision_dtype(master_dtype, "master_dtype")
        self.slot_dtype = resolve_precision_dtype(slot_dtype, "slot_dtype")
        if self.master_dtype == torch.int8:
            raise ValueError("master_dtype='int8' is not supported (integer master weights "
                             "have no gradient); use 'bfloat16' or the experimental "
                             "'float8_e4m3' tier")
        if self.slot_dtype is not None and self.slot_dtype != torch.bfloat16:
            raise ValueError("slot_dtype supports 'bfloat16' (f32 is the default; fp8 second "
                             "moments underflow and int8 slots have no update rule)")
        # error feedback belongs to the compressed exchange
        self.error_feedback = bool(error_feedback) and self.comms_dtype is not None

    @property
    def active(self) -> bool:
        return (self.comms_dtype is not None or self.master_dtype is not None
                or self.slot_dtype is not None)

    @property
    def quantizes_state(self) -> bool:
        return self.master_dtype is not None or self.slot_dtype is not None

    @property
    def master_scaled(self) -> bool:
        """True for a master stored as scaled codes (the fp8 tier)."""
        return self.master_dtype is not None and self.master_dtype in _QUANT_RANGE


class StatePrecision:
    """``master_dtype`` / ``slot_dtype`` bound to a ``FlatParameter``: the
    encode at entry, the decode at the cold seams and before each forward,
    and the stochastically rounded narrowing around ``update_flat``."""

    def __init__(self, fp, policy: LowPrecisionPolicy):
        self.fp = fp
        self.policy = policy
        if policy.master_scaled:
            self._qmax = quant_range_max(policy.master_dtype)

    def _seg(self, device) -> torch.Tensor:
        return self.fp.segment_ids_on(device)

    def _n_rows(self) -> int:
        return len(self.fp.sizes) + 1

    # -------------------------------------------------------------- master
    def encode_master(self, vec: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """float32 master -> (stored vector, per-segment scale or None),
        rounded to nearest (once, at entry)."""
        md = self.policy.master_dtype
        if md is None:
            return vec, None
        if not self.policy.master_scaled:
            return vec.to(md), None
        seg = self._seg(vec.device)
        scales = scales_from_amax(segment_amax(vec, seg, self._n_rows()), self._qmax)
        return (vec / scales[seg]).to(md), scales

    def decode_master(self, stored: torch.Tensor, scale=None, out=None) -> torch.Tensor:
        """Stored master -> float32 (into ``out`` when given)."""
        if self.policy.master_dtype is None:
            deq = stored
        elif not self.policy.master_scaled:
            deq = stored.float()
        else:
            deq = stored.float() * scale[self._seg(stored.device)]
        if out is None:
            return deq
        return out.copy_(deq)

    def downcast_master(self, vec: torch.Tensor, seed: int
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """float32 -> stored with stochastic rounding; the fp8 tier's scales
        come from the updated weights."""
        md = self.policy.master_dtype
        if md is None:
            return vec, None
        if not self.policy.master_scaled:
            return stochastic_round(vec, md, seed), None
        seg = self._seg(vec.device)
        scales = scales_from_amax(segment_amax(vec, seg, self._n_rows()), self._qmax)
        return stochastic_round(vec / scales[seg], md, seed), scales

    # --------------------------------------------------------------- slots
    def _is_flat_slot(self, v) -> bool:
        return isinstance(v, torch.Tensor) and v.dim() == 1 and v.dtype == torch.float32

    def encode_slots(self, slots: Dict[str, Any]) -> Dict[str, Any]:
        sd = self.policy.slot_dtype
        if sd is None:
            return slots
        return {k: v.to(sd) if k != MASTER_SCALE_KEY and self._is_flat_slot(v) else v
                for k, v in slots.items()}

    def decode_slots(self, slots: Dict[str, Any]) -> Dict[str, Any]:
        sd = self.policy.slot_dtype
        if sd is None:
            return slots
        return {k: v.float() if k != MASTER_SCALE_KEY and getattr(v, "dtype", None) == sd
                else v for k, v in slots.items()}

    def downcast_slots(self, slots: Dict[str, Any], seed_parts) -> Dict[str, Any]:
        """Each float32 slot vector narrowed with its own stream (salted by
        its sorted position)."""
        sd = self.policy.slot_dtype
        if sd is None:
            return slots
        out: Dict[str, Any] = {}
        for i, (k, v) in enumerate(sorted(slots.items())):
            if k != MASTER_SCALE_KEY and self._is_flat_slot(v):
                out[k] = stochastic_round(v, sd, sr_seed(*seed_parts, i))
            else:
                out[k] = v
        return out

    # ------------------------------------------------------------ the step
    def apply_update(self, method, gvec, master_stored, slots_stored, lr, step, *,
                     wd_coeff=None, lr_scale=None, pad_zero=None, p32=None):
        """Decode, ``update_flat`` in float32, re-zero the padding tail, then
        narrow back. ``p32`` is the decoded master when the caller already
        has it (it is updated in place). Returns ``(stored master, stored
        slots, p32)``: the stored vectors are written in place where their
        dtype allows."""
        mscale = slots_stored.get(MASTER_SCALE_KEY)
        if p32 is None:
            p32 = self.decode_master(master_stored, mscale)
            if p32 is master_stored:
                p32 = p32.clone()
        stored_slots = {k: v for k, v in slots_stored.items() if k != MASTER_SCALE_KEY}
        s32 = self.decode_slots(stored_slots)
        method.update_flat(gvec, p32, s32, lr, step, wd_coeff=wd_coeff, lr_scale=lr_scale)
        if pad_zero is not None:
            pad_zero(p32)  # before narrowing: a stale tail must never reach the codes
        new_p, new_scale = self.downcast_master(p32, sr_seed(step, 0xA))
        if new_p is not master_stored and new_p.dtype == master_stored.dtype:
            master_stored.copy_(new_p)
            new_p = master_stored
        narrowed = self.downcast_slots(s32, (step, 0xB))
        out_slots: Dict[str, Any] = {}
        for k, v in narrowed.items():
            old = stored_slots[k]
            if v is not old and isinstance(old, torch.Tensor) and v.dtype == old.dtype:
                old.copy_(v)
                v = old
            out_slots[k] = v
        if new_scale is not None:
            out_slots[MASTER_SCALE_KEY] = new_scale
        return new_p, out_slots, p32
