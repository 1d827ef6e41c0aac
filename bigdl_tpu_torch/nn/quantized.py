"""Quantized inference layers and the ``Module.quantize()`` rewriter
(counterpart of ``bigdl_tpu/nn/quantized.py``; reference:
``$DL/nn/quantized/{Quantization,Linear,SpatialConvolution,Utils}.scala``).

``quantize(module, dtype)`` rewrites a built float tree in place, swapping
each ``Linear``, ``SpatialConvolution`` and ``SpatialDilatedConvolution``
(exactly those classes, not their subclasses) for a quantized twin, and
switches the tree to eval mode (inference only).

* **int8** (``QuantizedLinear``, ``QuantizedSpatialConvolution``,
  ``QuantizedSpatialDilatedConvolution``): weights per output channel on
  the amax/127 grid, the input per tensor at each call, the product
  accumulated in int32 exactly as the JAX package's
  ``preferred_element_type=int32``: ``torch._int_mm`` (cuBLASLt's integer
  kernels on the card), the convolutions over an im2col of the int8 codes,
  one product per group. Never through a float convolution, whose f32 sums
  of int8 products stop being exact past 2^24 (``F.conv2d`` of two int8
  tensors even returns int8). ``_int_mm`` takes more than 16 rows and K and
  N multiples of 8: zero rows and columns pad the operands (they add
  nothing) and the result is cropped back.
* **fp8** (``Fp8Linear``, ``Fp8SpatialConvolution``,
  ``Fp8SpatialDilatedConvolution``): float8_e4m3fn weights per output
  channel and input per tensor, the product accumulated in float32:
  ``torch._scaled_mm`` with unit scales on the card (M, K and N padded to
  multiples of 16), the codes upcast to float32 on the CPU. e4m3 values and
  their products are exact in float32, so only the order of the sums
  differs from the JAX package's.

The dequantization ``acc * (s_x * s_w)`` and the bias stay in float32, as
in the JAX package. ``products(params, x)`` returns a layer's input codes,
input scale and accumulator, the quantities ``chip_smoke.py`` holds card
against CPU.
"""

from __future__ import annotations

import torch

from ..tensor.quantized import QuantizedTensor, quantize_fp8, quantize_symmetric
from ..utils.compat import float8_matmul_reason, probe_float8
from ..utils.precision import to_float, true_div
from .conv import SpatialConvolution, SpatialDilatedConvolution, conv_out_size, resolve_padding
from .linear import Linear
from .module import AbstractModule, Container


def _quantize_activation(x: torch.Tensor):
    """Dynamic per-tensor symmetric int8: ``(codes, float32 scale)``."""
    amax = torch.amax(torch.abs(x))
    scale = torch.where(amax > 0, true_div(amax, 127.0), torch.ones_like(amax)).to(torch.float32)
    xq = torch.clamp(torch.round(to_float(x) / scale), -127, 127).to(torch.int8)
    return xq, scale


def _quantize_activation_fp8(x: torch.Tensor, dtype: torch.dtype):
    """Dynamic per-tensor symmetric float8: the scale maps the tensor's amax
    to the format's max. ``(codes, float32 scale)``."""
    fmax = float(torch.finfo(dtype).max)
    amax = torch.amax(torch.abs(x))
    scale = torch.where(amax > 0, true_div(amax, fmax), torch.ones_like(amax)).to(torch.float32)
    return (to_float(x) / scale).to(dtype), scale


def _pad2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` (2-D) zero-extended to (rows, cols)."""
    if tuple(t.shape) == (rows, cols):
        return t.contiguous()
    out = t.new_zeros((rows, cols))
    out[:t.shape[0], :t.shape[1]] = t
    return out


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` for int8 ``a`` (M, K) and ``w`` (N, K), accumulated in
    int32 exactly (``torch._int_mm``; M > 16, K and N multiples of 8)."""
    m, k = a.shape
    n = w.shape[0]
    kp, np_ = _round_up(k, 8), _round_up(n, 8)
    acc = torch._int_mm(_pad2(a, max(m, 17), kp), _pad2(w, np_, kp).t())
    return acc[:m, :n]


def _fp8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w.T`` for float8 ``a`` (M, K) and ``w`` (N, K), accumulated in
    float32: ``torch._scaled_mm`` with unit scales on the card, the codes
    upcast to float32 elsewhere (e4m3 products are exact in float32)."""
    if a.device.type != "cuda":
        return a.to(torch.float32) @ w.to(torch.float32).t()
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = _round_up(m, 16), _round_up(k, 16), _round_up(n, 16)
    one = torch.ones((), dtype=torch.float32, device=a.device)
    acc = torch._scaled_mm(_pad2(a, mp, kp), _pad2(w, np_, kp).t(), scale_a=one, scale_b=one,
                           out_dtype=torch.float32)
    return acc[:m, :n]


def _im2col(xq: torch.Tensor, kernel, stride, padding, dilation) -> torch.Tensor:
    """The (N·OH·OW, C·kH·kW) patch matrix of NCHW codes, rows in (n, oh,
    ow) order and columns in the OIHW weight's (c, i, j) order. Built on the
    codes' bytes (float8 viewed as uint8: +0 is the zero byte), so no value
    is rounded."""
    (h_lo, h_hi), (w_lo, w_hi) = padding
    (kh, kw), (sh, sw), (dh, dw) = kernel, stride, dilation
    codes = xq.view(torch.uint8) if xq.is_floating_point() else xq
    n, c, h, w = codes.shape
    if h_lo or h_hi or w_lo or w_hi:
        padded = codes.new_zeros((n, c, h + h_lo + h_hi, w + w_lo + w_hi))
        padded[:, :, h_lo:h_lo + h, w_lo:w_lo + w] = codes
        codes = padded
    ke_h, ke_w = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    patches = codes.unfold(2, ke_h, sh).unfold(3, ke_w, sw)[..., ::dh, ::dw]
    oh, ow = patches.shape[2], patches.shape[3]
    cols = patches.permute(0, 2, 3, 1, 4, 5).reshape(n * oh * ow, c * kh * kw)
    return cols.view(xq.dtype) if xq.is_floating_point() else cols


class _QuantizedLayer(AbstractModule):
    """What the quantized layers share: the twin of a built float layer
    (``from_float``) and the call's products. A family sets
    ``_quantize_weight``, ``_quantize_input`` and ``_matmul``."""

    _quantize_weight = staticmethod(quantize_symmetric)

    @staticmethod
    def _quantize_input(x, params):
        return _quantize_activation(x)

    _matmul = staticmethod(_int8_matmul)

    @classmethod
    def from_float(cls, m):
        """The quantized twin of the built float layer ``m``, on its device."""
        if not m.is_built():
            raise ValueError(f"{m.name()}: quantize() requires a built module")
        fp = m.get_parameters()
        with torch.no_grad():
            qt = cls._quantize_weight(fp["weight"].detach(), channel_axis=0)
            params = {"weight_q": qt.values, "weight_scale": qt.scales}
            if m.with_bias:
                params["bias"] = fp["bias"].detach().clone()
        q = cls(*cls._twin_args(m), device=m.device)
        q.set_name(m.name())
        q._param_tree = {}
        for key, val in params.items():  # codes cannot require a gradient: none does
            q.register_parameter(key, torch.nn.Parameter(val, requires_grad=False))
            q._param_tree[key] = getattr(q, key)
        q._state = {}
        q._built = True
        return q

    def quantized_weight(self, params) -> QuantizedTensor:
        return QuantizedTensor(params["weight_q"], params["weight_scale"], 0)


class QuantizedLinear(_QuantizedLayer):
    """Int8 linear (reference: ``$DL/nn/quantized/Linear.scala``): int8
    weight (out, in), per-output-channel scales, float bias. Inference only;
    ``from_float`` captures a trained ``Linear``."""

    def __init__(self, input_size: int, output_size: int, with_bias: bool = True, device=None):
        super().__init__(device)
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.train(False)

    @classmethod
    def _twin_args(cls, m):
        return (m.input_size, m.output_size, m.with_bias)

    def products(self, params, x):
        """``(input codes, input scale, accumulator)`` of one call: the
        accumulator is int32 for int8, float32 for fp8."""
        xq, sx = self._quantize_input(x, params)
        lead = xq.shape[:-1]
        acc = self._matmul(xq.reshape(-1, xq.shape[-1]), params["weight_q"])
        return xq, sx, acc.reshape(*lead, acc.shape[-1])

    def _apply_params(self, params, state, x, training, rng):
        _, sx, acc = self.products(params, x)
        y = acc.to(torch.float32) * (sx * params["weight_scale"])
        if self.with_bias:
            y = y + params["bias"]
        return y, state


class QuantizedSpatialConvolution(_QuantizedLayer):
    """Int8 NCHW convolution (reference:
    ``$DL/nn/quantized/SpatialConvolution.scala``): the float layer's
    hyperparameters, int8 OIHW weights with per-output-channel scales, an
    int32 accumulator per output."""

    dilation = (1, 1)

    def __init__(self, n_input_plane, n_output_plane, kernel, stride, pad, n_group: int = 1,
                 with_bias: bool = True, device=None):
        super().__init__(device)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel = tuple(kernel)
        self.stride = tuple(stride)
        self.pad = tuple(pad)
        self.n_group = n_group
        self.with_bias = with_bias
        self.train(False)

    @classmethod
    def _twin_args(cls, m):
        return (m.get_parameters()["weight"].shape[1] * m.n_group, m.n_output_plane, m.kernel,
                m.stride, m.pad, m.n_group, m.with_bias)

    def products(self, params, x):
        """``(input codes, input scale, accumulator)``: the accumulator NCHW,
        int32 for int8, float32 for fp8."""
        xq, sx = self._quantize_input(x, params)
        w = params["weight_q"]
        padding = resolve_padding(self.pad, tuple(x.shape[2:]), self.kernel, self.stride,
                                  self.dilation)
        n, c, h, wd = xq.shape
        oh = conv_out_size(h + sum(padding[0]), self.kernel[0], self.stride[0], 0,
                           self.dilation[0])
        ow = conv_out_size(wd + sum(padding[1]), self.kernel[1], self.stride[1], 0,
                           self.dilation[1])
        cg, og = c // self.n_group, w.shape[0] // self.n_group
        accs = []
        for g in range(self.n_group):
            cols = _im2col(xq[:, g * cg:(g + 1) * cg], self.kernel, self.stride, padding,
                           self.dilation)
            accs.append(self._matmul(cols, w[g * og:(g + 1) * og].reshape(og, -1)))
        acc = accs[0] if len(accs) == 1 else torch.cat(accs, 1)
        return xq, sx, acc.reshape(n, oh, ow, -1).permute(0, 3, 1, 2)

    def _apply_params(self, params, state, x, training, rng):
        _, sx, acc = self.products(params, x)
        y = acc.to(torch.float32) * (sx * params["weight_scale"][None, :, None, None])
        if self.with_bias:
            y = y + params["bias"][None, :, None, None]
        return y, state


def _dilated_twin_args(m):
    return (m.get_parameters()["weight"].shape[1] * m.n_group, m.n_output_plane, m.kernel,
            m.stride, m.pad, m.dilation, m.n_group, m.with_bias)


class QuantizedSpatialDilatedConvolution(QuantizedSpatialConvolution):
    """Int8 atrous convolution (reference:
    ``$DL/nn/quantized/SpatialDilatedConvolution.scala``): the int8 scheme
    with the float layer's dilation."""

    def __init__(self, n_input_plane, n_output_plane, kernel, stride, pad, dilation=(1, 1),
                 n_group: int = 1, with_bias: bool = True, device=None):
        super().__init__(n_input_plane, n_output_plane, kernel, stride, pad, n_group,
                         with_bias, device=device)
        self.dilation = tuple(dilation)

    @classmethod
    def _twin_args(cls, m):
        return _dilated_twin_args(m)


# --------------------------------------------------------------------------
# the float8 serving tier (per-output-channel fp8 weights, f32-accumulated)
# --------------------------------------------------------------------------

def _fp8_input(x, params):
    return _quantize_activation_fp8(x, params["weight_q"].dtype)


class Fp8Linear(QuantizedLinear):
    """Float8 linear, the fp8 tier's twin of :class:`QuantizedLinear`:
    e4m3fn weights per output channel, the input per tensor in the same
    format, the product accumulated in float32."""

    _quantize_weight = staticmethod(quantize_fp8)
    _quantize_input = staticmethod(_fp8_input)
    _matmul = staticmethod(_fp8_matmul)


class Fp8SpatialConvolution(QuantizedSpatialConvolution):
    """Float8 NCHW convolution (fp8 twin of :class:`QuantizedSpatialConvolution`)."""

    _quantize_weight = staticmethod(quantize_fp8)
    _quantize_input = staticmethod(_fp8_input)
    _matmul = staticmethod(_fp8_matmul)


class Fp8SpatialDilatedConvolution(Fp8SpatialConvolution):
    """Float8 atrous convolution (fp8 twin of the int8 dilated layer)."""

    def __init__(self, n_input_plane, n_output_plane, kernel, stride, pad, dilation=(1, 1),
                 n_group: int = 1, with_bias: bool = True, device=None):
        super().__init__(n_input_plane, n_output_plane, kernel, stride, pad, n_group,
                         with_bias, device=device)
        self.dilation = tuple(dilation)

    @classmethod
    def _twin_args(cls, m):
        return _dilated_twin_args(m)


_QUANTIZABLE = {
    "int8": {Linear: QuantizedLinear.from_float,
             SpatialConvolution: QuantizedSpatialConvolution.from_float,
             SpatialDilatedConvolution: QuantizedSpatialDilatedConvolution.from_float},
    "fp8": {Linear: Fp8Linear.from_float,
            SpatialConvolution: Fp8SpatialConvolution.from_float,
            SpatialDilatedConvolution: Fp8SpatialDilatedConvolution.from_float},
}

# fp8 first: its classes subclass the int8 twins, so the most-derived
# family is checked before the base one
_QUANT_MODE_CLASSES = (
    ("fp8", (Fp8Linear, Fp8SpatialConvolution)),
    ("int8", (QuantizedLinear, QuantizedSpatialConvolution)),
)


def quantized_mode(module: AbstractModule):
    """``"int8"`` / ``"fp8"`` when the tree holds quantized layers of that
    family, else ``None`` (``ModelServer`` tags every serve record with it)."""
    for mode, classes in _QUANT_MODE_CLASSES:
        if any(isinstance(m, classes) for m in module.walk()):
            return mode
    return None


def _set_layers(container: Container, layers) -> None:
    """``container``'s children are ``layers`` (the JAX ``modules`` list,
    which may name one module twice for a graph's shared node); each name
    registers once, the last module of that name."""
    container._layers = list(layers)
    container._modules.clear()
    for m in container._layers:
        container._modules[m.name()] = m


def _convert(m: AbstractModule, table) -> AbstractModule:
    from .graph import Graph

    conv = table.get(type(m))
    if conv is not None:
        return conv(m)
    if isinstance(m, Graph):
        # the graph runs through node.module: rewrite each node's, then its
        # list of children, one per node as the JAX package's rewrite leaves it
        for node in m._topo:
            if node not in m.input_nodes:
                node.module = _convert(node.module, table)
        _set_layers(m, [n.module for n in m._topo if n not in m.input_nodes])
    elif isinstance(m, Container):
        _set_layers(m, [_convert(c, table) for c in m._layers])
    return m


def quantize(module: AbstractModule, dtype: str = "int8") -> AbstractModule:
    """``Module.quantize()``: rewrite the built tree, swapping ``Linear``,
    ``SpatialConvolution`` and ``SpatialDilatedConvolution`` instances for
    their quantized twins of the family ``dtype`` (``"int8"`` or ``"fp8"``);
    returns the tree in eval mode. fp8 on a torch build without float8, or
    on a card without fp8 products, raises ``ValueError``: nothing falls
    back to int8 or to float."""
    if not module.is_built():
        raise ValueError("quantize() requires a built module (run forward once)")
    table = _QUANTIZABLE.get(dtype)
    if table is None:
        raise ValueError(f"quantize(dtype={dtype!r}): unknown quantization family; "
                         f"choose one of {sorted(_QUANTIZABLE)}")
    if dtype == "fp8":
        support = probe_float8()
        reason = support.reason if not support.available else float8_matmul_reason(
            module.device)
        if reason is not None:
            raise ValueError("quantize(dtype='fp8') requires float8 support, which this "
                             f"stack lacks ({reason})")
    out = _convert(module, table)
    out.evaluate()
    return out
