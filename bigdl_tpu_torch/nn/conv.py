"""The convolutions of ``bigdl_tpu/nn/conv.py``: ``SpatialConvolution``,
``SpatialDilatedConvolution``, ``SpatialFullConvolution``,
``TemporalConvolution``, ``VolumetricConvolution``,
``SpatialSeparableConvolution`` and the locally connected
``LocallyConnected1D``/``LocallyConnected2D``. The
spatial ones: NCHW input, OIHW weights, Torch padding with
``-1`` meaning TensorFlow's SAME (for the dilated kernel's extent), groups,
dilation, an optional bias and an optional ``activation`` epilogue
(``precision.channel_bias_act``): ``act(conv + b)`` in torch ops, or, with a
bias under ``Engine.set_fused_kernels(True)``, the row-mode
``fused_bias_act`` (the CUDA kernels on the card). The convolution itself is
:func:`bigdl_tpu_torch.utils.precision.conv2d` (cuDNN on the card);
``VolumetricConvolution``'s is ``precision.conv3d``. The locally connected
layers take each output position's patch in (C, kh, kw) order, channel
major, as ``lax.conv_general_dilated_patches`` lays it out (``F.unfold``'s
order), and multiply it by that position's own weight (one einsum over the
positions, under the policy)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import precision
from .initialization import InitializationMethod, RandomUniform, Xavier, Zeros
from .module import AbstractModule, spec

SAME_PADDING = -1  # reference convention: pad = -1 means TF "SAME"


def conv_out_size(in_size: int, k: int, s: int, p: int, dilation: int = 1) -> int:
    """Torch conv output extent along one dim; ``p == -1`` is TF SAME."""
    if p == SAME_PADDING:
        return -(-in_size // s)
    ke = (k - 1) * dilation + 1
    return (in_size + 2 * p - ke) // s + 1


def resolve_padding(pad: Tuple[int, int], in_hw: Tuple[int, int], kernel: Tuple[int, int],
                    stride: Tuple[int, int], dilation: Tuple[int, int] = (1, 1)):
    """((h_lo, h_hi), (w_lo, w_hi)) zeros for Torch (padH, padW); -1 on either
    dim means SAME on both, split as XLA splits it (the odd cell high), for
    the dilated kernel's extent ``(k - 1) * d + 1`` as XLA's SAME with
    ``rhs_dilation`` pads."""
    if SAME_PADDING in pad:
        out = []
        for size, k, s, d in zip(in_hw, kernel, stride, dilation):
            ke = (k - 1) * d + 1
            total = max(0, (conv_out_size(size, k, s, SAME_PADDING) - 1) * s + ke - size)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    return (pad[0], pad[0]), (pad[1], pad[1])


class SpatialConvolution(AbstractModule):
    """2-D convolution over NCHW input; weight (nOutputPlane,
    nInputPlane/nGroup, kH, kW)."""

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) != 4:
            raise ValueError(f"{self.name()}: expects NCHW input, got shape {shape}")
        n, c, h, w = shape
        if self.n_input_plane is not None and c != self.n_input_plane:
            raise ValueError(f"{self.name()}: expected {self.n_input_plane} input channels, "
                             f"got {c} (input shape {shape})")
        if c % self.n_group:
            raise ValueError(f"{self.name()}: {c} input channels not divisible by "
                             f"n_group={self.n_group}")
        (kh, kw), (sh, sw), (ph, pw) = self.kernel, self.stride, self.pad
        dh, dw = self.dilation
        oh, ow = conv_out_size(h, kh, sh, ph, dh), conv_out_size(w, kw, sw, pw, dw)
        if oh <= 0 or ow <= 0:
            raise ValueError(f"{self.name()}: kernel {self.kernel} / stride {self.stride} / "
                             f"pad {self.pad} over-reduce the spatial dims of input {shape} "
                             f"(computed output {(oh, ow)})")
        return spec((n, self.n_output_plane, oh, ow), precision.result_dtype(in_spec.dtype))

    dilation: Tuple[int, int] = (1, 1)  # (dH, dW); SpatialDilatedConvolution sets it

    def __init__(self, n_input_plane: Optional[int], n_output_plane: int, kernel_w: int,
                 kernel_h: Optional[int] = None, stride_w: int = 1,
                 stride_h: Optional[int] = None, pad_w: int = 0, pad_h: Optional[int] = None,
                 n_group: int = 1, with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None, activation: Optional[str] = None, device=None):
        super().__init__(device)
        precision._act_fn(activation)  # validate the name
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel = (kernel_h if kernel_h is not None else kernel_w, kernel_w)
        self.stride = (stride_h if stride_h is not None else stride_w, stride_w)
        self.pad = (pad_h if pad_h is not None else pad_w, pad_w)
        self.n_group = n_group
        self.with_bias = with_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        self.activation = activation
        self.weight_init: InitializationMethod = Xavier()
        self.bias_init: InitializationMethod = Zeros()

    def set_init_method(self, weight_init=None, bias_init=None) -> "SpatialConvolution":
        if weight_init is not None:
            self.weight_init = weight_init
        if bias_init is not None:
            self.bias_init = bias_init
        return self

    def _build(self, generator, sample):
        cin = sample.shape[1]
        if self.n_input_plane is not None and self.n_input_plane != cin:
            raise ValueError(f"{self.name()}: expected {self.n_input_plane} channels, got {cin}")
        if cin % self.n_group or self.n_output_plane % self.n_group:
            raise ValueError(f"{self.name()}: channels {cin} -> {self.n_output_plane} not "
                             f"divisible by n_group={self.n_group}")
        self.n_input_plane = cin
        kh, kw = self.kernel
        fan_in = (cin // self.n_group) * kh * kw
        fan_out = (self.n_output_plane // self.n_group) * kh * kw
        params = {"weight": self.weight_init(
            generator, (self.n_output_plane, cin // self.n_group, kh, kw), fan_in, fan_out)}
        if self.with_bias:
            params["bias"] = self.bias_init(generator, (self.n_output_plane,), fan_in, fan_out)
        return params, {}

    def _apply_params(self, params, state, x, training, rng):
        padding = resolve_padding(self.pad, tuple(x.shape[2:]), self.kernel, self.stride,
                                  self.dilation)
        y = precision.conv2d(x, params["weight"], self.stride, padding, self.n_group,
                             self.dilation)
        return precision.channel_bias_act(y, params["bias"] if self.with_bias else None,
                                          self.activation), state

    def regularization_loss(self, params):
        loss = 0.0
        if self.w_regularizer is not None:
            loss = loss + self.w_regularizer(params["weight"])
        if self.b_regularizer is not None and self.with_bias:
            loss = loss + self.b_regularizer(params["bias"])
        return loss


class SpatialDilatedConvolution(SpatialConvolution):
    """Atrous convolution (reference: ``$DL/nn/SpatialDilatedConvolution.scala``):
    ``SpatialConvolution``'s arguments plus ``dilation_w``/``dilation_h``."""

    def __init__(self, *args, dilation_w: int = 1, dilation_h: int = 1, **kw):
        super().__init__(*args, **kw)
        self.dilation = (dilation_h, dilation_w)


class SpatialFullConvolution(AbstractModule):
    """Transposed convolution, the deconvolution (reference:
    ``$DL/nn/SpatialFullConvolution.scala``): NCHW input, weight (nInputPlane,
    nOutputPlane, kH, kW) (Torch's own layout), ``Xavier`` weights and a zero
    bias; output extent ``(in - 1) * stride - 2 * pad + kernel + adj`` per
    dim for any ``adj`` (:func:`~bigdl_tpu_torch.utils.precision.
    conv_transpose2d`). No activation epilogue, as in the JAX package."""

    def __init__(self, n_input_plane: Optional[int], n_output_plane: int, kernel_w: int,
                 kernel_h: Optional[int] = None, stride_w: int = 1,
                 stride_h: Optional[int] = None, pad_w: int = 0, pad_h: Optional[int] = None,
                 adj_w: int = 0, adj_h: int = 0, with_bias: bool = True, device=None):
        super().__init__(device)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel = (kernel_h if kernel_h is not None else kernel_w, kernel_w)
        self.stride = (stride_h if stride_h is not None else stride_w, stride_w)
        self.pad = (pad_h if pad_h is not None else pad_w, pad_w)
        self.adj = (adj_h, adj_w)
        self.with_bias = with_bias
        self.weight_init: InitializationMethod = Xavier()

    def _build(self, generator, sample):
        cin = sample.shape[1]
        if self.n_input_plane is not None and self.n_input_plane != cin:
            raise ValueError(f"{self.name()}: declared {self.n_input_plane} input planes, "
                             f"got {cin}")
        self.n_input_plane = cin
        kh, kw = self.kernel
        params = {"weight": self.weight_init(generator, (cin, self.n_output_plane, kh, kw),
                                             cin * kh * kw, self.n_output_plane * kh * kw)}
        if self.with_bias:
            params["bias"] = torch.zeros(self.n_output_plane)
        return params, {}

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) != 4:
            raise ValueError(f"{self.name()}: expects NCHW input, got shape {shape}")
        n, c, h, w = shape
        if self.n_input_plane is not None and c != self.n_input_plane:
            raise ValueError(f"{self.name()}: declared {self.n_input_plane} input planes, "
                             f"got {c} (input shape {shape})")
        (kh, kw), (sh, sw), (ph, pw), (ah, aw) = self.kernel, self.stride, self.pad, self.adj
        oh = (h - 1) * sh - 2 * ph + kh + ah
        ow = (w - 1) * sw - 2 * pw + kw + aw
        if oh <= 0 or ow <= 0:
            raise ValueError(f"{self.name()}: deconv output {(oh, ow)} is empty for input "
                             f"{shape} (kernel {self.kernel}, stride {self.stride}, "
                             f"pad {self.pad}, adj {self.adj})")
        return spec((n, self.n_output_plane, oh, ow), precision.result_dtype(in_spec.dtype))

    def _apply_params(self, params, state, x, training, rng):
        y = precision.conv_transpose2d(x, params["weight"], self.stride, self.pad, self.adj)
        if self.with_bias:
            y = precision.bias_add(y, params["bias"].reshape(1, -1, 1, 1))
        return y, state


class TemporalConvolution(AbstractModule):
    """1-D convolution over (N, T, C) input (reference:
    ``$DL/nn/TemporalConvolution.scala``): weight (O, C, K) and bias (O,),
    both ``RandomUniform`` (U(±1/sqrt(C·K))), no padding, ``stride_w`` and
    ``dilation_w``; (N, T', O) out. The convolution is
    :func:`~bigdl_tpu_torch.utils.precision.conv1d`, the bias
    ``precision.bias_add`` (no activation epilogue, as in the JAX package).
    A frame size other than the declared one, an input that is not 3-D or
    a dilated kernel wider than T raise ``ValueError`` with the JAX
    package's words."""

    def infer_shape(self, in_spec):
        self._check(in_spec)
        n, t, _ = in_spec.shape
        ot = (t - ((self.kernel_w - 1) * self.dilation_w + 1)) // self.stride_w + 1
        return spec((n, ot, self.output_frame_size), precision.result_dtype(in_spec.dtype))

    def __init__(self, input_frame_size: Optional[int], output_frame_size: int, kernel_w: int,
                 stride_w: int = 1, dilation_w: int = 1, device=None):
        super().__init__(device)
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        self.dilation_w = dilation_w
        self.weight_init: InitializationMethod = RandomUniform()

    def _check(self, x) -> None:
        shape = tuple(x.shape)
        if len(shape) != 3:
            raise ValueError(f"{self.name()}: expects (N, T, C) input, got shape {shape}")
        t, c = shape[1], shape[2]
        if self.input_frame_size is not None and c != self.input_frame_size:
            raise ValueError(f"{self.name()}: declared frame size {self.input_frame_size}, "
                             f"got {c} (input shape {shape})")
        ke = (self.kernel_w - 1) * self.dilation_w + 1
        if (t - ke) // self.stride_w + 1 <= 0:
            raise ValueError(f"{self.name()}: kernel {self.kernel_w} (dilation "
                             f"{self.dilation_w}) exceeds the {t} input frames of {shape}")

    def _build(self, generator, sample):
        self._check(sample)
        cin = sample.shape[-1]
        self.input_frame_size = cin
        fan_in, out = cin * self.kernel_w, self.output_frame_size
        return {"weight": self.weight_init(generator, (out, cin, self.kernel_w), fan_in, out),
                "bias": self.weight_init(generator, (out,), fan_in, out)}, {}

    def _apply_params(self, params, state, x, training, rng):
        self._check(x)
        y = precision.conv1d(x.transpose(1, 2), params["weight"], self.stride_w,
                             self.dilation_w)
        return precision.bias_add(y.transpose(1, 2), params["bias"]), state


class VolumetricConvolution(AbstractModule):
    """3-D convolution over NCDHW input (reference:
    ``$DL/nn/VolumetricConvolution.scala``): weight (nOutputPlane,
    nInputPlane, kT, kH, kW), ``Xavier``, a zero bias; padding (pad_t,
    pad_h, pad_w) on both sides. The constructor's order is the
    reference's: (k_t, k_w, k_h, d_t, d_w, d_h, pad_t, pad_w, pad_h)."""

    def __init__(self, n_input_plane: Optional[int], n_output_plane: int, k_t: int, k_w: int,
                 k_h: int, d_t: int = 1, d_w: int = 1, d_h: int = 1, pad_t: int = 0,
                 pad_w: int = 0, pad_h: int = 0, with_bias: bool = True, device=None):
        super().__init__(device)
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel = (k_t, k_h, k_w)
        self.stride = (d_t, d_h, d_w)
        self.pad = (pad_t, pad_h, pad_w)
        self.with_bias = with_bias
        self.weight_init: InitializationMethod = Xavier()

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) != 5:
            raise ValueError(f"{self.name()}: expects NCDHW input, got shape {shape}")
        n, c = shape[:2]
        if self.n_input_plane is not None and c != self.n_input_plane:
            raise ValueError(f"{self.name()}: expected {self.n_input_plane} input planes, "
                             f"got {c} (input shape {shape})")
        out = tuple((i + 2 * p - k) // s + 1
                    for i, k, s, p in zip(shape[2:], self.kernel, self.stride, self.pad))
        if min(out) <= 0:
            raise ValueError(f"{self.name()}: kernel {self.kernel} / stride {self.stride} / "
                             f"pad {self.pad} over-reduce input {shape} (output {out})")
        return spec((n, self.n_output_plane) + out, precision.result_dtype(in_spec.dtype))

    def _build(self, generator, sample):
        cin = sample.shape[1]
        if self.n_input_plane is not None and self.n_input_plane != cin:
            raise ValueError(f"{self.name()}: expected {self.n_input_plane} input planes, "
                             f"got {cin}")
        self.n_input_plane = cin
        kt, kh, kw = self.kernel
        params = {"weight": self.weight_init(
            generator, (self.n_output_plane, cin, kt, kh, kw), cin * kt * kh * kw,
            self.n_output_plane * kt * kh * kw)}
        if self.with_bias:
            params["bias"] = torch.zeros(self.n_output_plane)
        return params, {}

    def _apply_params(self, params, state, x, training, rng):
        y = precision.conv3d(x, params["weight"], self.stride, self.pad)
        if self.with_bias:
            y = precision.bias_add(y, params["bias"].reshape(1, -1, 1, 1, 1))
        return y, state


class LocallyConnected2D(AbstractModule):
    """A convolution-shaped layer with its own weights at every output
    position (reference: ``$DL/nn/LocallyConnected2D.scala``): weight
    (oH·oW, nOutputPlane, C·kH·kW) over the (C, kh, kw)-ordered patch, bias
    (nOutputPlane, oH, oW); the input's H and W are fixed at construction."""

    def __init__(self, n_input_plane: Optional[int], input_width: int, input_height: int,
                 n_output_plane: int, kernel_w: int, kernel_h: Optional[int] = None,
                 stride_w: int = 1, stride_h: Optional[int] = None, pad_w: int = 0,
                 pad_h: Optional[int] = None, with_bias: bool = True, device=None):
        super().__init__(device)
        self.n_input_plane = n_input_plane
        self.input_width = input_width
        self.input_height = input_height
        self.n_output_plane = n_output_plane
        self.kernel = (kernel_h if kernel_h is not None else kernel_w, kernel_w)
        self.stride = (stride_h if stride_h is not None else stride_w, stride_w)
        self.pad = (pad_h if pad_h is not None else pad_w, pad_w)
        self.with_bias = with_bias
        self.weight_init: InitializationMethod = Xavier()

    def _out_hw(self) -> Tuple[int, int]:
        (kh, kw), (sh, sw), (ph, pw) = self.kernel, self.stride, self.pad
        return ((self.input_height + 2 * ph - kh) // sh + 1,
                (self.input_width + 2 * pw - kw) // sw + 1)

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) != 4:
            raise ValueError(f"{self.name()}: expects NCHW input, got shape {shape}")
        n, c, h, w = shape
        if self.n_input_plane is not None and c != self.n_input_plane:
            raise ValueError(f"{self.name()}: expected {self.n_input_plane} channels, got {c} "
                             f"(input shape {shape})")
        if (h, w) != (self.input_height, self.input_width):
            raise ValueError(f"{self.name()}: per-position weights are bound to input "
                             f"{self.input_height}x{self.input_width}, got {h}x{w} "
                             f"(input shape {shape})")
        oh, ow = self._out_hw()
        return spec((n, self.n_output_plane, oh, ow), precision.result_dtype(in_spec.dtype))

    def _build(self, generator, sample):
        cin = sample.shape[1]
        if self.n_input_plane is not None and self.n_input_plane != cin:
            raise ValueError(f"{self.name()}: expected {self.n_input_plane} channels, got {cin}")
        self.n_input_plane = cin
        kh, kw = self.kernel
        oh, ow = self._out_hw()
        params = {"weight": self.weight_init(
            generator, (oh * ow, self.n_output_plane, cin * kh * kw), cin * kh * kw,
            self.n_output_plane)}
        if self.with_bias:
            params["bias"] = torch.zeros(self.n_output_plane, oh, ow)
        return params, {}

    def _apply_params(self, params, state, x, training, rng):
        n = x.shape[0]
        oh, ow = self._out_hw()
        patches = torch.nn.functional.unfold(x, self.kernel, padding=self.pad,
                                             stride=self.stride)  # (N, C·kh·kw, oh·ow)
        y = precision.einsum("npk,pok->npo", patches.transpose(1, 2), params["weight"])
        y = y.transpose(1, 2).reshape(n, self.n_output_plane, oh, ow)
        if self.with_bias:
            y = precision.bias_add(y, params["bias"][None])
        return y, state


class LocallyConnected1D(AbstractModule):
    """``TemporalConvolution`` with its own weights at every output frame,
    over (N, T, C) (reference: ``$DL/nn/LocallyConnected1D.scala``): weight
    (oT, output_frame_size, C·kw) over the (C, kw)-ordered frame,
    ``RandomUniform``; bias (oT, output_frame_size), zeros; T is fixed at
    construction."""

    def __init__(self, n_input_frame: int, input_frame_size: int, output_frame_size: int,
                 kernel_w: int, stride_w: int = 1, device=None):
        super().__init__(device)
        self.n_input_frame = n_input_frame
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        self.weight_init: InitializationMethod = RandomUniform()

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) != 3:
            raise ValueError(f"{self.name()}: expects (N, T, C) input, got shape {shape}")
        n, t, c = shape
        if c != self.input_frame_size:
            raise ValueError(f"{self.name()}: declared frame size {self.input_frame_size}, "
                             f"got {c} (input shape {shape})")
        if t != self.n_input_frame:
            raise ValueError(f"{self.name()}: per-frame weights are bound to "
                             f"{self.n_input_frame} input frames, got {t} (input shape {shape})")
        ot = (self.n_input_frame - self.kernel_w) // self.stride_w + 1
        return spec((n, ot, self.output_frame_size), precision.result_dtype(in_spec.dtype))

    def _build(self, generator, sample):
        cin = sample.shape[-1]
        if self.input_frame_size != cin:
            raise ValueError(f"{self.name()}: declared frame size {self.input_frame_size}, "
                             f"got {cin}")
        ot = (self.n_input_frame - self.kernel_w) // self.stride_w + 1
        return {"weight": self.weight_init(generator, (ot, self.output_frame_size,
                                                       cin * self.kernel_w),
                                           cin * self.kernel_w, self.output_frame_size),
                "bias": torch.zeros(ot, self.output_frame_size)}, {}

    def _apply_params(self, params, state, x, training, rng):
        n, _, c = x.shape
        frames = x.transpose(1, 2).unfold(2, self.kernel_w, self.stride_w)  # (N, C, oT, kw)
        frames = frames.permute(0, 2, 1, 3).reshape(n, frames.shape[2], c * self.kernel_w)
        y = precision.einsum("ntk,tok->nto", frames, params["weight"])
        return precision.bias_add(y, params["bias"][None]), state


class SpatialSeparableConvolution(AbstractModule):
    """Depthwise then pointwise convolution over NCHW (reference:
    ``$DL/nn/SpatialSeparableConvolution.scala``): ``depth_weight``
    (C·depth_multiplier, 1, kH, kW) in C groups, with Torch padding (-1:
    SAME), then ``point_weight`` (nOutputChannel, C·depth_multiplier, 1, 1)
    and a zero bias; both weights ``Xavier``."""

    def __init__(self, n_input_channel: Optional[int], n_output_channel: int,
                 depth_multiplier: int, kernel_w: int, kernel_h: Optional[int] = None,
                 stride_w: int = 1, stride_h: Optional[int] = None, pad_w: int = 0,
                 pad_h: Optional[int] = None, with_bias: bool = True, device=None):
        super().__init__(device)
        self.n_input_channel = n_input_channel
        self.n_output_channel = n_output_channel
        self.depth_multiplier = depth_multiplier
        self.kernel = (kernel_h if kernel_h is not None else kernel_w, kernel_w)
        self.stride = (stride_h if stride_h is not None else stride_w, stride_w)
        self.pad = (pad_h if pad_h is not None else pad_w, pad_w)
        self.with_bias = with_bias
        self.weight_init: InitializationMethod = Xavier()

    def infer_shape(self, in_spec):
        shape = tuple(in_spec.shape)
        if len(shape) != 4:
            raise ValueError(f"{self.name()}: expects NCHW input, got shape {shape}")
        n, c, h, w = shape
        if self.n_input_channel is not None and c != self.n_input_channel:
            raise ValueError(f"{self.name()}: expected {self.n_input_channel} input channels, "
                             f"got {c} (input shape {shape})")
        (kh, kw), (sh, sw), (ph, pw) = self.kernel, self.stride, self.pad
        oh, ow = conv_out_size(h, kh, sh, ph), conv_out_size(w, kw, sw, pw)
        if oh <= 0 or ow <= 0:
            raise ValueError(f"{self.name()}: kernel {self.kernel} / stride {self.stride} / "
                             f"pad {self.pad} over-reduce the spatial dims of input {shape}")
        return spec((n, self.n_output_channel, oh, ow), precision.result_dtype(in_spec.dtype))

    def _build(self, generator, sample):
        cin = sample.shape[1]
        if self.n_input_channel is not None and self.n_input_channel != cin:
            raise ValueError(f"{self.name()}: expected {self.n_input_channel} channels, "
                             f"got {cin}")
        self.n_input_channel = cin
        (kh, kw), dm = self.kernel, self.depth_multiplier
        params = {"depth_weight": self.weight_init(generator, (cin * dm, 1, kh, kw), kh * kw,
                                                   kh * kw),
                  "point_weight": self.weight_init(generator,
                                                   (self.n_output_channel, cin * dm, 1, 1),
                                                   cin * dm, self.n_output_channel)}
        if self.with_bias:
            params["bias"] = torch.zeros(self.n_output_channel)
        return params, {}

    def _apply_params(self, params, state, x, training, rng):
        padding = resolve_padding(self.pad, tuple(x.shape[2:]), self.kernel, self.stride)
        y = precision.conv2d(x, params["depth_weight"], self.stride, padding, x.shape[1])
        y = precision.conv2d(y, params["point_weight"], (1, 1), ((0, 0), (0, 0)))
        if self.with_bias:
            y = precision.bias_add(y, params["bias"].reshape(1, -1, 1, 1))
        return y, state
