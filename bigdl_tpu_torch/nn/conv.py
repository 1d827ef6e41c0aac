"""``SpatialConvolution`` (counterpart of ``bigdl_tpu/nn/conv.py``): NCHW
input, OIHW weights, Torch padding with ``-1`` meaning TensorFlow's SAME,
groups, an optional bias and an optional ``activation`` epilogue
(``precision.channel_bias_act``): ``act(conv + b)`` in torch ops, or, with a
bias under ``Engine.set_fused_kernels(True)``, the row-mode
``fused_bias_act`` (the CUDA kernels on the card). The convolution itself is
:func:`bigdl_tpu_torch.utils.precision.conv2d` (cuDNN on the card)."""

from __future__ import annotations

from typing import Optional, Tuple

from ..utils import precision
from .initialization import InitializationMethod, Xavier, Zeros
from .module import AbstractModule

SAME_PADDING = -1  # reference convention: pad = -1 means TF "SAME"


def conv_out_size(in_size: int, k: int, s: int, p: int, dilation: int = 1) -> int:
    """Torch conv output extent along one dim; ``p == -1`` is TF SAME."""
    if p == SAME_PADDING:
        return -(-in_size // s)
    ke = (k - 1) * dilation + 1
    return (in_size + 2 * p - ke) // s + 1


def resolve_padding(pad: Tuple[int, int], in_hw: Tuple[int, int], kernel: Tuple[int, int],
                    stride: Tuple[int, int]):
    """((h_lo, h_hi), (w_lo, w_hi)) zeros for Torch (padH, padW); -1 on either
    dim means SAME on both, split as XLA splits it (the odd cell high)."""
    if SAME_PADDING in pad:
        out = []
        for size, k, s in zip(in_hw, kernel, stride):
            total = max(0, (conv_out_size(size, k, s, SAME_PADDING) - 1) * s + k - size)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    return (pad[0], pad[0]), (pad[1], pad[1])


class SpatialConvolution(AbstractModule):
    """2-D convolution over NCHW input; weight (nOutputPlane,
    nInputPlane/nGroup, kH, kW)."""

    def __init__(self, n_input_plane: Optional[int], n_output_plane: int, kernel_w: int,
                 kernel_h: Optional[int] = None, stride_w: int = 1,
                 stride_h: Optional[int] = None, pad_w: int = 0, pad_h: Optional[int] = None,
                 n_group: int = 1, with_bias: bool = True, activation: Optional[str] = None,
                 device=None):
        super().__init__(device)
        precision._act_fn(activation)  # validate the name
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel = (kernel_h if kernel_h is not None else kernel_w, kernel_w)
        self.stride = (stride_h if stride_h is not None else stride_w, stride_w)
        self.pad = (pad_h if pad_h is not None else pad_w, pad_w)
        self.n_group = n_group
        self.with_bias = with_bias
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
        padding = resolve_padding(self.pad, tuple(x.shape[2:]), self.kernel, self.stride)
        y = precision.conv2d(x, params["weight"], self.stride, padding, self.n_group)
        return precision.channel_bias_act(y, params["bias"] if self.with_bias else None,
                                          self.activation), state
