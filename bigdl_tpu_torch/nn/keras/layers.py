"""Keras-1.2.2-style layer wrappers (counterpart of
``bigdl_tpu/nn/keras/layers.py``; reference: ``$DL/nn/keras/*.scala``).

A wrapper is a lazy ``Sequential`` whose children are made at build time
from the input's shape (the reference's ``InferShape``), each the core class
the JAX wrapper makes, with the same arguments: ``Merge(mode="concat")`` is
``JoinTable(concat_axis + 1)``, ``Deconvolution2D`` a
``SpatialFullConvolution``, ``MaxPooling2D`` a ``SpatialMaxPooling`` (whose
backward is the max-pool kernel on the card). The children are named
``<Type>_<index>`` as the JAX package names them, so a wrapper's parameter
tree is ``{child name: child tree}`` on the JAX paths. They are made on the
wrapper's ``device`` (the card unless ``"cpu"``). ``__call__`` on a graph
node (or a list of them) wires the functional API (``Dense(10)(x)``); on
data it runs ``forward``. ``dim_ordering`` is 'th' (NCHW) only, and the
valid-only modes raise, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import activations as A
from ..activations import SReLU as CoreSReLU
from ..activations import ThresholdedReLU as CoreThresholdedReLU
from ..conv import LocallyConnected1D as CoreLocallyConnected1D
from ..conv import LocallyConnected2D as CoreLocallyConnected2D
from ..conv import (SpatialConvolution, SpatialDilatedConvolution, SpatialFullConvolution,
                    SpatialSeparableConvolution, TemporalConvolution, VolumetricConvolution)
from ..dropout import Dropout as CoreDropout
from ..dropout import GaussianDropout as CoreGaussianDropout
from ..dropout import GaussianNoise as CoreGaussianNoise
from ..dropout import SpatialDropout1D as CoreSpatialDropout1D
from ..dropout import SpatialDropout2D as CoreSpatialDropout2D
from ..dropout import SpatialDropout3D as CoreSpatialDropout3D
from ..embedding import LookupTable
from ..graph import ModuleNode
from ..initialization import MsraFiller, Ones, RandomNormal, RandomUniform, Xavier, Zeros
from ..linear import Highway as CoreHighway
from ..linear import Linear, Maxout
from ..module import AbstractModule
from ..module import Sequential as CoreSequential
from ..normalization import BatchNormalization as CoreBatchNorm
from ..normalization import SpatialBatchNormalization
from ..pooling import (SpatialAveragePooling, SpatialMaxPooling, TemporalAveragePooling,
                       TemporalMaxPooling, VolumetricAveragePooling, VolumetricMaxPooling)
from ..recurrent import GRU as GRUCell
from ..recurrent import LSTM as LSTMCell
from ..recurrent import BiRecurrent, ConvLSTMPeephole, Recurrent, RnnCell
from ..recurrent import TimeDistributed as CoreTimeDistributed
from ..structural import Cropping1D as CoreCropping1D
from ..structural import Cropping2D as CoreCropping2D
from ..structural import Cropping3D as CoreCropping3D
from ..structural import Flatten as CoreFlatten
from ..structural import Masking as CoreMasking
from ..structural import Reshape as CoreReshape
from ..structural import (Padding, Replicate, Select, SpatialZeroPadding, Transpose)
from ..structural import UpSampling1D as CoreUpSampling1D
from ..structural import UpSampling2D as CoreUpSampling2D
from ..structural import UpSampling3D as CoreUpSampling3D
from ..table_ops import CAddTable, CAveTable, CMaxTable, CMulTable, JoinTable

_ACTIVATIONS = {
    "relu": A.ReLU,
    "tanh": A.Tanh,
    "sigmoid": A.Sigmoid,
    "hard_sigmoid": A.HardSigmoid,
    "softmax": A.SoftMax,
    "log_softmax": A.LogSoftMax,
    "softplus": A.SoftPlus,
    "softsign": A.SoftSign,
    "elu": A.ELU,
}

_INITS = {
    "glorot_uniform": Xavier,
    "glorot_normal": Xavier,  # the closest core method, as in the JAX package
    "he_normal": MsraFiller,
    "uniform": RandomUniform,
    "normal": RandomNormal,
    "zero": Zeros,
    "one": Ones,
}

def activation_module(name: Optional[str], device=None) -> Optional[AbstractModule]:
    if name is None or name == "linear":
        return None
    try:
        return _ACTIVATIONS[name](device=device)
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None


def _init_method(name: Optional[str]):
    if name is None:
        return None
    try:
        return _INITS[name]()
    except KeyError:
        raise ValueError(f"unknown init {name!r}") from None


def _check_dim_ordering(kwargs: dict) -> None:
    """This layer set is 'th' (NCHW) only, like the reference's; a silently
    dropped 'tf' request would convolve over the wrong axes."""
    ordering = kwargs.pop("dim_ordering", "th")
    if ordering != "th":
        raise ValueError(f"dim_ordering='th' (NCHW) is the only supported layout, got "
                         f"{ordering!r} — transpose the data to NCHW instead")


class KerasLayer(CoreSequential):
    """Base wrapper: the children are made from the input at build time."""

    def __init__(self, activation: Optional[str] = None,
                 input_shape: Optional[Sequence[int]] = None, device=None):
        super().__init__(device=device)
        self.activation_name = activation
        self.input_shape = tuple(input_shape) if input_shape is not None else None

    def _make(self, in_spec) -> List[AbstractModule]:
        raise NotImplementedError

    @property
    def _d(self) -> dict:
        """The device keyword of the children this wrapper makes."""
        return {"device": self._device}

    def infer_shape(self, in_spec):
        if not self._layers:
            # the children are made at build: a meta build infers the shape
            return NotImplemented
        return super().infer_shape(in_spec)

    def build(self, generator, sample) -> None:
        if not self._layers:
            for m in self._make(sample):
                self.add(m)
            act = activation_module(self.activation_name, self._device)
            if act is not None:
                self.add(act)
        super().build(generator, sample)

    def __call__(self, x):
        if isinstance(x, ModuleNode):
            return self.inputs(x)
        if isinstance(x, (list, tuple)) and x and all(isinstance(n, ModuleNode) for n in x):
            return self.inputs(*x)
        return super().__call__(x)


class Dense(KerasLayer):
    """Keras Dense (reference: ``$DL/nn/keras/Dense.scala``): a ``Linear``
    with the named init and a zero bias."""

    def __init__(self, output_dim: int, init: str = "glorot_uniform",
                 activation: Optional[str] = None, bias: bool = True, W_regularizer=None,
                 b_regularizer=None, input_shape=None, device=None, **_ignored):
        super().__init__(activation, input_shape, device)
        self.output_dim = output_dim
        self.init_name = init
        self.bias = bias
        self.w_reg, self.b_reg = W_regularizer, b_regularizer

    def _make(self, in_spec):
        lin = Linear(None, self.output_dim, self.bias, self.w_reg, self.b_reg, **self._d)
        lin.set_init_method(_init_method(self.init_name), Zeros())
        return [lin]


class Activation(KerasLayer):
    def __init__(self, activation: str, input_shape=None, device=None):
        super().__init__(activation, input_shape, device)

    def _make(self, in_spec):
        return []


class Dropout(KerasLayer):
    def __init__(self, p: float, input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        self.p = p

    def _make(self, in_spec):
        return [CoreDropout(self.p, **self._d)]


class Flatten(KerasLayer):
    def _make(self, in_spec):
        return [CoreFlatten(**self._d)]


class Reshape(KerasLayer):
    def __init__(self, target_shape: Sequence[int], input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        self.target_shape = tuple(target_shape)

    def _make(self, in_spec):
        return [CoreReshape(self.target_shape, **self._d)]


class Convolution2D(KerasLayer):
    """Keras Convolution2D, th ordering (reference: keras/Convolution2D.scala):
    a ``SpatialConvolution`` (SAME as pad -1) with the named init and a zero
    bias."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int, init: str = "glorot_uniform",
                 activation: Optional[str] = None, border_mode: str = "valid",
                 subsample: Tuple[int, int] = (1, 1), bias: bool = True, W_regularizer=None,
                 b_regularizer=None, input_shape=None, device=None, **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(activation, input_shape, device)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode must be valid|same, got {border_mode!r}")
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.init_name = init
        self.border_mode = border_mode
        self.subsample = subsample
        self.bias = bias
        self.w_reg, self.b_reg = W_regularizer, b_regularizer

    def _make(self, in_spec):
        pad = -1 if self.border_mode == "same" else 0
        conv = SpatialConvolution(in_spec.shape[1], self.nb_filter, self.nb_col, self.nb_row,
                                  self.subsample[1], self.subsample[0], pad, pad,
                                  with_bias=self.bias, w_regularizer=self.w_reg,
                                  b_regularizer=self.b_reg, **self._d)
        conv.set_init_method(_init_method(self.init_name), Zeros())
        return [conv]


class _Pool2D(KerasLayer):
    def __init__(self, pool_size=(2, 2), strides=None, border_mode="valid", input_shape=None,
                 device=None, **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(None, input_shape, device)
        self.pool_size = pool_size
        self.strides = strides if strides is not None else pool_size
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode must be valid|same, got {border_mode!r}")
        self.border_mode = border_mode

    def _pool_args(self):
        ph, pw = (-1, -1) if self.border_mode == "same" else (0, 0)
        return dict(kernel_w=self.pool_size[1], kernel_h=self.pool_size[0],
                    stride_w=self.strides[1], stride_h=self.strides[0], pad_w=pw, pad_h=ph,
                    **self._d)


class MaxPooling2D(_Pool2D):
    def _make(self, in_spec):
        return [SpatialMaxPooling(**self._pool_args())]


class AveragePooling2D(_Pool2D):
    def _make(self, in_spec):
        return [SpatialAveragePooling(count_include_pad=False, **self._pool_args())]


class _GlobalPool(AbstractModule):
    """A reduction over ``axes``: ``op`` is ``torch.mean`` or ``torch.amax``
    (``jnp.mean``/``jnp.max`` in the JAX package; ``amax`` splits a tied
    maximum's gradient evenly, as ``jnp.max``'s does). Backs the six
    Global*Pooling wrappers."""

    def __init__(self, op, axes, device=None):
        super().__init__(device)
        self._op = op
        self.axes = tuple(axes)

    def _apply_params(self, params, state, x, training, rng):
        return self._op(x, dim=self.axes), state


class GlobalAveragePooling2D(KerasLayer):
    def _make(self, in_spec):
        return [_GlobalPool(torch.mean, (2, 3), **self._d)]


class GlobalMaxPooling2D(KerasLayer):
    def _make(self, in_spec):
        return [_GlobalPool(torch.amax, (2, 3), **self._d)]


class BatchNormalization(KerasLayer):
    """Keras BatchNormalization, axis 1 (th): spatial or 1-D from the
    input's rank at build; keras' momentum weights the OLD statistics, the
    core's the new batch's, so the core gets ``1 - momentum``."""

    def __init__(self, epsilon: float = 1e-3, momentum: float = 0.99, input_shape=None,
                 device=None, **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(None, input_shape, device)
        self.epsilon = epsilon
        self.momentum = momentum

    def _make(self, in_spec):
        cls = SpatialBatchNormalization if len(in_spec.shape) == 4 else CoreBatchNorm
        return [cls(in_spec.shape[1], eps=self.epsilon, momentum=1.0 - self.momentum,
                    **self._d)]


class Embedding(KerasLayer):
    def __init__(self, input_dim: int, output_dim: int, input_shape=None, W_regularizer=None,
                 device=None, **_ignored):
        super().__init__(None, input_shape, device)
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.w_reg = W_regularizer

    def _make(self, in_spec):
        return [LookupTable(self.input_dim, self.output_dim, w_regularizer=self.w_reg,
                            **self._d)]


def _relu(x):
    return torch.maximum(x, x.new_zeros(()))  # a tie's gradient split evenly, as jnp's


def _sigmoid(x):
    return 1.0 / (1.0 + torch.exp(-x))


_RNN_ACTIVATIONS = {"tanh": torch.tanh, "relu": _relu, "sigmoid": _sigmoid}


class _KerasRNN(KerasLayer):
    def __init__(self, output_dim: int, activation: Optional[str] = None,
                 return_sequences: bool = False, input_shape=None, device=None, **_ignored):
        super().__init__(None, input_shape, device)
        self.output_dim = output_dim
        self.rnn_activation = activation
        self.return_sequences = return_sequences

    def _cell(self):
        raise NotImplementedError

    def _check_default_activation(self):
        # the core LSTM/GRU cells are fixed-recipe (tanh): a requested
        # non-default activation raises rather than being dropped
        if self.rnn_activation not in (None, "tanh"):
            raise ValueError(f"{type(self).__name__} supports only the default 'tanh' "
                             f"activation, got {self.rnn_activation!r}")

    def _make(self, in_spec):
        mods: List[AbstractModule] = [Recurrent(self._cell(), **self._d)]
        if not self.return_sequences:
            mods.append(Select(2, -1, **self._d))  # the last step of (N, T, H)
        return mods


class LSTM(_KerasRNN):
    def _cell(self):
        self._check_default_activation()
        return LSTMCell(None, self.output_dim, **self._d)


class GRU(_KerasRNN):
    def _cell(self):
        self._check_default_activation()
        return GRUCell(None, self.output_dim, **self._d)


class SimpleRNN(_KerasRNN):
    def _cell(self):
        name = self.rnn_activation or "tanh"
        try:
            act = _RNN_ACTIVATIONS[name]
        except KeyError:
            raise ValueError(f"unknown rnn activation {name!r}") from None
        return RnnCell(None, self.output_dim, activation=act, **self._d)


class Merge(KerasLayer):
    """Merge a Table of inputs (reference: keras/Merge.scala). Functional
    use: ``Merge(mode='sum')([n1, n2])``; ``concat`` joins along the 0-based
    ``concat_axis`` (``JoinTable(concat_axis + 1)``)."""

    _MODES = {"sum": CAddTable, "mul": CMulTable, "ave": CAveTable, "max": CMaxTable}
    accepts_table_input = True

    def __init__(self, mode: str = "sum", concat_axis: int = 1, input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        if mode not in ("concat", *self._MODES):
            raise ValueError(f"unknown merge mode {mode!r}")
        self.mode = mode
        self.concat_axis = concat_axis

    def _make(self, in_spec):
        if self.mode == "concat":
            return [JoinTable(self.concat_axis + 1, **self._d)]  # 0-based axis -> 1-based dim
        return [self._MODES[self.mode](**self._d)]


class Convolution1D(KerasLayer):
    """Keras Convolution1D over (N, T, F) (reference: keras/Convolution1D.scala):
    a ``TemporalConvolution`` with the named init."""

    def __init__(self, nb_filter: int, filter_length: int, init: str = "glorot_uniform",
                 activation: Optional[str] = None, border_mode: str = "valid",
                 subsample_length: int = 1, input_shape=None, device=None, **_ignored):
        super().__init__(activation, input_shape, device)
        if border_mode != "valid":
            raise ValueError("Convolution1D supports border_mode='valid' only "
                             "(reference parity)")
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.subsample_length = subsample_length
        self.init_name = init

    def _make(self, in_spec):
        conv = TemporalConvolution(in_spec.shape[2], self.nb_filter, self.filter_length,
                                   self.subsample_length, **self._d)
        conv.weight_init = _init_method(self.init_name)
        return [conv]


class AtrousConvolution1D(KerasLayer):
    """Keras AtrousConvolution1D, a dilated ``TemporalConvolution`` over
    (N, T, F)."""

    def __init__(self, nb_filter: int, filter_length: int, init: str = "glorot_uniform",
                 activation: Optional[str] = None, border_mode: str = "valid",
                 subsample_length: int = 1, atrous_rate: int = 1, input_shape=None,
                 device=None, **_ignored):
        super().__init__(activation, input_shape, device)
        if border_mode != "valid":
            raise ValueError("AtrousConvolution1D supports border_mode='valid' only "
                             "(reference parity)")
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.subsample_length = subsample_length
        self.atrous_rate = atrous_rate
        self.init_name = init

    def _make(self, in_spec):
        conv = TemporalConvolution(in_spec.shape[2], self.nb_filter, self.filter_length,
                                   self.subsample_length, dilation_w=self.atrous_rate, **self._d)
        conv.weight_init = _init_method(self.init_name)
        return [conv]


class Convolution3D(KerasLayer):
    """Keras Convolution3D over (N, C, D, H, W): a ``VolumetricConvolution``."""

    def __init__(self, nb_filter: int, kernel_dim1: int, kernel_dim2: int, kernel_dim3: int,
                 activation: Optional[str] = None, border_mode: str = "valid",
                 subsample=(1, 1, 1), bias: bool = True, input_shape=None, device=None,
                 **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(activation, input_shape, device)
        if border_mode != "valid":
            raise ValueError("Convolution3D supports border_mode='valid' only")
        self.nb_filter = nb_filter
        self.kernel = (kernel_dim1, kernel_dim2, kernel_dim3)
        self.subsample = subsample
        self.bias = bias

    def _make(self, in_spec):
        kd, kh, kw = self.kernel
        st, sh, sw = self.subsample
        return [VolumetricConvolution(in_spec.shape[1], self.nb_filter, kd, kw, kh, st, sw, sh,
                                      with_bias=self.bias, **self._d)]


class AtrousConvolution2D(KerasLayer):
    """Keras AtrousConvolution2D: a ``SpatialDilatedConvolution``, th ordering."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int, init: str = "glorot_uniform",
                 activation: Optional[str] = None, border_mode: str = "valid",
                 subsample=(1, 1), atrous_rate=(1, 1), bias: bool = True, input_shape=None,
                 device=None, **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(activation, input_shape, device)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode must be valid|same, got {border_mode!r}")
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.border_mode = border_mode
        self.subsample = subsample
        self.atrous_rate = atrous_rate
        self.bias = bias
        self.init_name = init

    def _make(self, in_spec):
        pad = -1 if self.border_mode == "same" else 0
        conv = SpatialDilatedConvolution(
            in_spec.shape[1], self.nb_filter, self.nb_col, self.nb_row, self.subsample[1],
            self.subsample[0], pad, pad, dilation_w=self.atrous_rate[1],
            dilation_h=self.atrous_rate[0], with_bias=self.bias, **self._d)
        conv.set_init_method(_init_method(self.init_name), Zeros())
        return [conv]


class Deconvolution2D(KerasLayer):
    """Keras Deconvolution2D: a ``SpatialFullConvolution``, th ordering,
    valid only."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation: Optional[str] = None, border_mode: str = "valid",
                 subsample=(1, 1), bias: bool = True, input_shape=None, device=None, **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(activation, input_shape, device)
        if border_mode != "valid":
            raise ValueError("Deconvolution2D supports border_mode='valid' only "
                             "(reference parity)")
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.subsample = subsample
        self.bias = bias

    def _make(self, in_spec):
        return [SpatialFullConvolution(in_spec.shape[1], self.nb_filter, self.nb_col,
                                       self.nb_row, self.subsample[1], self.subsample[0],
                                       with_bias=self.bias, **self._d)]


class SeparableConvolution2D(KerasLayer):
    """Keras SeparableConvolution2D: a ``SpatialSeparableConvolution``."""

    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation: Optional[str] = None, border_mode: str = "valid",
                 subsample=(1, 1), depth_multiplier: int = 1, bias: bool = True,
                 input_shape=None, device=None, **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(activation, input_shape, device)
        if border_mode not in ("valid", "same"):
            raise ValueError(f"border_mode must be valid|same, got {border_mode!r}")
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.border_mode = border_mode
        self.subsample = subsample
        self.depth_multiplier = depth_multiplier
        self.bias = bias

    def _make(self, in_spec):
        pad = -1 if self.border_mode == "same" else 0
        return [SpatialSeparableConvolution(
            in_spec.shape[1], self.nb_filter, self.depth_multiplier, self.nb_col, self.nb_row,
            self.subsample[1], self.subsample[0], pad, pad, with_bias=self.bias, **self._d)]


class LocallyConnected1D(KerasLayer):
    def __init__(self, nb_filter: int, filter_length: int, activation: Optional[str] = None,
                 subsample_length: int = 1, input_shape=None, device=None, **_ignored):
        super().__init__(activation, input_shape, device)
        self.nb_filter = nb_filter
        self.filter_length = filter_length
        self.subsample_length = subsample_length

    def _make(self, in_spec):
        return [CoreLocallyConnected1D(in_spec.shape[1], in_spec.shape[2], self.nb_filter,
                                       self.filter_length, self.subsample_length, **self._d)]


class LocallyConnected2D(KerasLayer):
    def __init__(self, nb_filter: int, nb_row: int, nb_col: int,
                 activation: Optional[str] = None, subsample=(1, 1), bias: bool = True,
                 input_shape=None, device=None, **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(activation, input_shape, device)
        self.nb_filter, self.nb_row, self.nb_col = nb_filter, nb_row, nb_col
        self.subsample = subsample
        self.bias = bias

    def _make(self, in_spec):
        return [CoreLocallyConnected2D(
            in_spec.shape[1], in_spec.shape[3], in_spec.shape[2], self.nb_filter, self.nb_col,
            self.nb_row, self.subsample[1], self.subsample[0], with_bias=self.bias,
            **self._d)]


class MaxPooling1D(KerasLayer):
    def __init__(self, pool_length: int = 2, stride: Optional[int] = None,
                 border_mode: str = "valid", input_shape=None, device=None, **_ignored):
        super().__init__(None, input_shape, device)
        if border_mode != "valid":
            raise ValueError("MaxPooling1D supports border_mode='valid' only")
        self.pool_length = pool_length
        self.stride = stride if stride is not None else pool_length

    def _make(self, in_spec):
        return [TemporalMaxPooling(self.pool_length, self.stride, **self._d)]


class AveragePooling1D(MaxPooling1D):
    def _make(self, in_spec):
        return [TemporalAveragePooling(self.pool_length, self.stride, **self._d)]


class MaxPooling3D(KerasLayer):
    def __init__(self, pool_size=(2, 2, 2), strides=None, border_mode: str = "valid",
                 input_shape=None, device=None, **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(None, input_shape, device)
        if border_mode != "valid":
            raise ValueError("MaxPooling3D supports border_mode='valid' only")
        self.pool_size = pool_size
        self.strides = strides if strides is not None else pool_size

    def _make(self, in_spec):
        (kt, kh, kw), (st, sh, sw) = self.pool_size, self.strides
        return [VolumetricMaxPooling(kt, kw, kh, st, sw, sh, **self._d)]


class AveragePooling3D(MaxPooling3D):
    def _make(self, in_spec):
        (kt, kh, kw), (st, sh, sw) = self.pool_size, self.strides
        return [VolumetricAveragePooling(kt, kw, kh, st, sw, sh, **self._d)]


class GlobalMaxPooling1D(KerasLayer):
    def _make(self, in_spec):
        return [_GlobalPool(torch.amax, (1,), **self._d)]


class GlobalAveragePooling1D(KerasLayer):
    def _make(self, in_spec):
        return [_GlobalPool(torch.mean, (1,), **self._d)]


class GlobalMaxPooling3D(KerasLayer):
    def _make(self, in_spec):
        return [_GlobalPool(torch.amax, (2, 3, 4), **self._d)]


class GlobalAveragePooling3D(KerasLayer):
    def _make(self, in_spec):
        return [_GlobalPool(torch.mean, (2, 3, 4), **self._d)]


class UpSampling1D(KerasLayer):
    def __init__(self, length: int = 2, input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        self.length = length

    def _make(self, in_spec):
        return [CoreUpSampling1D(self.length, **self._d)]


class UpSampling2D(KerasLayer):
    def __init__(self, size=(2, 2), input_shape=None, device=None, **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(None, input_shape, device)
        self.size = size

    def _make(self, in_spec):
        return [CoreUpSampling2D(self.size, **self._d)]


class UpSampling3D(KerasLayer):
    def __init__(self, size=(2, 2, 2), input_shape=None, device=None, **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(None, input_shape, device)
        self.size = size

    def _make(self, in_spec):
        return [CoreUpSampling3D(self.size, **self._d)]


class ZeroPadding1D(KerasLayer):
    def __init__(self, padding: int = 1, input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        self.padding = padding

    def _make(self, in_spec):
        # both ends of the T dim of (N, T, F)
        return [Padding(1, -self.padding, 2, **self._d), Padding(1, self.padding, 2, **self._d)]


class ZeroPadding2D(KerasLayer):
    def __init__(self, padding=(1, 1), input_shape=None, device=None, **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(None, input_shape, device)
        self.padding = padding

    def _make(self, in_spec):
        return [SpatialZeroPadding(self.padding[1], self.padding[1], self.padding[0],
                                   self.padding[0], **self._d)]


class Cropping1D(KerasLayer):
    def __init__(self, cropping=(1, 1), input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        self.cropping = cropping

    def _make(self, in_spec):
        return [CoreCropping1D(self.cropping, **self._d)]


class Cropping2D(KerasLayer):
    def __init__(self, cropping=((0, 0), (0, 0)), input_shape=None, device=None, **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(None, input_shape, device)
        self.cropping = cropping

    def _make(self, in_spec):
        return [CoreCropping2D(self.cropping, **self._d)]


class Cropping3D(KerasLayer):
    def __init__(self, cropping=((1, 1), (1, 1), (1, 1)), input_shape=None, device=None,
                 **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(None, input_shape, device)
        self.cropping = cropping

    def _make(self, in_spec):
        return [CoreCropping3D(self.cropping, **self._d)]


class Permute(KerasLayer):
    """Keras Permute: ``dims`` are the 1-based positions of the non-batch
    axes, decomposed into the core ``Transpose``'s swaps."""

    def __init__(self, dims: Sequence[int], input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        self.dims = tuple(dims)

    def _make(self, in_spec):
        perm = [0] + list(self.dims)
        cur = list(range(len(perm)))
        swaps = []
        for i in range(len(perm)):
            j = cur.index(perm[i])
            if j != i:
                cur[i], cur[j] = cur[j], cur[i]
                swaps.append((i + 1, j + 1))
        return [Transpose(swaps, **self._d)] if swaps else []


class RepeatVector(KerasLayer):
    def __init__(self, n: int, input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        self.n = n

    def _make(self, in_spec):
        return [Replicate(self.n, 1, **self._d)]


class Masking(KerasLayer):
    def __init__(self, mask_value: float = 0.0, input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        self.mask_value = mask_value

    def _make(self, in_spec):
        return [CoreMasking(self.mask_value, **self._d)]


class GaussianNoise(KerasLayer):
    def __init__(self, sigma: float, input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        self.sigma = sigma

    def _make(self, in_spec):
        return [CoreGaussianNoise(self.sigma, **self._d)]


class GaussianDropout(KerasLayer):
    def __init__(self, p: float, input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        self.p = p

    def _make(self, in_spec):
        return [CoreGaussianDropout(self.p, **self._d)]


class SpatialDropout1D(KerasLayer):
    def __init__(self, p: float = 0.5, input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        self.p = p

    def _make(self, in_spec):
        return [CoreSpatialDropout1D(self.p, **self._d)]


class SpatialDropout2D(KerasLayer):
    def __init__(self, p: float = 0.5, input_shape=None, device=None, **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(None, input_shape, device)
        self.p = p

    def _make(self, in_spec):
        return [CoreSpatialDropout2D(self.p, **self._d)]


class SpatialDropout3D(KerasLayer):
    def __init__(self, p: float = 0.5, input_shape=None, device=None, **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(None, input_shape, device)
        self.p = p

    def _make(self, in_spec):
        return [CoreSpatialDropout3D(self.p, **self._d)]


class ELU(KerasLayer):
    def __init__(self, alpha: float = 1.0, input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        self.alpha = alpha

    def _make(self, in_spec):
        return [A.ELU(self.alpha, **self._d)]


class LeakyReLU(KerasLayer):
    def __init__(self, alpha: float = 0.3, input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        self.alpha = alpha

    def _make(self, in_spec):
        return [A.LeakyReLU(self.alpha, **self._d)]


class PReLU(KerasLayer):
    def __init__(self, input_shape=None, device=None):
        super().__init__(None, input_shape, device)

    def _make(self, in_spec):
        return [A.PReLU(**self._d)]


class SReLU(KerasLayer):
    def __init__(self, shared_axes=None, input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        self.shared_axes = shared_axes

    def _make(self, in_spec):
        return [CoreSReLU(self.shared_axes, **self._d)]


class ThresholdedReLU(KerasLayer):
    def __init__(self, theta: float = 1.0, input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        self.theta = theta

    def _make(self, in_spec):
        return [CoreThresholdedReLU(self.theta, **self._d)]


class SoftMax(KerasLayer):
    def _make(self, in_spec):
        return [A.SoftMax(**self._d)]


class Highway(KerasLayer):
    """Keras Highway: a core ``Highway`` over the last dim, the named
    activation on its H(x)."""

    def __init__(self, activation: Optional[str] = None, bias: bool = True, input_shape=None,
                 device=None, **_ignored):
        super().__init__(None, input_shape, device)
        self.hw_activation = activation
        self.bias = bias

    def _make(self, in_spec):
        act = activation_module(self.hw_activation, self._device)
        fn = (lambda x: act._apply_params({}, {}, x, False, None)[0]) if act else None
        return [CoreHighway(in_spec.shape[-1], self.bias, fn, **self._d)]


class MaxoutDense(KerasLayer):
    def __init__(self, output_dim: int, nb_feature: int = 4, bias: bool = True,
                 input_shape=None, device=None, **_ignored):
        super().__init__(None, input_shape, device)
        self.output_dim = output_dim
        self.nb_feature = nb_feature
        self.bias = bias

    def _make(self, in_spec):
        return [Maxout(in_spec.shape[-1], self.output_dim, self.nb_feature, self.bias,
                       **self._d)]


class TimeDistributed(KerasLayer):
    """Apply an inner keras layer to every time step (reference:
    keras/TimeDistributed.scala over the core ``TimeDistributed``)."""

    def __init__(self, layer: KerasLayer, input_shape=None, device=None):
        super().__init__(None, input_shape, device)
        # not registered here: it becomes the core TimeDistributed's child
        object.__setattr__(self, "layer", layer)

    def _make(self, in_spec):
        return [CoreTimeDistributed(self.layer, **self._d)]


class Bidirectional(KerasLayer):
    """Bidirectional RNN wrapper over the core ``BiRecurrent``
    (reference: keras/Bidirectional.scala). ``merge_mode``: 'sum'|'concat'."""

    def __init__(self, layer: "_KerasRNN", merge_mode: str = "concat", input_shape=None,
                 device=None):
        super().__init__(None, input_shape, device)
        if not isinstance(layer, _KerasRNN):
            raise TypeError("Bidirectional wraps a keras LSTM/GRU/SimpleRNN")
        object.__setattr__(self, "layer", layer)  # a recipe for the cell, not a child
        self.merge_mode = {"sum": "add", "concat": "concat"}.get(merge_mode, merge_mode)

    def _make(self, in_spec):
        mods: List[AbstractModule] = [BiRecurrent(self.layer._cell(),
                                                  merge_mode=self.merge_mode, **self._d)]
        if not self.layer.return_sequences:
            mods.append(Select(2, -1, **self._d))
        return mods


class ConvLSTM2D(KerasLayer):
    """Convolutional LSTM over (N, T, C, H, W) (reference:
    keras/ConvLSTM2D.scala over the core ``ConvLSTMPeephole``)."""

    def __init__(self, nb_filter: int, nb_kernel: int, return_sequences: bool = False,
                 border_mode: str = "same", subsample: int = 1, input_shape=None, device=None,
                 **kwargs):
        _check_dim_ordering(kwargs)
        super().__init__(None, input_shape, device)
        if border_mode != "same":
            raise ValueError("ConvLSTM2D supports border_mode='same' only")
        self.nb_filter = nb_filter
        self.nb_kernel = nb_kernel
        self.return_sequences = return_sequences
        self.subsample = subsample

    def _make(self, in_spec):
        mods: List[AbstractModule] = [Recurrent(ConvLSTMPeephole(
            in_spec.shape[2], self.nb_filter, self.nb_kernel, self.nb_kernel, self.subsample,
            **self._d), **self._d)]
        if not self.return_sequences:
            mods.append(Select(2, -1, **self._d))
        return mods
