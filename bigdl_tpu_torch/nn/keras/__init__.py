"""Keras-1.2.2-style API (counterpart of ``bigdl_tpu/nn/keras``; reference:
``$DL/nn/keras`` and ``$PY/nn/keras``): layer wrappers with shape inference,
and ``Sequential``/``Model`` with compile/fit/evaluate/predict. The JAX
package's ``converter.py`` (foreign Keras JSON/HDF5 files) is not ported
here: it goes with the interop loaders."""

from . import layers as _L
from .layers import KerasLayer
from .topology import Input, Model, Sequential

_WRAPPERS = [
    "Activation", "AtrousConvolution1D", "AtrousConvolution2D", "AveragePooling1D",
    "AveragePooling2D", "AveragePooling3D", "BatchNormalization",
    "Bidirectional", "ConvLSTM2D", "Convolution1D", "Convolution2D",
    "Convolution3D", "Cropping1D", "Cropping2D", "Cropping3D",
    "Deconvolution2D", "Dense", "Dropout", "ELU", "Embedding", "Flatten",
    "GRU", "GaussianDropout", "GaussianNoise", "GlobalAveragePooling1D",
    "GlobalAveragePooling2D", "GlobalAveragePooling3D", "GlobalMaxPooling1D",
    "GlobalMaxPooling2D", "GlobalMaxPooling3D", "Highway", "LSTM",
    "LeakyReLU", "LocallyConnected1D", "LocallyConnected2D", "Masking",
    "MaxPooling1D", "MaxPooling2D", "MaxPooling3D", "MaxoutDense", "Merge",
    "PReLU", "Permute", "RepeatVector", "Reshape", "SReLU",
    "SeparableConvolution2D", "SimpleRNN", "SoftMax", "SpatialDropout1D",
    "SpatialDropout2D", "SpatialDropout3D", "ThresholdedReLU",
    "TimeDistributed", "UpSampling1D", "UpSampling2D", "UpSampling3D",
    "ZeroPadding1D", "ZeroPadding2D",
]
for _name in _WRAPPERS:
    globals()[_name] = getattr(_L, _name)

__all__ = ["Input", "KerasLayer", "Model", "Sequential", *_WRAPPERS]
