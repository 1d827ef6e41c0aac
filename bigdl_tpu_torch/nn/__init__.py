"""Layers, containers and criterions of the port; ``load_module`` reads a
model file (``AbstractModule.save_module``, either package's)."""

from .activations import (ELU, GELU, PReLU, RReLU, SELU, HardSigmoid, HardTanh, LeakyReLU,
                          LogSoftMax, ReLU, ReLU6, Sigmoid, SoftMax, SoftMin, SoftPlus,
                          SoftSign, SReLU, Swish, Tanh, Threshold, ThresholdedReLU)
from .attention import (Attention, FeedForwardNetwork, SequenceBeamSearch, Transformer,
                        attention_bias_lower_triangle, get_position_encoding,
                        padding_attention_bias, scaled_dot_product_attention,
                        sequence_beam_search)
from .conv import (LocallyConnected1D, LocallyConnected2D, SpatialConvolution,
                   SpatialDilatedConvolution, SpatialFullConvolution, SpatialSeparableConvolution,
                   TemporalConvolution, VolumetricConvolution)
from .criterion import (AbsCriterion, AbstractCriterion, BCECriterion, BCECriterionWithLogits,
                        ClassNLLCriterion, ClassSimplexCriterion, CosineEmbeddingCriterion,
                        CrossEntropyCriterion, DiceCoefficientCriterion, DistKLDivCriterion,
                        HingeEmbeddingCriterion, L1Cost, MarginCriterion,
                        MarginRankingCriterion, MSECriterion, MultiCriterion,
                        MultiLabelMarginCriterion, MultiLabelSoftMarginCriterion,
                        ParallelCriterion, SmoothL1Criterion, TimeDistributedCriterion)
from .detection import (FPN, Anchor, BoxHead, MaskHead, Pooler, RegionProposal, bbox_clip,
                        bbox_decode, bbox_encode, bbox_iou, fast_rcnn_loss, match_targets,
                        multilevel_roi_align, nms, roi_align, rpn_loss, sample_matches)
from .dropout import (Dropout, GaussianDropout, GaussianNoise, SpatialDropout1D,
                      SpatialDropout2D, SpatialDropout3D)
from .embedding import DenseToSparse, LookupTable, LookupTableSparse, SparseJoinTable
from .graph import Graph, Input, ModuleNode
from .initialization import (BilinearFiller, ConstInitMethod, MsraFiller, Ones, RandomNormal,
                             RandomUniform, Xavier, Zeros)
from .linear import Highway, Linear, Maxout, SparseLinear
from .math_ops import (Abs, Add, AddConstant, Bilinear, CAdd, Clamp, CMul, Cosine, Euclidean,
                       Exp, Log, Max, Mean, Min, Mul, MulConstant, Neg, Power, Scale, Sqrt,
                       Square, Sum)
from .module import AbstractModule, Container, Echo, ForwardHookHandle, Identity, Sequential
from .moe import MoE
from .normalization import (BatchNormalization, LayerNormalization, Normalize, RMSNorm,
                            SpatialBatchNormalization, SpatialCrossMapLRN,
                            SpatialWithinChannelLRN)
from .pipelined import PipelinedBlocks
from .pooling import (RoiPooling, SpatialAdaptiveMaxPooling, SpatialAveragePooling,
                      SpatialMaxPooling, TemporalAveragePooling, TemporalMaxPooling,
                      VolumetricAveragePooling, VolumetricMaxPooling)
from .quantized import (Fp8Linear, Fp8SpatialConvolution, Fp8SpatialDilatedConvolution,
                        QuantizedLinear, QuantizedSpatialConvolution,
                        QuantizedSpatialDilatedConvolution, quantize, quantized_mode)
from .remat import Remat
from .recurrent import (GRU, LSTM, BiRecurrent, Cell, ConvLSTMPeephole, LSTMPeephole, Recurrent,
                        RecurrentDecoder, RnnCell, TimeDistributed)
from .structural import (Contiguous, Cropping1D, Cropping2D, Cropping3D, Flatten, Index,
                         InferReshape, Masking, MaskedSelect, Narrow, Padding, Replicate,
                         Reshape, Select, SpaceToDepth, SpatialZeroPadding, Squeeze, Transpose,
                         Unsqueeze, UpSampling1D, UpSampling2D, UpSampling3D, View,
                         ZeroPadding2D)
from .table_ops import (MM, MV, CAddTable, CAveTable, CDivTable, CMaxTable, CMinTable,
                        CMulTable, Concat, ConcatTable, CosineDistance, CSubTable, DotProduct,
                        FlattenTable, JoinTable, MapTable, MixtureTable, PairwiseDistance,
                        ParallelTable, SelectTable)
from .tree_lstm import BinaryTreeLSTM, encode_tree



def load_module(path: str, device=None) -> AbstractModule:
    """The model that ``save_module`` wrote (topology and arrays), rebuilt on
    ``device`` (the card unless ``"cpu"``) without its building code."""
    from ..utils.module_serializer import load_module_def

    return load_module_def(path, device)


def load_caffe(prototxt_path: str, weights=None, device=None):
    """Import a Caffe prototxt topology, with its weights from a
    ``.caffemodel`` path or a {layer: arrays} dict, onto ``device`` (the
    card unless ``"cpu"``; reference: ``Module.loadCaffeModel``)."""
    from ..utils.caffe import load_caffe as _load

    return _load(prototxt_path, weights, device)


def load_tf(path: str, inputs, outputs, device=None):
    """Import a frozen TF GraphDef onto ``device`` (the card unless
    ``"cpu"``; reference: ``Module.loadTF``)."""
    from ..utils.tf_loader import load_tf as _load

    return _load(path, inputs, outputs, device)


__all__ = ["Abs", "AbsCriterion", "AbstractCriterion", "AbstractModule", "Add", "AddConstant",
           "Anchor", "Attention", "attention_bias_lower_triangle", "BatchNormalization",
           "bbox_clip", "bbox_decode", "bbox_encode", "bbox_iou", "BCECriterion",
           "BCECriterionWithLogits", "Bilinear", "BilinearFiller", "BinaryTreeLSTM",
           "BiRecurrent", "BoxHead", "CAdd", "CAddTable", "CAveTable", "CDivTable", "Cell",
           "Clamp", "ClassNLLCriterion", "ClassSimplexCriterion", "CMaxTable", "CMinTable",
           "CMul", "CMulTable", "Concat", "ConcatTable", "ConstInitMethod", "Container",
           "Contiguous", "ConvLSTMPeephole", "Cosine", "CosineDistance",
           "CosineEmbeddingCriterion", "Cropping1D", "Cropping2D", "Cropping3D",
           "CrossEntropyCriterion", "CSubTable", "DenseToSparse", "DiceCoefficientCriterion",
           "DistKLDivCriterion", "DotProduct", "Dropout", "Echo", "ELU", "encode_tree",
           "Euclidean", "Exp", "fast_rcnn_loss", "FeedForwardNetwork", "Flatten", "FlattenTable",
           "ForwardHookHandle", "Fp8Linear", "Fp8SpatialConvolution",
           "Fp8SpatialDilatedConvolution", "FPN", "GaussianDropout", "GaussianNoise", "GELU",
           "get_position_encoding", "Graph", "GRU", "HardSigmoid", "HardTanh", "Highway",
           "HingeEmbeddingCriterion", "Identity", "Index", "InferReshape", "Input", "JoinTable",
           "L1Cost", "LayerNormalization", "LeakyReLU", "Linear", "load_caffe", "load_module",
           "load_tf",
           "LocallyConnected1D", "LocallyConnected2D", "Log", "LogSoftMax", "LookupTable",
           "LookupTableSparse", "LSTM", "LSTMPeephole", "MapTable", "MarginCriterion",
           "MarginRankingCriterion", "MaskedSelect", "MaskHead", "Masking", "match_targets",
           "Max", "Maxout", "Mean", "Min", "MixtureTable", "MM", "ModuleNode", "MoE",
           "MSECriterion", "MsraFiller", "Mul", "MulConstant", "MultiCriterion",
           "MultiLabelMarginCriterion", "MultiLabelSoftMarginCriterion", "multilevel_roi_align",
           "MV", "Narrow", "Neg", "nms", "Normalize", "Ones", "Padding", "padding_attention_bias",
           "PairwiseDistance", "ParallelCriterion", "ParallelTable", "PipelinedBlocks", "Pooler",
           "Power", "PReLU", "quantize", "quantized_mode", "QuantizedLinear",
           "QuantizedSpatialConvolution", "QuantizedSpatialDilatedConvolution", "RandomNormal",
           "RandomUniform", "Recurrent", "RecurrentDecoder", "RegionProposal", "ReLU", "ReLU6",
           "Remat", "Replicate", "Reshape", "RMSNorm", "RnnCell", "roi_align", "RoiPooling",
           "rpn_loss", "RReLU", "sample_matches", "Scale", "scaled_dot_product_attention",
           "Select", "SelectTable", "SELU", "sequence_beam_search", "SequenceBeamSearch",
           "Sequential", "Sigmoid", "SmoothL1Criterion", "SoftMax", "SoftMin", "SoftPlus",
           "SoftSign", "SpaceToDepth", "SparseJoinTable", "SparseLinear",
           "SpatialAdaptiveMaxPooling", "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialCrossMapLRN", "SpatialDilatedConvolution",
           "SpatialDropout1D", "SpatialDropout2D", "SpatialDropout3D", "SpatialFullConvolution",
           "SpatialMaxPooling", "SpatialSeparableConvolution", "SpatialWithinChannelLRN",
           "SpatialZeroPadding", "Sqrt", "Square", "Squeeze", "SReLU", "Sum", "Swish", "Tanh",
           "TemporalAveragePooling", "TemporalConvolution", "TemporalMaxPooling", "Threshold",
           "ThresholdedReLU", "TimeDistributed", "TimeDistributedCriterion", "Transformer",
           "Transpose", "Unsqueeze", "UpSampling1D", "UpSampling2D", "UpSampling3D", "View",
           "VolumetricAveragePooling", "VolumetricConvolution", "VolumetricMaxPooling", "Xavier",
           "ZeroPadding2D", "Zeros"]
