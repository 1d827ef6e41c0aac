"""Layers, containers and criterions of the port; ``load_module`` reads a
model file (``AbstractModule.save_module``, either package's)."""

from .activations import (ELU, GELU, PReLU, RReLU, SELU, HardSigmoid, HardTanh, LeakyReLU,
                          LogSoftMax, ReLU, ReLU6, Sigmoid, SoftMax, SoftMin, SoftPlus,
                          SoftSign, SReLU, Swish, Tanh, Threshold, ThresholdedReLU)
from .attention import (Attention, FeedForwardNetwork, SequenceBeamSearch, Transformer,
                        attention_bias_lower_triangle, get_position_encoding,
                        padding_attention_bias, scaled_dot_product_attention,
                        sequence_beam_search)
from .conv import SpatialConvolution, SpatialDilatedConvolution, TemporalConvolution
from .criterion import (AbsCriterion, AbstractCriterion, BCECriterion, BCECriterionWithLogits,
                        ClassNLLCriterion, ClassSimplexCriterion, CosineEmbeddingCriterion,
                        CrossEntropyCriterion, DiceCoefficientCriterion, DistKLDivCriterion,
                        HingeEmbeddingCriterion, L1Cost, MarginCriterion,
                        MarginRankingCriterion, MSECriterion, MultiCriterion,
                        MultiLabelMarginCriterion, MultiLabelSoftMarginCriterion,
                        ParallelCriterion, SmoothL1Criterion, TimeDistributedCriterion)
from .dropout import (Dropout, GaussianDropout, GaussianNoise, SpatialDropout1D,
                      SpatialDropout2D, SpatialDropout3D)
from .embedding import DenseToSparse, LookupTable, LookupTableSparse, SparseJoinTable
from .graph import Graph, Input, ModuleNode
from .initialization import MsraFiller, RandomNormal, RandomUniform, Xavier, Zeros
from .linear import Linear, SparseLinear
from .math_ops import (Abs, Add, AddConstant, Bilinear, CAdd, Clamp, CMul, Cosine, Euclidean,
                       Exp, Log, Max, Mean, Min, Mul, MulConstant, Neg, Power, Scale, Sqrt,
                       Square, Sum)
from .module import AbstractModule, Container, Identity, Sequential
from .normalization import (BatchNormalization, LayerNormalization, RMSNorm,
                            SpatialBatchNormalization, SpatialCrossMapLRN)
from .pipelined import PipelinedBlocks
from .pooling import SpatialAveragePooling, SpatialMaxPooling, TemporalMaxPooling
from .recurrent import (GRU, LSTM, BiRecurrent, Cell, ConvLSTMPeephole, LSTMPeephole, Recurrent,
                        RecurrentDecoder, RnnCell, TimeDistributed)
from .structural import Reshape, Select, SpaceToDepth
from .table_ops import (MM, MV, CAddTable, CAveTable, CDivTable, CMaxTable, CMinTable,
                        CMulTable, Concat, ConcatTable, CosineDistance, CSubTable, DotProduct,
                        FlattenTable, JoinTable, MapTable, MixtureTable, PairwiseDistance,
                        ParallelTable, SelectTable)



def load_module(path: str, device=None) -> AbstractModule:
    """The model that ``save_module`` wrote (topology and arrays), rebuilt on
    ``device`` (the card unless ``"cpu"``) without its building code."""
    from ..utils.module_serializer import load_module_def

    return load_module_def(path, device)


__all__ = ["Abs", "AbsCriterion", "AbstractCriterion", "AbstractModule", "Add",
           "AddConstant", "Attention", "BCECriterion", "BCECriterionWithLogits",
           "BatchNormalization", "BiRecurrent", "Bilinear", "CAdd", "CAddTable",
           "CAveTable", "CDivTable", "CMaxTable", "CMinTable", "CMul", "CMulTable",
           "CSubTable", "Cell", "Clamp", "ClassNLLCriterion", "ClassSimplexCriterion",
           "Concat", "ConcatTable", "Container", "ConvLSTMPeephole", "Cosine",
           "CosineDistance", "CosineEmbeddingCriterion", "CrossEntropyCriterion",
           "DenseToSparse", "DiceCoefficientCriterion", "DistKLDivCriterion",
           "DotProduct", "Dropout", "ELU", "Euclidean", "Exp", "FeedForwardNetwork",
           "FlattenTable", "GELU", "GRU", "GaussianDropout", "GaussianNoise", "Graph",
           "HardSigmoid", "HardTanh", "HingeEmbeddingCriterion", "Identity", "Input",
           "JoinTable", "L1Cost", "LSTM", "LSTMPeephole", "LayerNormalization",
           "LeakyReLU", "Linear", "Log", "load_module", "LogSoftMax", "LookupTable", "LookupTableSparse",
           "MM", "MSECriterion", "MV", "MapTable", "MarginCriterion",
           "MarginRankingCriterion", "Max", "Mean", "Min", "MixtureTable", "ModuleNode",
           "MsraFiller", "Mul", "MulConstant", "MultiCriterion",
           "MultiLabelMarginCriterion", "MultiLabelSoftMarginCriterion", "Neg", "PReLU",
           "PairwiseDistance", "ParallelCriterion", "ParallelTable", "PipelinedBlocks",
           "Power", "RMSNorm", "RReLU", "RandomNormal", "RandomUniform", "ReLU", "ReLU6",
           "Recurrent", "RecurrentDecoder", "Reshape", "RnnCell", "SELU", "SReLU",
           "Scale", "Select", "SelectTable", "SequenceBeamSearch", "Sequential",
           "Sigmoid", "SmoothL1Criterion", "SoftMax", "SoftMin", "SoftPlus", "SoftSign",
           "SpaceToDepth", "SparseJoinTable", "SparseLinear", "SpatialAveragePooling",
           "SpatialBatchNormalization", "SpatialConvolution", "SpatialCrossMapLRN",
           "SpatialDilatedConvolution", "SpatialDropout1D", "SpatialDropout2D",
           "SpatialDropout3D", "SpatialMaxPooling", "Sqrt", "Square", "Sum", "Swish",
           "Tanh", "TemporalConvolution", "TemporalMaxPooling", "Threshold",
           "ThresholdedReLU", "TimeDistributed", "TimeDistributedCriterion",
           "Transformer", "Xavier", "Zeros", "attention_bias_lower_triangle",
           "get_position_encoding", "padding_attention_bias",
           "scaled_dot_product_attention", "sequence_beam_search"]
