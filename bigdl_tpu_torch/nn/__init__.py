"""Layers, containers and criterions of the port."""

from .activations import LogSoftMax, ReLU, Sigmoid, Tanh
from .attention import (Attention, FeedForwardNetwork, SequenceBeamSearch, Transformer,
                        attention_bias_lower_triangle, get_position_encoding,
                        padding_attention_bias, scaled_dot_product_attention,
                        sequence_beam_search)
from .conv import SpatialConvolution, SpatialDilatedConvolution, TemporalConvolution
from .criterion import (AbstractCriterion, ClassNLLCriterion, CrossEntropyCriterion,
                        MSECriterion, TimeDistributedCriterion)
from .dropout import (Dropout, GaussianDropout, GaussianNoise, SpatialDropout1D,
                      SpatialDropout2D, SpatialDropout3D)
from .embedding import DenseToSparse, LookupTable, LookupTableSparse, SparseJoinTable
from .graph import Graph, Input, ModuleNode
from .initialization import MsraFiller, RandomNormal, RandomUniform, Xavier, Zeros
from .linear import Linear, SparseLinear
from .math_ops import Max, Mean, Min, Sum
from .module import AbstractModule, Container, Identity, Sequential
from .normalization import (BatchNormalization, LayerNormalization, RMSNorm,
                            SpatialBatchNormalization, SpatialCrossMapLRN)
from .pipelined import PipelinedBlocks
from .pooling import SpatialAveragePooling, SpatialMaxPooling, TemporalMaxPooling
from .recurrent import LSTM, BiRecurrent, Cell, Recurrent, TimeDistributed
from .structural import Reshape, Select, SpaceToDepth
from .table_ops import CAddTable, Concat

__all__ = ["AbstractCriterion", "AbstractModule", "Attention", "BatchNormalization",
           "BiRecurrent", "CAddTable", "Cell", "ClassNLLCriterion", "Concat", "Container",
           "CrossEntropyCriterion", "DenseToSparse", "Dropout", "FeedForwardNetwork",
           "GaussianDropout", "GaussianNoise", "Graph", "Identity", "Input", "LSTM",
           "LayerNormalization", "Linear", "LogSoftMax", "LookupTable", "LookupTableSparse",
           "MSECriterion", "Max", "Mean", "Min", "ModuleNode", "MsraFiller", "PipelinedBlocks",
           "RMSNorm", "RandomNormal", "RandomUniform", "ReLU", "Recurrent", "Reshape", "Select",
           "SequenceBeamSearch", "Sequential", "Sigmoid", "SpaceToDepth", "SparseJoinTable",
           "SparseLinear", "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialCrossMapLRN", "SpatialDilatedConvolution",
           "SpatialDropout1D", "SpatialDropout2D", "SpatialDropout3D", "SpatialMaxPooling", "Sum",
           "Tanh", "TemporalConvolution", "TemporalMaxPooling", "TimeDistributed",
           "TimeDistributedCriterion", "Transformer", "Xavier", "Zeros",
           "attention_bias_lower_triangle", "get_position_encoding", "padding_attention_bias",
           "scaled_dot_product_attention", "sequence_beam_search"]
