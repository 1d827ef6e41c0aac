"""Layers, containers and criterions of the port."""

from .activations import LogSoftMax, ReLU, Tanh
from .attention import FeedForwardNetwork, Transformer, scaled_dot_product_attention
from .conv import SpatialConvolution
from .criterion import (AbstractCriterion, ClassNLLCriterion, CrossEntropyCriterion,
                        TimeDistributedCriterion)
from .dropout import Dropout
from .embedding import DenseToSparse, LookupTable, LookupTableSparse, SparseJoinTable
from .graph import Graph, Input, ModuleNode
from .initialization import MsraFiller, RandomNormal, RandomUniform, Xavier, Zeros
from .linear import Linear, SparseLinear
from .module import AbstractModule, Container, Identity, Sequential
from .normalization import (BatchNormalization, LayerNormalization, RMSNorm,
                            SpatialBatchNormalization, SpatialCrossMapLRN)
from .pipelined import PipelinedBlocks
from .pooling import SpatialAveragePooling, SpatialMaxPooling
from .recurrent import LSTM, BiRecurrent, Cell, Recurrent
from .structural import Reshape, Select, SpaceToDepth
from .table_ops import CAddTable, Concat

__all__ = ["AbstractCriterion", "AbstractModule", "BatchNormalization", "BiRecurrent", "CAddTable",
           "Cell", "ClassNLLCriterion", "Concat", "Container", "CrossEntropyCriterion",
           "DenseToSparse", "Dropout", "FeedForwardNetwork", "Graph", "Identity", "Input", "LSTM",
           "LayerNormalization", "Linear", "LogSoftMax", "LookupTable", "LookupTableSparse",
           "ModuleNode", "MsraFiller", "PipelinedBlocks", "RMSNorm", "RandomNormal",
           "RandomUniform", "ReLU", "Recurrent", "Reshape", "Select", "Sequential", "SpaceToDepth",
           "SparseJoinTable", "SparseLinear", "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialCrossMapLRN", "SpatialMaxPooling", "Tanh",
           "TimeDistributedCriterion", "Transformer", "Xavier", "Zeros",
           "scaled_dot_product_attention"]
