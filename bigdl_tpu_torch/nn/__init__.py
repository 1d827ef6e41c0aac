"""Layers, containers and criterions of the port."""

from .activations import LogSoftMax, ReLU
from .attention import FeedForwardNetwork, Transformer, scaled_dot_product_attention
from .conv import SpatialConvolution
from .criterion import (AbstractCriterion, ClassNLLCriterion, CrossEntropyCriterion,
                        TimeDistributedCriterion)
from .dropout import Dropout
from .embedding import LookupTable
from .graph import Graph, Input, ModuleNode
from .initialization import MsraFiller, RandomNormal, RandomUniform, Xavier, Zeros
from .linear import Linear
from .module import AbstractModule, Container, Identity, Sequential
from .normalization import (BatchNormalization, LayerNormalization, RMSNorm,
                            SpatialBatchNormalization)
from .pipelined import PipelinedBlocks
from .pooling import SpatialAveragePooling, SpatialMaxPooling
from .structural import Reshape, SpaceToDepth
from .table_ops import CAddTable

__all__ = ["AbstractCriterion", "AbstractModule", "BatchNormalization", "CAddTable",
           "ClassNLLCriterion", "Container", "CrossEntropyCriterion", "Dropout",
           "FeedForwardNetwork", "Graph", "Identity", "Input", "LayerNormalization", "Linear",
           "LogSoftMax", "LookupTable", "ModuleNode", "MsraFiller", "PipelinedBlocks",
           "RMSNorm", "RandomNormal", "RandomUniform", "ReLU", "Reshape", "Sequential",
           "SpaceToDepth", "SpatialAveragePooling", "SpatialBatchNormalization",
           "SpatialConvolution", "SpatialMaxPooling", "TimeDistributedCriterion",
           "Transformer", "Xavier", "Zeros", "scaled_dot_product_attention"]
