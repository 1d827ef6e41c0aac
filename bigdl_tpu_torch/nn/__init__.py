"""Layers and criterions of the port."""

from .attention import FeedForwardNetwork, Transformer, scaled_dot_product_attention
from .criterion import AbstractCriterion, ClassNLLCriterion, CrossEntropyCriterion
from .module import AbstractModule

__all__ = ["AbstractCriterion", "AbstractModule", "ClassNLLCriterion",
           "CrossEntropyCriterion", "FeedForwardNetwork", "Transformer",
           "scaled_dot_product_attention"]
