"""Layers of the port."""

from .attention import FeedForwardNetwork, Transformer, scaled_dot_product_attention
from .module import AbstractModule

__all__ = ["AbstractModule", "FeedForwardNetwork", "Transformer",
           "scaled_dot_product_attention"]
