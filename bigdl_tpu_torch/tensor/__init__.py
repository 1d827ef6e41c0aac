"""Tensors of the port beyond ``torch.Tensor``: the COO ``SparseTensor``."""

from .sparse import SparseTensor, sparse_join

__all__ = ["SparseTensor", "sparse_join"]
