"""Tensors of the port beyond ``torch.Tensor``: the COO ``SparseTensor`` and
the 1-based BigDL ``Tensor`` façade."""

from .sparse import SparseTensor, sparse_join
from .tensor import Tensor

__all__ = ["SparseTensor", "Tensor", "sparse_join"]
