"""Training data of the port."""

from .dataset import AbstractDataSet, DataSet, LocalArrayDataSet, MiniBatch

__all__ = ["AbstractDataSet", "DataSet", "LocalArrayDataSet", "MiniBatch"]
