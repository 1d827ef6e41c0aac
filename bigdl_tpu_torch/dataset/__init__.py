"""Training data of the port."""

from .dataset import (AbstractDataSet, DataSet, LocalArrayDataSet, MiniBatch, pad_minibatch,
                      to_device)

__all__ = ["AbstractDataSet", "DataSet", "LocalArrayDataSet", "MiniBatch", "pad_minibatch",
           "to_device"]
