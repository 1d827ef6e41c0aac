"""Training data of the port."""

from .criteo import load_criteo
from .dataset import (AbstractDataSet, DataSet, LocalArrayDataSet, LocalTableDataSet, MiniBatch,
                      pad_minibatch, rows_of, to_device)

__all__ = ["AbstractDataSet", "DataSet", "LocalArrayDataSet", "LocalTableDataSet", "MiniBatch",
           "load_criteo", "pad_minibatch", "rows_of", "to_device"]
