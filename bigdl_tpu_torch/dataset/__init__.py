"""Training data of the port."""

from .criteo import load_criteo
from .dataset import (AbstractDataSet, DataSet, LocalArrayDataSet, LocalTableDataSet, MiniBatch,
                      pad_minibatch, rows_of, to_device)
from .mnist import load_mnist
from .movielens import load_movielens
from . import segmentation  # noqa: E402  (COCO masks and annotations)

__all__ = ["AbstractDataSet", "DataSet", "LocalArrayDataSet", "LocalTableDataSet", "MiniBatch",
           "load_criteo", "load_mnist", "load_movielens", "pad_minibatch", "rows_of",
           "to_device"]
