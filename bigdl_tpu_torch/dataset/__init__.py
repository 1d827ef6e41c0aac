"""Training data of the port (the JAX package's ``bigdl_tpu.dataset`` exports,
and the port's ``Table`` and device helpers)."""

from .dataset import (
    Sample,
    MiniBatch,
    Transformer,
    Lambda,
    SampleToMiniBatch,
    AbstractDataSet,
    LocalArrayDataSet,
    LocalTableDataSet,
    BucketedTextDataSet,
    DistributedDataSet,
    DataSet,
    pad_minibatch,
    rows_of,
    to_device,
)
from .tfrecord import (
    TFRecordDataSet,
    build_example,
    parse_example,
    read_tfrecords,
    write_tfrecords,
)
from .files import (
    ImageFolderDataSet,
    ShardedRecordDataSet,
    read_record_shard,
    write_record_shards,
)
from .pipeline import DataPipeline, StagingRing
from .criteo import load_criteo
from .mnist import load_mnist
from .movielens import load_movielens
from . import cifar, criteo, mnist, segmentation, text  # noqa: E402

__all__ = ["AbstractDataSet", "BucketedTextDataSet", "DataPipeline", "DataSet",
           "DistributedDataSet", "ImageFolderDataSet", "Lambda", "LocalArrayDataSet",
           "LocalTableDataSet", "MiniBatch", "Sample", "SampleToMiniBatch",
           "ShardedRecordDataSet", "StagingRing", "TFRecordDataSet", "Transformer",
           "build_example", "load_criteo", "load_mnist", "load_movielens", "pad_minibatch",
           "parse_example", "read_record_shard", "read_tfrecords", "rows_of", "to_device",
           "write_record_shards", "write_tfrecords"]
