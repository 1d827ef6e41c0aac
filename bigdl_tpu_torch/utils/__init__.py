"""Engine policy, precision helpers, seeded generators, weight carry-over,
``Table`` and the static ``Shape`` objects (the JAX package's
``bigdl_tpu.utils`` exports that the port has)."""

from .engine import Engine
from .random import RandomGenerator, set_seed
from .shape import MultiShape, Shape, SingleShape
from .table import T, Table

__all__ = ["Engine", "RandomGenerator", "set_seed", "Shape", "SingleShape", "MultiShape", "T",
           "Table"]
