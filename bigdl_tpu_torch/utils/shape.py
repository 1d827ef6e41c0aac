"""Static shape objects (counterpart of ``bigdl_tpu/utils/shape.py``;
reference: ``$DL/utils/Shape.scala`` SingleShape/MultiShape).

The keras-style API's user-facing static description of an input; the
port infers shapes itself over meta tensors (``analysis.ShapeProp``).
"""

from __future__ import annotations

from typing import List, Sequence


class Shape:
    @staticmethod
    def of(value) -> "Shape":
        """A ``Shape`` as it is; a sequence of sequences (or shapes) as a
        ``MultiShape`` of each; any other sequence as a ``SingleShape``."""
        if isinstance(value, Shape):
            return value
        if value and isinstance(value[0], (list, tuple, Shape)):
            return MultiShape([Shape.of(v) for v in value])
        return SingleShape(list(value))


class SingleShape(Shape):
    def __init__(self, dims: Sequence[int]):
        self.dims: List[int] = list(dims)

    def to_tuple(self):
        return tuple(self.dims)

    def __repr__(self):
        return f"SingleShape({self.dims})"

    def __eq__(self, other):
        return isinstance(other, SingleShape) and self.dims == other.dims


class MultiShape(Shape):
    def __init__(self, shapes: Sequence[Shape]):
        self.shapes: List[Shape] = list(shapes)

    def __repr__(self):
        return f"MultiShape({self.shapes})"

    def __eq__(self, other):
        return isinstance(other, MultiShape) and self.shapes == other.shapes
