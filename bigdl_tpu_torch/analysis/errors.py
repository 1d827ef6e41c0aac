"""Error and finding types of the static-analysis passes (counterpart of
``bigdl_tpu/analysis/errors.py``).

Every fatal finding carries the module's full path
(``Sequential(model)/Linear(fc1)``), so that a fault deep in a container
names its layer on the host, before anything runs on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from ..utils.table import Table


class AnalysisError(ValueError):
    """Base of every fatal static-analysis finding."""


class ShapeInferenceError(AnalysisError):
    """A shape or dtype contract violation at a module path."""

    def __init__(self, module_path: Tuple[str, ...], in_spec, message: str):
        self.module_path = tuple(module_path)
        self.in_spec = in_spec
        super().__init__(f"shape inference failed at {format_path(self.module_path)} "
                         f"(input spec: {format_spec(in_spec)}): {message}")


class GraphValidationError(AnalysisError):
    """A structural defect in a ``ModuleNode`` DAG (cycle, dangling input,
    duplicate name, arity mismatch)."""


class ParamAuditError(AnalysisError):
    """A parameter-tree defect (accidental aliasing, dtype-policy violation,
    non-finite initializer)."""


@dataclass
class Finding:
    """One analysis result below or at the level of an exception."""

    code: str  # e.g. 'graph-dangling-node', 'param-shared'
    severity: str  # 'error' | 'warning'
    message: str
    path: Optional[str] = None

    def __str__(self) -> str:
        where = f" [{self.path}]" if self.path else ""
        return f"{self.severity}: {self.code}{where}: {self.message}"


def format_path(path: Tuple[str, ...]) -> str:
    return "/".join(path) if path else "<model>"


def _leaves(spec, out) -> None:
    if isinstance(spec, Table):
        spec = spec.to_list()
    if isinstance(spec, (list, tuple)):
        for s in spec:
            _leaves(s, out)
    elif isinstance(spec, dict):
        for s in spec.values():
            _leaves(s, out)
    else:
        out.append(spec)


def format_spec(spec: Any) -> str:
    """A spec (meta tensors, through tables and lists) as ``float32(2, 5)``
    or ``(float32(2, 5), int64(2,))``."""

    def one(a) -> str:
        shape = getattr(a, "shape", None)
        if shape is None:
            return repr(a)
        dtype = getattr(a, "dtype", None)
        name = str(dtype).replace("torch.", "") if isinstance(dtype, torch.dtype) else dtype
        return f"{name}{tuple(shape)}"

    leaves: list = []
    _leaves(spec, leaves)
    if len(leaves) == 1 and spec is leaves[0]:
        return one(spec)
    return "(" + ", ".join(one(a) for a in leaves) + ")"
