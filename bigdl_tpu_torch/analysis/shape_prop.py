"""ShapeProp — static shape and dtype inference over module trees
(counterpart of ``bigdl_tpu/analysis/shape_prop.py``).

Propagates specs — meta tensors (``torch.empty(shape, dtype=...,
device="meta")``, the counterpart of ``jax.ShapeDtypeStruct``) through
``Table`` s and lists — through ``Sequential`` chains and ``Graph`` DAGs
without running the model on data or allocating a parameter. Each layer
resolves through its ``infer_shape`` contract where it has one, else
through its forward on meta tensors (``nn.module.infer_module_shape``).
Nothing touches the card or launches a kernel. A mismatch raises
``ShapeInferenceError`` with the module's full path and the input spec.
"""

from __future__ import annotations

from typing import Any, List, Tuple

from ..nn.module import AbstractModule, Sequential, import_torch_dynamo, infer_module_shape
from ..nn.module import to_spec as _to_spec
from .errors import ShapeInferenceError, format_path


def to_spec(x):
    """Arrays, tensors and specs, through tables and lists, as meta tensors."""
    return _to_spec(x)


def _path_entry(module: AbstractModule) -> str:
    return f"{type(module).__name__}({module.name()})"


class ShapeProp:
    """Static shape/dtype propagation over one model.

    ``infer(sample_or_spec)`` returns the output spec and fills ``report``
    with ``(module_path, in_spec, out_spec)`` triples in evaluation order.
    Raises :class:`ShapeInferenceError` on the first violation.
    """

    def __init__(self, model: AbstractModule):
        self.model = model
        self.report: List[Tuple[str, Any, Any]] = []

    def infer(self, sample_or_spec):
        import_torch_dynamo()  # the first meta dispatch must not hold the model's frames
        self.report = []
        return self._infer(self.model, to_spec(sample_or_spec), (_path_entry(self.model),))

    def _infer(self, module: AbstractModule, in_spec, path: Tuple[str, ...]):
        from ..nn.graph import Graph

        # recurse only where the container's semantics are the stock ones: a
        # subclass with its own forward routes data differently, and resolves
        # through its contract or the meta forward instead
        if (isinstance(module, Sequential)
                and type(module)._apply_params is Sequential._apply_params and module._layers):
            out = self._infer_sequential(module, in_spec, path)
        elif isinstance(module, Graph) and type(module)._apply_params is Graph._apply_params:
            out = self._infer_graph(module, in_spec, path)
        else:
            out = self._infer_leaf(module, in_spec, path)
        self.report.append((format_path(path), in_spec, out))
        return out

    def _infer_sequential(self, module: Sequential, in_spec, path):
        spec = in_spec
        for child in module._layers:
            spec = self._infer(child, spec, path + (_path_entry(child),))
        return spec

    def _infer_graph(self, graph, in_spec, path):
        def resolve(node, spec):
            return self._infer(node.module, spec, path + (_path_entry(node.module),))

        try:
            return graph.infer_shape(in_spec, _resolve=resolve)
        except ShapeInferenceError:
            raise
        except Exception as e:
            raise ShapeInferenceError(path, in_spec, str(e)) from e

    def _infer_leaf(self, module: AbstractModule, in_spec, path):
        try:
            return infer_module_shape(module, in_spec)
        except ShapeInferenceError:
            raise  # already carries a (deeper) module path
        except Exception as e:
            raise ShapeInferenceError(path, in_spec, str(e)) from e


def infer_shapes(model: AbstractModule, sample_or_spec):
    """Run ShapeProp; returns ``(out_spec, report)``."""
    prop = ShapeProp(model)
    out = prop.infer(sample_or_spec)
    return out, prop.report
