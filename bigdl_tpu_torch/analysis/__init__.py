"""Static model analysis (counterpart of ``bigdl_tpu/analysis/``): fail fast
on the host, before anything is allocated or launched on the card.

* :class:`ShapeProp` — shape/dtype inference over ``Sequential`` and
  ``Graph`` through each layer's ``infer_shape`` contract or its forward on
  meta tensors; errors carry the module path and the input spec.
* :class:`GraphValidator` — structural DAG checks (cycles, orphan roots,
  unreachable inputs, duplicate names, merge arity, dangling nodes).
* :class:`ParamAudit` — parameter hygiene (accidental aliasing, float32
  masters, non-finite values).
* :class:`FlatParamAudit` — the same over the flat layout's vector (codec
  geometry, float32, finiteness), before the first flat step.
* :class:`ShardedParamAudit` — the same over a rank's blocks of a tree cut
  by a ``ShardingPlan`` (finiteness naming the block and the rank, float32,
  aliasing over the tree before the cut).

``validate_model`` composes them; ``Graph`` and the optimizers run them by
default (``validate=False`` skips them).
"""

from __future__ import annotations

from typing import List

from .errors import (AnalysisError, Finding, GraphValidationError, ParamAuditError,
                     ShapeInferenceError)
from .graph_validator import GraphValidator
from .param_audit import FlatParamAudit, ParamAudit, ShardedParamAudit
from .shape_prop import ShapeProp, infer_shapes, to_spec


def validate_model(model, sample_or_spec=None, allow_shared=()) -> List[Finding]:
    """Run every applicable pass; raise an :class:`AnalysisError` on the
    first fatal finding, return the others: every ``Graph`` of the tree is
    validated, ``ShapeProp`` runs when an input or spec is given and
    ``ParamAudit`` when the model is built."""
    from ..nn.graph import Graph

    findings: List[Finding] = []
    for m in model.walk():
        if isinstance(m, Graph):
            findings.extend(GraphValidator(m).check())
    if sample_or_spec is not None:
        ShapeProp(model).infer(sample_or_spec)
    if model.is_built():
        findings.extend(ParamAudit(model, allow_shared=allow_shared).check())
    return findings


__all__ = ["AnalysisError", "FlatParamAudit", "Finding", "GraphValidationError", "GraphValidator", "ParamAudit",
           "ParamAuditError", "ShapeInferenceError", "ShapeProp", "ShardedParamAudit", "infer_shapes", "to_spec",
           "validate_model"]
