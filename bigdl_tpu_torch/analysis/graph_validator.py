"""GraphValidator — structural checks on ``ModuleNode`` DAGs (counterpart of
``bigdl_tpu/analysis/graph_validator.py``).

Validates the wiring of a ``nn.Graph`` (or raw input/output endpoint lists,
before the ``Graph`` object exists) without running or building anything:

* **cycles** — reported with the module names along the cycle;
* **orphan roots** — a node with no parents that is not a declared graph input
  (its ``_apply`` would receive an empty Table);
* **unreachable inputs** — declared inputs no output depends on;
* **duplicate names** — two *distinct* modules sharing a name (their params
  would silently collide in the container pytree; one module at several nodes
  is intentional weight sharing and is fine);
* **merge arity** — a node with several parents whose module is a known
  single-tensor-input layer (e.g. ``Linear`` fed by two branches where a
  ``JoinTable``/``CAddTable`` was intended);
* **dangling nodes** (warning) — wired downstream of an input but feeding no
  output: silently never executed. A node holds its children weakly
  (``nn.graph``), so a dangling node that nothing holds is already freed
  and not reported.

Fatal findings raise :class:`GraphValidationError` from ``check()``;
``findings()`` returns everything, warnings included.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from .errors import Finding, GraphValidationError


def _name(node) -> str:
    return f"{type(node.module).__name__}({node.module.name()})"


def _accepts_multi_parents(module) -> Optional[bool]:
    """True/False when the module's input arity is known; None when it is not
    (custom containers route data in ways static analysis cannot see)."""
    from ..nn.graph import Graph
    from ..nn.module import Container, Identity, Sequential

    if getattr(module, "accepts_table_input", False):
        return True
    if isinstance(module, (Identity, Graph)):
        return True  # pass-through / multi-input subgraph
    if isinstance(module, Sequential):
        if module._layers:
            return _accepts_multi_parents(module._layers[0])
        return None  # children materialize at build (keras wrappers)
    if isinstance(module, Container):
        return None
    return False


class GraphValidator:
    """Validate one DAG, given a ``Graph`` or its raw endpoints."""

    def __init__(self, graph=None, *, inputs: Sequence = (), outputs: Sequence = ()):
        if graph is not None:
            inputs, outputs = graph.input_nodes, graph.output_nodes
        self.inputs = list(inputs)
        self.outputs = list(outputs)

    # ------------------------------------------------------------------ passes
    def findings(self) -> List[Finding]:
        found: List[Finding] = []
        order, cycle = self._ancestors_of_outputs()
        if cycle is not None:
            found.append(
                Finding(
                    "graph-cycle",
                    "error",
                    "cycle detected in Graph: " + " -> ".join(_name(n) for n in cycle),
                    path=_name(cycle[0]),
                )
            )
            return found  # downstream passes assume a DAG

        ancestor_ids = {id(n) for n in order}
        input_ids = {id(n) for n in self.inputs}

        for n in order:
            if (
                not n.parents
                and id(n) not in input_ids
                and not getattr(n.module, "graph_source", False)
            ):
                # source modules (Const/Variable — graph_source=True) emit a
                # value from zero parents by design; anything else would
                # receive an empty input
                found.append(
                    Finding(
                        "graph-orphan-root",
                        "error",
                        f"{_name(n)} has no parents and is not a declared "
                        "graph input; it would receive an empty input",
                        path=_name(n),
                    )
                )

        for n in self.inputs:
            if id(n) not in ancestor_ids:
                found.append(
                    Finding(
                        "graph-unreachable-input",
                        "error",
                        f"declared input {_name(n)} is not connected to any output",
                        path=_name(n),
                    )
                )

        # duplicate names among DISTINCT modules (same module at several nodes
        # is weight sharing and registers once)
        by_name: Dict[str, Set[int]] = {}
        for n in order:
            by_name.setdefault(n.module.name(), set()).add(id(n.module))
        for name, ids in sorted(by_name.items()):
            if len(ids) > 1:
                found.append(
                    Finding(
                        "graph-duplicate-name",
                        "error",
                        f"{len(ids)} distinct modules named {name!r}: their "
                        "parameters would collide in the Graph's param pytree; "
                        "give them unique set_name()s",
                        path=name,
                    )
                )

        for n in order:
            if len(n.parents) > 1 and id(n) not in input_ids:
                ok = _accepts_multi_parents(n.module)
                if ok is False:
                    found.append(
                        Finding(
                            "graph-merge-arity",
                            "error",
                            f"{_name(n)} receives {len(n.parents)} parent "
                            "branches but is a single-input layer; merge them "
                            "first (JoinTable/CAddTable/...)",
                            path=_name(n),
                        )
                    )

        for n in self._forward_reachable():
            if id(n) not in ancestor_ids:
                # children edges are per-NODE, not per-graph: a node shared
                # with a sibling Graph shows up here too, so this stays a
                # warning and names both readings
                found.append(
                    Finding(
                        "graph-dangling-node",
                        "warning",
                        f"{_name(n)} is wired downstream of an input but feeds "
                        "no output of THIS graph: dead wiring, unless the node "
                        "belongs to another Graph sharing these inputs",
                        path=_name(n),
                    )
                )
        return found

    def check(self) -> List[Finding]:
        """Raise :class:`GraphValidationError` on the first error-severity
        finding; return all findings (warnings included) otherwise."""
        found = self.findings()
        errors = [f for f in found if f.severity == "error"]
        if errors:
            raise GraphValidationError(
                "; ".join(str(f) for f in errors)
                if len(errors) > 1
                else errors[0].message
            )
        return found

    # ---------------------------------------------------------------- helpers
    def _ancestors_of_outputs(self):
        """Post-order over ancestors of the outputs; returns (order, cycle).

        ``cycle`` is the node sequence of the first back-edge found (or None).
        """
        seen: Set[int] = set()
        order: List = []
        visiting: Dict[int, None] = {}  # insertion-ordered path for reporting
        nodes_on_path: List = []

        for out in self.outputs:
            stack = [(out, False)]
            while stack:
                node, expanded = stack.pop()
                if expanded:
                    visiting.pop(id(node), None)
                    if nodes_on_path and nodes_on_path[-1] is node:
                        nodes_on_path.pop()
                    if id(node) not in seen:
                        seen.add(id(node))
                        order.append(node)
                    continue
                if id(node) in seen:
                    continue
                if id(node) in visiting:
                    # reconstruct the cycle from the current DFS path
                    idx = next(
                        i for i, n in enumerate(nodes_on_path) if n is node
                    )
                    return order, nodes_on_path[idx:] + [node]
                visiting[id(node)] = None
                nodes_on_path.append(node)
                stack.append((node, True))
                for p in node.parents:
                    if id(p) not in seen:
                        stack.append((p, False))
        return order, None

    def _forward_reachable(self) -> List:
        """Nodes reachable from the inputs via recorded (live) children edges."""
        seen: Set[int] = set()
        out: List = []
        stack = list(self.inputs)
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            out.append(n)
            stack.extend(getattr(n, "children", ()))
        return out
