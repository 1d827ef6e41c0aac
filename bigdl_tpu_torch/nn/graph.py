"""``Graph`` — a DAG of modules (counterpart of ``bigdl_tpu/nn/graph.py``).

Nodes are wired with ``layer.inputs(node, ...)``; ``Graph(input, output)``
sorts them topologically, registers each node's module as a child under its
name, and runs them in that order. A node with several parents receives a
``Table`` of their outputs (Torch convention); ``CAddTable`` sums it.

Not ported yet: ``GraphValidator``, serialization, and a module used at
several nodes (shared weights), which raises ``NotImplementedError``.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple, Union

import torch

from ..utils.table import T, Table
from .module import AbstractModule, Container, Identity

_node_ids = itertools.count(1)


class ModuleNode:
    """A vertex wrapping a module instance."""

    def __init__(self, module: AbstractModule, parents: Sequence["ModuleNode"] = ()):
        self.id = next(_node_ids)
        self.module = module
        self.parents: List[ModuleNode] = list(parents)

    def __repr__(self):
        return f"Node({self.module.name()})"


def Input() -> ModuleNode:
    """Source placeholder node. Its module is never built or run, so it
    lives on the CPU whatever device the graph uses."""
    return ModuleNode(Identity(device="cpu").set_name(f"Input{next(_node_ids)}"), [])


Nodes = Union[ModuleNode, Sequence[ModuleNode]]


def _as_list(x) -> list:
    if isinstance(x, Table):
        return x.to_list()
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Graph(Container):
    def __init__(self, inputs: Nodes, outputs: Nodes, device=None):
        input_nodes = [inputs] if isinstance(inputs, ModuleNode) else list(inputs)
        output_nodes = [outputs] if isinstance(outputs, ModuleNode) else list(outputs)
        topo = _topo_sort(input_nodes, output_nodes)
        children, seen = [], set()
        for n in topo:
            if n in input_nodes:
                continue
            if id(n.module) in seen:
                raise NotImplementedError(
                    f"{n.module.name()} is used at several nodes; graphs with shared "
                    "modules are not ported yet")
            seen.add(id(n.module))
            children.append(n.module)
        super().__init__(*children, device=device)
        self.input_nodes, self.output_nodes, self._topo = input_nodes, output_nodes, topo

    def _run(self, x, step) -> Tuple[object, Dict[str, object]]:
        """Walk the nodes in topological order: ``step(module, input)`` gives
        ``(output, state)``."""
        graph_inputs = _as_list(x)
        if len(graph_inputs) != len(self.input_nodes):
            raise ValueError(f"Graph expects {len(self.input_nodes)} inputs, "
                             f"got {len(graph_inputs)}")
        values = {n.id: v for n, v in zip(self.input_nodes, graph_inputs)}
        new_state: Dict[str, object] = {}
        for node in self._topo:
            if node in self.input_nodes:
                continue
            if len(node.parents) == 1:
                arg = values[node.parents[0].id]
            else:
                arg = T(*[values[p.id] for p in node.parents])
            values[node.id], new_state[node.module.name()] = step(node.module, arg)
        outs = [values[n.id] for n in self.output_nodes]
        return (outs[0] if len(outs) == 1 else T(*outs)), new_state

    def build(self, generator: torch.Generator, sample) -> None:
        """Build the nodes' modules in topological order, each from the
        eval-mode outputs of its parents on ``sample`` under
        ``torch.no_grad()``."""
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        with torch.no_grad():
            self._run(sample, lambda m, v: (self._build_child(m, generator, v), None))
        self._built = True

    def _apply_params(self, params, state, x, training, rng):
        return self._run(x, lambda m, v: m._apply_params(params[m.name()], state[m.name()],
                                                         v, training, rng))


def _topo_sort(input_nodes: List[ModuleNode], output_nodes: List[ModuleNode]) -> List[ModuleNode]:
    """Parents before children, by an iterative post-order walk from the
    outputs; raises on a cycle and on an input that reaches no output."""
    seen: Dict[int, ModuleNode] = {}
    order: List[ModuleNode] = []
    visiting = set()
    for out in output_nodes:
        stack: List[Tuple[ModuleNode, bool]] = [(out, False)]
        while stack:
            node, expanded = stack.pop()
            if node.id in seen:
                continue
            if expanded:
                visiting.discard(node.id)
                seen[node.id] = node
                order.append(node)
                continue
            if node.id in visiting:
                raise ValueError("cycle detected in Graph")
            visiting.add(node.id)
            stack.append((node, True))
            for p in node.parents:
                if p.id not in seen:
                    stack.append((p, False))
    for inp in input_nodes:
        if inp.id not in seen:
            raise ValueError(f"input node {inp} is not connected to any output")
    return order
