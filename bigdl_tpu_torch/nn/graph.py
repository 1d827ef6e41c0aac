"""``Graph`` — a DAG of modules (counterpart of ``bigdl_tpu/nn/graph.py``).

Nodes are wired with ``layer.inputs(node, ...)``; ``Graph(input, output)``
validates the wiring (``analysis.GraphValidator``: cycles with the modules
along them, orphan roots, unreachable inputs, duplicate names, merge
arity; ``validate=False`` skips it), sorts the nodes topologically,
registers each node's module as a child under its name, and runs them in
that order. A node with several parents receives a ``Table`` of their
outputs (Torch convention); ``CAddTable`` sums it.

One module at several nodes is weight sharing (a Siamese tower, a keras
shared layer): it registers once, as one child with one parameter set,
every site reads ``params[name]`` and autograd sums the sites' gradients.
It is built at its first site; a later site only runs it (eval mode, no
gradient) to give its children a sample. Every site reads the module's
state from before the forward and the last site's new state is kept, as
in the JAX package: a shared BatchNormalization keeps the second site's
running statistics, each updated from the pre-step state.

A node records its children through weak references (``children``), for
the validator's dangling-node warning: strong ones would tie each parent
and child into a reference cycle, and a dropped model's weights would wait
for the cyclic collector. A dangling node that nothing else holds is
therefore freed and not reported (the JAX package reports it).

``_serialize_spec`` / ``_from_spec`` are the model file's DAG record
(:mod:`bigdl_tpu_torch.utils.module_serializer`): the modules once each,
in topological order, and the nodes by module index; the per-node format
of older files is read too.
"""

from __future__ import annotations

import itertools
import weakref
from typing import Any, Dict, List, Sequence, Tuple, Union

import torch

from ..utils.table import T, Table
from .module import AbstractModule, Container, Identity, infer_module_shape

_node_ids = itertools.count(1)


class ModuleNode:
    """A vertex wrapping a module instance."""

    def __init__(self, module: AbstractModule, parents: Sequence["ModuleNode"] = ()):
        self.id = next(_node_ids)
        self.module = module
        self.parents: List[ModuleNode] = list(parents)
        self._children: List[weakref.ref] = []
        for p in self.parents:
            p._children.append(weakref.ref(self))

    def __deepcopy__(self, memo):
        """A copy whose module and parents are copies (through ``memo``):
        each copied node registers itself with its copied parents, so no
        weak reference of the copy points into the original (``copy``
        would keep a ``weakref.ref`` as it is)."""
        import copy

        node = ModuleNode.__new__(ModuleNode)
        memo[id(self)] = node
        node.id = next(_node_ids)
        node.__dict__.update({k: copy.deepcopy(v, memo) for k, v in self.__dict__.items()
                              if k not in ("id", "module", "parents", "_children")})
        node.module = copy.deepcopy(self.module, memo)
        node.parents = [copy.deepcopy(p, memo) for p in self.parents]
        node._children = []
        for p in node.parents:
            p._children.append(weakref.ref(node))
        return node

    @property
    def children(self) -> List["ModuleNode"]:
        """The live nodes wired to this one as a parent."""
        return [c for c in (r() for r in self._children) if c is not None]

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
    def __init__(self, inputs: Nodes, outputs: Nodes, validate: bool = True, device=None):
        input_nodes = [inputs] if isinstance(inputs, ModuleNode) else list(inputs)
        output_nodes = [outputs] if isinstance(outputs, ModuleNode) else list(outputs)
        if validate:
            from ..analysis.graph_validator import GraphValidator

            GraphValidator(inputs=input_nodes, outputs=output_nodes).check()
        topo = _topo_sort(input_nodes, output_nodes)
        children, seen = [], set()
        for n in topo:
            if n in input_nodes or id(n.module) in seen:
                continue
            seen.add(id(n.module))
            children.append(n.module)
        super().__init__(*children, device=device)
        self.input_nodes, self.output_nodes, self._topo = input_nodes, output_nodes, topo

    def _run(self, x, step) -> Tuple[object, Dict[str, object]]:
        """Walk the nodes in topological order: ``step(node, input)`` gives
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
            values[node.id], new_state[node.module.name()] = step(node, arg)
        outs = [values[n.id] for n in self.output_nodes]
        return (outs[0] if len(outs) == 1 else T(*outs)), new_state

    def build(self, generator: torch.Generator, sample) -> None:
        """Build the nodes' modules in topological order, each from the
        eval-mode outputs of its parents on ``sample`` under
        ``torch.no_grad()``; a shared module is built at its first site."""
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        with torch.no_grad():
            self._run(sample, lambda n, v: (self._build_child(n.module, generator, v), None))
        self._built = True

    def infer_shape(self, in_spec, _resolve=None):
        """The output spec over the DAG; ``_resolve(node, in_spec)`` is the
        per-node inference (``analysis.ShapeProp`` passes its own, which
        tracks the module path)."""
        resolve = _resolve or (lambda node, spec: infer_module_shape(node.module, spec))
        return self._run(in_spec, lambda n, v: (resolve(n, v), None))[0]

    def _apply_params(self, params, state, x, training, rng):
        def step(node, v):
            m = node.module
            return m._apply_params(params[m.name()], state[m.name()], v, training, rng)

        return self._run(x, step)

    # -------------------------------------------------------- model file
    def _serialize_spec(self) -> Dict[str, Any]:
        from ..utils.module_serializer import class_ref, module_to_spec

        idx = {node.id: i for i, node in enumerate(self._topo)}
        mod_specs: List[Any] = []
        mod_index: Dict[int, int] = {}
        node_mods: List[int] = []
        for n in self._topo:
            key = id(n.module)
            if key not in mod_index:  # a shared module is written once
                mod_index[key] = len(mod_specs)
                mod_specs.append(module_to_spec(n.module))
            node_mods.append(mod_index[key])
        module, cls = class_ref(type(self))
        return {"class": cls, "module": module,
                "graph": {"modules": mod_specs,
                          "nodes": [{"module_index": node_mods[i],
                                     "parents": [idx[p.id] for p in n.parents]}
                                    for i, n in enumerate(self._topo)],
                          "inputs": [idx[n.id] for n in self.input_nodes],
                          "outputs": [idx[n.id] for n in self.output_nodes]}}

    @classmethod
    def _from_spec(cls, spec, device=None) -> "Graph":
        from ..utils.module_serializer import spec_to_module

        g = spec["graph"]
        modules = [spec_to_module(ms, device) for ms in g.get("modules", [])]
        built: List[ModuleNode] = []
        for ns in g["nodes"]:  # topological order: parents precede their children
            if "module_index" in ns:
                module = modules[ns["module_index"]]
            else:  # the per-node format of older files
                module = spec_to_module(ns["module"], device)
            built.append(ModuleNode(module, [built[i] for i in ns["parents"]]))
        return cls([built[i] for i in g["inputs"]], [built[i] for i in g["outputs"]],
                   device=device)


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
