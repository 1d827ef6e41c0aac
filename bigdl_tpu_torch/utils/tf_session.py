"""TF Session analog (counterpart of ``bigdl_tpu/utils/tf_session.py``;
BigDL's ``BigDLSessionImpl``): feeds/fetches execution and TRAINING over an
imported GraphDef.

* ``TFSession.run(feed_dict, fetches)`` — feeds/fetches execution of the
  imported ``nn.Graph`` (placeholders are fed by name);
* Variable/Assign handling — an UNfrozen GraphDef's ``VariableV2`` nodes
  are resolved through their initializing ``Assign(var, Const)`` and
  wired as ``ops.Variable`` modules, whose value is a trainable
  parameter;
* ``trainable=True`` — a FROZEN graph's float Consts are promoted to
  Variables, so ``save_tf``-exported (or externally frozen) inference
  graphs can be fine-tuned;
* ``TFSession.train(dataset, criterion, ...)`` — wraps the imported
  graph in ``LocalOptimizer`` and fine-tunes those variables in place;
  subsequent ``run`` calls see the updated weights.

The graph lives on ``device``: the card unless ``"cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .tf_loader import NodeDef, TensorflowLoader, parse_graph_def


def _resolve_variables(nodes: List[NodeDef]) -> List[NodeDef]:
    """Fold ``VariableV2 <- Assign(var, init)`` pairs into Const nodes.

    The initializer is found by walking the Assign's value input through
    Identity chains to a Const. Assign/NoOp(init) nodes are dropped —
    the graph has no in-graph mutation; the variable's state lives as a
    module parameter instead (the same ownership move the reference makes
    when it binds tf variables to its own weight storage)."""
    by_name = {n.name: n for n in nodes}

    def resolve_const(name: str) -> Optional[NodeDef]:
        seen = set()
        while name not in seen:
            seen.add(name)
            nd = by_name.get(name.split(":")[0])
            if nd is None:
                return None
            if nd.op == "Const":
                return nd
            if nd.op in ("Identity", "StopGradient") and nd.inputs:
                name = nd.inputs[0]
                continue
            return None
        return None

    inits: Dict[str, NodeDef] = {}
    dropped = set()
    for nd in nodes:
        if nd.op == "Assign" and len(nd.inputs) >= 2:
            var = nd.inputs[0].split(":")[0]
            target = by_name.get(var)
            if target is not None and target.op in ("Variable", "VariableV2"):
                const = resolve_const(nd.inputs[1])
                if const is None:
                    raise ValueError(
                        f"Assign to {var!r} has a non-Const initializer — "
                        "only Const (possibly via Identity) initial values "
                        "are supported"
                    )
                inits[var] = const
                dropped.add(nd.name)

    out: List[NodeDef] = []
    for nd in nodes:
        if nd.name in dropped:
            continue
        if nd.op in ("Variable", "VariableV2"):
            if nd.name not in inits:
                raise ValueError(
                    f"Variable {nd.name!r} has no initializing Assign"
                )
            folded = NodeDef()
            folded.name = nd.name
            folded.op = "Const"
            folded.inputs = []
            folded.attrs = {"value": inits[nd.name].attrs.get("value",
                                                             (None, None)),
                            "__was_variable__": (None, True)}
            out.append(folded)
        else:
            out.append(nd)
    return out


def _was_variable(nd: NodeDef) -> bool:
    return bool(nd.attrs.get("__was_variable__", (None, False))[1])


class TFSession:
    """Feeds/fetches + training over an imported GraphDef (see module doc).

    Args:
        graph: path to a serialized GraphDef, or its raw bytes.
        inputs: placeholder node names fed by ``run``/``train``.
        outputs: fetchable output node names (the graph is built once over
            all of them; ``run``'s ``fetches`` selects among them).
        trainable: False -> only Variable/Assign-backed state is trainable;
            True -> every float Const is promoted to a Variable, making a
            frozen inference graph fine-tunable.
        device: where the graph runs (the card unless ``"cpu"``).
    """

    def __init__(self, graph, inputs: Sequence[str],
                 outputs: Sequence[str], trainable: bool = False, device=None):
        if isinstance(graph, (str, bytes)):
            blob = graph if isinstance(graph, bytes) else open(graph, "rb").read()
        else:
            raise TypeError("graph must be a path or GraphDef bytes")
        nodes = _resolve_variables(parse_graph_def(blob))
        loader = TensorflowLoader.__new__(TensorflowLoader)
        loader.nodes = nodes
        loader.device = device
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        predicate = (lambda nd: True) if trainable else _was_variable
        self.optimizer = None  # the LocalOptimizer of the last train()
        self.graph = loader.create_module(self.inputs, self.outputs,
                                          trainable=predicate)

    # ------------------------------------------------------------------ run
    def run(self, feed_dict: Dict[str, Any],
            fetches: Optional[Sequence[str]] = None):
        """Execute the graph: ``feed_dict`` maps input names to arrays;
        returns the fetched tensors (list, or a single tensor for a single
        fetch). ``fetches`` defaults to all declared outputs and must be a
        subset of them (the graph is built over the declared set)."""
        missing = [n for n in self.inputs if n not in feed_dict]
        if missing:
            raise ValueError(f"feed_dict missing inputs {missing}")
        from .table import Table

        feeds = [feed_dict[n] for n in self.inputs]
        feeds = [f if isinstance(f, torch.Tensor) else np.asarray(f) for f in feeds]
        with torch.no_grad():
            out = self.graph.forward(feeds[0] if len(feeds) == 1 else feeds)
        if isinstance(out, Table):
            values = out.to_list()
        elif isinstance(out, (list, tuple)):
            values = list(out)
        else:
            values = [out]
        if fetches is None:
            fetches = self.outputs
        sel = []
        for f in fetches:
            if f not in self.outputs:
                raise ValueError(
                    f"fetch {f!r} is not among the session outputs "
                    f"{self.outputs}; rebuild the session with it included"
                )
            sel.append(values[self.outputs.index(f)])
        return sel[0] if len(sel) == 1 else sel

    # ---------------------------------------------------------------- train
    def train(self, dataset, criterion, optim_method=None, end_when=None):
        """Fine-tune the imported graph's variables against ``criterion``
        (reference: ``BigDLSessionImpl.train(outputs, dataset, optim,
        criterion, endWhen)``). Returns the trained ``nn.Graph``; the
        session keeps using the updated weights, and ``self.optimizer`` is
        the ``LocalOptimizer`` that trained them."""
        from ..optim import SGD, LocalOptimizer, Trigger

        opt = LocalOptimizer(self.graph, dataset, criterion)
        opt.set_optim_method(optim_method or SGD(learningrate=1e-2))
        opt.set_end_when(end_when or Trigger.max_epoch(1))
        self.optimizer = opt  # its ``history`` keeps the steps' losses
        return opt.optimize()

    def variables(self) -> Dict[str, np.ndarray]:
        """Current values of the graph's Variable parameters, by node name,
        as host arrays."""
        from ..nn import ops as O

        out = {}
        for node in self.graph._topo:
            if isinstance(node.module, O.Variable):
                params = node.module.get_parameters()
                if params:
                    out[node.module.name()] = params["value"].detach().cpu().numpy()
        return out
