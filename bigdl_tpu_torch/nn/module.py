"""``AbstractModule`` — the port's counterpart of ``bigdl_tpu/nn/module.py``.

A ``torch.nn.Module`` with the JAX package's serving and gradient surface:

* ``_build(generator, sample) -> (params, state)`` allocates the module's
  parameter dict (nested dicts of tensors, the same paths as the JAX
  pytree); ``build``/``init``/``_ensure_built`` register them as
  ``nn.Parameter`` s, so ``named_parameters()`` reads ``block0.self_q_w``
  exactly where the JAX tree has ``params["block0"]["self_q_w"]``.
* ``_apply_params(params, state, x, training, rng) -> (y, new_state)`` is
  the pure forward over explicit dicts; ``apply`` exposes it and ``forward``
  runs it on the module's own parameters. (The hook is not named ``_apply``:
  that name is ``torch.nn.Module``'s, behind ``.to()``, ``.cuda()`` and the
  dtype casts.)
* ``get_grad_parameters`` / ``zero_grad_parameters`` / ``backward(x,
  grad_output)``: BigDL's stateful gradient surface over torch autograd;
  ``backward`` accumulates parameter gradients into ``.grad``.
* ``evaluate()`` switches to eval mode (torch's ``eval()``);
  ``evaluate(dataset, methods)`` also runs an ``Evaluator`` sweep, and
  ``predict`` / ``predict_class`` run a ``Predictor`` (both in
  :mod:`bigdl_tpu_torch.optim.predictor`).
* ``Container`` / ``Sequential`` hold child modules as registered
  submodules under their names and own no parameters: their trees are
  ``{child.name(): child_tree}``, as in the JAX package. ``name()`` /
  ``set_name`` and ``inputs(...)`` (graph wiring, :mod:`.graph`) are the JAX
  package's.

``rng`` is a ``torch.Generator`` (or ``None``); train/eval mode is torch's
own ``train()``/``eval()``. Parameters live on the module's ``device``,
which is the card unless the caller asks for ``device="cpu"``; ``.to()``,
``.cuda()``, ``.cpu()`` and the dtype casts move the parameters and the
state together, and ``device`` follows them.

Deliberate deviation: ``apply(params, state, x, *, training, rng)`` is the
JAX package's API and shadows ``torch.nn.Module.apply(fn)``.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tensor.sparse import SparseTensor
from ..utils.engine import Engine
from ..utils.random import RandomGenerator
from ..utils.table import T, Table

_uid = itertools.count(1)


def _register_tree(owner: torch.nn.Module, tree: Dict[str, Any]) -> Dict[str, Any]:
    """Register a nested dict of tensors on ``owner`` (sub-dicts become child
    modules) and return the same tree holding the registered Parameters."""
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            child = torch.nn.Module()
            owner.add_module(key, child)
            out[key] = _register_tree(child, val)
        else:
            param = torch.nn.Parameter(val)
            owner.register_parameter(key, param)
            out[key] = param
    return out


class AbstractModule(torch.nn.Module):
    """Base class of the port's layers (see module docstring)."""

    def __init__(self, device=None):
        super().__init__()
        self._uid = next(_uid)
        self._name: Optional[str] = None
        self._built = False
        self._param_tree: Dict[str, Any] = {}
        self._state: Dict[str, Any] = {}
        self._device = Engine.device(device)
        self._last_rng_state: Optional[torch.Tensor] = None
        self._last_state: Optional[Dict[str, Any]] = None

    @property
    def device(self) -> torch.device:
        """Where the parameters live: the constructor's device until the
        module is built, then the parameters' own (it follows ``.to()``)."""
        if self._built:
            for p in self.parameters():
                return p.device
        return self._device

    def _apply(self, fn, recurse: bool = True):
        """``torch.nn.Module``'s conversion hook (``.to()``, ``.cuda()``,
        ``.double()``, ...): the state tree follows the parameters."""
        super()._apply(fn, recurse)
        if self._built:
            self._param_tree = _rebind(self, self._param_tree)
            self._state = _map_tree(fn, self._state)
            if self._last_state is not None:
                self._last_state = _map_tree(fn, self._last_state)
        return self

    # ------------------------------------------------------------------ names
    def name(self) -> str:
        return self._name or f"{type(self).__name__}{self._uid}"

    def set_name(self, name: str) -> "AbstractModule":
        self._name = name
        return self

    def n_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # --------------------------------------------------------------- building
    def _build(self, generator: torch.Generator, sample) -> Tuple[Dict, Dict]:
        return {}, {}

    def _apply_params(self, params, state, x, training: bool, rng):  # pragma: no cover
        raise NotImplementedError

    def is_built(self) -> bool:
        return self._built

    def build(self, generator: torch.Generator, sample) -> None:
        """Allocate and register params/state for ``sample`` (one batch)."""
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        params, state = self._build(generator, sample)
        params = _to_device(params, self.device)
        self._param_tree = _register_tree(self, params)
        self._state = _to_device(state, self.device)
        self._built = True

    def init(self, generator: Optional[torch.Generator] = None, sample_input=None):
        """Explicitly initialise; returns the (params, state) dicts."""
        if sample_input is not None:
            self.build(generator or RandomGenerator.generator(),
                       self._as_input(sample_input))
        elif not self._built:
            raise ValueError(f"{self.name()}: init() needs a sample_input the first time")
        return self.get_parameters(), self.get_state()

    def _ensure_built(self, x) -> None:
        if not self._built:
            self.build(RandomGenerator.generator(), self._as_input(x))

    def _as_input(self, x):
        """``x`` as tensors on the module's device (a ``Table``, or a list of
        arrays or tensors, element by element; a ``SparseTensor`` whole)."""
        if isinstance(x, Table):
            return T(*[self._as_input(v) for v in x])
        if isinstance(x, SparseTensor):
            return x.to(self.device)
        if isinstance(x, (list, tuple)) and x and all(
                isinstance(v, (np.ndarray, torch.Tensor)) for v in x):
            return [self._as_input(v) for v in x]
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return torch.as_tensor(x, device=self.device)

    # ------------------------------------------------------------- functional
    def apply(self, params, state, x, *, training: bool = False, rng=None):
        """Pure forward over explicit dicts."""
        return self._apply_params(params, state, x, training, rng)

    def get_parameters(self) -> Dict[str, Any]:
        return self._param_tree

    def get_state(self) -> Dict[str, Any]:
        return self._state

    def set_state(self, state: Dict[str, Any]) -> None:
        self._state = state

    def get_grad_parameters(self) -> Dict[str, Any]:
        """The parameters' gradients on the JAX paths (zeros where none has
        been accumulated yet)."""
        return _map_tree(lambda p: p.grad if p.grad is not None else torch.zeros_like(p),
                         self._param_tree)

    def zero_grad_parameters(self) -> None:
        for p in self.parameters():
            p.grad = torch.zeros_like(p)

    # --------------------------------------------------------------- stateful
    def forward(self, x):
        """Forward on the module's own parameters (dropout only in train mode)."""
        x = self._as_input(x)
        self._ensure_built(x)
        rng = RandomGenerator.generator() if self.training else None
        self._last_rng_state = None if rng is None else rng.get_state()
        self._last_state = self.get_state()
        y, new_state = self._apply_params(self.get_parameters(), self._last_state, x,
                                          self.training, rng)
        if self.training:
            self.set_state(new_state)
        return y

    def backward(self, x, grad_output):
        """Gradient of the input (``None`` for integer ids); accumulates the
        parameter gradients into ``.grad`` (BigDL semantics). The forward is
        recomputed with the generator state of the preceding ``forward``, so
        dropout draws the same masks."""
        x = self._as_input(x)
        self._ensure_built(x)
        rng = None
        if self._last_rng_state is not None:
            rng = torch.Generator()
            rng.set_state(self._last_rng_state)
        state = self._last_state if self._last_state is not None else self.get_state()
        xin = x.detach().requires_grad_(x.is_floating_point())
        params = list(self.parameters())
        with torch.enable_grad():
            y, _ = self._apply_params(self.get_parameters(), state, xin,
                                      self.training, rng)
            wrt = params + ([xin] if xin.requires_grad else [])
            grads = torch.autograd.grad(y, wrt, torch.as_tensor(grad_output, device=y.device),
                                        allow_unused=True)
        with torch.no_grad():
            for p, gp in zip(params, grads):
                if gp is not None:
                    p.grad = gp if p.grad is None else p.grad + gp
        return grads[-1] if xin.requires_grad else None

    # -------------------------------------------------------------- inference
    def evaluate(self, dataset=None, methods=None, batch_size: Optional[int] = None):
        """No arguments: switch to eval mode and return the module. With a
        dataset and validation methods: also run them over the dataset
        (``Evaluator``) and return ``{method name: result}``. The sweep's
        batches are the dataset's: ``batch_size``, which sizes the JAX
        package's sharded predictor, is not ported and raises."""
        self.eval()
        if dataset is None:
            return self
        if batch_size is not None:
            raise NotImplementedError(
                "evaluate(batch_size=...) is not ported: the sweep runs the dataset's batches")
        from ..optim.predictor import Evaluator

        return Evaluator(self).evaluate(dataset, methods)

    def predict(self, data, batch_size: Optional[int] = None) -> torch.Tensor:
        """Batched eval-mode forward over a dataset, an array or a list of
        records; the stacked outputs on the host."""
        from ..optim.predictor import Predictor

        return Predictor(self, batch_size).predict(data)

    def predict_class(self, data, batch_size: Optional[int] = None) -> torch.Tensor:
        """1-based argmax class per record (the reference's ``predictClass``)."""
        from ..optim.predictor import Predictor

        return Predictor(self, batch_size).predict_class(data)

    # ----------------------------------------------------------------- graphs
    def inputs(self, *parents) -> "ModuleNode":
        """``layer.inputs(n1, n2)``: a graph node of this module fed by
        ``parents`` (see :mod:`bigdl_tpu_torch.nn.graph`)."""
        from .graph import ModuleNode

        return ModuleNode(self, parents)


class Container(AbstractModule):
    """A module of child modules (counterpart of the JAX package's
    ``Container``). It owns no parameters: its parameter, state and gradient
    trees are ``{child.name(): child_tree}``. Each child is a registered
    submodule under its name, so ``.to()`` moves it and ``named_parameters()``
    reads ``child.grandchild.weight`` where the JAX tree has
    ``params["child"]["grandchild"]["weight"]``. An unnamed child is named
    ``<Type>_<index>`` when it is added."""

    def __init__(self, *modules: AbstractModule, device=None):
        super().__init__(device)
        self._layers: List[AbstractModule] = []
        for m in modules:
            self.add(m)

    def add(self, module: AbstractModule) -> "Container":
        if not isinstance(module, AbstractModule):
            raise TypeError(f"expected AbstractModule, got {type(module)}")
        if module._name is None:
            module.set_name(f"{type(module).__name__}_{len(self._layers)}")
        name = module.name()
        if any(m.name() == name for m in self._layers):
            raise ValueError(f"duplicate child name {name!r}")
        if not name or "." in name:
            raise ValueError(f"{self.name()}: child name {name!r} cannot be a submodule name")
        # registered as torch.nn.Module.add_module does, minus its refusal of a
        # name that is also an attribute (a child may be named "add"; it is then
        # reached by index or named_modules(), not as an attribute)
        self._modules[name] = module
        self._layers.append(module)
        return self

    def __getitem__(self, i: int) -> AbstractModule:
        return self._layers[i]

    def __len__(self) -> int:
        return len(self._layers)

    def get_parameters(self) -> Dict[str, Any]:
        return {m.name(): m.get_parameters() for m in self._layers}

    def get_state(self) -> Dict[str, Any]:
        return {m.name(): m.get_state() for m in self._layers}

    def set_state(self, state: Dict[str, Any]) -> None:
        for m in self._layers:
            m.set_state(state[m.name()])

    def get_grad_parameters(self) -> Dict[str, Any]:
        return {m.name(): m.get_grad_parameters() for m in self._layers}

    @staticmethod
    def _build_child(m: AbstractModule, generator, x):
        """Build ``m`` from ``x`` unless it is built, and return its eval-mode
        output on ``x`` (no gradient, running statistics untouched)."""
        if not m.is_built():
            m.build(generator, x)
        return m._apply_params(m.get_parameters(), m.get_state(), x, False, None)[0]


class Sequential(Container):
    """A chain of modules."""

    def build(self, generator: torch.Generator, sample) -> None:
        """Build the children in order, each from its predecessor's eval-mode
        output on ``sample`` under ``torch.no_grad()``."""
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        x = sample
        with torch.no_grad():
            for m in self._layers:
                x = self._build_child(m, generator, x)
        self._built = True

    def _apply_params(self, params, state, x, training, rng):
        new_state: Dict[str, Any] = {}
        for m in self._layers:
            x, new_state[m.name()] = m._apply_params(params[m.name()], state[m.name()], x,
                                                     training, rng)
        return x, new_state


class Identity(AbstractModule):
    """Pass-through."""

    def _apply_params(self, params, state, x, training, rng):
        return x, state


def _map_tree(fn, tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (_map_tree(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _rebind(owner: torch.nn.Module, tree: Dict[str, Any]) -> Dict[str, Any]:
    """``tree`` with each leaf replaced by the Parameter now registered at its
    path (a conversion may have swapped the Parameter objects)."""
    return {k: (_rebind(getattr(owner, k), v) if isinstance(v, dict) else getattr(owner, k))
            for k, v in tree.items()}


def _to_device(tree: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return _map_tree(lambda v: v.to(device), tree)
