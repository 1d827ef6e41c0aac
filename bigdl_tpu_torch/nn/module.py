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

Every subclass records its constructor's arguments (``_ctor_spec``; the
``device=`` keyword is left out: a model file does not say where a model
runs) and the outermost ``build`` records the input's spec
(``_top_in_spec``), so ``save_module`` can write the topology and
``nn.load_module`` rebuild it in a fresh process
(:mod:`bigdl_tpu_torch.utils.module_serializer`). ``infer_shape(in_spec)``
is a module's static shape contract over specs (meta tensors, the
counterpart of ``jax.ShapeDtypeStruct``), ``NotImplemented`` where it has
none; :func:`infer_module_shape` resolves any module, and ``walk()`` yields
a module and its descendants (:mod:`bigdl_tpu_torch.analysis`).

Deliberate deviations, each where a JAX name meets ``torch.nn.Module``'s:

* ``apply(params, state, x, *, training, rng)`` is the JAX package's API and
  shadows ``torch.nn.Module.apply(fn)``.
* ``register_forward_hook(hook)`` is the JAX package's and shadows torch's:
  ``hook(module, x, y)`` runs after every pure forward of the module (at the
  root, inside a container, at each graph node, in ``LocalOptimizer``'s
  step), and a dict it returns is merged into the module's new state; torch's
  ``hook(module, args, output)`` fires on ``forward`` only. The returned
  :class:`ForwardHookHandle`'s ``remove()`` restores the forward as it was
  before the hook, hooks removed in LIFO order.
* The JAX ``parameters()`` (a (weights, gradients) pair of leaf lists) and
  ``training()`` (a method switching to train mode) are not ported under
  those names: torch's ``parameters()`` feeds torch's own machinery (the
  optimizers, ``.to()``), and ``self.training`` is the bool that torch's
  ``train()``/``eval()`` set and ``forward`` reads. Their counterparts are
  ``get_parameters()`` / ``get_grad_parameters()`` (the trees on the JAX
  paths) and ``train()``; ``is_training()`` reads the mode.
* ``Echo`` prints on every call (the port runs eagerly); the JAX one prints
  once a trace.
"""

from __future__ import annotations

import functools
import itertools
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tensor.sparse import SparseTensor
from ..utils.engine import Engine
from ..utils.random import RandomGenerator
from ..utils.table import T, Table

_uid = itertools.count(1)
META = torch.device("meta")


def spec(shape, dtype: torch.dtype) -> torch.Tensor:
    """A spec: a meta tensor of ``shape`` and ``dtype``."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def to_spec(x):
    """The spec of ``x``: each tensor or array as a meta tensor of its shape
    and dtype (the counterpart of ``jax.ShapeDtypeStruct``), through
    ``Table`` s, lists and tuples; a ``SparseTensor``'s parts too."""
    if isinstance(x, Table):
        return T(*[to_spec(v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(to_spec(v) for v in x)
    if isinstance(x, SparseTensor):
        return x.to(META)
    if isinstance(x, np.ndarray):
        return torch.empty(x.shape, dtype=torch.from_numpy(np.zeros(0, x.dtype)).dtype,
                           device=META)
    if isinstance(x, torch.Tensor):
        return x if x.device == META else torch.empty(x.shape, dtype=x.dtype, device=META)
    return x


# --- constructor and build recording, for the model file (utils/module_serializer) ---
_build_depth = threading.local()


def _record_ctor(init):
    @functools.wraps(init)
    def wrapper(self, *args, **kwargs):
        if "_ctor_spec" not in self.__dict__:  # the most-derived class wins
            object.__setattr__(self, "_ctor_spec",
                               (args, {k: v for k, v in kwargs.items() if k != "device"}))
        init(self, *args, **kwargs)

    wrapper._ctor_recorded = True
    return wrapper


def _record_build(build):
    @functools.wraps(build)
    def wrapper(self, generator, sample):
        depth = getattr(_build_depth, "d", 0)
        if depth == 0:  # only the outermost build sees the model's input
            object.__setattr__(self, "_top_in_spec", to_spec(sample))
        _build_depth.d = depth + 1
        try:
            return build(self, generator, sample)
        finally:
            _build_depth.d = depth

    wrapper._build_recorded = True
    return wrapper


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

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        init = cls.__dict__.get("__init__")
        if init is not None and not getattr(init, "_ctor_recorded", False):
            cls.__init__ = _record_ctor(init)
        bld = cls.__dict__.get("build")
        if bld is not None and not getattr(bld, "_build_recorded", False):
            cls.build = _record_build(bld)

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

    def get_name(self) -> str:
        return self.name()

    def n_parameters(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def walk(self):
        """This module and, for a container, every descendant."""
        yield self

    # ----------------------------------------------------------- shape contract
    def infer_shape(self, in_spec):
        """Static contract: input spec -> output spec (meta tensors). It
        must not run the model or allocate a parameter, and raises
        ``ValueError`` naming the module and the shapes on a violation.
        ``NotImplemented`` (the default) means no contract:
        :func:`infer_module_shape` then runs the module on meta tensors."""
        return NotImplemented

    def _infer_shape_via_apply(self, in_spec):
        """The contract of a parameter-less layer: its own forward on the
        meta spec."""
        with torch.no_grad():
            return to_spec(self._apply_params({}, {}, in_spec, False, None)[0])

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

    def set_parameters(self, params: Dict[str, Any]) -> None:
        """Copy ``params`` (this module's tree: tensors or arrays on the JAX
        paths) into the registered parameters, in place; a key or shape that
        differs raises."""
        if not self._built:
            raise ValueError(f"{self.name()}: set_parameters needs a built module")
        with torch.no_grad():
            _copy_tree(self.get_parameters(), params, f"{self.name()} parameters",
                       lambda p, v: p.copy_(v))

    def set_grad_parameters(self, grads: Dict[str, Any]) -> None:
        """Set each parameter's ``.grad`` to ``grads`` at its path (a copy
        on the parameter's device and dtype)."""
        if not self._built:
            raise ValueError(f"{self.name()}: set_grad_parameters needs a built module")

        def put(p, v):
            p.grad = v.detach().clone()

        _copy_tree(self.get_parameters(), grads, f"{self.name()} gradients", put)

    def get_parameters_table(self) -> Dict[str, Dict[str, Any]]:
        """``{name: own parameter tree}`` for every module of the subtree
        that holds parameters of its own."""
        return {m.name(): m._param_tree for m in self.walk() if m._param_tree}

    def is_training(self) -> bool:
        return self.training

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

    def regularization_loss_tree(self, params):
        """The regularizer penalties of this subtree over ``params`` (its
        parameter tree): the layer's ``regularization_loss`` where it has
        one, else 0.0; a container sums its children's. ``LocalOptimizer``
        adds it to the training loss."""
        if hasattr(self, "regularization_loss"):
            return self.regularization_loss(params)
        return 0.0

    def auxiliary_loss_tree(self, state):
        """The sum of the input-dependent losses a training forward left in
        the state tree under ``"_aux_loss"`` keys (the MoE router's
        load-balancing term), else 0.0. ``LocalOptimizer`` adds it to the
        training loss, as it adds ``regularization_loss_tree``."""
        total = 0.0
        for v in _aux_losses(state):  # in the JAX package's order: depth first
            total = total + v
        return total

    def quantize(self, dtype: str = "int8") -> "AbstractModule":
        """This built tree with quantized inference layers (reference:
        ``AbstractModule.quantize``): ``dtype`` ``"int8"`` or ``"fp8"``
        (:func:`bigdl_tpu_torch.nn.quantized.quantize`)."""
        from .quantized import quantize

        return quantize(self, dtype=dtype)

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
            self.set_state(detach_tree(new_state))
        return y

    def update_output(self, x):
        """BigDL's name for ``forward``."""
        return self.forward(x)

    def _vjp(self, x, grad_output, params):
        """The gradients of the preceding forward's output against
        ``grad_output`` for ``params`` and then the input (``None`` for
        integer ids). The forward is recomputed with that forward's
        generator state and module state, so dropout draws the same masks."""
        x = self._as_input(x)
        self._ensure_built(x)
        rng = None
        if self._last_rng_state is not None:
            rng = torch.Generator()
            rng.set_state(self._last_rng_state)
        state = self._last_state if self._last_state is not None else self.get_state()
        xin = x.detach().requires_grad_(x.is_floating_point())
        with torch.enable_grad():
            y, _ = self._apply_params(self.get_parameters(), state, xin,
                                      self.training, rng)
            wrt = params + ([xin] if xin.requires_grad else [])
            grads = torch.autograd.grad(y, wrt, torch.as_tensor(grad_output, device=y.device),
                                        allow_unused=True)
        return grads[:len(params)], (grads[-1] if xin.requires_grad else None)

    def backward(self, x, grad_output):
        """Gradient of the input (``None`` for integer ids); accumulates the
        parameter gradients into ``.grad`` (BigDL semantics)."""
        params = list(self.parameters())
        gps, gx = self._vjp(x, grad_output, params)
        with torch.no_grad():
            for p, gp in zip(params, gps):
                if gp is not None:
                    p.grad = gp if p.grad is None else p.grad + gp
        return gx

    def update_grad_input(self, x, grad_output):
        """The gradient of the input alone; the parameters' ``.grad`` stay
        as they were (BigDL's ``updateGradInput``)."""
        return self._vjp(x, grad_output, [])[1]

    def acc_grad_parameters(self, x, grad_output) -> None:
        """Accumulate the parameter gradients into ``.grad`` (BigDL's
        ``accGradParameters``; in the JAX package also a full ``backward``)."""
        self.backward(x, grad_output)

    # ---------------------------------------------------------- forward hooks
    def register_forward_hook(self, hook) -> "ForwardHookHandle":
        """Wrap this module's pure forward: after every ``_apply_params``
        (the root ``forward``/``apply``, a container's call of its child, a
        graph node, ``LocalOptimizer``'s step) ``hook(module, x, y)`` runs,
        and a dict it returns is merged into the new state (the channel the
        JAX package's activation probes use). Shadows
        ``torch.nn.Module.register_forward_hook`` (module docstring).
        Returns a handle whose ``remove()`` restores the previous forward."""
        prev = self.__dict__.get("_apply_params")  # None: the class's forward
        inner = self._apply_params  # the current, possibly already hooked, forward

        def hooked(params, state, x, training, rng):
            y, new_state = inner(params, state, x, training, rng)
            extra = hook(self, x, y)
            if extra is not None:
                new_state = dict(new_state)
                new_state.update(extra)
            return y, new_state

        object.__setattr__(self, "_apply_params", hooked)
        return ForwardHookHandle(self, hooked, prev)

    # ------------------------------------------------------------------- misc
    def reset(self) -> None:
        """Drop the parameters and state of this subtree: the next forward
        re-samples them from the generator (lazily, as the JAX package's:
        building needs an input). The device the parameters were on is kept."""
        for m in self.modules():
            if isinstance(m, AbstractModule) and m._built:
                m._device = m.device
                for key in m._param_tree:
                    m._parameters.pop(key, None)
                    m._modules.pop(key, None)
                m._param_tree, m._state, m._last_state = {}, {}, None
                m._last_rng_state = None
                m._built = False

    def clone(self) -> "AbstractModule":
        """A deep copy: parameters, state and, for a ``Graph``, its nodes
        (each node's weak references to its children point into the copy)."""
        import copy

        return copy.deepcopy(self)

    # -------------------------------------------------------------- inference
    def evaluate(self, dataset=None, methods=None, batch_size: Optional[int] = None):
        """No arguments: switch to eval mode and return the module. With a
        dataset and validation methods: also run them over the dataset
        (``Evaluator(self, batch_size)``) and return ``{method name:
        result}``. The sweep's batches are the dataset's (``batch_size``
        sizes the predictor, as in the JAX package); under a process group
        each rank evaluates its rows and the counters are summed."""
        self.eval()
        if dataset is None:
            return self
        from ..optim.predictor import Evaluator

        return Evaluator(self, batch_size).evaluate(dataset, methods)

    def predict(self, data, batch_size: Optional[int] = None) -> torch.Tensor:
        """Batched eval-mode forward over a dataset, an array or a list of
        records; the stacked outputs on the host."""
        from ..optim.predictor import Predictor

        return Predictor(self, batch_size).predict(data)

    def predict_class(self, data, batch_size: Optional[int] = None) -> torch.Tensor:
        """1-based argmax class per record (the reference's ``predictClass``)."""
        from ..optim.predictor import Predictor

        return Predictor(self, batch_size).predict_class(data)

    # ------------------------------------------------------------ persistence
    def save_module(self, path: str, overwrite: bool = True) -> None:
        """Write the topology, the parameters and the state as one ``.npz``
        (the reference's ``Module.saveModule``), which ``nn.load_module``
        rebuilds in a fresh process. Falls back to the arrays alone when a
        constructor argument cannot be encoded; instance ``load_module``
        reads those into a rebuilt module."""
        from ..utils.module_serializer import save_module_def
        from ..utils.serialization import save_pytree

        if not overwrite and os.path.exists(path):
            raise FileExistsError(path)
        if not self.is_built():
            raise ValueError("save_module: module not built yet")
        try:
            save_module_def(path, self)
        except (TypeError, ValueError):
            save_pytree(path, {"params": self.get_parameters(), "state": self.get_state()})

    def load_module(self, path: str) -> "AbstractModule":
        """Copy the arrays that ``save_module`` wrote into this built module,
        in place (the reference's ``Module.loadModule``)."""
        from ..utils.serialization import copy_into, load_pytree

        if not self.is_built():
            raise ValueError("load_module: build the module first (init with a sample input)")
        flat = load_pytree(path)
        for what, tree in (("params", self.get_parameters()), ("state", self.get_state())):
            copy_into(tree, {k[len(what) + 1:]: v for k, v in flat.items()
                             if k.startswith(what + "/")}, what)
        return self

    # ----------------------------------------------------------------- graphs
    def inputs(self, *parents) -> "ModuleNode":
        """``layer.inputs(n1, n2)``: a graph node of this module fed by
        ``parents`` (see :mod:`bigdl_tpu_torch.nn.graph`)."""
        from .graph import ModuleNode

        return ModuleNode(self, parents)


AbstractModule.build = _record_build(AbstractModule.build)


class ForwardHookHandle:
    """Undo token of :meth:`AbstractModule.register_forward_hook`: ``remove()``
    restores the forward from before the hook (the class's, or an earlier
    hook's). Removal is LIFO: a handle whose hook another hook has wrapped
    since does nothing."""

    __slots__ = ("_module", "_wrapped", "_prev")

    def __init__(self, module, wrapped, prev):
        self._module, self._wrapped, self._prev = module, wrapped, prev

    def remove(self) -> None:
        m = self._module
        if m.__dict__.get("_apply_params") is not self._wrapped:
            return  # a later hook wrapped this one, or it is removed already
        if self._prev is None:
            del m.__dict__["_apply_params"]
        else:
            object.__setattr__(m, "_apply_params", self._prev)


def _copy_tree(dst, src, what, put) -> None:
    """``put(dst_leaf, src_leaf as a tensor on dst_leaf's device and dtype)``
    at every path of ``dst``; ``src`` must have the same paths and shapes."""
    if not isinstance(src, dict) or set(src) != set(dst):
        raise KeyError(f"{what}: paths differ: expected {sorted(dst)}, got "
                       f"{sorted(src) if isinstance(src, dict) else type(src).__name__}")
    for k, d in dst.items():
        if isinstance(d, dict):
            _copy_tree(d, src[k], what, put)
            continue
        v = torch.as_tensor(np.asarray(src[k]) if not isinstance(src[k], torch.Tensor)
                            else src[k]).to(device=d.device, dtype=d.dtype)
        if tuple(v.shape) != tuple(d.shape):
            raise ValueError(f"{what}: {k} has shape {tuple(v.shape)}, expected "
                             f"{tuple(d.shape)}")
        put(d, v)


def _meta_like(t):
    return torch.empty(t.shape, dtype=t.dtype, device=META)


def import_torch_dynamo() -> None:
    """Import ``torch._dynamo`` once, on a thread of its own. torch imports
    it lazily at the first call of a function it wraps with
    ``_disable_dynamo`` (the meta kernels of ops such as ``torch.maximum``,
    ``torch.utils.checkpoint``). That import runs ``torch.fx.wrap``, whose
    frame refers to itself (``inspect.currentframe()`` in a local), so it
    and, through ``f_back``, every frame below it wait for the cyclic
    collector: imported inside a model's forward or ShapeProp, those frames
    hold the model. A new thread's stack holds nothing of the caller's.
    Called before the port's first meta dispatch and checkpoint."""
    import sys

    if "torch._dynamo" not in sys.modules:
        import importlib

        t = threading.Thread(target=importlib.import_module, args=("torch._dynamo",),
                             name="bigdl-import-dynamo")
        t.start()
        t.join()


def infer_module_shape(module: AbstractModule, in_spec):
    """The output spec of ``module`` for ``in_spec`` without running the
    model on data or allocating a parameter. In order: the module's own
    ``infer_shape`` contract; for a built module, its forward over meta
    copies of its parameters and state; for an unbuilt one, a build on
    meta tensors with a throwaway generator, after which every module of
    the subtree is restored exactly as it was (attributes, registered
    parameters and children). None of the three touches the card or
    launches a kernel: the kernels' entry points take their plain versions
    on meta tensors."""
    import_torch_dynamo()
    out = module.infer_shape(in_spec)
    if out is not NotImplemented:
        return out
    with torch.no_grad():
        if module.is_built():
            return to_spec(module._apply_params(_map_tree(_meta_like, module.get_parameters()),
                                                _map_tree(_meta_like, module.get_state()),
                                                in_spec, False, None)[0])
        saved = {}
        for m in module.modules():
            d = dict(m.__dict__)
            for key in ("_parameters", "_buffers", "_modules", "_layers"):
                if key in d:
                    d[key] = type(d[key])(d[key])
            saved[id(m)] = (m, d)
        try:
            for m, _ in saved.values():
                if isinstance(m, AbstractModule):
                    m._device = META
            module.build(torch.Generator(), in_spec)
            return to_spec(module._apply_params(module.get_parameters(), module.get_state(),
                                                in_spec, False, None)[0])
        finally:
            for m, d in saved.values():
                m.__dict__.clear()
                m.__dict__.update(d)


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

    def walk(self):
        yield self
        for m in self._layers:
            yield from m.walk()

    def get_state(self) -> Dict[str, Any]:
        return {m.name(): m.get_state() for m in self._layers}

    def set_state(self, state: Dict[str, Any]) -> None:
        for m in self._layers:
            m.set_state(state[m.name()])

    def get_grad_parameters(self) -> Dict[str, Any]:
        return {m.name(): m.get_grad_parameters() for m in self._layers}

    def regularization_loss_tree(self, params):
        total = 0.0
        for m in self._layers:
            total = total + m.regularization_loss_tree(params[m.name()])
        return total

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

    def infer_shape(self, in_spec):
        out = in_spec
        for m in self._layers:
            out = infer_module_shape(m, out)
        return out

    def _apply_params(self, params, state, x, training, rng):
        new_state: Dict[str, Any] = {}
        for m in self._layers:
            x, new_state[m.name()] = m._apply_params(params[m.name()], state[m.name()], x,
                                                     training, rng)
        return x, new_state


class Identity(AbstractModule):
    """Pass-through."""

    def infer_shape(self, in_spec):
        return in_spec

    def _apply_params(self, params, state, x, training, rng):
        return x, state


class Echo(AbstractModule):
    """Pass-through that prints its name and the input's shapes (reference:
    ``$DL/nn/Echo.scala``) on every call: the port runs eagerly, where the
    JAX package prints once a trace."""

    def infer_shape(self, in_spec):
        return in_spec

    def _apply_params(self, params, state, x, training, rng):
        shapes = (tuple(x.shape) if isinstance(x, torch.Tensor)
                  else [tuple(v.shape) for v in _leaves(x)])
        print(f"[{self.name()}] {shapes}")
        return x, state


def _leaves(x):
    if isinstance(x, (Table, list, tuple)):
        return [v for e in x for v in _leaves(e)]
    return [x]


def _aux_losses(state):
    """The ``"_aux_loss"`` leaves of a state tree, depth first."""
    if isinstance(state, dict):
        for k, v in state.items():
            if k == "_aux_loss":
                yield v
            else:
                yield from _aux_losses(v)


def detach_tree(tree):
    """``tree`` with every tensor detached: a state kept across steps must
    not hold a step's graph (the MoE's ``"_aux_loss"`` carries one)."""
    if isinstance(tree, dict):
        return {k: detach_tree(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


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
