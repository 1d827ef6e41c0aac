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
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.engine import Engine
from ..utils.random import RandomGenerator

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
        return f"{type(self).__name__}{self._uid}"

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

    def _as_input(self, x) -> torch.Tensor:
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
        self._last_state = self._state
        y, new_state = self._apply_params(self.get_parameters(), self._state, x,
                                          self.training, rng)
        if self.training:
            self._state = new_state
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
        state = self._last_state if self._last_state is not None else self._state
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
