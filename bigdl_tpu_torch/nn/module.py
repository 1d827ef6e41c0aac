"""``AbstractModule`` — the port's counterpart of ``bigdl_tpu/nn/module.py``.

A ``torch.nn.Module`` with the JAX package's serving surface:

* ``_build(generator, sample) -> (params, state)`` allocates the module's
  parameter dict (nested dicts of tensors, the same paths as the JAX
  pytree); ``build``/``init``/``_ensure_built`` register them as
  ``nn.Parameter`` s, so ``named_parameters()`` reads ``block0.self_q_w``
  exactly where the JAX tree has ``params["block0"]["self_q_w"]``.
* ``_apply(params, state, x, training, rng) -> (y, new_state)`` is the pure
  forward over explicit dicts; ``apply`` exposes it and ``forward`` runs it
  on the module's own parameters.

``rng`` is a ``torch.Generator`` (or ``None``); train/eval mode is torch's
own ``train()``/``eval()``. Parameters live on the module's ``device``,
which is the card unless the caller asks for ``device="cpu"``.
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
        self.device = Engine.device(device)

    # ------------------------------------------------------------------ names
    def name(self) -> str:
        return f"{type(self).__name__}{self._uid}"

    # --------------------------------------------------------------- building
    def _build(self, generator: torch.Generator, sample) -> Tuple[Dict, Dict]:
        return {}, {}

    def _apply(self, params, state, x, training: bool, rng):  # pragma: no cover
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
        return self._apply(params, state, x, training, rng)

    def get_parameters(self) -> Dict[str, Any]:
        return self._param_tree

    def get_state(self) -> Dict[str, Any]:
        return self._state

    # --------------------------------------------------------------- stateful
    def forward(self, x):
        """Forward on the module's own parameters (dropout only in train mode)."""
        x = self._as_input(x)
        self._ensure_built(x)
        rng = RandomGenerator.generator() if self.training else None
        y, new_state = self._apply(self.get_parameters(), self._state, x,
                                   self.training, rng)
        if self.training:
            self._state = new_state
        return y


def _to_device(tree: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return {k: (_to_device(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}
