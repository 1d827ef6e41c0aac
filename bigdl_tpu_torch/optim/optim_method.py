"""Optimization methods (counterpart of ``bigdl_tpu/optim/optim_method.py``:
``SGD`` and ``Adam`` so far).

``init_slots(params)`` builds the slot trees and ``update(grads, params,
slots, lr, step)`` applies one step, over nested dicts of tensors on the
JAX package's parameter paths. Unlike the JAX package's pure update, the
port updates ``params`` and ``slots`` IN PLACE under ``torch.no_grad()``
(no second copy of the weights and slots in device memory) and returns the
same objects. The host-side state table (``epoch``, ``neval``) and the
learning-rate schedule live on the method, as in the reference.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from .schedules import Default, LearningRateSchedule


def _leaves(tree: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs with the path in ``jax.tree_util.keystr`` form,
    e.g. ``['block0']['self_q_w']``."""
    for key, val in tree.items():
        path = f"{prefix}[{key!r}]"
        if isinstance(val, dict):
            yield from _leaves(val, path)
        else:
            yield path, val


def _zeros_like(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (_zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v))
            for k, v in tree.items()}


def _wd_excluded(path: str, patterns) -> bool:
    """Weight-decay exclusion: substring match against the keystr path."""
    return any(pat in path for pat in patterns)


class OptimMethod:
    """Base optimizer; ``state`` is the host-side state table."""

    def __init__(self):
        self.state: Dict[str, Any] = {"epoch": 1, "neval": 1}
        self.learningrate: float = 1e-3
        self.learningrate_decay: float = 0.0
        self.schedule: Optional[LearningRateSchedule] = None

    def get_learning_rate(self) -> float:
        sched = self.schedule if self.schedule is not None else Default()
        return float(sched.update(self, self.state))

    def update_state(self, **kv) -> None:
        self.state.update(kv)

    def init_slots(self, params) -> Dict[str, Any]:
        return {}

    def update(self, grads, params, slots, lr: float, step: int):
        """One step in place; returns ``(params, slots)``."""
        raise NotImplementedError


class SGD(OptimMethod):
    """SGD with momentum, dampening (default: ``momentum``, Torch7's
    semantics: ``v = m·v + (1-m)·g``), nesterov, weight decay and the
    learning-rate decay of the ``Default`` schedule.

    ``weightdecay_exclude``: substrings matched against each parameter's
    keystr path (``['block0']['filter_b']``) that skip weight decay.
    """

    def __init__(self, learningrate: float = 1e-3, learningrate_decay: float = 0.0,
                 weightdecay: float = 0.0, momentum: float = 0.0,
                 dampening: Optional[float] = None, nesterov: bool = False,
                 leaningrate_schedule: Optional[LearningRateSchedule] = None,
                 weightdecay_exclude: Optional[Sequence[str]] = None):
        super().__init__()
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.weightdecay = weightdecay
        self.momentum = momentum
        self.dampening = dampening if dampening is not None else momentum
        self.nesterov = nesterov
        # (sic) "leaningrate" matches the reference's public param name
        self.schedule = leaningrate_schedule
        self.weightdecay_exclude = tuple(weightdecay_exclude) if weightdecay_exclude else ()
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError("nesterov requires momentum > 0 and dampening = 0")

    def init_slots(self, params):
        return {"velocity": _zeros_like(params)} if self.momentum > 0 else {}

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        wd, mom, damp = self.weightdecay, self.momentum, self.dampening
        vel = dict(_leaves(slots["velocity"])) if mom > 0 else {}
        for (path, p), (_, g) in zip(_leaves(params), _leaves(grads)):
            if wd > 0 and not _wd_excluded(path, self.weightdecay_exclude):
                g = g + wd * p
            if mom > 0:
                v = vel[path]
                v.mul_(mom).add_(g, alpha=1 - damp)
                g = g + mom * v if self.nesterov else v
            p.sub_(lr * g)
        return params, slots


class Adam(OptimMethod):
    """Adam with bias correction (reference: ``Adam.scala``)."""

    def __init__(self, learningrate: float = 1e-3, learningrate_decay: float = 0.0,
                 beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-8):
        super().__init__()
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_slots(self, params):
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        t = float(step)
        bias1, bias2 = 1 - b1 ** t, 1 - b2 ** t
        for (_, p), (_, g), (_, m), (_, v) in zip(_leaves(params), _leaves(grads),
                                                  _leaves(slots["m"]), _leaves(slots["v"])):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(lr * (m / bias1) / (torch.sqrt(v / bias2) + eps))
        return params, slots
