"""Optimization methods (counterpart of ``bigdl_tpu/optim/optim_method.py``;
reference: one file each under ``$DL/optim``): ``SGD``, ``Adam`` (and its
alias ``ParallelAdam``), ``Adagrad``, ``Adadelta``, ``Adamax``,
``RMSprop``, ``Ftrl``, ``Lamb`` and ``LarsSGD``; ``LBFGS`` is in
:mod:`.lbfgs`.

``init_slots(params)`` builds the slot trees and ``update(grads, params,
slots, lr, step)`` applies one step, over nested dicts of tensors on the
JAX package's parameter paths. Unlike the JAX package's pure update, the
port updates ``params`` and ``slots`` IN PLACE under ``torch.no_grad()``
(no second copy of the weights and slots in device memory) and returns the
same objects. ``lr`` and ``step`` (``neval``) are Python numbers; every
bias correction (``Adam``, ``Adamax``, ``Lamb``) is ``1 - beta**step`` in
Python floats, rounded once to the tensors' dtype where it meets them (the
JAX package takes ``beta**step`` in float32: the two differ by one float32
rounding of that factor). The host-side state table (``epoch``, ``neval``)
and the learning-rate schedule live on the method, as in the reference.
``elementwise`` is the JAX package's flag: False for the methods that take
per-leaf norms (``Lamb``, ``LarsSGD``; each norm summed in float64 and
rounded once to the leaf's dtype, on every device), which have no
flat-vector update. ``update_flat`` is the flat layout's update (the ZeRO-1
``DistriOptimizer``, ``flat_update=True``): the method's own rule over one
vector (a one-leaf tree), in place, with per-element weight-decay
coefficients and rate scales.
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
    return _map(torch.zeros_like, tree)


def _map(fn, tree: Dict[str, Any], *rest: Dict[str, Any]) -> Dict[str, Any]:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    return {k: (_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def _norm(x: torch.Tensor) -> torch.Tensor:
    """A leaf's L2 norm as a 0-d tensor of its dtype, summed in float64: the
    CPU's float32 ``vector_norm`` accumulates an error that grows with the
    leaf's size and the card's sums in another order, so both take one
    accurate sum and round it once, and agree."""
    return torch.linalg.vector_norm(x, dtype=torch.float64).to(x.dtype)


def _wd_excluded(path: str, patterns) -> bool:
    """Weight-decay exclusion: substring match against the keystr path."""
    return any(pat in path for pat in patterns)


class OptimMethod:
    """Base optimizer; ``state`` is the host-side state table."""

    elementwise = True
    # True while update_flat applies the decay itself (wd_coeff): the
    # methods with a built-in decay term skip theirs
    external_weight_decay = False

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

    def init_flat_slots(self, vec: torch.Tensor) -> Dict[str, Any]:
        """The slots of a flat parameter vector: one vector like ``vec`` a
        slot (scalar slot state as it is)."""
        return {k: v["flat"] if isinstance(v, dict) else v
                for k, v in self.init_slots({"flat": vec}).items()}

    def update_flat(self, gvec, pvec, slot_vecs, lr, step, *, wd_coeff=None, lr_scale=None):
        """One step over a flat float32 vector, in place (the JAX package's
        ``update_flat``): ``wd_coeff`` is the per-element weight-decay
        coefficient (0 on excluded segments and the padding tail), applied
        here as ``g + wd_coeff * p`` with the method's own decay off for the
        call; ``lr_scale`` a per-element rate multiplier. A method with
        ``weightdecay_exclude`` needs ``wd_coeff`` (the flat layout has no
        paths); ``elementwise=False`` methods refuse. Returns ``(pvec,
        slot_vecs)``."""
        if not self.elementwise:
            raise NotImplementedError(
                f"{type(self).__name__} is layer-structure-aware "
                "(elementwise=False) and has no flat-vector update")
        if (wd_coeff is None and float(getattr(self, "weightdecay", 0.0) or 0.0) > 0
                and getattr(self, "weightdecay_exclude", ())):
            raise ValueError(
                f"{type(self).__name__} has weightdecay_exclude patterns; the flat layout "
                "carries no parameter paths, so the caller must precompute the exclusions "
                "into a wd_coeff vector (FlatParameter.coefficient_vector)")
        if lr_scale is not None:
            lr = lr * lr_scale
        if wd_coeff is not None:
            gvec = gvec + wd_coeff * pvec
        slots = {k: {"flat": v} if isinstance(v, torch.Tensor) and v.shape == pvec.shape else v
                 for k, v in slot_vecs.items()}
        prev = self.external_weight_decay
        self.external_weight_decay = wd_coeff is not None
        try:
            self.update({"flat": gvec}, {"flat": pvec}, slots, lr, step)
        finally:
            self.external_weight_decay = prev
        return pvec, slot_vecs

    def optimize(self, feval, params):
        """One eager step, the reference's ``optimize(feval, x)``:
        ``feval(params) -> (loss, grads)``, then :meth:`update` in place at
        the schedule's rate and ``neval``; returns ``(params, loss)``. The
        slots are made at the first call and kept on the method."""
        loss, grads = feval(params)
        if not hasattr(self, "_slots"):
            self._slots = self.init_slots(params)
        params, self._slots = self.update(grads, params, self._slots, self.get_learning_rate(),
                                          self.state["neval"])
        self.state["neval"] += 1
        return params, loss


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
        own_wd = wd > 0 and not self.external_weight_decay
        for (path, p), (_, g) in zip(_leaves(params), _leaves(grads)):
            if own_wd and not _wd_excluded(path, self.weightdecay_exclude):
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


class ParallelAdam(Adam):
    """The reference's ``ParallelAdam`` runs Adam's update on slices of the
    flat parameter vector in parallel threads; the arithmetic is Adam's, and
    so is this alias's (the JAX package's reason: the parallelism belongs to
    the runtime)."""


class Adagrad(OptimMethod):
    """``accum += g²``; ``p -= lr·g / (√accum + 1e-10)``, weight decay added
    to the gradient first (reference: ``Adagrad.scala``)."""

    def __init__(self, learningrate: float = 1e-3, learningrate_decay: float = 0.0,
                 weightdecay: float = 0.0):
        super().__init__()
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.weightdecay = weightdecay

    def init_slots(self, params):
        return {"accum": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        wd = self.weightdecay
        for (_, p), (_, g), (_, a) in zip(_leaves(params), _leaves(grads),
                                          _leaves(slots["accum"])):
            if wd > 0 and not self.external_weight_decay:
                g = g + wd * p
            a.addcmul_(g, g)
            p.sub_(lr * g / (torch.sqrt(a) + 1e-10))
        return params, slots


class Adadelta(OptimMethod):
    """``decayrate`` is rho (reference: ``Adadelta.scala``). The method is
    rate-free: ``learningrate`` is fixed at 1.0 and the ratio of the two
    accumulators sets the step."""

    def __init__(self, decayrate: float = 0.9, epsilon: float = 1e-10):
        super().__init__()
        self.learningrate = 1.0
        self.rho, self.epsilon = decayrate, epsilon

    def init_slots(self, params):
        return {"accum": _zeros_like(params), "delta_accum": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        rho, eps = self.rho, self.epsilon
        for (_, p), (_, g), (_, a), (_, d) in zip(_leaves(params), _leaves(grads),
                                                  _leaves(slots["accum"]),
                                                  _leaves(slots["delta_accum"])):
            a.mul_(rho).addcmul_(g, g, value=1 - rho)
            delta = g * torch.sqrt(d + eps) / torch.sqrt(a + eps)
            d.mul_(rho).addcmul_(delta, delta, value=1 - rho)
            p.sub_(lr * delta)
        return params, slots


class Adamax(OptimMethod):
    """Adam under the infinity norm: ``u = max(beta2·u, |g| + epsilon)``,
    ``p -= lr / (1 - beta1^t) · m / u``. The default ``epsilon`` 1e-38 is a
    float32 subnormal; it keeps ``u`` above 0 where a leaf's gradient is
    all zero, so ``m / u`` is 0 there (the card's elementwise kernels keep
    subnormals: no flush to zero)."""

    def __init__(self, learningrate: float = 2e-3, beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-38):
        super().__init__()
        self.learningrate = learningrate
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_slots(self, params):
        return {"m": _zeros_like(params), "u": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        b1, b2 = self.beta1, self.beta2
        scale = lr / (1 - b1 ** float(step))
        for (_, p), (_, g), (_, m), (_, u) in zip(_leaves(params), _leaves(grads),
                                                  _leaves(slots["m"]), _leaves(slots["u"])):
            m.mul_(b1).add_(g, alpha=1 - b1)
            torch.maximum(u.mul_(b2), torch.abs(g) + self.epsilon, out=u)
            p.sub_(scale * m / u)
        return params, slots


class RMSprop(OptimMethod):
    """``accum = rho·accum + (1-rho)·g²``; ``p -= lr·g / (√accum + epsilon)``."""

    def __init__(self, learningrate: float = 1e-2, learningrate_decay: float = 0.0,
                 decayrate: float = 0.99, epsilon: float = 1e-8):
        super().__init__()
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.rho, self.epsilon = decayrate, epsilon

    def init_slots(self, params):
        return {"accum": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        rho = self.rho
        for (_, p), (_, g), (_, a) in zip(_leaves(params), _leaves(grads),
                                          _leaves(slots["accum"])):
            a.mul_(rho).addcmul_(g, g, value=1 - rho)
            p.sub_(lr * g / (torch.sqrt(a) + self.epsilon))
        return params, slots


class Ftrl(OptimMethod):
    """FTRL-proximal (reference: ``Ftrl.scala``), Wide&Deep's optimizer for
    its sparse wide part. Slots ``accum`` (starting at
    ``initial_accumulator_value``, 0.1 by default, not 0) and ``linear``; the
    new weight is the closed-form proximal step, 0 where
    ``|linear| <= l1``."""

    def __init__(self, learningrate: float = 1e-3, learningrate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1, l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0):
        super().__init__()
        self.learningrate = learningrate
        self.lr_power = learningrate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength

    def init_slots(self, params):
        return {"accum": _map(lambda p: torch.full_like(p, self.init_accum), params),
                "linear": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        lp = self.lr_power
        for (_, p), (_, g), (_, a), (_, lin) in zip(_leaves(params), _leaves(grads),
                                                    _leaves(slots["accum"]),
                                                    _leaves(slots["linear"])):
            new_a = a + g * g
            sigma = (new_a ** -lp - a ** -lp) / lr
            lin.add_(g - sigma * p)
            quad = new_a ** -lp / lr + 2 * self.l2
            pre = torch.clamp(lin, -self.l1, self.l1) - lin
            p.copy_(torch.where(torch.abs(lin) > self.l1, pre / quad, torch.zeros_like(p)))
            a.copy_(new_a)
        return params, slots


class Lamb(OptimMethod):
    """LAMB (You et al. 2020): Adam's direction plus decoupled weight decay,
    ``u = m̂ / (√v̂ + epsilon) + wd·p``, each leaf's step scaled by the trust
    ratio ``||p|| / ||u||`` (1 where either norm is 0).
    ``weightdecay_exclude`` is ``SGD``'s keystr-path substring match."""

    elementwise = False

    def __init__(self, learningrate: float = 1e-3, learningrate_decay: float = 0.0,
                 beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-6,
                 weightdecay: float = 0.0, weightdecay_exclude: Optional[Sequence[str]] = None):
        super().__init__()
        self.learningrate = learningrate
        self.learningrate_decay = learningrate_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.weightdecay = weightdecay
        self.weightdecay_exclude = tuple(weightdecay_exclude) if weightdecay_exclude else ()

    def init_slots(self, params):
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        b1, b2, eps, wd = self.beta1, self.beta2, self.epsilon, self.weightdecay
        t = float(step)
        bias1, bias2 = 1 - b1 ** t, 1 - b2 ** t
        for (path, p), (_, g), (_, m), (_, v) in zip(_leaves(params), _leaves(grads),
                                                     _leaves(slots["m"]), _leaves(slots["v"])):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (m / bias1) / (torch.sqrt(v / bias2) + eps)
            if wd > 0 and not _wd_excluded(path, self.weightdecay_exclude):
                u = u + wd * p
            pn, un = _norm(p), _norm(u)
            ratio = torch.where((pn > 0) & (un > 0), pn / un, torch.ones_like(pn))
            p.sub_(lr * ratio * u)
        return params, slots


class LarsSGD(SGD):
    """Layer-wise adaptive rate scaling (reference: ``LarsSGD.scala``): each
    leaf's gradient times ``trust·||p|| / (||g|| + wd·||p|| + 1e-12)`` (1
    where either norm is 0), then ``SGD``'s update, whose weight decay comes
    after that scaling. ``**kw`` are ``SGD``'s."""

    elementwise = False

    def __init__(self, trust: float = 1.0, **kw):
        super().__init__(**kw)
        self.trust = trust

    @torch.no_grad()
    def update(self, grads, params, slots, lr, step):
        def scale(p, g):
            pn, gn = _norm(p), _norm(g)
            ratio = self.trust * pn / (gn + self.weightdecay * pn + 1e-12)
            return g * torch.where((pn > 0) & (gn > 0), ratio, torch.ones_like(ratio))

        return super().update(_map(scale, params, grads), params, slots, lr, step)
