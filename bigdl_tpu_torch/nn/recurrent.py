"""Recurrent layers (counterpart of ``Cell``, ``LSTM``, ``Recurrent``,
``BiRecurrent`` and ``TimeDistributed`` in ``bigdl_tpu/nn/recurrent.py``;
reference: ``$DL/nn/Recurrent.scala``, ``Cell.scala``, ``LSTM.scala``,
``BiRecurrent.scala``, ``TimeDistributed.scala``): batch-first (N, T, D) input, one cell's step driven
over T with its weights shared by every step.

The JAX package compiles one step under ``lax.scan``; here the time loop is
a Python loop over T whose steps autograd records, so the host's share of a
step grows with T. ``Cell.project`` takes the input's part of every step at
once: ``LSTM``'s ``x @ i2g.T`` is one product of N·T rows instead of T
products of N rows. Each of its elements is the same fp32 sum of D products,
rounded once to the policy's dtype, as the JAX package's per-step product.

Dtypes follow the JAX package step for step: the carry starts as fp32
zeros; under a reduced-precision policy each product has compute-dtype
operands and an ``out_dtype()`` result, and adding the fp32 ``bias``
promotes the gates, so c, h and the per-step outputs are fp32.

``TimeDistributed`` folds time into the batch dim: one module call over
N·T rows.

``LSTMPeephole``, ``GRU``, ``RnnCell``, ``ConvLSTMPeephole`` and
``RecurrentDecoder`` wait for a later slice.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from ..utils import precision
from .initialization import InitializationMethod, RandomUniform
from .module import AbstractModule, Container


class Cell(AbstractModule):
    """Recurrent cell base. ``project(params, x)`` computes the input's part
    of every step at once (identity by default); ``step(params, carry, u_t)
    -> (new_carry, y_t)`` runs one step from the projected input ``u_t``;
    ``init_carry(batch, device)`` is the zero state. A bare cell applied
    outside ``Recurrent`` runs ONE step from the zero carry."""

    hidden_size: int

    def init_carry(self, batch_size: int, device):
        raise NotImplementedError

    def project(self, params, x: torch.Tensor):
        return x

    def step(self, params, carry, u_t):
        raise NotImplementedError

    def _apply_params(self, params, state, x, training, rng):
        _, y = self.step(params, self.init_carry(x.shape[0], x.device), self.project(params, x))
        return y, state


class LSTM(Cell):
    """Standard LSTM cell (reference: $DL/nn/LSTM.scala). Gates i, f, g (the
    candidate), o, packed into ``i2g`` (4H, D), ``h2g`` (4H, H) and one
    ``bias`` (4H), each drawn ``RandomUniform`` (U(±1/sqrt(fan_in)): fan_in
    D for ``i2g`` and ``bias``, H for ``h2g``). ``w_regularizer`` penalises
    ``i2g``, ``u_regularizer`` ``h2g`` and ``b_regularizer`` ``bias``."""

    def __init__(self, input_size: Optional[int], hidden_size: int, w_regularizer=None,
                 u_regularizer=None, b_regularizer=None, device=None):
        super().__init__(device)
        self.w_regularizer = w_regularizer
        self.u_regularizer = u_regularizer
        self.b_regularizer = b_regularizer
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.weight_init: InitializationMethod = RandomUniform()

    def init_carry(self, batch_size: int, device):
        h = torch.zeros((batch_size, self.hidden_size), device=device)
        return h, torch.zeros_like(h)

    def _build(self, generator, sample):
        d = sample.shape[-1]
        if self.input_size is not None and self.input_size != d:
            raise ValueError(f"{self.name()}: declared input_size {self.input_size}, got {d}")
        self.input_size = d
        hsz = self.hidden_size
        return {"i2g": self.weight_init(generator, (4 * hsz, d), d, hsz),
                "h2g": self.weight_init(generator, (4 * hsz, hsz), hsz, hsz),
                "bias": self.weight_init(generator, (4 * hsz,), d, hsz)}, {}

    def project(self, params, x):
        return precision.einsum("...d,gd->...g", x, params["i2g"])

    def step(self, params, carry, u_t):
        h, c = carry
        gates = u_t + precision.einsum("nh,gh->ng", h, params["h2g"]) + params["bias"]
        i, f, g, o = gates.chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_h, new_c), new_h

    def regularization_loss(self, params):
        loss = 0.0
        for reg, key in ((self.w_regularizer, "i2g"), (self.u_regularizer, "h2g"),
                         (self.b_regularizer, "bias")):
            if reg is not None:
                loss = loss + reg(params[key])
        return loss


class Recurrent(Container):
    """Time loop over exactly one ``Cell`` (reference: Recurrent): (N, T, D)
    -> (N, T, H). ``add(cell)`` mirrors ``Recurrent().add(LSTM(...))``."""

    def __init__(self, cell: Optional[Cell] = None, device=None):
        super().__init__(*([cell] if cell is not None else []), device=device)

    def add(self, cell: Cell) -> "Recurrent":
        if len(self._layers) >= 1:
            raise ValueError("Recurrent holds exactly one Cell")
        if not isinstance(cell, Cell):
            raise TypeError(f"Recurrent needs a Cell, got {type(cell).__name__}")
        return super().add(cell)

    @property
    def cell(self) -> Cell:
        return self._layers[0]

    def build(self, generator: torch.Generator, sample) -> None:
        """Build the cell from one step of ``sample`` (the time axis dropped)."""
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        if not self.cell.is_built():
            self.cell.build(generator, sample[:, 0])
        self._built = True

    def _apply_params(self, params, state, x, training, rng):
        cell = self.cell
        p = params[cell.name()]
        u = cell.project(p, x)
        carry = cell.init_carry(x.shape[0], x.device)
        ys = []
        for t in range(x.shape[1]):
            carry, y = cell.step(p, carry, u[:, t])
            ys.append(y)
        return torch.stack(ys, dim=1), {cell.name(): state[cell.name()]}


class BiRecurrent(Container):
    """A forward and a time-reversed ``Recurrent`` with merged outputs
    (reference: BiRecurrent). Without ``cell_bwd`` the reverse direction gets
    a deep copy of ``cell_fwd`` whose name is cleared, so that its
    ``Recurrent`` names it ``<Type>_0`` as the JAX package does.
    ``merge_mode``: ``"add"`` (the reference's CAddTable) or ``"concat"``
    (on the feature dim)."""

    def __init__(self, cell_fwd: Cell, cell_bwd: Optional[Cell] = None,
                 merge_mode: str = "add", device=None):
        if cell_bwd is None:
            cell_bwd = copy.deepcopy(cell_fwd)
            cell_bwd._name = None
        if merge_mode not in ("add", "concat"):
            raise ValueError(f"unknown merge_mode {merge_mode!r}")
        super().__init__(Recurrent(cell_fwd, device=device), Recurrent(cell_bwd, device=device),
                         device=device)
        self.merge_mode = merge_mode

    def build(self, generator: torch.Generator, sample) -> None:
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        for m in self._layers:
            if not m.is_built():
                m.build(generator, sample)
        self._built = True

    def _apply_params(self, params, state, x, training, rng):
        fwd_m, bwd_m = self._layers
        fwd, fwd_s = fwd_m._apply_params(params[fwd_m.name()], state[fwd_m.name()], x,
                                         training, rng)
        bwd, bwd_s = bwd_m._apply_params(params[bwd_m.name()], state[bwd_m.name()],
                                         torch.flip(x, (1,)), training, rng)
        bwd = torch.flip(bwd, (1,))
        y = torch.cat([fwd, bwd], dim=-1) if self.merge_mode == "concat" else fwd + bwd
        return y, {fwd_m.name(): fwd_s, bwd_m.name(): bwd_s}


class TimeDistributed(Container):
    """One module applied at every time step of (N, T, ...) input
    (reference: TimeDistributed), as one call over the (N·T, ...) rows
    with time folded into the batch dim; (N, T, ...) out. Its parameter
    tree nests the module's under the module's name, as in the JAX
    package."""

    def __init__(self, module: AbstractModule, device=None):
        super().__init__(module, device=device)

    def build(self, generator: torch.Generator, sample) -> None:
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        inner = self._layers[0]
        if not inner.is_built():
            inner.build(generator, sample.reshape((-1,) + tuple(sample.shape[2:])))
        self._built = True

    def _apply_params(self, params, state, x, training, rng):
        inner = self._layers[0]
        n, t = x.shape[0], x.shape[1]
        y, inner_state = inner._apply_params(params[inner.name()], state[inner.name()],
                                             x.reshape((n * t,) + tuple(x.shape[2:])),
                                             training, rng)
        return y.reshape((n, t) + tuple(y.shape[1:])), {inner.name(): inner_state}
