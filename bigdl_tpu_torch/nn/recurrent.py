"""Recurrent layers (counterpart of ``bigdl_tpu/nn/recurrent.py``;
reference: ``$DL/nn/Recurrent.scala``, ``Cell.scala``, ``RnnCell.scala``,
``LSTM.scala``, ``LSTMPeephole.scala``, ``GRU.scala``,
``ConvLSTMPeephole.scala``, ``BiRecurrent.scala``, ``TimeDistributed.scala``,
``RecurrentDecoder.scala``): batch-first (N, T, D) input ((N, T, C, H, W)
for ``ConvLSTMPeephole``), one cell's step driven over T with its weights
shared by every step.

The JAX package compiles one step under ``lax.scan``; here the time loop is
a Python loop over T whose steps autograd records, so the host's share of a
step grows with T. ``Cell.project`` takes the input's part of every step at
once: ``LSTM``'s ``x @ i2g.T`` is one product of N·T rows instead of T
products of N rows (``GRU``'s two input products are one product against
``i2rz`` and ``i2n`` stacked; ``ConvLSTMPeephole``'s input convolution one
call over the N·T frames). Each of its elements is the same fp32 sum of D
products, rounded once to the policy's dtype, as the JAX package's per-step
product. ``RecurrentDecoder`` feeds each step's output back as the next
input, so it projects one step at a time.

Dtypes follow the JAX package step for step: the carry starts as fp32
zeros; under a reduced-precision policy each product has compute-dtype
operands and an ``out_dtype()`` result, and adding the fp32 ``bias``
promotes the gates, so c, h and the per-step outputs are fp32.

``TimeDistributed`` folds time into the batch dim: one module call over
N·T rows.
"""

from __future__ import annotations

import copy
from typing import Optional, Tuple

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

    accepts_table_input = True  # consumes a multi-parent Table when graph-wired

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


class RnnCell(Cell):
    """``activation(x·i2hᵀ + h·h2hᵀ + bias)`` (reference: RnnCell), with
    ``i2h`` (H, D), ``h2h`` (H, H) and ``bias`` (H) drawn ``RandomUniform``
    as ``LSTM``'s. ``activation`` is a torch callable."""

    def __init__(self, input_size: Optional[int], hidden_size: int, activation=torch.tanh,
                 device=None):
        super().__init__(device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        self.weight_init: InitializationMethod = RandomUniform()

    def init_carry(self, batch_size: int, device):
        return torch.zeros((batch_size, self.hidden_size), device=device)

    def _build(self, generator, sample):
        d = _check_input_size(self, sample.shape[-1])
        h = self.hidden_size
        return {"i2h": self.weight_init(generator, (h, d), d, h),
                "h2h": self.weight_init(generator, (h, h), h, h),
                "bias": self.weight_init(generator, (h,), d, h)}, {}

    def project(self, params, x):
        return precision.einsum("...d,hd->...h", x, params["i2h"])

    def step(self, params, carry, u_t):
        h = self.activation(u_t + precision.einsum("nk,hk->nh", carry, params["h2h"])
                            + params["bias"])
        return h, h


def _check_input_size(cell, d: int) -> int:
    """``d``, after checking it against the cell's declared ``input_size``."""
    if cell.input_size is not None and cell.input_size != d:
        raise ValueError(f"{cell.name()}: declared input_size {cell.input_size}, got {d}")
    cell.input_size = d
    return d


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
        d = _check_input_size(self, sample.shape[-1])
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


class LSTMPeephole(LSTM):
    """``LSTM`` with peephole connections from the cell state (reference:
    LSTMPeephole): ``peep`` (3, H) adds ``peep[0]·c`` to the input gate,
    ``peep[1]·c`` to the forget gate and ``peep[2]·new_c`` (the updated
    state) to the output gate."""

    def _build(self, generator, sample):
        params, state = super()._build(generator, sample)
        hsz = self.hidden_size
        params["peep"] = self.weight_init(generator, (3, hsz), hsz, hsz)
        return params, state

    def step(self, params, carry, u_t):
        h, c = carry
        gates = u_t + precision.einsum("nh,gh->ng", h, params["h2g"]) + params["bias"]
        i, f, g, o = gates.chunk(4, dim=-1)
        p = params["peep"]
        new_c = torch.sigmoid(f + p[1] * c) * c + torch.sigmoid(i + p[0] * c) * torch.tanh(g)
        new_h = torch.sigmoid(o + p[2] * new_c) * torch.tanh(new_c)
        return (new_h, new_c), new_h


class GRU(Cell):
    """GRU cell (reference: $DL/nn/GRU.scala) in the cuDNN form: the reset
    gate scales ``h·h2nᵀ`` after the product. Parameters ``i2rz`` (2H, D),
    ``h2rz`` (2H, H), ``bias_rz`` (2H), ``i2n`` (H, D), ``h2n`` (H, H),
    ``bias_n`` (H); ``new_h = (1 - z)·n + z·h``. ``project`` takes both
    input products in one product against ``i2rz`` and ``i2n`` stacked:
    (..., 3H), the r/z part first."""

    def __init__(self, input_size: Optional[int], hidden_size: int, device=None):
        super().__init__(device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.weight_init: InitializationMethod = RandomUniform()

    def init_carry(self, batch_size: int, device):
        return torch.zeros((batch_size, self.hidden_size), device=device)

    def _build(self, generator, sample):
        d = _check_input_size(self, sample.shape[-1])
        hsz = self.hidden_size
        w = self.weight_init
        return {"i2rz": w(generator, (2 * hsz, d), d, hsz),
                "h2rz": w(generator, (2 * hsz, hsz), hsz, hsz),
                "bias_rz": w(generator, (2 * hsz,), d, hsz),
                "i2n": w(generator, (hsz, d), d, hsz),
                "h2n": w(generator, (hsz, hsz), hsz, hsz),
                "bias_n": w(generator, (hsz,), d, hsz)}, {}

    def project(self, params, x):
        return precision.einsum("...d,gd->...g", x, torch.cat([params["i2rz"], params["i2n"]]))

    def step(self, params, carry, u_t):
        u_rz, u_n = u_t.split([2 * self.hidden_size, self.hidden_size], dim=-1)
        rz = torch.sigmoid(u_rz + precision.einsum("nk,gk->ng", carry, params["h2rz"])
                           + params["bias_rz"])
        r, z = rz.chunk(2, dim=-1)
        n = torch.tanh(u_n + r * precision.einsum("nk,hk->nh", carry, params["h2n"])
                       + params["bias_n"])
        new_h = (1 - z) * n + z * carry
        return new_h, new_h


def _same_padding(k: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """XLA's SAME padding of a stride-1 k x k convolution: (k - 1) // 2 low
    and k // 2 high on each spatial dim (an even kernel's odd cell high)."""
    return ((k - 1) // 2, k // 2), ((k - 1) // 2, k // 2)


class ConvLSTMPeephole(Cell):
    """Convolutional LSTM cell with peephole connections over (N, C, H, W)
    steps (reference: ``$DL/nn/ConvLSTMPeephole.scala``): ``LSTM``'s gate
    products become SAME-padded stride-1 convolutions, ``i2g`` (4·C_out,
    C_in, kernel_i, kernel_i) over the input and ``h2g`` (4·C_out, C_out,
    kernel_c, kernel_c) over the hidden state, plus ``bias`` (4·C_out); the
    peepholes ``peep`` (3, C_out) are per-channel weights on the cell state
    (``with_peephole=False`` drops them). Driven by ``Recurrent`` over (N,
    T, C, H, W); ``project`` runs the input convolution once over the N·T
    frames. The carry's spatial size is the built sample's."""

    def __init__(self, input_size: Optional[int], output_size: int, kernel_i: int = 3,
                 kernel_c: int = 3, stride: int = 1, with_peephole: bool = True, device=None):
        super().__init__(device)
        if stride != 1:
            raise ValueError("ConvLSTMPeephole requires stride 1 (hidden spatial dims must "
                             "be preserved across steps)")
        self.input_size = input_size
        self.hidden_size = output_size
        self.output_size = output_size
        self.kernel_i = kernel_i
        self.kernel_c = kernel_c
        self.with_peephole = with_peephole
        self.weight_init: InitializationMethod = RandomUniform()
        self._spatial: Optional[Tuple[int, int]] = None

    def init_carry(self, batch_size: int, device):
        if self._spatial is None:
            raise ValueError("ConvLSTMPeephole: build before init_carry")
        z = torch.zeros((batch_size, self.output_size) + self._spatial, device=device)
        return z, torch.zeros_like(z)

    def _build(self, generator, sample):
        cin = _check_input_size(self, sample.shape[1])
        self._spatial = (int(sample.shape[2]), int(sample.shape[3]))
        co, ki, kc = self.output_size, self.kernel_i, self.kernel_c
        fan_i, fan_c = cin * ki * ki, co * kc * kc
        w = self.weight_init
        params = {"i2g": w(generator, (4 * co, cin, ki, ki), fan_i, co),
                  "h2g": w(generator, (4 * co, co, kc, kc), fan_c, co),
                  "bias": w(generator, (4 * co,), fan_i, co)}
        if self.with_peephole:
            params["peep"] = w(generator, (3, co), co, co)
        return params, {}

    def project(self, params, x):
        """The input convolution of one step (N, C, H, W), or of every step of
        (N, T, C, H, W) with time folded into the batch."""
        if x.dim() == 5:
            n, t = x.shape[:2]
            u = self.project(params, x.reshape((n * t,) + tuple(x.shape[2:])))
            return u.reshape((n, t) + tuple(u.shape[1:]))
        return precision.conv2d(x, params["i2g"], 1, _same_padding(self.kernel_i))

    def step(self, params, carry, u_t):
        h, c = carry
        gates = (u_t + precision.conv2d(h, params["h2g"], 1, _same_padding(self.kernel_c))
                 + params["bias"][None, :, None, None])
        i, f, g, o = gates.chunk(4, dim=1)
        if self.with_peephole:
            p = params["peep"][:, None, :, None, None]
            i, f = torch.sigmoid(i + p[0] * c), torch.sigmoid(f + p[1] * c)
        else:
            i, f = torch.sigmoid(i), torch.sigmoid(f)
        new_c = f * c + i * torch.tanh(g)
        o = torch.sigmoid(o + p[2] * new_c) if self.with_peephole else torch.sigmoid(o)
        new_h = o * torch.tanh(new_c)
        return (new_h, new_c), new_h


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


class RecurrentDecoder(Container):
    """Feed each step's output back as the next input for ``seq_length``
    steps (reference: RecurrentDecoder): (N, D) start input -> (N,
    seq_length, H), so the cell's output must fit its input (D == H). Each
    step projects its own input (``cell.project`` on the fed-back output);
    there is no all-steps projection."""

    def __init__(self, seq_length: int, cell: Optional[Cell] = None, device=None):
        super().__init__(*([cell] if cell is not None else []), device=device)
        self.seq_length = seq_length

    def add(self, cell: Cell) -> "RecurrentDecoder":
        if len(self._layers) >= 1:
            raise ValueError("RecurrentDecoder holds exactly one Cell")
        if not isinstance(cell, Cell):
            raise TypeError(f"RecurrentDecoder needs a Cell, got {type(cell).__name__}")
        return super().add(cell)

    @property
    def cell(self) -> Cell:
        return self._layers[0]

    def build(self, generator: torch.Generator, sample) -> None:
        if self._built:
            raise RuntimeError(f"{self.name()} is already built")
        if not self.cell.is_built():
            self.cell.build(generator, sample)
        self._built = True

    def _apply_params(self, params, state, x, training, rng):
        cell = self.cell
        p = params[cell.name()]
        carry = cell.init_carry(x.shape[0], x.device)
        ys = []
        for _ in range(self.seq_length):
            carry, x = cell.step(p, carry, cell.project(p, x))
            ys.append(x)
        return torch.stack(ys, dim=1), {cell.name(): state[cell.name()]}
