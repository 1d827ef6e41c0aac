"""Reductions over one dimension (counterpart of ``_Reduce``, ``Sum``,
``Mean``, ``Max`` and ``Min`` in ``bigdl_tpu/nn/math_ops.py``).

``dimension`` is 1-based (Torch convention). With ``n_input_dims > 0`` and
an input of more dims than that, the axis moves one past the batch dim, so
``Max(1, n_input_dims=2)`` on (N, T, C) reduces T. ``squeeze=False`` keeps
the reduced dim with extent 1.

``Max`` and ``Min`` are ``torch.amax``/``torch.amin``, whose gradient is
split evenly among tied extrema, as ``jnp.max``'s is (``torch.max(x, dim)``
would route all of it to one index).
"""

from __future__ import annotations

import torch

from .module import AbstractModule


class _Reduce(AbstractModule):
    """A reduction over the 1-based ``dimension`` (see module docstring)."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1, size_average: bool = False,
                 squeeze: bool = True, device=None):
        super().__init__(device)
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.size_average = size_average
        self.squeeze = squeeze

    def _axis(self, x: torch.Tensor) -> int:
        d = self.dimension - 1
        if self.n_input_dims > 0 and x.dim() > self.n_input_dims:
            d += 1
        return d

    def _reduce(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        raise NotImplementedError

    def _apply_params(self, params, state, x, training, rng):
        axis = self._axis(x)
        y = self._reduce(x, axis)
        if not self.squeeze:
            y = y.unsqueeze(axis)
        return y, state


class Sum(_Reduce):
    """Sum; divided by the dim's extent with ``size_average``."""

    def _reduce(self, x, axis):
        y = torch.sum(x, dim=axis)
        if self.size_average:
            y = y / x.shape[axis]
        return y


class Mean(_Reduce):
    def _reduce(self, x, axis):
        return torch.mean(x, dim=axis)


class Max(_Reduce):
    def _reduce(self, x, axis):
        return torch.amax(x, dim=axis)


class Min(_Reduce):
    def _reduce(self, x, axis):
        return torch.amin(x, dim=axis)
