"""``Dropout`` (counterpart of ``Dropout`` in ``bigdl_tpu/nn/dropout.py``):
inverted dropout at train time, the identity in eval mode or at p = 0.

The mask is drawn on the input's device, from a generator there seeded by
one draw of the host generator ``rng`` (no host-sized mask, no copy). The
draws differ from ``jax.random``'s, so parity tests run with dropout off.
"""

from __future__ import annotations

from typing import Optional

import torch

from .module import AbstractModule


def dropout(rng: Optional[torch.Generator], p: float, x: torch.Tensor,
            scale: bool = True) -> torch.Tensor:
    """Zero each element with probability ``p`` and, with ``scale``, divide
    the kept ones by ``1 - p``; identity when ``rng`` is None or p <= 0."""
    if p <= 0.0 or rng is None:
        return x
    keep = 1.0 - p
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=rng))
    gen = torch.Generator(device=x.device).manual_seed(seed)
    y = x * (torch.rand(x.shape, generator=gen, device=x.device) < keep)
    return y / keep if scale else y


class Dropout(AbstractModule):
    """Inverted dropout: kept units scaled by 1/(1-p) at train time
    (``scale=True``, the reference's default). ``inplace`` is accepted and
    ignored."""

    def __init__(self, init_p: float = 0.5, inplace: bool = False, scale: bool = True,
                 device=None):
        super().__init__(device)
        self.p = init_p
        self.scale = scale

    def _apply_params(self, params, state, x, training, rng):
        if not training:
            return x, state
        return dropout(rng, self.p, x, self.scale), state
