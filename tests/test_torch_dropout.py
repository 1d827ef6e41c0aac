"""The port's ``nn.Dropout`` (counterpart of ``bigdl_tpu/nn/dropout.py``):
inverted statistics at train time, the identity in eval mode and at p = 0,
``scale=False`` leaving kept units as they are, and the mask drawn on the
input's device from a generator seeded by the host generator. The JAX
package draws other masks from ``jax.random``, so only the statistics are
compared: the keep rate within 1% of 1 - p over 200k draws (about 9
standard deviations), the mean within 2%.
"""

import numpy as np
import torch

from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.nn import dropout as pdrop


def _train_forward(m, x, seed):
    return m.apply({}, {}, x, training=True, rng=torch.Generator().manual_seed(seed))[0]


def test_dropout_keeps_inverted_statistics():
    p = 0.3
    m = pnn.Dropout(p, device="cpu")
    y = _train_forward(m, torch.ones(200_000), 0)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    assert abs(y.mean().item() - 1.0) < 0.02
    unscaled = _train_forward(pnn.Dropout(p, scale=False, device="cpu"), torch.ones(1000), 0)
    assert set(np.unique(unscaled.numpy())) <= {0.0, 1.0}


def test_dropout_is_the_identity_in_eval_mode_and_at_zero():
    x = torch.randn(4, 7)
    m = pnn.Dropout(0.5, device="cpu")
    assert m.apply({}, {}, x, training=False)[0] is x
    assert _train_forward(pnn.Dropout(0.0, device="cpu"), x, 1) is x
    assert m.apply({}, {}, x, training=True, rng=None)[0] is x
    m.eval()
    assert torch.equal(m.forward(x), x)


def test_dropout_draws_its_mask_on_the_input_device(monkeypatch):
    seen = []
    real = torch.rand

    def spy(*args, **kwargs):
        seen.append((kwargs.get("device"), kwargs["generator"].device))
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "rand", spy)
    x = torch.ones(6, 5)
    m = pnn.Dropout(0.5, device="cpu")
    a, b = _train_forward(m, x, 3), _train_forward(m, x, 3)
    assert seen == [(x.device, x.device)] * 2
    torch.testing.assert_close(a, b)  # the host generator fixes the device draw
    assert pdrop.dropout(torch.Generator().manual_seed(3), 0.5, x).shape == x.shape
