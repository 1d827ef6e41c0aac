"""The port's dropout and noise variants (``SpatialDropout1D/2D/3D``,
``GaussianNoise``, ``GaussianDropout``) against the JAX package's.

The port draws its masks and noise on the input's device from a generator
seeded by the host generator; the JAX package draws from ``jax.random``. So
the packages are held to the same statistics, not the same draws, on one
numpy-made input: the kept share of slices within 5 binomial standard
deviations of ``1 - p`` (about 1 in 3.5 million to fail by chance), each
dropped or kept slice whole (every element of a channel or feature map
shares its fate), kept slices scaled by ``1 / (1 - p)`` exactly (1e-6
relative); the noise's mean and standard deviation within 5 standard errors
of the JAX formula's. Eval mode, ``p = 0`` and no generator are the identity
in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.nn import dropout as pdrop

SPATIAL = {  # name: (input shape, the dims a mask cell spans)
    "SpatialDropout1D": ((400, 6, 50), (1,)),
    "SpatialDropout2D": ((400, 50, 3, 3), (2, 3)),
    "SpatialDropout3D": ((400, 50, 2, 2, 2), (2, 3, 4)),
}


def _port(module, x, seed=0):
    return module.apply({}, {}, x, training=True,
                        rng=torch.Generator().manual_seed(seed))[0]


def _jax(module, x, seed=0):
    module.init(jax.random.PRNGKey(0), sample_input=x)
    return np.asarray(module.apply({}, {}, jnp.asarray(x), training=True,
                                   rng=jax.random.PRNGKey(seed))[0])


def _slices(y, spans):
    """(number of mask cells, elements per cell) view of y."""
    y = np.moveaxis(y, spans, tuple(range(y.ndim - len(spans), y.ndim)))
    return y.reshape(-1, int(np.prod([y.shape[d] for d in range(y.ndim - len(spans), y.ndim)])))


def _check_spatial(y, x, p, spans):
    cells, xc = _slices(y, spans), _slices(x, spans)
    kept = (cells != 0).any(axis=1)
    np.testing.assert_array_equal((cells != 0).all(axis=1), kept)  # whole slices
    np.testing.assert_allclose(cells[kept], xc[kept] / (1 - p), rtol=1e-6)
    n = len(kept)
    bound = 5 * np.sqrt(p * (1 - p) / n)
    assert abs(kept.mean() - (1 - p)) < bound, (kept.mean(), 1 - p, bound)


@pytest.mark.parametrize("p", [0.2, 0.5])
@pytest.mark.parametrize("name", sorted(SPATIAL))
def test_spatial_dropout_statistics_match_jax(name, p):
    shape, spans = SPATIAL[name]
    x = (np.random.RandomState(1).rand(*shape) + 0.5).astype(np.float32)  # no zeros
    _check_spatial(_jax(getattr(jnn, name)(p), x), x, p, spans)
    got = _port(getattr(pnn, name)(p, device="cpu"), torch.from_numpy(x)).numpy()
    _check_spatial(got, x, p, spans)


@pytest.mark.parametrize("stddev", [0.1, 2.0])
def test_gaussian_noise_statistics_match_jax(stddev):
    x = np.full((400, 500), 3.0, np.float32)
    n = x.size
    for y in (_jax(jnn.GaussianNoise(stddev), x),
              _port(pnn.GaussianNoise(stddev, device="cpu"), torch.from_numpy(x)).numpy()):
        noise = y - x
        assert abs(noise.mean()) < 5 * stddev / np.sqrt(n)
        assert abs(noise.std() - stddev) < 5 * stddev / np.sqrt(2 * n)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_gaussian_dropout_statistics_match_jax(rate):
    x = np.full((400, 500), 2.0, np.float32)
    n, std = x.size, (rate / (1 - rate)) ** 0.5
    for y in (_jax(jnn.GaussianDropout(rate), x),
              _port(pnn.GaussianDropout(rate, device="cpu"), torch.from_numpy(x)).numpy()):
        mult = y / x
        assert abs(mult.mean() - 1.0) < 5 * std / np.sqrt(n)
        assert abs(mult.std() - std) < 5 * std / np.sqrt(2 * n)


VARIANTS = [("SpatialDropout1D", 0.5, (2, 3, 4)), ("SpatialDropout2D", 0.5, (2, 3, 4, 4)),
            ("SpatialDropout3D", 0.5, (2, 3, 2, 2, 2)), ("GaussianNoise", 0.3, (3, 5)),
            ("GaussianDropout", 0.3, (3, 5))]


@pytest.mark.parametrize("name,arg,shape", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_identity_in_eval_mode_and_without_a_generator(name, arg, shape):
    x = torch.randn(shape)
    m = getattr(pnn, name)(arg, device="cpu")
    assert m.apply({}, {}, x, training=False)[0] is x
    assert m.apply({}, {}, x, training=True, rng=None)[0] is x
    m.eval()
    assert torch.equal(m.forward(x), x)
    jm = getattr(jnn, name)(arg)
    jm.init(jax.random.PRNGKey(0), sample_input=x.numpy())
    np.testing.assert_array_equal(np.asarray(jm.apply({}, {}, jnp.asarray(x.numpy()),
                                                      training=False)[0]), x.numpy())
    m.train()
    assert not torch.equal(m.forward(x), x)  # train mode draws


@pytest.mark.parametrize("name", sorted(SPATIAL))
def test_spatial_dropout_at_zero_is_the_identity(name):
    x = torch.randn((2,) + SPATIAL[name][0][1:])
    m = getattr(pnn, name)(0.0, device="cpu")
    assert _port(m, x) is x


@pytest.mark.parametrize("name,arg,shape", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_draws_are_on_the_input_device_and_replayable(name, arg, shape, monkeypatch):
    seen = []
    real = pdrop._device_generator

    def spy(rng, device):
        gen = real(rng, device)
        seen.append(gen.device)
        return gen

    monkeypatch.setattr(pdrop, "_device_generator", spy)
    x = torch.randn(shape, dtype=torch.bfloat16)
    m = getattr(pnn, name)(arg, device="cpu")
    a = m.apply({}, {}, x, training=True, rng=torch.Generator().manual_seed(4))[0]
    b = m.apply({}, {}, x, training=True, rng=torch.Generator().manual_seed(4))[0]
    assert seen == [x.device, x.device]
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)  # the host seed fixes the draw


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_dropout_variants.py`")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SPATIAL))
def test_spatial_dropout_on_card(cuda_card, name):
    shape, spans = SPATIAL[name]
    x = (torch.rand(shape, generator=torch.Generator().manual_seed(2)) + 0.5).cuda()
    y = _port(getattr(pnn, name)(0.3, device="cuda"), x)
    assert y.is_cuda
    _check_spatial(y.cpu().numpy(), x.cpu().numpy(), 0.3, spans)


@pytest.mark.gpu
def test_gaussian_variants_on_card(cuda_card):
    x = torch.full((400, 500), 2.0, device="cuda")
    n = x.numel()
    noise = (_port(pnn.GaussianNoise(0.5, device="cuda"), x) - x).cpu().numpy()
    assert abs(noise.mean()) < 5 * 0.5 / np.sqrt(n)
    assert abs(noise.std() - 0.5) < 5 * 0.5 / np.sqrt(2 * n)
    mult = (_port(pnn.GaussianDropout(0.5, device="cuda"), x) / x).cpu().numpy()
    assert abs(mult.mean() - 1) < 5 / np.sqrt(n) and abs(mult.std() - 1) < 5 / np.sqrt(2 * n)
