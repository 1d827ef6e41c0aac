"""The port's math layers against the JAX package's: every class of
``bigdl_tpu/nn/math_ops.py`` that the port did not have (``Sum``,
``Mean``, ``Max`` and ``Min`` are held in ``test_torch_text_models.py``) forward
and backward (input and parameter gradients against ``jax.grad``) on the
same seeded numpy input, in f32 and bf16, weights carried with
``load_jax_params``; ``Clamp`` at its exact bounds.

Tolerances are ``test_torch_activations.TOL``'s, fixed there: f32 1e-6
absolute plus 1e-5 relative (elementwise formulas; ``Bilinear``,
``Euclidean`` and ``Cosine`` sum at most 20 products in another order);
bf16 2^-6 relative plus 2^-7 of the tensor's largest value, and 2^-6 of
an element's cotangent in an elementwise layer's input gradient.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu_torch import nn as pnn

from test_torch_activations import _fp32_policy, check_pair, planted_input  # noqa: F401


def _positive(shape=(4, 6, 5), seed=0):
    return (0.1 + np.random.default_rng(seed).random(shape) * 3).astype(np.float32)


def _pair(s1, s2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s1).astype(np.float32), rng.standard_normal(s2).astype(np.float32)]


# name -> (constructor over a package and its device kwargs, input maker, elementwise)
MATH = {
    "Abs": (lambda nn, d: nn.Abs(**d), planted_input, True),
    "Power": (lambda nn, d: nn.Power(2.0, 1.5, 0.5, **d), planted_input, True),
    "Power_sqrt": (lambda nn, d: nn.Power(0.5, 2.0, 0.0, **d), _positive, True),
    "Square": (lambda nn, d: nn.Square(**d), planted_input, True),
    "Sqrt": (lambda nn, d: nn.Sqrt(**d), _positive, True),
    "Log": (lambda nn, d: nn.Log(**d), _positive, True),
    "Exp": (lambda nn, d: nn.Exp(**d),
            lambda: np.random.default_rng(1).standard_normal((4, 6, 4)).astype(np.float32), True),
    "Clamp": (lambda nn, d: nn.Clamp(-1.0, 2.5, **d), planted_input, True),
    "MulConstant": (lambda nn, d: nn.MulConstant(-1.5, **d), planted_input, True),
    "AddConstant": (lambda nn, d: nn.AddConstant(0.75, **d), planted_input, True),
    "Neg": (lambda nn, d: nn.Neg(**d), planted_input, True),
    "Mul": (lambda nn, d: nn.Mul(**d), planted_input, False),
    "Add": (lambda nn, d: nn.Add(5, **d), planted_input, False),
    "CMul": (lambda nn, d: nn.CMul((1, 6, 1), **d), planted_input, False),
    "CAdd": (lambda nn, d: nn.CAdd((1, 6, 5), **d), planted_input, False),
    "Bilinear": (lambda nn, d: nn.Bilinear(5, 4, 3, **d), lambda: _pair((6, 5), (6, 4)), False),
    "Bilinear_nobias": (lambda nn, d: nn.Bilinear(5, 4, 3, bias_res=False, **d),
                        lambda: _pair((6, 5), (6, 4), 2), False),
    "Euclidean": (lambda nn, d: nn.Euclidean(5, 3, **d),
                  lambda: np.random.default_rng(3).standard_normal((6, 5)).astype(np.float32),
                  False),
    "Cosine": (lambda nn, d: nn.Cosine(5, 3, **d),
               lambda: np.random.default_rng(4).standard_normal((6, 5)).astype(np.float32),
               False),
    "Scale": (lambda nn, d: nn.Scale(**d), planted_input, False),
    "Scale_4d": (lambda nn, d: nn.Scale(6, **d),
                 lambda: np.random.default_rng(5).standard_normal((2, 6, 3, 3)).astype(
                     np.float32), False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MATH))
def test_math_layer_matches_jax(name, dtype):
    make, data, elementwise = MATH[name]
    check_pair(make(jnn, {}), make(pnn, {"device": "cpu"}), data(), dtype,
               dy_share=2.0 ** -6 if (dtype == "bfloat16" and elementwise) else 0.0)


def test_clamp_takes_half_the_gradient_at_exact_bounds():
    import jax

    jm, pm = jnn.Clamp(-1.0, 2.5), pnn.Clamp(-1.0, 2.5, device="cpu")
    b = np.array([-1.0, 2.5, 0.0], np.float32)
    jg = jax.grad(lambda v: jnp.sum(jm.apply({}, {}, v)[0]))(jnp.asarray(b))
    x = torch.from_numpy(b).requires_grad_(True)
    pm.apply({}, {}, x)[0].sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), [0.5, 0.5, 1.0])
    np.testing.assert_array_equal(np.asarray(jg), x.grad.numpy())


def test_euclidean_and_cosine_edges():
    """Euclidean's 1e-12 under the root (a point on a centre: 1e-6, not 0)
    and Cosine's norm clip (a zero row gives 0, not NaN)."""
    pm = pnn.Euclidean(3, 2, device="cpu")
    x = np.zeros((1, 3), np.float32)
    pm.init(sample_input=x)
    with torch.no_grad():
        pm.weight.zero_()
    y = pm.forward(x)
    np.testing.assert_allclose(y.detach().numpy(), [[1e-6, 1e-6]], rtol=1e-6)
    cm = pnn.Cosine(3, 2, device="cpu")
    cm.init(sample_input=x)
    assert torch.equal(cm.forward(x).detach(), torch.zeros(1, 2))


def test_parameterised_layer_errors():
    x = np.zeros((2, 6, 5), np.float32)
    with pytest.raises(ValueError, match="does not broadcast"):
        pnn.CMul((1, 4, 1), device="cpu").init(sample_input=x)
    with pytest.raises(ValueError, match="declared 4 channels"):
        pnn.Scale(4, device="cpu").init(sample_input=x)
    with pytest.raises(ValueError, match="declared input sizes"):
        pnn.Bilinear(5, 3, 2, device="cpu").init(sample_input=_pair((2, 5), (2, 4)))
    with pytest.raises(ValueError, match=r"expects \(N, 5\) input"):
        pnn.Euclidean(5, 2, device="cpu").init(sample_input=x)
