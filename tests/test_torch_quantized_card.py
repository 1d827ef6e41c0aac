"""The quantized layers, ``MoE`` and ``Remat`` on the card against the CPU
route (every test is marked ``gpu`` and skips without a card; run on the
card with ``python -m pytest -m gpu tests/test_torch_quantized_card.py``).
No JAX here: the CPU route is the oracle, itself held against the JAX
package by ``test_torch_quantized.py``, ``test_torch_moe.py`` and
``test_torch_remat.py``.

Limits, fixed before the first run: int8 codes, scales and int32
accumulators equal to the bit (``torch._int_mm`` sums integers exactly;
every shape rule of it crossed: fewer than 17 rows, K and N off a multiple
of 8); fp8 codes and scales to the bit, accumulators within 1e-3 of the
largest |value| (the card's fp8 tensor cores add in a narrower accumulator
before promoting partial sums to f32); MoE routing equal and outputs and
gradients within 1e-5 of the largest (f32, TF32 off, sums in another
order); ``Remat`` with dropout to the bit against the unwrapped module.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.nn import quantized as pq

FP8_ACC_REL = 1e-3
REL = 1e-5


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_quantized_card.py`")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


LAYERS = {
    "linear_few_rows": (lambda d: pnn.Linear(13, 7, device=d), (5, 13)),
    "linear": (lambda d: pnn.Linear(64, 40, device=d), (33, 64)),
    "conv_same": (lambda d: pnn.SpatialConvolution(5, 6, 4, 3, 2, 1, -1, -1, device=d),
                  (2, 5, 9, 10)),
    "conv_grouped": (lambda d: pnn.SpatialConvolution(4, 6, 3, 3, 1, 1, 1, 1, n_group=2,
                                                      device=d), (3, 4, 7, 7)),
    "dilated": (lambda d: pnn.SpatialDilatedConvolution(3, 5, 3, 3, 1, 1, 2, 2, dilation_w=2,
                                                        dilation_h=2, device=d),
                (2, 3, 12, 11)),
}


def _twins(name, family):
    factory, shape = LAYERS[name]
    x = np.random.default_rng(len(name)).standard_normal(shape).astype(np.float32)
    RandomGenerator.set_seed(3)
    cpu = factory("cpu")
    cpu.init(sample_input=x)
    card = factory("cuda")
    card.init(sample_input=x)
    with torch.no_grad():
        for p, q in zip(card.parameters(), cpu.parameters()):
            p.copy_(q)
    return (pq._QUANTIZABLE[family][type(cpu)](cpu), pq._QUANTIZABLE[family][type(card)](card),
            torch.from_numpy(x))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_int8_layers_on_the_card_equal_the_cpu_to_the_bit(cuda_card, name):
    cpu, card, x = _twins(name, "int8")
    for k, v in cpu.get_parameters().items():
        assert torch.equal(_bits(card.get_parameters()[k]), _bits(v)), k
    a = cpu.products(cpu.get_parameters(), x)
    b = card.products(card.get_parameters(), x.cuda())
    assert b[2].dtype == torch.int32
    for u, v in zip(a, b):
        assert torch.equal(_bits(v), _bits(u))
    with torch.no_grad():
        assert torch.equal(card.forward(x).cpu(), cpu.forward(x))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_fp8_layers_on_the_card_match_the_cpu(cuda_card, name):
    cpu, card, x = _twins(name, "fp8")
    for k, v in cpu.get_parameters().items():
        assert torch.equal(_bits(card.get_parameters()[k]), _bits(v)), k
    a = cpu.products(cpu.get_parameters(), x)
    b = card.products(card.get_parameters(), x.cuda())
    assert torch.equal(_bits(b[0]), _bits(a[0])) and torch.equal(b[1].cpu(), a[1])
    assert float((b[2].cpu() - a[2]).abs().max()) <= FP8_ACC_REL * float(a[2].abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["int8", "fp8"])
def test_quantized_resnet_forward_has_no_host_sync(cuda_card, family):
    from bigdl_tpu_torch.models import ResNet

    RandomGenerator.set_seed(4)
    m = ResNet(8, class_num=10, dataset="cifar10", device="cuda")
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(0)).cuda()
    m.init(sample_input=x)
    q = m.evaluate().quantize(family)
    with torch.no_grad():
        q.forward(x)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = q.forward(x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert y.shape == (4, 10) and bool(torch.isfinite(y).all())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2])
def test_moe_on_the_card_matches_the_cpu_with_drops_and_ties(cuda_card, k):
    from bigdl_tpu_torch.parallel.moe import _route

    x = np.random.default_rng(k).standard_normal((8, 16, 12)).astype(np.float32)
    x[0, :4] = 0.0  # exact ties among the router logits
    RandomGenerator.set_seed(5)
    mods = {d: pnn.MoE(4, ffn_size=20, capacity_factor=0.75, router_top_k=k, device=d)
            for d in ("cpu", "cuda")}
    for m in mods.values():
        m.init(sample_input=x)
    with torch.no_grad():
        for p, q in zip(mods["cuda"].parameters(), mods["cpu"].parameters()):
            p.copy_(q)
    out = {}
    for d, m in mods.items():
        xt = torch.from_numpy(x).to(d).requires_grad_()
        y, st = m.apply(m.get_parameters(), m.get_state(), xt, training=True)
        ((y * y).sum() + st["_aux_loss"]).backward()
        logits = xt.detach().reshape(4, 32, 12) @ m.get_parameters()["router_w"].detach()
        routes = [_route(logits[s], 4, 6 * k, k)[:3] for s in range(4)]
        out[d] = (y.detach().cpu(), xt.grad.cpu(), [p.grad.cpu() for p in m.parameters()],
                  [[r.cpu() for r in rs] for rs in routes])
    (yc, gc, pc, rc), (yp, gp, pp, rp) = out["cuda"], out["cpu"]
    for a, b in zip(rc, rp):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    for a, b in [(yc, yp), (gc, gp)] + list(zip(pc, pp)):
        assert float((a - b).abs().max()) <= REL * float(b.abs().max())


@pytest.mark.gpu
def test_remat_with_dropout_on_the_card_is_bit_identical(cuda_card):
    x = torch.randn(6, 8, generator=torch.Generator().manual_seed(1)).cuda()

    def model(wrap):
        inner = pnn.Sequential(pnn.Linear(8, 16, device="cuda"), pnn.ReLU(device="cuda"),
                               pnn.Dropout(0.5, device="cuda"), pnn.Linear(16, 8, device="cuda"),
                               device="cuda")
        body = pnn.Remat(inner, policy="dots_saveable", device="cuda") if wrap else inner
        return pnn.Sequential(body, pnn.Dropout(0.3, device="cuda"), device="cuda")

    runs = []
    for wrap in (False, True):
        RandomGenerator.set_seed(6)
        m = model(wrap)
        m.init(sample_input=x)
        g = torch.Generator().manual_seed(7)
        y, _ = m.apply(m.get_parameters(), m.get_state(), x, training=True, rng=g)
        y.sum().backward()
        runs.append((y.detach(), [p.grad for p in m.parameters()], g.get_state()))
    (ya, ga, sa), (yb, gb, sb) = runs
    assert torch.equal(ya, yb) and torch.equal(sa, sb)
    assert all(torch.equal(u, v) for u, v in zip(ga, gb))
