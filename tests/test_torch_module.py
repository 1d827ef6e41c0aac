"""The port's module base under ``torch.nn.Module``'s conversions, and its
dropout.

``AbstractModule``'s pure forward hook is ``_apply_params``, so
``torch.nn.Module._apply`` (behind ``.to()``, ``.cuda()``, ``.cpu()`` and the
dtype casts) stays torch's own: a built module moves or casts its
parameters and its state together, and ``device``, ``get_parameters()``,
``forward`` and ``load_jax_params`` see the result. Small LM as in
``test_torch_transformer.py``; f32 on the CPU.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch.nn import AbstractModule, Transformer
from bigdl_tpu_torch.nn import attention as pattn
from bigdl_tpu_torch.utils.convert import load_jax_params

CFG = dict(vocab_size=101, hidden_size=64, num_heads=4, filter_size=128,
           num_hidden_layers=2, postprocess_dropout=0.0, attention_dropout=0.0,
           relu_dropout=0.0, mode="lm")


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def _ids(n=2, t=17, seed=0):
    return np.random.RandomState(seed).randint(1, CFG["vocab_size"], (n, t)).astype(np.int64)


def _built():
    RandomGenerator.set_seed(3)
    m = Transformer(**CFG, device="cpu")
    m.init(sample_input=_ids())
    return m


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_to_cpu_keeps_a_working_module():
    m = _built()
    want = m.forward(_ids()).detach()
    assert m.to("cpu") is m and m.cpu() is m
    assert m.device == torch.device("cpu")
    torch.testing.assert_close(m.forward(_ids()).detach(), want)


def test_double_casts_parameters_seen_everywhere():
    m = _built()
    want = m.forward(_ids()).detach()
    assert m.double() is m
    leaves = list(_leaves(m.get_parameters()))
    assert leaves and all(p.dtype == torch.float64 for p in leaves)
    names = dict(m.named_parameters())
    assert m.get_parameters()["block0"]["self_q_w"] is names["block0.self_q_w"]
    y = m.forward(_ids())
    assert y.dtype == torch.float64
    torch.testing.assert_close(y.detach().float(), want, atol=1e-5, rtol=1e-5)
    # load_jax_params writes into the cast parameters, in their dtype
    tree = {k: np.zeros(tuple(v.shape), np.float32) for k, v in names.items()}
    nested = {}
    for path, arr in tree.items():
        node = nested
        *heads, last = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = arr
    load_jax_params(m, nested)
    assert all(not p.any() and p.dtype == torch.float64 for p in _leaves(m.get_parameters()))
    m.float()
    assert m.get_parameters()["embedding"].dtype == torch.float32


def test_parameters_replaced_by_a_conversion_are_rebound():
    """With torch's overwrite-on-conversion flag, ``.double()`` registers new
    Parameter objects; ``get_parameters()`` follows them."""
    m = _built()
    prev = torch.__future__.get_overwrite_module_params_on_conversion()
    torch.__future__.set_overwrite_module_params_on_conversion(True)
    try:
        before = m.get_parameters()["block1"]["filter_w"]
        m.double()
    finally:
        torch.__future__.set_overwrite_module_params_on_conversion(prev)
    now = dict(m.named_parameters())["block1.filter_w"]
    assert now is not before and now.dtype == torch.float64
    assert m.get_parameters()["block1"]["filter_w"] is now
    assert m.forward(_ids()).dtype == torch.float64


class _Counting(AbstractModule):
    """A module with state: a running count of forwards in train mode."""

    def _build(self, generator, sample):
        return {"w": torch.ones(3)}, {"count": torch.zeros(()), "hist": torch.zeros(3)}

    def _apply_params(self, params, state, x, training, rng):
        new = dict(state, count=state["count"] + 1) if training else state
        return x * params["w"], new


def test_state_follows_conversions():
    m = _Counting(device="cpu")
    m.init(sample_input=torch.ones(3))
    m.train()
    m.forward(torch.ones(3))
    assert m.get_state()["count"].item() == 1.0
    m.double()
    assert all(v.dtype == torch.float64 for v in m.get_state().values())
    assert m.get_parameters()["w"].dtype == torch.float64
    m.forward(torch.ones(3, dtype=torch.float64))
    assert m.get_state()["count"].item() == 2.0
    m.to(torch.float32)
    assert m.get_state()["hist"].dtype == torch.float32


def test_device_before_build_is_the_constructor_device():
    m = Transformer(**CFG, device="cpu")
    assert not m.is_built() and m.device == torch.device("cpu")
    m.to("cpu")  # nothing built yet: nothing to convert
    assert m.device == torch.device("cpu") and m.get_parameters() == {}


def test_dropout_keeps_inverted_statistics():
    """Keep rate within 1% of 1 - p over 200k draws (about 9 standard
    deviations), kept values scaled by 1/(1-p), mean preserved within 2%."""
    p = 0.3
    x = torch.ones(200_000)
    y = pattn._dropout(torch.Generator().manual_seed(0), p, x)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    assert abs(y.mean().item() - 1.0) < 0.02
    assert pattn._dropout(None, p, x) is x and pattn._dropout(torch.Generator(), 0.0, x) is x


def test_dropout_draws_its_mask_on_the_input_device(monkeypatch):
    seen = []
    real = torch.rand

    def spy(*args, **kwargs):
        seen.append((kwargs.get("device"), kwargs["generator"].device))
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "rand", spy)
    x = torch.ones(4, 5)
    a = pattn._dropout(torch.Generator().manual_seed(1), 0.5, x)
    b = pattn._dropout(torch.Generator().manual_seed(1), 0.5, x)
    assert seen == [(x.device, x.device)] * 2
    torch.testing.assert_close(a, b)  # the host generator fixes the device draw
