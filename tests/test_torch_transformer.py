"""The port's Transformer-LM against the JAX package's, with the JAX model's
weights carried over through ``load_jax_params``.

Small size (2 layers, hidden 64, 4 heads, vocab 101), f32 on the CPU; the
token ids come from numpy with a seed. Tolerance 1e-4 absolute and relative
on the logits: both sides compute the same f32 products but sum them in
another order through 2 blocks and the tied head.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn import attention as jattn
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch.nn import FeedForwardNetwork, Transformer
from bigdl_tpu_torch.nn import attention as pattn
from bigdl_tpu_torch.utils.convert import load_jax_params

ATOL = RTOL = 1e-4
CFG = dict(vocab_size=101, hidden_size=64, num_heads=4, filter_size=128,
           num_hidden_layers=2, postprocess_dropout=0.0, attention_dropout=0.0,
           relu_dropout=0.0, mode="lm")


@pytest.fixture(autouse=True)
def _fp32_policy():
    """Exact f32 math whatever the machine: the port's default compute dtype
    is bf16 wherever a card is present."""
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def _ids(n, t, seed=0):
    return np.random.RandomState(seed).randint(1, CFG["vocab_size"], (n, t)).astype(np.int32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_pair(ids, **kw):
    """A JAX Transformer and its port twin holding the same weights."""
    jm = jnn.Transformer(**CFG, **kw)
    jm.init(jax.random.PRNGKey(0), sample_input=jnp.asarray(ids))
    pm = Transformer(**CFG, **kw, device="cpu")
    pm.init(sample_input=ids)
    load_jax_params(pm, _np_tree(jm.get_parameters()))
    return jm, pm


@pytest.mark.parametrize("t", [17, 33])
@pytest.mark.parametrize("ffn_activation", ["relu", "swiglu"])
@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_lm_logits_match_jax(norm, ffn_activation, t):
    ids = _ids(3, t)
    jm, pm = make_pair(ids, norm=norm, ffn_activation=ffn_activation)
    want = np.asarray(jm.forward(jnp.asarray(ids)))
    got = pm.forward(ids).detach().numpy()
    assert got.shape == (3, t, CFG["vocab_size"])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_forced_flash_route_matches_jax_dense(monkeypatch):
    """impl='flash' forced on the CPU runs the kernel's plain version inside
    the model; it must agree with the JAX model's dense attention."""
    ids = _ids(2, 33, seed=1)
    jm, pm = make_pair(ids)
    want = np.asarray(jm.forward(jnp.asarray(ids)))
    calls = []
    real = pattn.flash_attention
    monkeypatch.setattr(pattn, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("BIGDL_ATTN_IMPL", "flash")
    got = pm.forward(ids).detach().numpy()
    assert len(calls) == CFG["num_hidden_layers"]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_apply_matches_forward_and_param_paths():
    ids = _ids(2, 17)
    jm, pm = make_pair(ids)
    names = {n for n, _ in pm.named_parameters()}
    assert "block0.self_q_w" in names and "embedding" in names and "ln_b" in names
    y, state = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(ids))
    torch.testing.assert_close(y, pm.forward(ids))
    assert state == {}


@pytest.mark.parametrize("causal,lengths,bias", [
    (False, None, False), (True, None, False), (True, [5, 9], False),
    (False, [5, 9], True)])
def test_sdpa_dense_matches_jax(causal, lengths, bias):
    rs = np.random.RandomState(2)
    q, k, v = (rs.randn(2, 3, 9, 8).astype(np.float32) for _ in range(3))
    b = rs.randn(2, 1, 9, 9).astype(np.float32) if bias else None
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    want = np.asarray(jattn.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if b is None else jnp.asarray(b), causal=causal, lengths=jl, impl="dense"))
    tl = None if lengths is None else torch.tensor(lengths)
    got = pattn.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if b is None else torch.from_numpy(b), causal=causal, lengths=tl,
        impl="dense")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_sdpa_auto_stays_dense_on_cpu_and_flash_rejects_bias():
    q = torch.randn(1, 2, 8, 16)
    called = []
    orig = pattn.flash_attention
    try:
        pattn.flash_attention = lambda *a, **k: called.append(1)
        pattn.scaled_dot_product_attention(q, q, q, causal=True)
    finally:
        pattn.flash_attention = orig
    assert not called
    with pytest.raises(ValueError, match="impl='flash'"):
        pattn.scaled_dot_product_attention(q, q, q, bias=torch.zeros(8, 8), impl="flash")


@pytest.mark.parametrize("activation", ["relu", "gelu", "swiglu"])
def test_feed_forward_matches_jax(activation):
    x = np.random.RandomState(4).randn(2, 5, 16).astype(np.float32)
    jm = jnn.FeedForwardNetwork(16, 32, activation=activation)
    jm.init(jax.random.PRNGKey(1), sample_input=jnp.asarray(x))
    pm = FeedForwardNetwork(16, 32, activation=activation, device="cpu")
    pm.init(sample_input=x)
    load_jax_params(pm, _np_tree(jm.get_parameters()))
    want = np.asarray(jm.forward(jnp.asarray(x)))
    np.testing.assert_allclose(pm.forward(x).detach().numpy(), want, atol=1e-5, rtol=1e-5)


def test_position_encoding_matches_jax():
    want = np.asarray(jattn.get_position_encoding(33, 63))
    got = pattn.get_position_encoding(33, 63)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_load_jax_params_rejects_mismatches():
    ids = _ids(1, 17)
    jm, pm = make_pair(ids)
    tree = _np_tree(jm.get_parameters())
    missing = {k: v for k, v in tree.items() if k != "ln_b"}
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(pm, missing)
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(pm, {**tree, "bogus": np.zeros(3)})
    bad = dict(tree, ln_g=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_params(pm, bad)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        Transformer(**{**CFG, "mode": "translation"}, device="cpu")
    with pytest.raises(NotImplementedError):
        Transformer(**CFG, position_encoding="rope", device="cpu")


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        assert Engine.device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Transformer(**CFG)
    assert Engine.device("cpu").type == "cpu"


def test_package_imports_without_jax_or_bigdl_tpu():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['bigdl_tpu'] = None\n"
        "import bigdl_tpu_torch, bigdl_tpu_torch.nn, bigdl_tpu_torch.serving\n"
        "import bigdl_tpu_torch.optim, bigdl_tpu_torch.ops.flash_attention\n"
        "import bigdl_tpu_torch.ops._build, bigdl_tpu_torch.utils.convert\n"
        "import bigdl_tpu_torch.utils.precision, bigdl_tpu_torch.dataset\n"
        "import bigdl_tpu_torch.nn.criterion, bigdl_tpu_torch.optim.local_optimizer\n"
        "import bigdl_tpu_torch.optim.optim_method, bigdl_tpu_torch.models\n"
        "import bigdl_tpu_torch.nn.graph, bigdl_tpu_torch.nn.conv\n"
        "import bigdl_tpu_torch.nn.normalization, bigdl_tpu_torch.nn.pooling\n"
        "import bigdl_tpu_torch.ops.maxpool, bigdl_tpu_torch.ops.fused_epilogue\n"
        "import bigdl_tpu_torch.ops.fused_common, bigdl_tpu_torch.nn.dropout\n"
        "import bigdl_tpu_torch.models.vgg\n"
        "bad = [m for m in set(sys.modules) - before\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'bigdl_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, timeout=120, cwd=root)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_dropout_only_in_train_mode():
    ids = _ids(2, 17)
    pm = Transformer(**{**CFG, "postprocess_dropout": 0.5, "relu_dropout": 0.5},
                     device="cpu")
    pm.init(sample_input=ids)
    pm.eval()
    y_eval = pm.forward(ids).detach()
    y_apply, _ = pm.apply(pm.get_parameters(), pm.get_state(), torch.from_numpy(ids))
    torch.testing.assert_close(y_eval, y_apply.detach())
    pm.train()
    assert not torch.allclose(pm.forward(ids).detach(), y_eval)
