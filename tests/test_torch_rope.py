"""Rotary positions and the incremental decode cache of the port against the
JAX package: ``apply_rotary``, the rope LM's logits, and ``decode_step_fn``'s
logits step by step against the JAX decode and against the port's own full
forward at the same positions (LM, sinusoidal and rope, and translation
mode with the encoder's cross K/V).

Small size (2 blocks, hidden 32, 4 heads, vocab 41), f32 on the CPU, weights
carried over through ``load_jax_params``. Tolerances: ``apply_rotary`` 1e-5
(f32 angles and products, the same formula); logits 1e-4 absolute and
relative as ``test_torch_transformer.py`` (another summation order through
the blocks and the head); decode against the full forward 1e-4 (the same
function, a 1-row query against the cache instead of the causal mask).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn import attention as jattn
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch.nn import Transformer
from bigdl_tpu_torch.nn import attention as pattn
from bigdl_tpu_torch.utils.convert import load_jax_params

ATOL = RTOL = 1e-4
CFG = dict(vocab_size=41, hidden_size=32, num_heads=4, filter_size=64,
           num_hidden_layers=2, postprocess_dropout=0.0, attention_dropout=0.0,
           relu_dropout=0.0)


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)
    Engine.set_activation_dtype(None)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ids(n, t, seed=0):
    return np.random.RandomState(seed).randint(2, CFG["vocab_size"], (n, t)).astype(np.int32)


def make_pair(sample, **kw):
    cfg = {**CFG, **kw}
    jm = jnn.Transformer(**cfg)
    jsample = ([jnp.asarray(s) for s in sample] if isinstance(sample, list)
               else jnp.asarray(sample))
    jm.init(jax.random.PRNGKey(0), sample_input=jsample)
    pm = Transformer(**cfg, device="cpu")
    pm.init(sample_input=sample)
    load_jax_params(pm, _np_tree(jm.get_parameters()))
    return jm, pm


@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("d", [8, 64])
def test_apply_rotary_matches_jax(d, offset):
    x = np.random.RandomState(d).randn(2, 3, 7, d).astype(np.float32)
    pos = np.arange(7) + offset
    want = np.asarray(jattn.apply_rotary(jnp.asarray(x), jnp.asarray(pos)))
    got = pattn.apply_rotary(torch.from_numpy(x), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_apply_rotary_keeps_dtype_and_norm_and_rejects_odd_dims():
    x = torch.randn(2, 4, 9, 16)
    y = pattn.apply_rotary(x, torch.arange(9))
    torch.testing.assert_close(y.norm(dim=-1), x.norm(dim=-1), atol=1e-5, rtol=1e-5)
    assert pattn.apply_rotary(x.bfloat16(), torch.arange(9)).dtype == torch.bfloat16
    # q.k after rotation depends only on the relative position
    q, k = torch.randn(1, 16), torch.randn(1, 16)
    rot = pattn.apply_rotary
    a = (rot(q, torch.tensor([7])) * rot(k, torch.tensor([3]))).sum()
    b = (rot(q, torch.tensor([14])) * rot(k, torch.tensor([10]))).sum()
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="even"):
        jattn.apply_rotary(jnp.zeros((1, 3, 5)), jnp.arange(3))
    with pytest.raises(ValueError, match="even"):
        pattn.apply_rotary(torch.zeros(1, 3, 5), torch.arange(3))


@pytest.mark.parametrize("norm", ["layer", "rms"])
@pytest.mark.parametrize("t", [9, 24])
def test_rope_lm_logits_match_jax(t, norm):
    ids = _ids(3, t)
    jm, pm = make_pair(ids, mode="lm", position_encoding="rope", norm=norm)
    want = np.asarray(jm.forward(jnp.asarray(ids)))
    got = pm.forward(ids).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_rope_lm_forced_flash_matches_jax_dense(monkeypatch):
    ids = _ids(2, 20, seed=3)
    jm, pm = make_pair(ids, mode="lm", position_encoding="rope")
    want = np.asarray(jm.forward(jnp.asarray(ids)))
    monkeypatch.setenv("BIGDL_ATTN_IMPL", "flash")
    got = pm.forward(ids).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _decode(fn, ids, cache, lib):
    """Logits of each step i, fed ids[:, :i+1] (the step reads the last)."""
    out = []
    for i in range(ids.shape[1]):
        step_ids = ids[:, :i + 1]
        logits, cache = fn(jnp.asarray(step_ids) if lib == "jax" else torch.from_numpy(step_ids),
                           i, cache)
        out.append(np.asarray(logits) if lib == "jax" else logits.detach().numpy())
    return np.stack(out, axis=1), cache


@pytest.mark.parametrize("position_encoding", ["sinusoidal", "rope"])
def test_lm_decode_matches_jax_and_full_forward(position_encoding):
    ids = _ids(2, 12, seed=1)
    jm, pm = make_pair(ids, mode="lm", position_encoding=position_encoding)
    t = ids.shape[1]
    want, jcache = _decode(jm.decode_step_fn(jm.get_parameters(), max_len=t), ids,
                           jm.init_decode_cache(2), "jax")
    with torch.no_grad():
        got, pcache = _decode(pm.decode_step_fn(pm.get_parameters(), max_len=t), ids,
                              pm.init_decode_cache(2), "torch")
        full = pm.forward(ids).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, full, atol=ATOL, rtol=RTOL)
    for b in ("block0", "block1"):
        assert tuple(pcache[b]["k"].shape) == (2, 4, t, 8)
        # the cached keys were rotated once, at their slots: equal to JAX's
        np.testing.assert_allclose(pcache[b]["k"].numpy(), np.asarray(jcache[b]["k"]),
                                   atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("position_encoding", ["sinusoidal", "rope"])
def test_translation_decode_matches_jax_and_full_forward(position_encoding):
    rs = np.random.RandomState(2)
    src = rs.randint(1, CFG["vocab_size"], (2, 9)).astype(np.int32)
    src[1, 5:] = 0
    tgt = _ids(2, 7, seed=4)
    jm, pm = make_pair([src, tgt], mode="translation", position_encoding=position_encoding)
    jp, pp = jm.get_parameters(), pm.get_parameters()
    jbias = jattn.padding_attention_bias((jnp.asarray(src) == 0).astype(jnp.float32))
    jenc = jm._encode(jp, jnp.asarray(src), False, None, jbias)
    want, _ = _decode(jm.decode_step_fn(jp, enc_out=jenc, enc_bias=jbias, max_len=7), tgt,
                      jm.init_decode_cache(2), "jax")
    with torch.no_grad():
        pbias = pattn.padding_attention_bias((torch.from_numpy(src) == 0).float())
        penc = pm._encode(pp, torch.from_numpy(src), False, None, pbias)
        got, cache = _decode(pm.decode_step_fn(pp, enc_out=penc, enc_bias=pbias, max_len=7),
                             tgt, pm.init_decode_cache(2), "torch")
        full = pm.forward([src, tgt]).numpy()
    assert set(cache) == {"dec_block0", "dec_block1"}
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, full, atol=ATOL, rtol=RTOL)


def test_decode_past_max_len_raises_for_the_sinusoidal_table():
    ids = _ids(1, 4)
    _, pm = make_pair(ids, mode="lm")
    fn = pm.decode_step_fn(pm.get_parameters(), max_len=3)
    cache = pm.init_decode_cache(1)
    with torch.no_grad():
        for i in range(3):
            _, cache = fn(torch.from_numpy(ids[:, :i + 1]), i, cache)
        with pytest.raises(IndexError, match="max_len=3"):
            fn(torch.from_numpy(ids), 3, cache)
        _, rm = make_pair(ids, mode="lm", position_encoding="rope")
        rfn = rm.decode_step_fn(rm.get_parameters(), max_len=3)
        rcache = rm.init_decode_cache(1)
        for i in range(4):  # rotary positions have no table to run past
            logits, rcache = rfn(torch.from_numpy(ids[:, :i + 1]), i, rcache)
    assert logits.shape == (1, CFG["vocab_size"])


@pytest.mark.parametrize("act", [None, "bfloat16"])
def test_decode_cache_dtype_follows_jax_under_bf16(act):
    """init_decode_cache is float32 and zero-length in both packages; bf16
    keys concatenated onto it become float32 (jnp.concatenate promotes, and
    so does torch.cat); the logits keep the activation dtype."""
    ids = _ids(2, 1)
    jm, pm = make_pair(ids, mode="lm", position_encoding="rope")
    prev = (JEngine.compute_dtype(), JEngine.activation_dtype())
    JEngine.set_compute_dtype("bfloat16")
    JEngine.set_activation_dtype(act)
    Engine.set_compute_dtype("bfloat16")
    Engine.set_activation_dtype(act)
    try:
        jl, jc = jm.decode_step_fn(jm.get_parameters(), max_len=4)(
            jnp.asarray(ids), 0, jm.init_decode_cache(2))
        with torch.no_grad():
            pl, pc = pm.decode_step_fn(pm.get_parameters(), max_len=4)(
                torch.from_numpy(ids), 0, pm.init_decode_cache(2))
    finally:
        JEngine.set_compute_dtype(prev[0])
        JEngine.set_activation_dtype(prev[1])
    assert str(pc["block0"]["k"].dtype)[6:] == str(jc["block0"]["k"].dtype) == "float32"
    assert str(pl.dtype)[6:] == str(jl.dtype)


def test_rope_constructor_checks_match_jax():
    for kw in (dict(hidden_size=15, num_heads=5), dict(hidden_size=12, num_heads=4)):
        cfg = {**CFG, **kw, "position_encoding": "rope"}
        with pytest.raises(ValueError, match="even head dim"):
            jnn.Transformer(**cfg)
        with pytest.raises(ValueError, match="even head dim"):
            Transformer(**cfg, device="cpu")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_rope.py`")


@pytest.mark.gpu
def test_rope_decode_on_card_matches_full_forward(cuda_card):
    """On the card, f32 with TF32 off: a T = 1024 forward (the flash route)
    against 16 decode steps (the dense route, no launch), 1e-4."""
    from bigdl_tpu_torch.ops import flash_attention as fa

    ids = _ids(2, 1024, seed=6)
    cfg = {**CFG, "hidden_size": 128, "num_heads": 2, "filter_size": 256}  # head dim 64
    pm = Transformer(**cfg, mode="lm", position_encoding="rope", device="cuda")
    pm.init(sample_input=ids)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            before = fa.launches
            full = pm.forward(ids)
            fn, cache = pm.decode_step_fn(pm.get_parameters(), max_len=16), pm.init_decode_cache(2)
            t = torch.as_tensor(ids, device="cuda")
            steps = []
            for i in range(16):
                logits, cache = fn(t[:, :i + 1], i, cache)
                steps.append(logits)
            torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert fa.launches - before == CFG["num_hidden_layers"]
    np.testing.assert_allclose(torch.stack(steps, 1).cpu().numpy(), full[:, :16].cpu().numpy(),
                               atol=ATOL, rtol=RTOL)
