"""The port's translation-mode Transformer, ``Attention`` and mask helpers
against the JAX package's, with the JAX model's weights carried over through
``load_jax_params``.

Small size (2 encoder + 2 decoder blocks, hidden 32, 4 heads, vocab 37), f32
on the CPU; ids come from numpy with a seed, sources trailing-padded with id
0 to ragged lengths. Tolerance 1e-4 absolute and relative on the logits, as
``test_torch_transformer.py``: both sides compute the same f32 products and
sum them in another order through 4 blocks, the cross-attention and the tied
head. ``Attention`` alone: 1e-5 (one block). Mask helpers: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn import attention as jattn
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch.nn import Attention, Transformer
from bigdl_tpu_torch.nn import attention as pattn
from bigdl_tpu_torch.utils.convert import load_jax_params

ATOL = RTOL = 1e-4
CFG = dict(vocab_size=37, hidden_size=32, num_heads=4, filter_size=64,
           num_hidden_layers=2, postprocess_dropout=0.0, attention_dropout=0.0,
           relu_dropout=0.0, mode="translation")


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def _batch(n, t_src, t_tgt, lengths, seed=0):
    """Source ids in [1, V) trailing-padded with 0 past each length; target
    ids in [1, V)."""
    rs = np.random.RandomState(seed)
    src = rs.randint(1, CFG["vocab_size"], (n, t_src)).astype(np.int32)
    for i, n_valid in enumerate(lengths):
        src[i, n_valid:] = 0
    tgt = rs.randint(1, CFG["vocab_size"], (n, t_tgt)).astype(np.int32)
    return src, tgt


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_pair(src, tgt, **kw):
    """A JAX translation Transformer and its port twin holding the same weights."""
    cfg = {**CFG, **kw}
    jm = jnn.Transformer(**cfg)
    jm.init(jax.random.PRNGKey(0), sample_input=[jnp.asarray(src), jnp.asarray(tgt)])
    pm = Transformer(**cfg, device="cpu")
    pm.init(sample_input=[src, tgt])
    load_jax_params(pm, _np_tree(jm.get_parameters()))
    return jm, pm


def _both(jm, pm, src, tgt):
    want = np.asarray(jm.forward([jnp.asarray(src), jnp.asarray(tgt)]))
    got = pm.forward([src, tgt]).detach().numpy()
    return got, want


@pytest.mark.parametrize("t_src,t_tgt,lengths", [(13, 9, [13, 5, 1]), (11, 11, [11, 7, 3])])
@pytest.mark.parametrize("pad_masking", ["lengths", "bias"])
@pytest.mark.parametrize("norm", ["layer", "rms"])
def test_translation_logits_match_jax(norm, pad_masking, t_src, t_tgt, lengths):
    src, tgt = _batch(3, t_src, t_tgt, lengths)
    jm, pm = make_pair(src, tgt, norm=norm, pad_masking=pad_masking)
    got, want = _both(jm, pm, src, tgt)
    assert got.shape == (3, t_tgt, CFG["vocab_size"])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("position_encoding", ["sinusoidal", "rope"])
@pytest.mark.parametrize("ffn_activation", ["relu", "swiglu"])
def test_translation_variants_match_jax(ffn_activation, position_encoding):
    src, tgt = _batch(2, 10, 7, [10, 4], seed=3)
    jm, pm = make_pair(src, tgt, ffn_activation=ffn_activation,
                       position_encoding=position_encoding)
    got, want = _both(jm, pm, src, tgt)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_translation_without_lm_head_returns_hidden_states():
    src, tgt = _batch(2, 8, 6, [8, 3], seed=4)
    jm, pm = make_pair(src, tgt, with_lm_head=False)
    got, want = _both(jm, pm, src, tgt)
    assert got.shape == (2, 6, CFG["hidden_size"])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("t_src,t_tgt", [(13, 9), (12, 12)])
def test_forced_flash_route_matches_jax_dense(monkeypatch, t_src, t_tgt):
    """BIGDL_ATTN_IMPL=flash on the CPU runs the kernel's plain version at
    every attention (encoder self: lengths + mask_q; decoder self: causal;
    cross: lengths, mask_q=False); the JAX package takes its dense path
    there. Equal-length src/tgt is the case a mask_q=True cross-attention
    would get wrong (zeroed valid decoder rows)."""
    src, tgt = _batch(3, t_src, t_tgt, [t_src, 6, 2], seed=1)
    jm, pm = make_pair(src, tgt)
    calls = []
    real = pattn.flash_attention
    monkeypatch.setattr(
        pattn, "flash_attention",
        lambda *a, **k: calls.append((a[3], k["mask_q"], k["lengths"] is not None))
        or real(*a, **k))
    monkeypatch.setenv("BIGDL_ATTN_IMPL", "flash")
    got, want = _both(jm, pm, src, tgt)
    layers = CFG["num_hidden_layers"]
    # (causal, mask_q, lengths given) per call, in the model's order
    assert calls == [(False, True, True)] * layers + [(True, True, False),
                                                      (False, False, True)] * layers
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_padded_source_positions_do_not_move_the_logits():
    """Trailing pads past a source's length are invisible under 'lengths':
    appending more of them leaves the logits as they were."""
    src, tgt = _batch(2, 10, 5, [6, 3], seed=5)
    _, pm = make_pair(src, tgt)
    longer = np.concatenate([src, np.zeros((2, 4), np.int32)], axis=1)
    a = pm.forward([src, tgt]).detach()
    b = pm.forward([longer, tgt]).detach()
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_translation_tree_loads_path_for_path():
    src, tgt = _batch(2, 6, 4, [6, 2])
    jm, pm = make_pair(src, tgt)
    names = {n for n, _ in pm.named_parameters()}
    for path in ("dec_block0.cross_q_w", "dec_block1.cross_out_w", "dec_block0.ln3_g",
                 "dec_block0.ln3_b", "dec_ln_g", "dec_ln_b", "block1.self_v_w", "ln_b"):
        assert path in names
    tree = _np_tree(jm.get_parameters())
    assert names == {f"{k}.{j}" if isinstance(v, dict) else k
                     for k, v in tree.items() for j in (v if isinstance(v, dict) else [k])}
    lm = Transformer(**{**CFG, "mode": "lm"}, device="cpu")
    lm.init(sample_input=tgt)
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(lm, tree)
    rms = Transformer(**CFG, norm="rms", device="cpu")
    rms.init(sample_input=[src, tgt])
    with pytest.raises(KeyError, match="extra"):  # the layer-norm shifts have no home
        load_jax_params(rms, tree)


def test_rope_tree_has_no_position_parameters():
    src, tgt = _batch(2, 6, 4, [6, 2])
    jm, pm = make_pair(src, tgt, position_encoding="rope")
    assert {n for n, _ in pm.named_parameters()} == {
        n for n, _ in make_pair(src, tgt)[1].named_parameters()}


@pytest.mark.parametrize("case", ["self", "self_none", "cross", "cross_bias"])
def test_attention_module_matches_jax(case):
    rs = np.random.RandomState(6)
    x = rs.randn(2, 5, 16).astype(np.float32)
    y = rs.randn(2, 7, 16).astype(np.float32)
    bias = (rs.rand(2, 1, 5, 7) < 0.3).astype(np.float32) * -1e9
    inputs = {"self": x, "self_none": [x, None], "cross": [x, y],
              "cross_bias": [x, y, bias]}[case]
    sample = [x, y] if case.startswith("cross") else x
    jm = jnn.Attention(24, num_heads=4)
    jm.init(jax.random.PRNGKey(2), sample_input=sample)
    pm = Attention(24, num_heads=4, device="cpu")
    pm.init(sample_input=sample)
    assert {n for n, _ in pm.named_parameters()} == {"q_w", "k_w", "v_w", "out_w"}
    load_jax_params(pm, _np_tree(jm.get_parameters()))

    def jax_in(v):
        return [None if a is None else jnp.asarray(a) for a in v] if isinstance(v, list) \
            else jnp.asarray(v)

    want = np.asarray(jm.forward(jax_in(inputs)))
    got = pm.forward(inputs).detach().numpy()
    assert got.shape == (2, 5, 24)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_attention_module_checks_heads_and_trains():
    with pytest.raises(ValueError, match="heads"):
        Attention(10, num_heads=4, device="cpu").init(sample_input=np.zeros((1, 2, 8),
                                                                            np.float32))
    m = Attention(num_heads=2, attention_dropout=0.5, device="cpu")
    x = torch.randn(2, 3, 8)
    m.init(sample_input=x)
    y = m.forward(x)
    y.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in m.parameters())
    m.eval()
    torch.testing.assert_close(m.forward(x), m.apply(m.get_parameters(), {}, x)[0])


def test_mask_helpers_match_jax():
    np.testing.assert_array_equal(pattn.attention_bias_lower_triangle(6).numpy(),
                                  np.asarray(jattn.attention_bias_lower_triangle(6)))
    pad = (np.random.RandomState(7).rand(3, 8) < 0.4).astype(np.float32)
    got = pattn.padding_attention_bias(torch.from_numpy(pad))
    assert got.shape == (3, 1, 1, 8) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jattn.padding_attention_bias(jnp.asarray(pad))))


@pytest.mark.parametrize("pad_id", [0, 5])
def test_lengths_from_ids_matches_jax(pad_id):
    ids = np.array([[3, 4, pad_id, 2, pad_id, pad_id], [pad_id] * 6, [1, 2, 3, 4, 6, 7],
                    [pad_id, 9, pad_id, pad_id, pad_id, pad_id]], np.int32)
    got = pattn.lengths_from_ids(torch.from_numpy(ids), pad_id)
    want = np.asarray(jattn.lengths_from_ids(jnp.asarray(ids), pad_id))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_lengths_from_ids_strict():
    trailing = np.array([[3, 4, 0, 0], [5, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    np.testing.assert_array_equal(
        pattn.lengths_from_ids(torch.from_numpy(trailing), strict=True).numpy(),
        np.asarray(jattn.lengths_from_ids(jnp.asarray(trailing), strict=True)))
    interior = np.array([[3, 0, 4, 0]], np.int32)
    with pytest.raises(ValueError, match="interior"):
        jattn.lengths_from_ids(jnp.asarray(interior), strict=True)
    with pytest.raises(ValueError, match="interior"):
        pattn.lengths_from_ids(torch.from_numpy(interior), strict=True)
    # not strict: the interior pad counts as visible, as in the JAX package
    assert pattn.lengths_from_ids(torch.from_numpy(interior)).tolist() == [3]


def test_pad_masking_bias_masks_interior_pads_like_jax():
    """'bias' masks every id-0 token, interior ones too; 'lengths' attends to
    interior pads. Both as in the JAX package."""
    src, tgt = _batch(2, 9, 5, [9, 9], seed=8)
    src[0, 3] = 0
    src[1, 1] = 0
    for masking in ("bias", "lengths"):
        jm, pm = make_pair(src, tgt, pad_masking=masking)
        got, want = _both(jm, pm, src, tgt)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_translation_trains_on_cpu():
    src, tgt = _batch(2, 8, 6, [8, 5])
    _, pm = make_pair(src, tgt)
    out = pm.forward([src, tgt])
    out.float().logsumexp(-1).mean().backward()
    grads = {n: p.grad for n, p in pm.named_parameters()}
    assert all(g is not None and torch.isfinite(g).all() for g in grads.values())
    assert grads["dec_block0.cross_k_w"].abs().sum() > 0
    assert grads["block0.self_q_w"].abs().sum() > 0


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_translation.py`")


@pytest.mark.gpu
@pytest.mark.parametrize("pad_masking", ["lengths", "bias"])
def test_translation_on_card_matches_cpu(cuda_card, pad_masking):
    """T = 1024 on the card takes the flash route for every attention under
    'lengths' (3 launches a block pair); under 'bias' the encoder's and the
    cross-attention's biases route them dense and the decoder's causal
    self-attention alone launches. f32 with TF32 off against the CPU from
    the same weights, 1e-4 (fp32 sums in other orders through 4 blocks and
    the head)."""
    from bigdl_tpu_torch.ops import flash_attention as fa

    src, tgt = _batch(2, 1024, 1024, [1024, 700], seed=9)
    # head dim 64, one the kernel takes
    cfg = {**CFG, "hidden_size": 128, "num_heads": 2, "filter_size": 256,
           "pad_masking": pad_masking}
    cpu = Transformer(**cfg, device="cpu")
    cpu.init(sample_input=[src, tgt])
    card = Transformer(**cfg, device="cuda")
    card.init(sample_input=[src, tgt])
    load_jax_params(card, {k: v.detach().numpy() for k, v in cpu.named_parameters()})
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = fa.launches
        with torch.no_grad():
            got = card.forward([src, tgt]).cpu().numpy()
            torch.cuda.synchronize()
        launched = fa.launches - before
        want = cpu.forward([src, tgt]).detach().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    layers = CFG["num_hidden_layers"]
    assert launched == (3 * layers if pad_masking == "lengths" else layers)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
