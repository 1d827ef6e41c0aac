"""The port's beam search against the JAX package's.

``sequence_beam_search`` runs in both packages over the same numpy logits
table (a function of each row's last id, the step and, where a cache is
given, the row's cached history), including the JAX package's own tie and
finished-beam cases (``tests/test_attention.py``): exact ties among
candidates (``lax.top_k`` puts the lower index first; the port's stable
descending sort must too), finished beams making rows of exact ``NEG_INF``
ties, and equal final scores (the JAX ``argsort`` is stable). The sequences
must be identical; the scores equal within 1e-5 absolute and relative (f32
log-softmax sums in another order). ``SequenceBeamSearch`` in LM and
translation mode, with the JAX model's weights carried over: identical
sequences, scores within 1e-4 (the logits' own tolerance,
``test_torch_transformer.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import bigdl_tpu.nn as jnn
from bigdl_tpu.nn import attention as jattn
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch.nn import SequenceBeamSearch, Transformer
from bigdl_tpu_torch.nn import attention as pattn
from bigdl_tpu_torch.utils.convert import load_jax_params


@pytest.fixture(autouse=True)
def _fp32_policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def _table_fn(table, lib, cache_mix=0.0):
    """``fn(ids, i, cache)``: logits row ``table[i % len][last id]``, plus
    ``cache_mix`` times the sum of the row's cached history (the cache holds
    each row's past ids and grows one slot a step)."""
    def fn(ids, i, cache):
        ids_np = np.asarray(ids) if lib == "jax" else ids.numpy()
        logits = table[i % len(table)][ids_np[:, -1]].astype(np.float32)
        new = {}
        if cache:
            hist = np.asarray(cache["h"]) if lib == "jax" else cache["h"].numpy()
            logits = logits + cache_mix * hist.sum(axis=1, keepdims=True)
            grown = np.concatenate([hist, ids_np[:, -1:].astype(np.float32)], axis=1)
            new = {"h": jnp.asarray(grown) if lib == "jax" else torch.from_numpy(grown)}
        return (jnp.asarray(logits) if lib == "jax" else torch.from_numpy(logits)), new
    return fn


def _run_both(table, init_ids, vocab, cache_mix=0.0, **kw):
    cache0 = (lambda lib: {} if not cache_mix else
              {"h": (jnp.zeros((len(init_ids), 0)) if lib == "jax"
                     else torch.zeros((len(init_ids), 0)))})
    js, jsc = jattn.sequence_beam_search(
        _table_fn(table, "jax", cache_mix), jnp.asarray(init_ids, jnp.int32), cache0("jax"),
        vocab, **kw)
    ps, psc = pattn.sequence_beam_search(
        _table_fn(table, "torch", cache_mix), torch.tensor(init_ids), cache0("torch"),
        vocab, **kw)
    return (np.asarray(js), np.asarray(jsc)), (ps.numpy(), psc.numpy())


def _assert_same(jax_out, port_out):
    (js, jsc), (ps, psc) = jax_out, port_out
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_allclose(psc, jsc, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("beam,alpha,steps", [(1, 0.6, 5), (3, 0.6, 6), (4, 0.0, 7),
                                              (5, 1.0, 4)])
def test_random_table_matches_jax(beam, alpha, steps):
    rs = np.random.RandomState(beam)
    vocab = 11
    table = rs.randn(3, vocab, vocab) * 2.0
    _assert_same(*_run_both(table, [2, 7], vocab, beam_size=beam, alpha=alpha,
                            max_decode_length=steps, eos_id=1))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_ties_match_jax(seed):
    """Logits drawn from {0, 1, 2}: most candidates tie exactly at every step,
    and many finished beams tie at the end."""
    rs = np.random.RandomState(10 + seed)
    vocab = 6
    table = rs.randint(0, 3, (2, vocab, vocab)).astype(np.float64)
    _assert_same(*_run_both(table, [0, 3, 5], vocab, beam_size=4, alpha=0.6,
                            max_decode_length=6, eos_id=2))


def test_cache_is_gathered_with_its_beams():
    rs = np.random.RandomState(3)
    vocab = 9
    table = rs.randn(2, vocab, vocab)
    _assert_same(*_run_both(table, [1, 4], vocab, cache_mix=0.3, beam_size=3, alpha=0.6,
                            max_decode_length=5, eos_id=0))


def test_finished_beams_frozen_like_jax():
    """EOS always most likely: a beam that emitted it only extends with EOS
    at no cost (rows of NEG_INF ties but the EOS column)."""
    vocab = 4
    table = np.zeros((1, vocab, vocab))
    table[:, :, 1] = 3.0
    out = _run_both(table, [0], vocab, beam_size=2, max_decode_length=3, eos_id=1)
    _assert_same(*out)
    np.testing.assert_array_equal(out[1][0][0, 0, 1:], [1, 1, 1])


def test_short_finished_beam_wins_after_normalization_like_jax():
    vocab = 4
    table = np.full((2, vocab, vocab), -8.0)
    table[0, :, 1], table[0, :, 2] = 1.0, 1.2
    table[1, :, 2], table[1, :, 3] = 0.5, 0.4
    table = np.concatenate([table[:1], np.repeat(table[1:], 5, axis=0)])  # step 0, then 1-5
    out = _run_both(table, [0], vocab, beam_size=2, max_decode_length=6, eos_id=1, alpha=1.0)
    _assert_same(*out)
    (seqs, scores) = out[1]
    assert seqs[0, 0, 1] == 1 and scores[0, 0] > scores[0, 1]


def test_beam_beats_greedy_like_jax():
    vocab = 3
    table = np.zeros((2, vocab, vocab))
    table[0, :] = [-10.0, 1.0, 1.1]
    table[1, :] = [-10.0, 0.0, 0.0]
    table[1, 1] = [-10.0, 5.0, -5.0]
    out = _run_both(table, [0], vocab, beam_size=2, max_decode_length=2, eos_id=0, alpha=0.0)
    _assert_same(*out)
    assert out[1][0][0, 0, 1] == 1


def test_top_k_puts_the_lower_index_first_among_ties():
    rows = np.array([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0], [-1e9] * 6,
                     [5.0, -1e9, 5.0, 5.0, -1e9, 0.0]], np.float32)
    jv, ji = lax.top_k(jnp.asarray(rows), 4)
    pv, pi = pattn._top_k(torch.from_numpy(rows), 4)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


CFG = dict(vocab_size=23, hidden_size=32, num_heads=4, filter_size=64,
           num_hidden_layers=2, postprocess_dropout=0.0, attention_dropout=0.0,
           relu_dropout=0.0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("position_encoding", ["sinusoidal", "rope"])
def test_sequence_beam_search_layer_lm_matches_jax(position_encoding):
    ids = np.random.RandomState(4).randint(2, CFG["vocab_size"], (3, 5)).astype(np.int32)
    jm = jnn.Transformer(**CFG, position_encoding=position_encoding)
    jm.init(jax.random.PRNGKey(1), sample_input=jnp.asarray(ids))
    pm = Transformer(**CFG, position_encoding=position_encoding, device="cpu")
    pm.init(sample_input=ids)
    load_jax_params(pm, _np_tree(jm.get_parameters()))
    jl = jnn.SequenceBeamSearch(jm, beam_size=3, max_decode_length=8, eos_id=1)
    pl = SequenceBeamSearch(pm, beam_size=3, max_decode_length=8, eos_id=1)
    js, jsc = jl.forward(jnp.asarray(ids))
    ps, psc = pl.forward(ids)
    assert ps.shape == (3, 3, 9) and not ps.requires_grad
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_allclose(psc.numpy(), np.asarray(jsc), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("pad_masking", ["lengths", "bias"])
def test_sequence_beam_search_layer_translation_matches_jax(pad_masking):
    rs = np.random.RandomState(5)
    src = rs.randint(2, CFG["vocab_size"], (2, 7)).astype(np.int32)
    src[1, 4:] = 0
    tgt = rs.randint(2, CFG["vocab_size"], (2, 3)).astype(np.int32)
    cfg = {**CFG, "mode": "translation", "pad_masking": pad_masking}
    jm = jnn.Transformer(**cfg)
    jm.init(jax.random.PRNGKey(2), sample_input=[jnp.asarray(src), jnp.asarray(tgt)])
    pm = Transformer(**cfg, device="cpu")
    pm.init(sample_input=[src, tgt])
    load_jax_params(pm, _np_tree(jm.get_parameters()))
    jl = jnn.SequenceBeamSearch(jm, beam_size=4, max_decode_length=6)
    pl = SequenceBeamSearch(pm, beam_size=4, max_decode_length=6)
    js, jsc = jl.forward(jnp.asarray(src))
    ps, psc = pl.forward(src)
    assert ps.shape == (2, 4, 7)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_allclose(psc.numpy(), np.asarray(jsc), atol=1e-4, rtol=1e-4)


def test_sequence_beam_search_layer_builds_its_model():
    src = np.array([[3, 4, 5]], np.int32)
    pm = Transformer(vocab_size=10, hidden_size=8, num_heads=2, filter_size=16,
                     num_hidden_layers=1, mode="translation", device="cpu")
    layer = SequenceBeamSearch(pm, beam_size=2, max_decode_length=4)
    seqs, scores = layer.forward(src)
    assert pm.is_built() and seqs.shape == (1, 2, 5) and scores.shape == (1, 2)
    assert {n.split(".")[0] for n, _ in layer.named_parameters()} == {"model"}
    assert bool(torch.all(scores[:, :-1] >= scores[:, 1:]))


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_beam_search.py`")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["lm", "translation"])
def test_sequence_beam_search_on_card_matches_cpu(cuda_card, mode):
    """The layer on the card against the CPU, f32 with TF32 off, from the
    same weights: identical sequences, scores within 1e-4."""
    rs = np.random.RandomState(8)
    src = rs.randint(2, CFG["vocab_size"], (2, 9)).astype(np.int32)
    src[0, 6:] = 0
    sample = [src, src[:, :3]] if mode == "translation" else src
    cpu = Transformer(**CFG, mode=mode, device="cpu")
    cpu.init(sample_input=sample)
    card = Transformer(**CFG, mode=mode, device="cuda")
    card.init(sample_input=sample)
    load_jax_params(card, {k: v.detach().numpy() for k, v in cpu.named_parameters()})
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gs, gsc = SequenceBeamSearch(card, beam_size=4, max_decode_length=10).forward(src)
        ws, wsc = SequenceBeamSearch(cpu, beam_size=4, max_decode_length=10).forward(src)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert gs.is_cuda
    np.testing.assert_array_equal(gs.cpu().numpy(), ws.numpy())
    np.testing.assert_allclose(gsc.cpu().numpy(), wsc.numpy(), atol=1e-4, rtol=1e-4)


def test_transformer_example_decodes_like_jax(capsys):
    """The port's example (``bigdl_tpu_torch/examples/transformer_train.py``)
    at a tiny size on the CPU: it trains (finite losses, one validation),
    prints each prompt's beam-0 continuation, and its beam search equals
    the JAX package's ``sequence_beam_search`` over the JAX Transformer
    holding the trained weights (identical sequences, scores within 1e-4)."""
    from bigdl_tpu_torch.examples import transformer_train

    run = transformer_train.main(["--platform", "cpu", "--max-epoch", "1", "--synthetic-size",
                                  "2000", "--seq-len", "16", "--vocab-size", "50",
                                  "--hidden-size", "16", "--num-heads", "2", "--num-layers", "1",
                                  "--decode-len", "6", "--beam-size", "3"])
    out = capsys.readouterr().out
    assert out.count("beam-0 continuation") == 2
    losses = [h["loss"] for h in run.optimizer.history]
    assert len(losses) == int(0.9 * (1999 // 16)) // 16 and np.all(np.isfinite(losses))
    assert run.sequences.shape == (2, 3, 7)
    args = run.args
    jm = jnn.Transformer(vocab_size=50, hidden_size=16, num_heads=2, filter_size=64,
                         num_hidden_layers=1, mode="lm")
    jm.init(jax.random.PRNGKey(0), sample_input=jnp.zeros((1, 1), jnp.int32))
    tree = {}  # the trained weights, nested as the JAX tree
    for name, p in run.model.named_parameters():
        node = tree
        *heads, last = name.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(p.detach().numpy())
    fn = jm.decode_step_fn(tree, max_len=args.decode_len + 1)
    js, jsc = jattn.sequence_beam_search(
        fn, jnp.asarray(run.prompts.numpy(), jnp.int32), jm.init_decode_cache(2), 50,
        beam_size=3, max_decode_length=6, eos_id=0)
    np.testing.assert_array_equal(run.sequences.numpy(), np.asarray(js))
    np.testing.assert_allclose(run.scores.numpy(), np.asarray(jsc), atol=1e-4, rtol=1e-4)
