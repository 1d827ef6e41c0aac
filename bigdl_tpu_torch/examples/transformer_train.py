"""Transformer language-model training and beam-search generation on one
card (counterpart of ``examples/transformer/train.py``; reference:
``$DL/nn/Transformer.scala`` and ``SequenceBeamSearch.scala``).

    python3 -m bigdl_tpu_torch.examples.transformer_train --vocab-size 8192 \\
        --seq-len 2048 --hidden-size 512 --num-layers 6 --num-heads 8 --batch-size 8

Trains the LM (filter 4 x hidden, postprocess and relu dropout 0.1,
attention dropout 0 so the flash route engages from T = 1024 on the card)
through ``LocalOptimizer`` with ``Adam(1e-3)`` (``--learning-rate`` is read
by the parser and, as in the JAX main, not used),
``TimeDistributedCriterion(CrossEntropyCriterion(), size_average=True)``,
validation (``Loss``) every epoch when there are validation sequences and a
checkpoint every epoch with ``--checkpoint``; then decodes a continuation of
the first token of two training sequences with length-normalized beam
search (``--beam-size``, ``--decode-len`` steps, EOS id 0) through the
incremental decode cache. It runs on the card, or on the CPU with
``--platform cpu``.

Data: the planted-bigram stream (``--synthetic-size`` tokens, 40000 by
default), or the whitespace words of ``<--data-dir>/corpus.txt`` numbered
in order of first appearance from id 2 (words past ``V - 3`` distinct share
the unknown id ``V - 1``); cut into ``(len - 1) // seq_len`` sequences
whose targets are the next tokens, the first 90% for training.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence

from ._common import base_parser, device_of, finish, setup_logging


def parser() -> argparse.ArgumentParser:
    """The JAX main's flags (its ``base_parser`` at batch 16 and its own).
    ``-f`` names a folder holding corpus.txt and ``--synthetic-size`` counts
    tokens; ``--learning-rate`` is not used: the recipe's rate is
    Adam(1e-3), as in the JAX main."""
    p = base_parser("Transformer LM + beam search", batch_size=16)
    p.add_argument("--vocab-size", type=int, default=200)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--hidden-size", type=int, default=64)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--beam-size", type=int, default=4)
    p.add_argument("--decode-len", type=int, default=16)
    return p


def planted_bigram_ids(n_tokens: int, vocab_size: int, seed: int = 0, jump: float = 0.15):
    """The LM examples' planted-bigram token stream: with probability
    ``1 - jump`` the next id is ``(3*id + 1) % (V - 2) + 2``, else a uniform
    draw from [2, V). Ids 0/1 are reserved (pad/eos)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = np.empty(n_tokens, np.int32)
    ids[0] = 2
    do_jump = rng.random(n_tokens) < jump
    rand = rng.integers(2, vocab_size, n_tokens)
    for i in range(1, n_tokens):
        ids[i] = rand[i] if do_jump[i] else (3 * ids[i - 1] + 1) % (vocab_size - 2) + 2
    return ids


def corpus_ids(args):
    """The token stream: ``corpus.txt``'s words or the planted bigrams."""
    import numpy as np

    v = args.vocab_size
    if not args.data_dir:
        return planted_bigram_ids(args.synthetic_size or 40000, v)
    path = os.path.join(args.data_dir, "corpus.txt")
    if not os.path.exists(path):
        raise SystemExit(f"corpus not found: {path}")
    with open(path) as f:
        words = f.read().split()
    vocab: dict = {}
    unk = v - 1  # overflow words share an explicit unk id, never alias

    def tok(w):
        if w not in vocab and len(vocab) + 2 < unk:
            vocab[w] = len(vocab) + 2
        return vocab.get(w, unk)

    return np.asarray([tok(w) for w in words], np.int32)


@dataclass
class Run:
    """What :func:`main` did: the optimizer (its ``history`` holds each
    iteration's loss), the model, the training sequences, the arguments
    and the beam search's prompts, sequences (N, beam, decode_len + 1) and
    scores (N, beam)."""

    optimizer: Any
    model: Any
    x: Any
    args: Any
    prompts: Any = None
    sequences: Any = None
    scores: Any = None


def build(args) -> Run:
    """The model, data, criterion, method and triggers, ready to
    ``optimizer.optimize()``."""
    from .. import nn
    from ..dataset import DataSet
    from ..optim import Adam, LocalOptimizer, Loss, Trigger
    from ..utils.random import RandomGenerator

    device = device_of(args)
    RandomGenerator.set_seed(42)
    ids, t = corpus_ids(args), args.seq_len
    n_seq = (len(ids) - 1) // t
    if n_seq < 1:
        raise SystemExit(f"{len(ids)} tokens make no sequence of {t}")
    x = ids[:n_seq * t].reshape(n_seq, t)
    y = ids[1:n_seq * t + 1].reshape(n_seq, t)
    split = max(1, int(0.9 * n_seq))
    train_ds = DataSet.array(x[:split], y[:split], batch_size=args.batch_size)
    model = nn.Transformer(
        vocab_size=args.vocab_size, hidden_size=args.hidden_size, num_heads=args.num_heads,
        filter_size=4 * args.hidden_size, num_hidden_layers=args.num_layers,
        postprocess_dropout=0.1, attention_dropout=0.0, relu_dropout=0.1, mode="lm",
        device=device)
    criterion = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(), size_average=True)
    opt = LocalOptimizer(model, train_ds, criterion)
    opt.set_optim_method(Adam(learningrate=1e-3))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    if n_seq - split >= 1:
        opt.set_validation(Trigger.every_epoch(),
                           DataSet.array(x[split:], y[split:], batch_size=args.batch_size),
                           [Loss(criterion)])
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    return Run(opt, model, x, args)


def beam_search(model, prompts, args):
    """Beam-search continuations of ``prompts`` (N,) through the model's
    incremental decode cache: (sequences (N, beam, decode_len + 1), scores
    (N, beam)), EOS id 0."""
    from ..nn import sequence_beam_search

    fn = model.decode_step_fn(model.get_parameters(), max_len=args.decode_len + 1)
    return sequence_beam_search(fn, prompts, model.init_decode_cache(len(prompts)),
                                vocab_size=args.vocab_size, beam_size=args.beam_size,
                                max_decode_length=args.decode_len, eos_id=0)


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None), train, then decode and
    print each prompt's best continuation."""
    import torch

    args = parser().parse_args(argv)
    setup_logging()
    run = build(args)
    run.model = run.optimizer.optimize()
    run.model.evaluate()
    run.prompts = torch.as_tensor(run.x[:2, 0], dtype=torch.long, device=run.model.device)
    run.sequences, run.scores = beam_search(run.model, run.prompts, args)
    for b in range(len(run.prompts)):
        print(f"prompt {int(run.prompts[b])} -> beam-0 continuation "
              f"{run.sequences[b, 0].tolist()} (score {float(run.scores[b, 0]):.2f})")
    finish(run.model, args, run.optimizer)
    return run


if __name__ == "__main__":
    main()
