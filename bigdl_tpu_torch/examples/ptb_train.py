"""PTB word-level language model training on one card (counterpart of
``examples/ptb/train.py``; reference: ``$DL/models/rnn/Train.scala``
driving ``PTBModel.scala``).

    python3 -m bigdl_tpu_torch.examples.ptb_train --vocab-size 10000 --max-epoch 2

Data: ``<--data-dir>/ptb.train.txt`` (words numbered from 1 in order of
first appearance, those past ``--vocab-size - 1`` distinct sharing the last
id) and ``ptb.valid.txt`` as the validation stream when present; else the
JAX main's synthetic stream of ``--synthetic-size`` tokens (20000 by
default; token t is followed by (3t + 1) mod V + 1, or with probability 0.2
a uniform draw). Windows of ``--seq-len`` tokens whose targets are the next
tokens; without a validation file the first 90% train. ``PTBModel``
(vocab + 1 ids, embedding and hidden ``--hidden-size``, ``--num-layers``
LSTMs), ``TimeDistributedCriterion(ClassNLLCriterion(one_based_label=True),
size_average=True)`` (a per-token loss, whose exp is the perplexity),
``Adam(1e-3)`` (``--learning-rate`` is parsed and, as in the JAX main, not
used), ``Loss`` every epoch and once more after training. It runs on the
card, or on the CPU with ``--platform cpu``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from ._common import Run, base_parser, device_of, finish, setup_logging


def parser():
    p = base_parser("PTB word LM (stacked LSTM)", batch_size=32)
    p.add_argument("--vocab-size", type=int, default=1000)
    p.add_argument("--seq-len", type=int, default=35)
    p.add_argument("--hidden-size", type=int, default=200)
    p.add_argument("--num-layers", type=int, default=2)
    return p


def load_corpus(data_dir, vocab_size: int, n_tokens: int, seed: int):
    """``(train ids, validation ids or None, vocab)``, 1-based, as the JAX
    main's ``_load_corpus``."""
    import numpy as np

    if data_dir:
        path = os.path.join(data_dir, "ptb.train.txt")
        if not os.path.exists(path):
            raise SystemExit(f"corpus not found: {path}")
        vocab: dict = {}

        def encode(words):
            out = []
            for w in words:
                if w not in vocab and len(vocab) < vocab_size - 1:
                    vocab[w] = len(vocab) + 1
                out.append(vocab.get(w, vocab_size))
            return np.asarray(out, np.int32)

        with open(path) as f:
            train_ids = encode(f.read().split())
        # the unknown id stays inside the vocabulary when the corpus has
        # fewer than vocab_size distinct words
        unk = min(len(vocab) + 1, vocab_size)
        vpath = os.path.join(data_dir, "ptb.valid.txt")
        valid_ids = None
        if os.path.exists(vpath):
            with open(vpath) as f:
                valid_ids = np.asarray([vocab.get(w, unk) for w in f.read().split()], np.int32)
        return train_ids, valid_ids, unk
    rng = np.random.default_rng(seed)
    ids = np.empty(n_tokens, np.int32)
    ids[0] = 1
    jump = rng.random(n_tokens) < 0.2
    rand = rng.integers(1, vocab_size + 1, n_tokens)
    for i in range(1, n_tokens):
        ids[i] = rand[i] if jump[i] else (3 * ids[i - 1] + 1) % vocab_size + 1
    return ids, None, vocab_size


def windows(stream, t: int):
    """Contiguous (input, next-token target) windows of ``t`` tokens."""
    n_seq = (len(stream) - 1) // t
    return stream[:n_seq * t].reshape(n_seq, t), stream[1:n_seq * t + 1].reshape(n_seq, t)


def build(args) -> Run:
    """The model, data, criterion, method and triggers, ready to
    ``optimizer.optimize()``."""
    from .. import nn
    from ..dataset import DataSet
    from ..models import PTBModel
    from ..optim import Adam, LocalOptimizer, Loss, Trigger
    from ..utils.random import RandomGenerator

    device = device_of(args)
    RandomGenerator.set_seed(42)
    ids, valid_ids, vocab = load_corpus(args.data_dir, args.vocab_size,
                                        args.synthetic_size or 20000, seed=0)
    x, y = windows(ids, args.seq_len)
    if valid_ids is not None and len(valid_ids) > args.seq_len:
        train_ds = DataSet.array(x, y, batch_size=args.batch_size)
        val_ds = DataSet.array(*windows(valid_ids, args.seq_len), batch_size=args.batch_size)
    else:
        split = max(1, int(0.9 * len(x)))
        train_ds = DataSet.array(x[:split], y[:split], batch_size=args.batch_size)
        val_ds = (DataSet.array(x[split:], y[split:], batch_size=args.batch_size)
                  if len(x) - split >= 1 else None)
    model = PTBModel(vocab_size=vocab + 1, embedding_dim=args.hidden_size,
                     hidden_size=args.hidden_size, num_layers=args.num_layers, device=device)
    criterion = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(one_based_label=True),
                                            size_average=True)
    opt = LocalOptimizer(model, train_ds, criterion)
    opt.set_optim_method(Adam(learningrate=1e-3))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    if val_ds is not None:
        opt.set_validation(Trigger.every_epoch(), val_ds, [Loss(criterion)])
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    return Run(opt, model, args, val_ds)


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None), train, then print the
    validation loss and its perplexity."""
    import math

    from ..optim import Loss

    args = parser().parse_args(argv)
    setup_logging()
    run = build(args)
    run.model = run.optimizer.optimize()
    if run.val_dataset is not None:
        results = run.model.evaluate(run.val_dataset, [Loss(run.optimizer.criterion)])
        for name, r in results.items():
            run.results[name] = loss = r.result()[0]
            print(f"{name}: {loss:.4f} (perplexity {math.exp(min(loss, 20.0)):.1f})")
    finish(run.model, args, run.optimizer)
    return run


if __name__ == "__main__":
    main()
