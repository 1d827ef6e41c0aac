"""BiLSTM text classifier training on one card (counterpart of
``examples/textclassification/train.py``; reference:
``$DL/example/textclassification``).

    python3 -m bigdl_tpu_torch.examples.textclassification_train --max-epoch 2

Data: the synthetic news20 corpus (``synthetic_news20``: class-marker tokens
planted in random token streams), ``--synthetic-size`` training records (512
by default) from seed 0 and ``max(128, N // 4)`` validation records from
seed 1, as the JAX main draws them. ``BiLSTMClassifier`` (LookupTable ->
BiRecurrent(LSTM) -> Linear -> LogSoftMax), ``ClassNLLCriterion``,
``Adam(1e-3)``, Top-1 every epoch and once more after training. It runs on
the card, or on the CPU with ``--platform cpu``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ._common import Run, base_parser, device_of, finish, setup_logging


def parser():
    p = base_parser("BiLSTM text classification (synthetic news20)", batch_size=32)
    p.add_argument("--vocab-size", type=int, default=2000)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--embedding-dim", type=int, default=64)
    p.add_argument("--hidden-size", type=int, default=64)
    p.add_argument("--class-num", type=int, default=20)
    return p


def build(args) -> Run:
    """The model, data, criterion, method and triggers, ready to
    ``optimizer.optimize()``."""
    from .. import nn
    from ..dataset import DataSet
    from ..dataset.text import synthetic_news20
    from ..models import BiLSTMClassifier
    from ..optim import Adam, LocalOptimizer, Top1Accuracy, Trigger
    from ..utils.random import RandomGenerator

    device = device_of(args)
    RandomGenerator.set_seed(42)
    n = args.synthetic_size or 512
    x, y = synthetic_news20(n, args.vocab_size, args.seq_len, args.class_num, seed=0)
    xv, yv = synthetic_news20(max(128, n // 4), args.vocab_size, args.seq_len, args.class_num,
                              seed=1)
    train_ds = DataSet.array(x, y, batch_size=args.batch_size)
    val_ds = DataSet.array(xv, yv, batch_size=args.batch_size)
    model = BiLSTMClassifier(args.vocab_size, args.embedding_dim, args.hidden_size,
                             args.class_num, device=device)
    opt = LocalOptimizer(model, train_ds, nn.ClassNLLCriterion())
    opt.set_optim_method(Adam(learningrate=1e-3))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    opt.set_validation(Trigger.every_epoch(), val_ds, [Top1Accuracy()])
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    return Run(opt, model, args, val_ds)


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None), train, validate once
    more and print Top-1."""
    from ..optim import Top1Accuracy

    args = parser().parse_args(argv)
    setup_logging()
    run = build(args)
    run.model = run.optimizer.optimize()
    run.results = run.model.evaluate(run.val_dataset, [Top1Accuracy()])
    for name, r in run.results.items():
        print(f"{name}: {r.result()[0]:.4f}")
    finish(run.model, args, run.optimizer)
    return run


if __name__ == "__main__":
    main()
