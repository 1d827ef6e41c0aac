"""Wide&Deep training on one card (counterpart of
``examples/widedeep/train.py``; BASELINE config 5).

    python3 -m bigdl_tpu_torch.examples.widedeep_train --max-epoch 3

Data: a ``Table`` (wide ``SparseTensor``, deep dense matrix) from
``load_criteo``: the Criteo log at ``--data-dir``, else its synthetic draw
(``--synthetic-size`` records, 1024 by default, seed 0; ``max(128, N // 4)``
validation records, seed 1). ``WideAndDeep(2, --wide-dim, (--embed-vocab,)
* 3)``, ``ClassNLLCriterion``, ``Adam(1e-3)``, Top-1 every epoch and once
more after training. It runs on the card, or on the CPU with ``--platform
cpu``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ._common import Run, base_parser, device_of, finish, setup_logging


def parser():
    p = base_parser("Wide&Deep on (synthetic) Criteo", batch_size=64)
    p.add_argument("--wide-dim", type=int, default=5000)
    p.add_argument("--embed-vocab", type=int, default=100)
    return p


def build(args) -> Run:
    """The model, data, criterion, method and triggers, ready to
    ``optimizer.optimize()``."""
    from .. import nn
    from ..dataset import DataSet
    from ..dataset.criteo import load_criteo
    from ..models import WideAndDeep
    from ..optim import Adam, LocalOptimizer, Top1Accuracy, Trigger
    from ..utils.random import RandomGenerator

    device = device_of(args)
    RandomGenerator.set_seed(42)
    n = args.synthetic_size or 1024
    table, labels = load_criteo(args.data_dir, n=n, wide_dim=args.wide_dim,
                                embed_vocab=args.embed_vocab, seed=0)
    vt, vl = load_criteo(args.data_dir, n=max(128, n // 4), wide_dim=args.wide_dim,
                         embed_vocab=args.embed_vocab, seed=1)
    train_ds = DataSet.array(table, labels, batch_size=args.batch_size)
    val_ds = DataSet.array(vt, vl, batch_size=args.batch_size)
    model = WideAndDeep(class_num=2, wide_dim=args.wide_dim,
                        embed_vocabs=(args.embed_vocab,) * 3, device=device)
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
