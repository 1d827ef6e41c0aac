"""Inception-v1 training on one card (counterpart of
``examples/inception/train.py``, which trains through ``DistriOptimizer``;
reference: ``$DL/models/inception/Train.scala``).

    python3 -m bigdl_tpu_torch.examples.inception_train --max-epoch 1 --synthetic-size 256

Data: synthetic, as the JAX main draws it (``default_rng(0)``: N standard
normal images of 3 x size x size and int32 labels in [0, class_num)), N =
``max(--synthetic-size or 256, batch)``; the first ``4 * batch`` records are
evaluated after training. ``Inception_v1(--class-num)``,
``ClassNLLCriterion``, SGD at ``--learning-rate`` with momentum 0.9, a
checkpoint every epoch with ``--checkpoint``. It trains through
``LocalOptimizer`` on one card (``--n-devices`` above 1 raises), or on the
CPU with ``--platform cpu``. The JAX main's raise of a small per-device
batch to 8 works around a TPU compiler fault and has no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ._common import Run, base_parser, device_of, finish, setup_logging


def parser():
    p = base_parser("Inception-v1 (Graph/Concat) on synthetic ImageNet", batch_size=32)
    p.add_argument("--class-num", type=int, default=1000)
    p.add_argument("--image-size", type=int, default=224,
                   help="must be >= 224 (the stem + pool5/7x7 geometry)")
    return p


def build(args) -> Run:
    """The model, data, criterion, method and triggers, ready to
    ``optimizer.optimize()``."""
    import numpy as np

    from .. import nn
    from ..dataset import DataSet
    from ..models import Inception_v1
    from ..optim import SGD, LocalOptimizer, Trigger
    from ..utils.random import RandomGenerator

    if args.image_size < 224:
        raise SystemExit("Inception-v1 needs --image-size >= 224 (7x7 final pool)")
    device = device_of(args)
    RandomGenerator.set_seed(42)
    n = max(args.synthetic_size or 256, args.batch_size)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 3, args.image_size, args.image_size)).astype(np.float32)
    y = rng.integers(0, args.class_num, n).astype(np.int32)
    train_ds = DataSet.array(x, y, batch_size=args.batch_size)
    model = Inception_v1(args.class_num, device=device)
    opt = LocalOptimizer(model, train_ds, nn.ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=args.learning_rate, momentum=0.9))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    val_ds = DataSet.array(x[: 4 * args.batch_size], y[: 4 * args.batch_size],
                           batch_size=args.batch_size)
    return Run(opt, model, args, val_ds)


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None), train, evaluate Top-1
    on the first records and print it."""
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
