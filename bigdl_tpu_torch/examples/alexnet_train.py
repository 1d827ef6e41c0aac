"""AlexNet training on one card (counterpart of ``examples/alexnet/train.py``;
reference: ``$DL/models/alexnet``, the perf benchmark model of the BigDL
paper).

    python3 -m bigdl_tpu_torch.examples.alexnet_train --max-epoch 1 --synthetic-size 640

Data: the JAX main's synthetic 227x227 images (``default_rng(0)``:
``--class-num`` class templates of 3x8x8 drawn from U(-1, 1), each record
its label's template repeated 29x and cropped to 227, plus 0.3 standard
normal noise), ``--synthetic-size`` records (256 by default), the first
``max(batch, 0.75 N)`` for training, the rest for validation. ``AlexNet``
with dropout, ``ClassNLLCriterion``, SGD at ``--learning-rate`` with
momentum 0.9; Top-1 and Top-5 every epoch when the validation set holds a
batch, a checkpoint every epoch with ``--checkpoint``. It runs on the card
(the port's policy there: bf16 products, f32 activations), or on the CPU
with ``--platform cpu``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ._common import Run, base_parser, device_of, finish, setup_logging


def parser():
    p = base_parser("AlexNet (synthetic ImageNet)", batch_size=64)
    p.add_argument("--class-num", type=int, default=1000)
    return p


def synthetic_images(n: int, class_num: int):
    """``(x (n, 3, 227, 227) f32, labels (n,))`` as the JAX main draws them."""
    import numpy as np

    rng = np.random.default_rng(0)
    templates = rng.uniform(-1, 1, (class_num, 3, 8, 8)).astype(np.float32)
    y = rng.integers(0, class_num, n)
    x = np.repeat(np.repeat(templates[y], 29, axis=2), 29, axis=3)[:, :, :227, :227]
    x += 0.3 * rng.standard_normal(x.shape).astype(np.float32)
    return x, y


def build(args) -> Run:
    """The model, data, criterion, method and triggers, ready to
    ``optimizer.optimize()``."""
    from .. import nn
    from ..dataset import DataSet
    from ..models import AlexNet
    from ..optim import SGD, LocalOptimizer, Top1Accuracy, Top5Accuracy, Trigger
    from ..utils.random import RandomGenerator

    device = device_of(args)
    RandomGenerator.set_seed(42)
    x, y = synthetic_images(args.synthetic_size or 256, args.class_num)
    split = max(args.batch_size, int(0.75 * len(x)))
    train_ds = DataSet.array(x[:split], y[:split], batch_size=args.batch_size)
    val_ds = DataSet.array(x[split:], y[split:], batch_size=args.batch_size)
    model = AlexNet(args.class_num, device=device)
    opt = LocalOptimizer(model, train_ds, nn.ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=args.learning_rate, momentum=0.9))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    run = Run(opt, model, args)
    if len(x) - split >= args.batch_size:
        opt.set_validation(Trigger.every_epoch(), val_ds, [Top1Accuracy(), Top5Accuracy()])
        run.val_dataset = val_ds
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    return run


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None) and train."""
    args = parser().parse_args(argv)
    setup_logging()
    run = build(args)
    run.model = run.optimizer.optimize()
    finish(run.model, args, run.optimizer)
    return run


if __name__ == "__main__":
    main()
