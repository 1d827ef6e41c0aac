"""VGG on CIFAR-10 through DistriOptimizer (counterpart of
``examples/vgg/train.py``; reference: ``$DL/models/vgg/Train.scala``),
BASELINE config 2: ``VggForCifar10(10)`` (VGG-16's conv stacks with BN and
a 512-wide head), ``ClassNLLCriterion``, SGD at ``--learning-rate`` with
momentum 0.9 and weight decay 5e-4, Top-1 every epoch and once more after
training, a checkpoint every epoch with ``--checkpoint`` and the trained
model written by ``--model-save`` (rank 0's).

    python3 -m bigdl_tpu_torch.examples.vgg_train --max-epoch 1 --synthetic-size 512
    python3 -m bigdl_tpu_torch.examples.vgg_train --n-devices 2 --platform cpu \\
        --synthetic-size 512

Data: CIFAR-10 from ``--data-dir``, else ``load_cifar10`` 's synthetic
images (``--synthetic-size``). One card, ``--n-devices N`` ranks (the
global batch ``-b`` divides into them) or ``--platform cpu``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ._common import Run, base_parser, device_of, finish, join_from_env, run_ranks, setup_logging

MODULE = "bigdl_tpu_torch.examples.vgg_train"


def parser():
    return base_parser("VggForCifar10 on CIFAR-10 (DistriOptimizer)", batch_size=128)


def build(args) -> Run:
    """The model, data, criterion, method and triggers for this process's
    rank, ready to ``optimizer.optimize()``."""
    from .. import nn
    from ..dataset import DataSet
    from ..dataset.cifar import load_cifar10
    from ..models import VggForCifar10
    from ..optim import SGD, Top1Accuracy, Trigger
    from ..parallel import DistriOptimizer
    from ..utils.engine import Engine
    from ..utils.random import RandomGenerator

    device = device_of(args, distributed=True)
    RandomGenerator.set_seed(42)
    n_dev = Engine.device_count()
    x_train, y_train = load_cifar10(args.data_dir, train=True, synthetic_size=args.synthetic_size)
    x_val, y_val = load_cifar10(args.data_dir, train=False, synthetic_size=args.synthetic_size)
    train_ds = DataSet.distributed(DataSet.array(x_train, y_train, batch_size=args.batch_size),
                                   n_dev)
    val_ds = DataSet.array(x_val, y_val, batch_size=args.batch_size)
    model = VggForCifar10(10, device=device)
    opt = DistriOptimizer(model, train_ds, nn.ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=args.learning_rate, momentum=0.9, weightdecay=5e-4))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    opt.set_validation(Trigger.every_epoch(), val_ds, [Top1Accuracy()])
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    return Run(opt, model, args, val_ds)


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None), train, validate once
    more and print Top-1. With ``--n-devices N`` outside a group the N ranks
    are spawned and the returned ``Run`` holds their summaries under
    ``results["ranks"]``."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    setup_logging()
    if (args.n_devices or 1) > 1 and not join_from_env(args):
        ranks = run_ranks(MODULE, argv, args)
        for name, (value, _) in ranks[0]["results"].items():
            print(f"{name}: {value:.4f}")
        return Run(None, None, args, None, results={"ranks": ranks})
    run = build(args)
    model = run.optimizer.optimize()
    run.results = model.evaluate(run.val_dataset, [run.optimizer.validation_methods[0]])
    for name, r in run.results.items():
        print(f"{name}: {r.result()[0]:.4f}")
    finish(model, args, run.optimizer)
    return run


if __name__ == "__main__":
    main()
