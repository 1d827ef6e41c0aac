"""LeNet-5 training on MNIST on one card (counterpart of
``examples/lenet/train.py``; reference: ``$DL/models/lenet/Train.scala``).

    python3 -m bigdl_tpu_torch.examples.lenet_train --max-epoch 2 --model-save lenet.bin

Data: MNIST from ``--data-dir`` (the idx files), else ``load_mnist`` 's
synthetic digits (``--synthetic-size`` records), normalized as the JAX main
loads them. ``LeNet5(10)``, ``ClassNLLCriterion``, SGD at
``--learning-rate`` with momentum 0.9, Top-1 every epoch and once more
after training; a checkpoint every epoch with ``--checkpoint``,
TensorBoard summaries under ``--summary-dir`` (``TrainSummary`` and
``ValidationSummary`` named ``lenet``: the loss every iteration, Top-1
every epoch), and the trained model written by ``--model-save``
(``nn.load_module`` 's format, what ``lenet_test`` reads). It runs on the card, or on the CPU with
``--platform cpu``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ._common import Run, base_parser, device_of, finish, setup_logging


def parser():
    return base_parser("LeNet-5 on MNIST", batch_size=128)


def build(args) -> Run:
    """The model, data, criterion, method and triggers, ready to
    ``optimizer.optimize()``."""
    from .. import nn
    from ..dataset import DataSet
    from ..dataset.mnist import load_mnist
    from ..models import LeNet5
    from ..optim import SGD, LocalOptimizer, Top1Accuracy, Trigger
    from ..utils.random import RandomGenerator

    device = device_of(args)
    RandomGenerator.set_seed(42)
    x_train, y_train = load_mnist(args.data_dir, train=True, synthetic_size=args.synthetic_size)
    x_val, y_val = load_mnist(args.data_dir, train=False, synthetic_size=args.synthetic_size)
    train_ds = DataSet.array(x_train, y_train, batch_size=args.batch_size)
    val_ds = DataSet.array(x_val, y_val, batch_size=args.batch_size)
    model = LeNet5(10, device=device)
    opt = LocalOptimizer(model, train_ds, nn.ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=args.learning_rate, momentum=0.9))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    opt.set_validation(Trigger.every_epoch(), val_ds, [Top1Accuracy()])
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    if args.summary_dir:
        from ..visualization import TrainSummary, ValidationSummary

        opt.set_train_summary(TrainSummary(args.summary_dir, "lenet"))
        opt.set_val_summary(ValidationSummary(args.summary_dir, "lenet"))
    return Run(opt, model, args, val_ds)


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None), train, validate once
    more, print Top-1 and write the model when asked."""
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
