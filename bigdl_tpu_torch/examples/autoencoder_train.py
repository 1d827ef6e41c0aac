"""The MNIST autoencoder's training on one card (counterpart of
``examples/autoencoder/train.py``; reference:
``$DL/models/autoencoder/Train.scala``).

    python3 -m bigdl_tpu_torch.examples.autoencoder_train --max-epoch 3

Data: ``load_mnist(--data-dir, train=True, normalize=False)``, the idx
files or ``--synthetic-size`` synthetic digits (4096 by default), each
image its own (784,) float target. ``Autoencoder(class_num=32)``,
``MSECriterion``, ``Adam`` at ``--learning-rate``, a checkpoint every epoch
with ``--checkpoint``; then the reconstruction MSE of the first 256 images
beside their variance. It runs on the card, or on the CPU with
``--platform cpu``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ._common import Run, base_parser, device_of, finish, setup_logging


def parser():
    return base_parser("FC autoencoder on MNIST", batch_size=128)


def build(args):
    """``(run, (x, targets))``: the model, data, criterion, method and
    triggers, ready to ``optimizer.optimize()``, and the images."""
    import numpy as np

    from .. import nn
    from ..dataset import DataSet, load_mnist
    from ..models import Autoencoder
    from ..optim import Adam, LocalOptimizer, Trigger
    from ..utils.random import RandomGenerator

    device = device_of(args)
    RandomGenerator.set_seed(1)
    x, _ = load_mnist(args.data_dir, train=True, normalize=False,
                      synthetic_size=args.synthetic_size or 4096)
    targets = np.asarray(x, np.float32).reshape(len(x), 784)
    model = Autoencoder(class_num=32, device=device)
    opt = LocalOptimizer(model, DataSet.array(x, targets, batch_size=args.batch_size),
                         nn.MSECriterion())
    opt.set_optim_method(Adam(learningrate=args.learning_rate))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    return Run(opt, model, args), (x, targets)


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None), train, then print the
    reconstruction MSE of 256 images."""
    import torch

    args = parser().parse_args(argv)
    setup_logging()
    run, (x, targets) = build(args)
    run.model = run.optimizer.optimize()
    with torch.no_grad():
        recon = run.model.forward(x[:256]).reshape(-1, 784).float().cpu().numpy()
    run.results["mse"] = float(((recon - targets[:256]) ** 2).mean())
    run.results["variance"] = float(targets[:256].var())
    print(f"reconstruction MSE on 256 samples: {run.results['mse']:.4f} "
          f"(data variance {run.results['variance']:.4f})")
    finish(run.model, args, run.optimizer)
    return run


if __name__ == "__main__":
    main()
