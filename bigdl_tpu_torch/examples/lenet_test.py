"""LeNet-5 evaluation on MNIST on one card (counterpart of
``examples/lenet/test.py``; reference: ``$DL/models/lenet/Test.scala``).

    python3 -m bigdl_tpu_torch.examples.lenet_test --model lenet.bin

Loads the model that ``lenet_train --model-save`` wrote (``nn.load_module``)
onto the card (or the CPU with ``--platform cpu``) and prints Top-1 and
Top-5 over the MNIST test set (``--data-dir``) or ``load_mnist`` 's
synthetic one.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ._common import Run, base_parser, device_of, setup_logging


def parser():
    return base_parser("Evaluate LeNet-5 on MNIST")


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None), load ``--model`` and
    print its Top-1 and Top-5."""
    from .. import nn
    from ..dataset import DataSet
    from ..dataset.mnist import load_mnist
    from ..optim import Top1Accuracy, Top5Accuracy

    args = parser().parse_args(argv)
    setup_logging()
    device = device_of(args)
    if not args.model:
        raise SystemExit("--model <file saved by lenet_train --model-save> is required")
    x_val, y_val = load_mnist(args.data_dir, train=False, synthetic_size=args.synthetic_size)
    val_ds = DataSet.array(x_val, y_val, batch_size=args.batch_size)
    model = nn.load_module(args.model, device=device)
    run = Run(None, model, args, val_ds)
    run.results = model.evaluate(val_ds, [Top1Accuracy(), Top5Accuracy()])
    for name, r in run.results.items():
        print(f"{name}: {r.result()[0]:.4f} (n={r.result()[1]})")
    return run


if __name__ == "__main__":
    main()
