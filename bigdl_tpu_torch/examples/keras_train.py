"""The keras-style API's training main on one card (counterpart of
``examples/keras/train.py``; reference: the ``$PY/nn/keras`` user flow).

    python3 -m bigdl_tpu_torch.examples.keras_train --max-epoch 2 [--platform cpu]

A small CNN built with the keras-1.2.2-style API (``cnn``: two 5x5
``Convolution2D`` + ``MaxPooling2D`` blocks of 8 and 16 filters, ``Flatten``,
``Dense(64, relu)``, ``Dropout(0.25)``, ``Dense(10)``) is compiled with
``SGD(--learning-rate)``, ``sparse_categorical_crossentropy`` and
``accuracy``, and ``fit`` on ``load_mnist(--data-dir)`` (the idx files, or
``--synthetic-size`` synthetic digits, 2048 by default) in batches of
``-b`` (64), validating on the first 512 records at each epoch's end; then
``evaluate`` on those 512 prints ``[loss, accuracy]``. It runs on the card,
or on the CPU with ``--platform cpu``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ._common import Run, base_parser, device_of, finish, setup_logging

VALIDATION = 512


def parser():
    return base_parser("keras-style CNN on synthetic MNIST", batch_size=64)


def cnn(K, dropout: float = 0.25, **d):
    """The example's model, built from the keras module ``K`` (each layer
    given ``d``, e.g. ``device="cpu"``)."""
    model = K.Sequential(**d)
    model.add(K.Convolution2D(8, 5, 5, activation="relu", input_shape=(1, 28, 28), **d))
    model.add(K.MaxPooling2D(**d))
    model.add(K.Convolution2D(16, 5, 5, activation="relu", **d))
    model.add(K.MaxPooling2D(**d))
    model.add(K.Flatten(**d))
    model.add(K.Dense(64, activation="relu", **d))
    model.add(K.Dropout(dropout, **d))
    model.add(K.Dense(10, **d))
    return model


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None), fit, then print the
    validation loss and accuracy. The returned ``Run`` holds the optimizer
    ``fit`` used (its ``history``), the model and ``results["validation"]``."""
    from ..dataset import load_mnist
    from ..nn import keras as K
    from ..optim import SGD
    from ..utils.random import RandomGenerator

    args = parser().parse_args(argv)
    device = device_of(args)
    setup_logging()
    RandomGenerator.set_seed(1)
    x, y = load_mnist(args.data_dir, train=True, synthetic_size=args.synthetic_size or 2048)
    model = cnn(K, device=device)
    model.compile(optimizer=SGD(learningrate=args.learning_rate),
                  loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    model.fit(x, y, batch_size=args.batch_size, nb_epoch=args.max_epoch,
              validation_data=(x[:VALIDATION], y[:VALIDATION]))
    acc = model.evaluate(x[:VALIDATION], y[:VALIDATION])
    print(f"final validation: {acc}")
    finish(model, args)
    return Run(model.last_optimizer, model, args, results={"validation": acc})


if __name__ == "__main__":
    main()
