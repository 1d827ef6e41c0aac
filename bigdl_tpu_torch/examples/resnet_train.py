"""The ResNet training mains (counterpart of ``examples/resnet/train.py``;
reference: ``$DL/models/resnet/TrainImageNet.scala`` and the CIFAR-10
``Train.scala``), trained through ``DistriOptimizer`` as the JAX main is.

    python3 -m bigdl_tpu_torch.examples.resnet_train --dataset imagenet --depth 50 \\
        --warmup-epochs 5 --label-smoothing 0.1 --lr-schedule multistep

The recipe: ResNet-``depth`` (conv7 or space-to-depth stem), linear warmup
to the base rate over ``--warmup-epochs``, then MultiStep at epochs 30, 60
and 80 (gamma 0.1) or Poly(2.0) to the last epoch; label-smoothed
``CrossEntropyCriterion``; nesterov SGD (momentum 0.9, dampening 0) with
weight decay, BN parameters and biases excluded (``("_bn", "bias")``)
unless ``--no-wd-exclusions``; Top-1 and Top-5 validated every epoch and
once more after training. It trains through ``DistriOptimizer``
(``--parameter-sync``, sharded by default) on one card, on ``--n-devices N``
ranks (``_common.run_ranks``, or torchrun), or on the CPU with
``--platform cpu``; the global batch ``-b`` divides into the ranks.

``--dataset cifar10`` (the default, as in the JAX main): ResNet-``depth``
(6n+2) for CIFAR-10 with a log-softmax head, ``ClassNLLCriterion``,
nesterov SGD (momentum 0.9, weight decay 1e-4) with MultiStep at epochs 80
and 120 (gamma 0.1), Top-1 every epoch; data from ``load_cifar10``
(synthetic without ``--data-dir``).

Data: with ``--data-dir``, the record shards there (``BDLSHRD1`` files of
``write_record_shards``, each record a size x size x 3 uint8 image and its
label; the files without a valid shard header are passed over, as the JAX
recipe does, and a directory without any stops the run), decoded by a
``ShardedRecordDataSet`` 's threads as the JAX recipe decodes them
(``(x / 255 - 0.449) / 0.226``, CHW) and batched by a ``DataPipeline`` of
four workers, with no validation set. Without it, synthetic, as the JAX
recipe draws it (``default_rng(0)``: N standard normal images of 3 x size x
size and labels in [0, class_num); the first ``max(batch, N // 4)`` records
are the validation set), N = ``--synthetic-size`` (1024 by default).

    python3 -m bigdl_tpu_torch.examples.resnet_train --dataset imagenet --depth 50 \\
        --data-dir /path/to/shards --max-epoch 1

Kept from the TPU era: bf16 activations (``--act-dtype bfloat16``, the
default) are set when the recipe runs on an accelerator, which for the port
is the card (the JAX recipe sets them when its engine is the TPU); on the
CPU the activations stay f32.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from ._common import base_parser, device_of, finish, join_from_env, run_ranks, setup_logging

MODULE = "bigdl_tpu_torch.examples.resnet_train"
PIPELINE_WORKERS = 4  # the DataPipeline's batch-assembly threads over record shards


def parser() -> argparse.ArgumentParser:
    """The JAX recipe's flags (its ``base_parser`` and the ResNet main's)."""
    p = base_parser("ResNet (CIFAR-10 DistriOptimizer / ImageNet north-star recipe)")
    p.add_argument("--depth", type=int, default=20,
                   help="cifar10: 6n+2; imagenet: 18/34/50/101/152")
    p.add_argument("--dataset", choices=["cifar10", "imagenet"], default="cifar10")
    p.add_argument("--parameter-sync", choices=["sharded", "replicated"], default="sharded",
                   help="DistriOptimizer's: ZeRO-1 sharded update or replicated")
    p.add_argument("--warmup-epochs", type=int, default=5)
    p.add_argument("--lr-schedule", choices=["multistep", "poly"], default="multistep")
    p.add_argument("--label-smoothing", type=float, default=0.1)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--no-wd-exclusions", action="store_true",
                   help="ALSO decay BN gamma/beta and biases (recipe default excludes)")
    p.add_argument("--stem", choices=["conv7", "s2d"], default="conv7")
    p.add_argument("--act-dtype", choices=["float32", "bfloat16"], default="bfloat16",
                   help="activation dtype on the card")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--class-num", type=int, default=1000)
    return p


def build_imagenet_schedule(args, iters_per_epoch: int):
    """Linear warmup to the base rate, then MultiStep [30, 60, 80] epochs or
    Poly(2.0) to ``max_epoch``."""
    from ..optim.schedules import LinearWarmup, MultiStep, Poly

    warmup_iters = args.warmup_epochs * iters_per_epoch
    if args.lr_schedule == "poly":
        main = Poly(2.0, args.max_epoch * iters_per_epoch)
    else:
        main = MultiStep([e * iters_per_epoch for e in (30, 60, 80)], 0.1)
    return LinearWarmup(warmup_iters, main) if warmup_iters else main


def record_shards(data_dir: str) -> List[str]:
    """The files of ``data_dir`` with a valid record shard header, sorted
    (data directories often hold metadata files beside the shards)."""
    import os

    from ..dataset.files import record_shard_count

    shards = []
    for f in sorted(os.listdir(data_dir)):
        p = os.path.join(data_dir, f)
        if not os.path.isfile(p):
            continue
        try:
            record_shard_count(p)
        except (ValueError, OSError):
            continue
        shards.append(p)
    return shards


def load_imagenet(args, n_dev: int = 1):
    """``(train, val, iters_per_epoch)``: the record shards of ``--data-dir``
    through a ``DataPipeline`` (no validation set), else the JAX recipe's
    synthetic draw; the training set divides into ``n_dev`` ranks
    (``DataSet.distributed``)."""
    import numpy as np

    from ..dataset import DataSet, Sample, ShardedRecordDataSet

    size = args.image_size
    if args.data_dir:
        shards = record_shards(args.data_dir)
        if not shards:
            raise SystemExit(f"no record shards in {args.data_dir}")

        def decode(payload, label):
            img = np.frombuffer(payload, np.uint8).reshape(size, size, 3)
            x = (img.astype(np.float32) / 255.0 - 0.449) / 0.226
            return Sample(x.transpose(2, 0, 1), np.int64(label))

        records = ShardedRecordDataSet(shards, decode, batch_size=args.batch_size)
        n = records.size()  # header counts
        return (DataSet.distributed(DataSet.pipeline(records, num_workers=PIPELINE_WORKERS),
                                    n_dev), None, max(1, n // args.batch_size))
    n = args.synthetic_size or 1024
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, 3, size, size)).astype(np.float32)
    y = rng.integers(0, args.class_num, n)
    train = DataSet.distributed(DataSet.array(x, y, batch_size=args.batch_size), n_dev)
    n_val = max(args.batch_size, n // 4)
    val = DataSet.array(x[:n_val], y[:n_val], batch_size=args.batch_size)
    return train, val, max(1, n // args.batch_size)


@dataclass
class Recipe:
    """What :func:`main` trained: the optimizer (its ``history`` holds each
    iteration's loss and learning rate), the model, the validation set (None
    over record shards) and methods, the iterations an epoch and the final
    validation's results."""

    optimizer: Any
    model: Any
    val_dataset: Any
    val_methods: List[Any]
    iters_per_epoch: int
    results: Optional[Dict[str, Any]] = None
    ranks: Optional[List[Dict[str, Any]]] = None  # each spawned rank's summary


def build(args) -> Recipe:
    """The recipe's model, data, criterion, method and triggers, ready to
    ``optimizer.optimize()``, for the process's rank of the group (or alone)."""
    from .. import nn
    from ..models import ResNet
    from ..optim import SGD, Top1Accuracy, Top5Accuracy, Trigger
    from ..optim.schedules import MultiStep
    from ..parallel import DistriOptimizer
    from ..utils.engine import Engine
    from ..utils.random import RandomGenerator

    device = device_of(args, distributed=True)
    n_dev = Engine.device_count()
    if args.batch_size % n_dev:
        raise SystemExit(f"batch size {args.batch_size} not divisible by {n_dev} devices")
    RandomGenerator.set_seed(42)
    if args.dataset == "imagenet":
        if args.act_dtype == "bfloat16" and Engine.device(device).type == "cuda":
            Engine.set_activation_dtype("bfloat16")
        train_ds, val_ds, iters_per_epoch = load_imagenet(args, n_dev)
        model = ResNet(args.depth, class_num=args.class_num, dataset="imagenet",
                       stem=args.stem, device=device)
        criterion = nn.CrossEntropyCriterion(label_smoothing=args.label_smoothing)
        exclude = () if args.no_wd_exclusions else ("_bn", "bias")
        method = SGD(learningrate=args.learning_rate, momentum=0.9, dampening=0.0,
                     weightdecay=args.weight_decay, nesterov=True,
                     leaningrate_schedule=build_imagenet_schedule(args, iters_per_epoch),
                     weightdecay_exclude=exclude)
        val_methods = [Top1Accuracy(), Top5Accuracy()]
    else:
        from ..dataset import DataSet
        from ..dataset.cifar import load_cifar10

        x_train, y_train = load_cifar10(args.data_dir, train=True,
                                        synthetic_size=args.synthetic_size)
        x_val, y_val = load_cifar10(args.data_dir, train=False,
                                    synthetic_size=args.synthetic_size)
        train_ds = DataSet.distributed(
            DataSet.array(x_train, y_train, batch_size=args.batch_size), n_dev)
        val_ds = DataSet.array(x_val, y_val, batch_size=args.batch_size)
        model = ResNet(args.depth, class_num=10, dataset="cifar10", with_log_softmax=True,
                       device=device)
        iters_per_epoch = max(1, len(x_train) // args.batch_size)
        schedule = MultiStep([80 * iters_per_epoch, 120 * iters_per_epoch], 0.1)
        criterion = nn.ClassNLLCriterion()
        method = SGD(learningrate=args.learning_rate, momentum=0.9, dampening=0.0,
                     weightdecay=1e-4, nesterov=True, leaningrate_schedule=schedule)
        val_methods = [Top1Accuracy()]
    opt = DistriOptimizer(model, train_ds, criterion, parameter_sync=args.parameter_sync)
    opt.set_optim_method(method)
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    if val_ds is not None:
        opt.set_validation(Trigger.every_epoch(), val_ds, val_methods)
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    return Recipe(opt, model, val_ds, val_methods, iters_per_epoch)


def main(argv: Optional[Sequence[str]] = None) -> Recipe:
    """Parse ``argv`` (the command line when None), train, validate once
    more and print the results. With ``--n-devices N`` outside a group, the
    N ranks are spawned and the returned ``Recipe`` holds their summaries
    (``ranks``) and rank 0's final results."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    setup_logging()
    if (args.n_devices or 1) > 1 and not join_from_env(args):
        ranks = run_ranks(MODULE, argv, args)
        for name, (value, _) in ranks[0]["results"].items():
            print(f"{name}: {value:.4f}")
        return Recipe(None, None, None, [], 0, results=ranks[0]["results"], ranks=ranks)
    recipe = build(args)
    model = recipe.optimizer.optimize()
    if recipe.val_dataset is not None:
        recipe.results = model.evaluate(recipe.val_dataset, recipe.val_methods)
        for name, r in recipe.results.items():
            print(f"{name}: {r.result()[0]:.4f}")
    finish(model, args, recipe.optimizer)
    return recipe


if __name__ == "__main__":
    main()
