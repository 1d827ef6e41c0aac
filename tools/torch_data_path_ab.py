#!/usr/bin/env python3
"""Time one checkout's training steps where the host's data path matters, on
one CUDA card.

    python3 tools/torch_data_path_ab.py ROOT LABEL

Imports ``bigdl_tpu_torch`` from the checkout at ROOT (building its kernel
library there) and trains, through ``LocalOptimizer`` on ``DataSet.array``
(bf16 compute and activations, SGD 0.01 momentum 0.9, random weights and
data from a seed), 12 iterations of each workload, printing after LABEL the
median ms a step over iterations 3-11 (the 12th's loss pull holds the end
of the run):

- ``lenet_1``: ``parity_config("lenet")``, its one batch of 512 an epoch
  (``chip_smoke.py`` [11]'s data);
- ``lenet_10``: the same model over 10 batches an epoch;
- ``flagship_3``: ResNet-50 (s2d stem) over 3 batches of 128 an epoch
  ([7]'s data).

Where the checkout has the host library (``bigdl_tpu_torch/native.py``),
each workload also runs with ``gather_rows`` held on numpy's route
(``_GATHER_NATIVE_MIN_BYTES`` raised past the batch), labelled ``+numpy``.
Run two checkouts in turns (a, b, b, a) in one call on one card to compare
them.
"""

import statistics
import sys
import time

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402
from bigdl_tpu_torch import Engine, RandomGenerator  # noqa: E402
from bigdl_tpu_torch.dataset import DataSet  # noqa: E402
from bigdl_tpu_torch.models import flagship_model, parity_config  # noqa: E402
from bigdl_tpu_torch.nn import ClassNLLCriterion  # noqa: E402
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger  # noqa: E402

try:
    from bigdl_tpu_torch import native  # noqa: E402
except ImportError:  # a checkout before the host library
    native = None

ITERS = 12


def lenet(epoch_batches):
    model, x, y, batch = parity_config("lenet", device="cuda")
    return model, np.concatenate([x] * epoch_batches), np.concatenate([y] * epoch_batches), batch


def flagship():
    model, x, y, _ = flagship_model(batch=384, seed=0, stem="s2d", device="cuda")
    return model, x, y, 128


WORKLOADS = {"lenet_1": lambda: lenet(1), "lenet_10": lambda: lenet(10),
             "flagship_3": flagship}


def step_ms(make):
    """The median step of ITERS iterations of a fresh model."""
    RandomGenerator.set_seed(1)
    model, x, y, batch = make()
    model.init(sample_input=x[:batch])
    opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=batch), ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=0.01, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(ITERS))
    opt.optimize()
    torch.cuda.synchronize()
    ms = statistics.median(h["wall_s"] for h in opt.history[2:-1]) * 1e3
    del opt, model
    torch.cuda.empty_cache()
    return ms


Engine.set_compute_dtype("bfloat16")
Engine.set_activation_dtype("bfloat16")
out = []
for name, make in WORKLOADS.items():
    out.append(f"{name} {step_ms(make):.2f}")
    if native is not None:
        threshold = native._GATHER_NATIVE_MIN_BYTES
        native._GATHER_NATIVE_MIN_BYTES = 1 << 62
        try:
            out.append(f"{name}+numpy {step_ms(make):.2f}")
        finally:
            native._GATHER_NATIVE_MIN_BYTES = threshold
print(f"AB {label} ({time.strftime('%H:%M:%S')}): " + ", ".join(out), flush=True)
