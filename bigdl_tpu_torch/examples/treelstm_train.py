"""TreeLSTM sentiment training on one card (counterpart of
``examples/treelstm/train.py``; reference:
``$DL/example/treeLSTMSentiment/Train.scala``).

    python3 -m bigdl_tpu_torch.examples.treelstm_train --max-epoch 3 [--platform cpu]

Synthetic constituency trees whose leaf embeddings carry the label: every
record is the same 7-slot tree (four leaves, two pairs, the root last),
its four leaves drawn around +1 or -1 (N(label · 2 - 1, 0.7²)).
``BinaryTreeLSTM(16, 32)`` and a ``Linear(32, 2)`` head on the last slot's
state train with ``Adam(--learning-rate)`` on the mean negative
log-likelihood, ``--synthetic-size`` trees (512 by default) in shuffled
batches (``-b``, 32), each epoch's order drawn from one numpy generator;
then the accuracy of the root's prediction over all trees is printed.

The head reads ``states[:, -1]``, the root's slot in this encoding, as the
JAX main does; ``optim.TreeNNAccuracy`` scores node 0 of a per-node output,
as the JAX package's does. The two indices differ (ROADMAP Queue 3,
"Reference-side behaviour").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from ._common import base_parser, device_of, setup_logging

D, H, SLOTS = 16, 32, 7


def parser():
    return base_parser("TreeLSTM sentiment on synthetic trees", batch_size=32)


@dataclass
class Run:
    """What :func:`main` did: the tree and head modules, the data, each
    step's loss and host ms, the arguments and the final root accuracy."""

    tree: Any
    head: Any
    x: Any
    children: Any
    labels: Any
    args: Any
    losses: List[float] = field(default_factory=list)
    step_ms: List[float] = field(default_factory=list)
    results: Dict[str, Any] = field(default_factory=dict)


def synthetic_trees(n: int, seed: int = 0):
    """``(labels, x (n, 7, 16), children (n, 7, 2))`` as the JAX main draws
    them, and the numpy generator it goes on drawing the epochs' orders from."""
    import numpy as np

    from ..nn.tree_lstm import encode_tree

    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n)
    x = np.zeros((n, SLOTS, D), np.float32)
    x[:, :4] = rng.standard_normal((n, 4, D)) * 0.7 + (labels * 2 - 1)[:, None, None]
    enc = encode_tree([(-1, -1)] * 4 + [(0, 1), (2, 3), (4, 5)], SLOTS)
    return labels, x, np.tile(enc, (n, 1, 1)), rng


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None), train, print each
    epoch's last loss and the root accuracy."""
    import time

    import numpy as np
    import torch

    from .. import nn
    from ..optim import Adam
    from ..utils.random import RandomGenerator
    from ..utils.table import T

    args = parser().parse_args(argv)
    setup_logging()
    device = device_of(args)
    RandomGenerator.set_seed(1)
    n = args.synthetic_size or 512
    labels, x, children, rng = synthetic_trees(n)
    tree = nn.BinaryTreeLSTM(D, H, device=device)
    head = nn.Linear(H, 2, device=device)
    tree.init(sample_input=T(x[:8], children[:8]))
    head.init(sample_input=np.zeros((8, H), np.float32))
    run = Run(tree, head, x, children, labels, args)
    params = {"tree": tree.get_parameters(), "head": head.get_parameters()}
    method = Adam(learningrate=args.learning_rate)
    slots = method.init_slots(params)
    dev = tree.device
    b, it = args.batch_size, 0
    for epoch in range(args.max_epoch):
        perm = rng.permutation(n)
        for lo in range(0, n - b + 1, b):
            idx = perm[lo:lo + b]
            it += 1
            t0 = time.perf_counter()
            xb = torch.from_numpy(x[idx]).to(dev)
            cb = torch.from_numpy(children[idx]).to(dev)
            yb = torch.from_numpy(labels[idx]).to(dev)
            states, _ = tree.apply(params["tree"], tree.get_state(), T(xb, cb), training=True)
            logits, _ = head.apply(params["head"], head.get_state(), states[:, -1],
                                   training=True)
            logp = torch.log_softmax(logits.float(), -1)
            loss = -logp[torch.arange(b, device=dev), yb].mean()
            leaves = list(tree.parameters()) + list(head.parameters())
            grads = torch.autograd.grad(loss, leaves)
            g = {"tree": dict(zip(params["tree"], grads[:len(params["tree"])])),
                 "head": dict(zip(params["head"], grads[len(params["tree"]):]))}
            with torch.no_grad():
                method.update(g, params, slots, args.learning_rate, it)
            run.losses.append(float(loss.detach()))
            run.step_ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[Epoch {epoch + 1}] loss is {run.losses[-1]:.4f}")
    with torch.no_grad():
        states, _ = tree.apply(params["tree"], tree.get_state(),
                               T(torch.from_numpy(x).to(dev), torch.from_numpy(children).to(dev)))
        logits, _ = head.apply(params["head"], head.get_state(), states[:, -1])
    acc = float((logits.float().argmax(1).cpu().numpy() == labels).mean())
    run.results["root_accuracy"] = acc
    print(f"root accuracy (TreeNNAccuracy semantics): {acc:.3f}")
    return run


if __name__ == "__main__":
    main()
