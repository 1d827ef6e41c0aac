"""Pipeline-parallel LM training (counterpart of ``examples/pipeline/train.py``).

    python3 -m bigdl_tpu_torch.examples.pipeline_train --n-stages 4 --dp 2 [--platform cpu]

A block-stack LM on the planted-bigram stream (``--synthetic-size`` tokens,
40000 by default): ``LookupTable(V, H)``, ``PipelinedBlocks`` of
``--n-stages`` pre-norm position-wise residual blocks (``LayerNormalization``
-> ``FeedForwardNetwork(H, 4·H)`` -> add, a ``Graph``), a final
``LayerNormalization`` and ``Linear(H, V)``, trained through
``LocalOptimizer`` with ``Adam(3e-3)`` and
``TimeDistributedCriterion(CrossEntropyCriterion(), size_average=True)``.
As in the JAX main the stack runs the GPipe schedule on a ``('data',
'pipe')`` mesh of ``--dp`` x ``--n-stages`` ranks, each data row its own
pipeline (``batch_axis="data"`` when ``--dp`` > 1), ``--n-micro``
microbatches a data row: run as it is, the main spawns the ranks
(``_common.mesh_ranks``; on the card they share it over gloo), each
running the replicated program. It ends with the bigram map's recovery on
one probe sequence in eval mode (one row does not fill the microbatch
grid: the stack takes its sequential path, as in the JAX main).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from ._common import Run, base_parser, device_of, finish, mesh_ranks, setup_logging

MODULE = "bigdl_tpu_torch.examples.pipeline_train"


def parser():
    p = base_parser("Pipeline-parallel LM (dp x pp on a device mesh)", batch_size=32)
    p.add_argument("--vocab-size", type=int, default=64)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--hidden-size", type=int, default=32)
    p.add_argument("--n-stages", type=int, default=4,
                   help="pipeline stages (= 'pipe' mesh-axis size)")
    p.add_argument("--dp", type=int, default=2,
                   help="data-parallel width (= 'data' mesh-axis size)")
    p.add_argument("--n-micro", type=int, default=None,
                   help="GPipe microbatches per dp shard (default n_stages)")
    return p


def block(hidden: int, device=None):
    """Pre-norm position-wise residual block (shape-preserving, stateless)."""
    from .. import nn

    inp = nn.Input()
    ln = nn.LayerNormalization(hidden, device=device).inputs(inp)
    ffn = nn.FeedForwardNetwork(hidden, filter_size=4 * hidden, device=device).inputs(ln)
    add = nn.CAddTable(device=device).inputs(inp, ffn)
    return nn.Graph(inp, add, device=device)


def build(args, mesh=None) -> Run:
    """The model, data, criterion, method and triggers, ready to
    ``optimizer.optimize()`` (the GPipe schedule on ``mesh`` when given)."""
    from .. import nn
    from ..dataset import DataSet
    from ..optim import Adam, LocalOptimizer, Trigger
    from ..utils.random import RandomGenerator
    from .transformer_train import planted_bigram_ids

    device = device_of(args, distributed=True)
    RandomGenerator.set_seed(42)
    v, t, h = args.vocab_size, args.seq_len, args.hidden_size
    ids = planted_bigram_ids(args.synthetic_size or 40000, v)
    n_seq = (len(ids) - 1) // t
    x = ids[:n_seq * t].reshape(n_seq, t)
    y = ids[1:n_seq * t + 1].reshape(n_seq, t)
    blocks = nn.PipelinedBlocks(block(h, device), args.n_stages, n_micro=args.n_micro,
                                pipeline_parallel=mesh is not None, mesh_axis="pipe",
                                batch_axis="data" if args.dp > 1 else None,
                                device=device).set_mesh(mesh)
    model = nn.Sequential(nn.LookupTable(v, h, device=device), blocks,
                          nn.LayerNormalization(h, device=device), nn.Linear(h, v, device=device),
                          device=device)
    criterion = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(), size_average=True)
    opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=args.batch_size), criterion)
    opt.set_optim_method(Adam(learningrate=3e-3))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    return Run(opt, model, args)


def probe_recovery(model, vocab: int):
    """The share of the probe (every id from 2 once) whose eval-mode argmax
    is the planted successor; ``(share, hits, length)``."""
    import numpy as np
    import torch

    probe = np.arange(2, vocab, dtype=np.int32)[None, :]
    model.evaluate()
    with torch.no_grad():
        pred = model.forward(probe).float().argmax(-1)[0].cpu().numpy()
    want = (3 * probe[0] + 1) % (vocab - 2) + 2
    hits = int((pred == want).sum())
    return hits / len(want), hits, len(want)


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None), train on the
    ``--dp`` x ``--n-stages`` mesh, then print the bigram map's recovery.
    Outside a group the ranks are spawned and the returned ``Run`` holds
    their summaries (``results["ranks"]``)."""
    from ..parallel import make_mesh

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    setup_logging()
    ranks = mesh_ranks(MODULE, argv, args, args.dp * args.n_stages)
    if ranks is not None:
        share = ranks[0]["results"]["bigram_recovery"]
        print(f"bigram-map recovery: {share:.3f} (rank 0 of {len(ranks)})")
        return Run(None, None, args, results={"bigram_recovery": share, "ranks": ranks})
    run = build(args, make_mesh({"data": args.dp, "pipe": args.n_stages}))
    run.model = run.optimizer.optimize()
    share, hits, n = probe_recovery(run.model, args.vocab_size)
    run.results["bigram_recovery"] = share
    print(f"bigram-map recovery: {share:.3f} ({hits}/{n} tokens)")
    finish(run.model, args, run.optimizer)
    return run


if __name__ == "__main__":
    main()
