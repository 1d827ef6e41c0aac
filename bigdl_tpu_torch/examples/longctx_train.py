"""Long-context LM training with ring-attention sequence parallelism
(counterpart of ``examples/longctx/train.py``).

    python3 -m bigdl_tpu_torch.examples.longctx_train --sp 8 [--platform cpu]

One registration, ``Engine.set_sequence_parallel(mesh, "sp")``, and the
unmodified ``nn.Transformer`` LM (vocab ``--vocab-size``, hidden
``--hidden-size``, 2 heads, filter 4·H, 1 layer, no dropout) trains with its
attention running as a ring over the ``--sp`` ranks of the mesh, each
holding ``--seq-len`` / ``--sp`` positions of every sequence, through
``LocalOptimizer`` with ``Adam(3e-3)`` on the planted-bigram stream. Run as
it is, the main spawns the ranks (``_common.mesh_ranks``; on the card they
share it over gloo), each running the JAX main's replicated program. The
registration is cleared before the bigram map's recovery is read on one
probe sequence in eval mode.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from ._common import Run, base_parser, device_of, finish, mesh_ranks, setup_logging

MODULE = "bigdl_tpu_torch.examples.longctx_train"


def parser():
    p = base_parser("Long-context LM (ring-attention sp on a device mesh)", batch_size=32)
    p.add_argument("--vocab-size", type=int, default=64)
    p.add_argument("--seq-len", type=int, default=64,
                   help="context length (must be divisible by --sp)")
    p.add_argument("--hidden-size", type=int, default=32)
    p.add_argument("--sp", type=int, default=8,
                   help="sequence-parallel width (= 'sp' mesh-axis size)")
    return p


def build(args) -> Run:
    """The model, data, criterion, method and triggers, ready to
    ``optimizer.optimize()``."""
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
    model = nn.Transformer(vocab_size=v, hidden_size=h, num_heads=2, filter_size=4 * h,
                           num_hidden_layers=1, postprocess_dropout=0.0,
                           attention_dropout=0.0, relu_dropout=0.0, mode="lm",
                           with_lm_head=True, device=device)
    criterion = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(), size_average=True)
    opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=args.batch_size), criterion)
    opt.set_optim_method(Adam(learningrate=3e-3))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    return Run(opt, model, args)


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None), train with the ring
    over ``--sp`` ranks, then print the bigram map's recovery. Outside a
    group the ranks are spawned and the returned ``Run`` holds their
    summaries (``results["ranks"]``)."""
    from ..parallel import make_mesh
    from ..utils.engine import Engine
    from .pipeline_train import probe_recovery

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    setup_logging()
    if args.seq_len % args.sp:
        raise SystemExit(f"--seq-len {args.seq_len} must be divisible by --sp {args.sp}")
    ranks = mesh_ranks(MODULE, argv, args, args.sp)
    if ranks is not None:
        share = ranks[0]["results"]["bigram_recovery"]
        print(f"bigram-map recovery: {share:.3f} (rank 0 of {len(ranks)})")
        return Run(None, None, args, results={"bigram_recovery": share, "ranks": ranks})
    Engine.set_sequence_parallel(make_mesh({"sp": args.sp}), "sp")
    try:
        run = build(args)
        run.model = run.optimizer.optimize()
    finally:
        Engine.set_sequence_parallel(None)
    share, hits, n = probe_recovery(run.model, args.vocab_size)
    run.results["bigram_recovery"] = share
    print(f"bigram-map recovery: {share:.3f} ({hits}/{n} tokens)")
    finish(run.model, args, run.optimizer)
    return run


if __name__ == "__main__":
    main()
