"""Expert-parallel mixture-of-experts LM training (counterpart of
``examples/moe/train.py``).

    python3 -m bigdl_tpu_torch.examples.moe_train --n-experts 4 [--platform cpu]

A position-wise LM on the planted-bigram stream (``--synthetic-size``
tokens, 40000 by default; token t is followed by (3t + 1) mod (V - 2) + 2,
or with probability 0.15 a uniform draw), so a per-token model can recover
the map: ``LookupTable(V, H)`` -> ``LayerNormalization`` -> ``MoE``
(``--n-experts``, FFN 4·H, ``--capacity-factor``, ``--router-top-k``) added
back to the embedding -> ``LayerNormalization`` -> ``Linear(H, V)``, trained
through ``LocalOptimizer`` with ``Adam(3e-3)`` (``--learning-rate`` is not
used, as in the JAX main) and
``TimeDistributedCriterion(CrossEntropyCriterion(), size_average=True)``;
the router's load-balancing loss joins the objective. It ends with the
map's recovery on one probe sequence in eval mode.

As in the JAX main the MoE runs expert-parallel (``expert_parallel=True``,
one expert a rank on an ``expert`` mesh of ``--n-experts`` ranks, two
all-to-all hops a layer): run as it is, the main spawns the ranks
(``_common.mesh_ranks``; on the card they share it over gloo), and each
rank runs the JAX main's replicated ``LocalOptimizer`` program on the
mesh. ``build(args)`` without a mesh gives the same model on the layer's
dense path (the same capacity and routing).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from ._common import Run, base_parser, device_of, finish, mesh_ranks, setup_logging

MODULE = "bigdl_tpu_torch.examples.moe_train"


def parser():
    p = base_parser("Expert-parallel MoE LM", batch_size=32)
    p.add_argument("--vocab-size", type=int, default=64)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--hidden-size", type=int, default=32)
    p.add_argument("--n-experts", type=int, default=4, help="expert count")
    p.add_argument("--capacity-factor", type=float, default=1.5)
    p.add_argument("--router-top-k", type=int, default=1,
                   help="1 = switch routing, 2 = GShard top-2")
    return p


def moe_lm(vocab: int, hidden: int, n_experts: int, capacity_factor: float, top_k: int,
           device=None, mesh=None):
    """embed -> LN -> MoE FFN (residual) -> LN -> head, as a ``Graph``; the
    MoE expert-parallel on ``mesh`` when given."""
    from .. import nn

    inp = nn.Input()
    emb = nn.LookupTable(vocab, hidden, device=device).inputs(inp)
    ln1 = nn.LayerNormalization(hidden, device=device).inputs(emb)
    moe = nn.MoE(n_experts, ffn_size=4 * hidden, capacity_factor=capacity_factor,
                 router_top_k=top_k, expert_parallel=mesh is not None,
                 device=device).set_name("moe").set_mesh(mesh).inputs(ln1)
    res = nn.CAddTable(device=device).inputs(emb, moe)
    ln2 = nn.LayerNormalization(hidden, device=device).inputs(res)
    head = nn.Linear(hidden, vocab, device=device).inputs(ln2)
    return nn.Graph(inp, head, device=device)


def build(args, mesh=None) -> Run:
    """The model, data, criterion, method and triggers, ready to
    ``optimizer.optimize()`` (expert-parallel on ``mesh`` when given)."""
    from .. import nn
    from ..dataset import DataSet
    from ..optim import Adam, LocalOptimizer, Trigger
    from ..utils.random import RandomGenerator
    from .transformer_train import planted_bigram_ids

    device = device_of(args, distributed=True)
    RandomGenerator.set_seed(42)
    v, t = args.vocab_size, args.seq_len
    ids = planted_bigram_ids(args.synthetic_size or 40000, v)
    n_seq = (len(ids) - 1) // t
    x = ids[:n_seq * t].reshape(n_seq, t)
    y = ids[1:n_seq * t + 1].reshape(n_seq, t)
    model = moe_lm(v, args.hidden_size, args.n_experts, args.capacity_factor,
                   args.router_top_k, device=device, mesh=mesh)
    criterion = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion(), size_average=True)
    opt = LocalOptimizer(model, DataSet.array(x, y, batch_size=args.batch_size), criterion)
    opt.set_optim_method(Adam(learningrate=3e-3))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    return Run(opt, model, args)


def probe_recovery(model, vocab: int, n_experts: int):
    """The share of a probe sequence (every id from 2, as many as a
    multiple of the expert count) whose eval-mode argmax is the planted
    successor; ``(share, hits, length)``."""
    import numpy as np
    import torch

    n = ((vocab - 2) // n_experts) * n_experts
    probe = np.arange(2, 2 + n, dtype=np.int32)[None, :]
    model.evaluate()
    with torch.no_grad():
        pred = model.forward(probe).float().argmax(-1)[0].cpu().numpy()
    want = (3 * probe[0] + 1) % (vocab - 2) + 2
    hits = int((pred == want).sum())
    return hits / n, hits, n


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None), train on the
    ``--n-experts`` ranks of an ``expert`` mesh, then print the bigram
    map's recovery on the probe. Outside a group the ranks are spawned and
    the returned ``Run`` holds their summaries (``results["ranks"]``)."""
    from ..parallel import make_mesh

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    setup_logging()
    ranks = mesh_ranks(MODULE, argv, args, args.n_experts)
    if ranks is not None:
        share = ranks[0]["results"]["bigram_recovery"]
        print(f"bigram-map recovery: {share:.3f} (rank 0 of {len(ranks)})")
        return Run(None, None, args, results={"bigram_recovery": share, "ranks": ranks})
    run = build(args, make_mesh({"expert": args.n_experts}))
    run.model = run.optimizer.optimize()
    share, hits, n = probe_recovery(run.model, args.vocab_size, args.n_experts)
    run.results["bigram_recovery"] = share
    print(f"bigram-map recovery: {share:.3f} ({hits}/{n} tokens)")
    finish(run.model, args, run.optimizer)
    return run


if __name__ == "__main__":
    main()
