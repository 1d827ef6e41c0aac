"""NCF (NeuMF) recommender training on one card (counterpart of
``examples/ncf/train.py``; reference: the BigDL paper's NCF/MovieLens
benchmark).

    python3 -m bigdl_tpu_torch.examples.ncf_train --max-epoch 5

Data: ``load_movielens(--data-dir, n, seed=0)``: an ml-1m ``ratings.dat``
in full, or the synthetic log of ``--synthetic-size`` positives (4096 by
default) with one sampled negative each; the first 80% of the shuffled
records for training. ``NeuralCF`` (2 classes, embeddings ``--embed-dim``,
MLP 4/2/1 x ``--embed-dim``, GMF ``--mf-embed``), ``ClassNLLCriterion``,
``Adam(1e-3)`` (``--learning-rate`` is parsed and, as in the JAX main, not
used), Top-1 every epoch and once more after training. Then the NCF
recipe's ranking evaluation: each of the first 64 held-out positives
scored against 20 items its user never rated (sampled from
``default_rng(99)``, a group dropped when 1000 draws find too few),
HitRatio@10 and NDCG@10 over the groups. It runs on the card, or on the CPU
with ``--platform cpu``.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ._common import Run, base_parser, device_of, finish, setup_logging

NEG_NUM = 20


def parser():
    p = base_parser("NCF / NeuMF on (synthetic) MovieLens", batch_size=128)
    p.add_argument("--embed-dim", type=int, default=16)
    p.add_argument("--mf-embed", type=int, default=16)
    return p


def build(args):
    """``(run, (x, y, split, item_count))``: the model, data, criterion,
    method and triggers, ready to ``optimizer.optimize()``, and the records
    the ranking evaluation samples from."""
    from .. import nn
    from ..dataset import DataSet, load_movielens
    from ..models import NeuralCF
    from ..optim import Adam, LocalOptimizer, Top1Accuracy, Trigger
    from ..utils.random import RandomGenerator

    device = device_of(args)
    RandomGenerator.set_seed(42)
    # --synthetic-size sizes the generated log only; a real ratings.dat is
    # used in full (n=None: all rows)
    n = None if args.data_dir else (args.synthetic_size or 4096)
    x, y, user_count, item_count = load_movielens(args.data_dir, n=n, seed=0)
    split = int(0.8 * len(x))
    train_ds = DataSet.array(x[:split], y[:split], batch_size=args.batch_size)
    val_ds = DataSet.array(x[split:], y[split:], batch_size=args.batch_size)
    e = args.embed_dim
    model = NeuralCF(user_count, item_count, class_num=2, user_embed=e, item_embed=e,
                     hidden_layers=(4 * e, 2 * e, e), mf_embed=args.mf_embed, device=device)
    opt = LocalOptimizer(model, train_ds, nn.ClassNLLCriterion())
    opt.set_optim_method(Adam(learningrate=1e-3))
    opt.set_end_when(Trigger.max_epoch(args.max_epoch))
    opt.set_validation(Trigger.every_epoch(), val_ds, [Top1Accuracy()])
    if args.checkpoint:
        opt.set_checkpoint(args.checkpoint, Trigger.every_epoch())
    return Run(opt, model, args, val_ds), (x, y, split, item_count)


def ranking_groups(x, y, split: int, item_count: int, neg_num: int = NEG_NUM):
    """The ranking evaluation's rows: each of the first 64 held-out
    positives, then ``neg_num`` (user, item) pairs never seen (in the log
    or earlier in the groups) drawn from ``default_rng(99)``; a group whose
    1000-odd draws find too few is dropped, so every group has
    ``neg_num + 1`` rows."""
    import numpy as np

    rng = np.random.default_rng(99)
    seen = set(map(tuple, x.tolist()))
    rows = []
    for u, it in x[split:][y[split:] == 1][:64]:
        rows.append([u, it])
        negs, attempts, max_attempts = 0, 0, 50 * neg_num
        while negs < neg_num and attempts < max_attempts:
            attempts += 1
            cand = (int(u), int(rng.integers(1, item_count + 1)))
            if cand not in seen:
                rows.append(list(cand))
                seen.add(cand)
                negs += 1
        if negs < neg_num:
            del rows[-(negs + 1):]
    return np.asarray(rows, np.int64).reshape(-1, 2)


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None), train, print Top-1, then
    HitRatio@10 and NDCG@10 of the ranking evaluation."""
    import torch

    from ..optim import NDCG, HitRatio, Top1Accuracy

    args = parser().parse_args(argv)
    setup_logging()
    run, (x, y, split, item_count) = build(args)
    run.model = run.optimizer.optimize()
    for name, r in run.model.evaluate(run.val_dataset, [Top1Accuracy()]).items():
        run.results[name] = r.result()[0]
        print(f"{name}: {run.results[name]:.4f}")
    rows = ranking_groups(x, y, split, item_count)
    if len(rows):
        with torch.no_grad():
            scores = torch.exp(run.model.forward(rows))[:, 1]
        for m in (HitRatio(k=10, neg_num=NEG_NUM), NDCG(k=10, neg_num=NEG_NUM)):
            num, cnt = m.metric(scores, None)
            run.results[f"{m.name}@10"] = float(num) / float(cnt)
            print(f"{m.name}@10: {run.results[f'{m.name}@10']:.4f}")
    finish(run.model, args, run.optimizer)
    return run


if __name__ == "__main__":
    main()
