"""Which point-to-point route the mesh collectives can take between ranks
that share one card over gloo.

Four spawned ranks join one gloo group on ``cuda:0`` (or on the CPU with
``--device cpu``) and each of them checks, bit for bit against the values
its peers draw from the same seeds:

* ``send``/``recv`` of a float32 and a bfloat16 CUDA tensor around the
  ring ``r -> r+1``;
* ``batch_isend_irecv`` of the same exchange;
* ``all_to_all_single`` with uneven splits carrying the same ring shift;
* ``all_gather`` and ``all_reduce`` over two-rank subgroups from
  ``new_group``.

Each rank writes what it saw to ``build/p2p_probe/rank<r>.json`` after
every check (a hang still leaves the earlier ones); the script prints one
JSON line per rank and exits non-zero when a check raised or disagreed.
Run: ``python3 tools/torch_p2p_probe.py [--device cpu]``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join("build", "p2p_probe")
SHAPE = (8, 8, 512, 64)


def _draw(rank: int, dtype, device):
    import torch

    g = torch.Generator().manual_seed(1000 + rank)
    return torch.randn(SHAPE, generator=g).to(dtype).to(device)


def _check(name, fn, results, path):
    try:
        ok = bool(fn())
        results[name] = "equal" if ok else "DIFFERS"
    except Exception as e:  # recorded per check: the probe reports each route
        results[name] = f"raised {type(e).__name__}: {e}"[:400]
        traceback.print_exc()
    with open(path, "w") as f:  # after every check: a hang still leaves the earlier ones
        json.dump(results, f)


def rank_main(rank: int, world: int, folder: str, device: str) -> None:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    # a peer whose send raised leaves its receiver waiting: gloo ends the
    # wait at the group's timeout and the check records it
    dist.init_process_group("gloo", init_method=f"file://{folder}/group", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=20))
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"rank{rank}.json")
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    res = {"rank": rank, "device": str(dev), "torch": torch.__version__}
    try:
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).split(".")[-1]

            def send_recv():
                mine, want = _draw(rank, dtype, dev), _draw(prv, dtype, dev)
                got = torch.empty_like(mine)
                if rank % 2 == 0:
                    dist.send(mine, nxt)
                    dist.recv(got, prv)
                else:
                    dist.recv(got, prv)
                    dist.send(mine, nxt)
                return torch.equal(got, want)

            def batched():
                mine, want = _draw(rank, dtype, dev), _draw(prv, dtype, dev)
                got = torch.empty_like(mine)
                ops = [dist.P2POp(dist.isend, mine, nxt), dist.P2POp(dist.irecv, got, prv)]
                for w in dist.batch_isend_irecv(ops):
                    w.wait()
                return torch.equal(got, want)

            def uneven_all_to_all():
                mine, want = _draw(rank, dtype, dev), _draw(prv, dtype, dev)
                n = mine.numel()
                ins = [n if j == nxt else 0 for j in range(world)]
                outs = [n if j == prv else 0 for j in range(world)]
                got = torch.empty_like(mine)
                dist.all_to_all_single(got.view(-1), mine.reshape(-1).contiguous(), outs, ins)
                return torch.equal(got, want)

            _check(f"all_to_all_uneven_{tag}", uneven_all_to_all, res, path)
            _check(f"send_recv_{tag}", send_recv, res, path)
            _check(f"batch_isend_irecv_{tag}", batched, res, path)

        groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        group, pair = groups[rank // 2], [2 * (rank // 2), 2 * (rank // 2) + 1]

        def sub_gather():
            mine = _draw(rank, torch.float32, dev)
            outs = [torch.empty_like(mine) for _ in pair]
            dist.all_gather(outs, mine, group=group)
            return all(torch.equal(o, _draw(r, torch.float32, dev)) for o, r in zip(outs, pair))

        def sub_reduce():
            mine = _draw(rank, torch.float32, dev)
            want = _draw(pair[0], torch.float32, dev) + _draw(pair[1], torch.float32, dev)
            dist.all_reduce(mine, group=group)
            return torch.equal(mine, want)

        _check("subgroup_all_gather_float32", sub_gather, res, path)
        _check("subgroup_all_reduce_float32", sub_reduce, res, path)
    finally:
        dist.destroy_process_group()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--world", type=int, default=4)
    args = p.parse_args()
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
    from bigdl_tpu_torch.examples._common import spawn

    with tempfile.TemporaryDirectory(prefix="p2p_probe_") as folder:
        try:
            spawn(rank_main, (folder, args.device), args.world, 200.0, stderr_dir=folder)
        finally:
            for r in range(args.world):
                with open(os.path.join(folder, f"rank{r}.err")) as f:
                    print(f"--- rank {r} stderr (end):\n{f.read()[-1500:]}", file=sys.stderr)
    bad = 0
    for r in range(args.world):
        with open(os.path.join(OUT, f"rank{r}.json")) as f:
            res = json.load(f)
        print(json.dumps(res))
        bad += sum(1 for k, v in res.items() if k not in ("rank", "device", "torch")
                   and v != "equal")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
