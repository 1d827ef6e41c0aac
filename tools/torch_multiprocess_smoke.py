"""Two-process smoke run of the port's data-parallel seam (counterpart of
``tools/multiprocess_smoke.py``).

Two spawned processes on one machine (``examples._common.spawn``, under
one deadline) join one ``torch.distributed`` group
through ``Engine.init_distributed`` (a ``tcp://localhost`` address on a
free port; gloo). Each asserts the group's view, runs a cross-rank psum and
trains a model for eight epochs through ``DistriOptimizer``, whose
collectives then cross the process boundary; the launcher checks that both
ranks end with equal parameters and prints the outcome.

Usage:
    python3 tools/torch_multiprocess_smoke.py                # the CPU
    python3 tools/torch_multiprocess_smoke.py --device cuda  # two ranks on one card

Exit code 0 and "MULTIPROC OK" on success; ``--json`` also prints the
result as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
N_PROC = 2
DEADLINE_S = 600


def _worker(rank: int, world: int, port: int, device: str) -> None:
    import numpy as np
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer, _comm
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.random import RandomGenerator

    Engine.init_distributed(f"localhost:{port}", world, rank,
                            device="cpu" if device == "cpu" else None)
    assert Engine.device_count() == world and Engine.process_slice() == (rank, world)
    dev = Engine.rank_device()

    # 1. a collective that crosses the process boundary
    got = _comm.psum_(torch.arange(3, dtype=torch.float32, device=dev) + 10 * rank)
    want = sum(torch.arange(3, dtype=torch.float32) + 10 * r for r in range(world))
    assert torch.equal(got.cpu(), want), (got, want)
    print(f"[p{rank}] psum across processes ok: {got.tolist()} ({Engine.backend()} on {dev})",
          flush=True)

    # 2. a DistriOptimizer fit over the group
    RandomGenerator.set_seed(7)  # the same initialisation on every rank
    rng = np.random.default_rng(0)  # the same global data on every rank
    xs = rng.standard_normal((64, 10)).astype(np.float32)
    ys = np.argmax(xs @ rng.standard_normal((10, 4)).astype(np.float32), axis=1)
    d = "cpu" if device == "cpu" else None
    model = nn.Sequential(nn.Linear(10, 16, device=d), nn.ReLU(device=d),
                          nn.Linear(16, 4, device=d), device=d)
    ds = DataSet.distributed(DataSet.array(xs, ys, batch_size=16), world)
    opt = DistriOptimizer(model, ds, nn.CrossEntropyCriterion())
    opt.set_optim_method(SGD(learningrate=0.5))
    opt.set_end_when(Trigger.max_epoch(8))
    opt.optimize()
    flat = torch.cat([p.detach().reshape(-1).cpu() for p in model.parameters()])
    with torch.no_grad():
        logits = model.forward(torch.from_numpy(xs).to(dev))
    acc = float((logits.argmax(1).cpu().numpy() == ys).mean())
    print(f"[p{rank}] fit done: {len(opt.history)} steps, train acc={acc:.3f}", flush=True)
    np.save(os.path.join(REPO, "build", f"mp_smoke_params.{port}.{rank}.npy"), flat.numpy())
    assert acc > 0.9, f"distributed training failed to fit: acc={acc}"
    Engine.shutdown_distributed()
    print(f"[p{rank}] WORKER OK", flush=True)


def _launch(device: str, emit_json: bool) -> int:
    import numpy as np

    from bigdl_tpu_torch.examples._common import spawn

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    t0 = time.time()
    try:
        spawn(_worker, (port, device), N_PROC, DEADLINE_S)
        ok = True
    except RuntimeError as e:  # a rank failed or hung: reported, and the run fails
        print(e)
        ok = False
    files = [os.path.join(REPO, "build", f"mp_smoke_params.{port}.{r}.npy")
             for r in range(N_PROC)]
    equal = ok and all(os.path.exists(f) for f in files) and all(
        np.array_equal(np.load(files[0]), np.load(f)) for f in files[1:])
    for f in files:
        if os.path.exists(f):
            os.remove(f)
    ok = ok and equal
    result = {"ok": ok, "processes": N_PROC, "device": device, "params_equal": bool(equal),
              "seconds": round(time.time() - t0, 3)}
    if emit_json:
        print(json.dumps(result))
    print("MULTIPROC OK" if ok else "MULTIPROC FAILED")
    return 0 if ok else 1


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", choices=["cpu", "cuda"], default="cpu")
    p.add_argument("--json", action="store_true")
    a = p.parse_args()
    return _launch(a.device, a.json)


if __name__ == "__main__":
    sys.exit(main())
