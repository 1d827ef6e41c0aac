#!/usr/bin/env python3
"""Split ``chip_smoke.py`` [23a]'s f32 GPipe reading: where does the
pipelined run's distance from the sequential stack come from?

[23a] runs 3 f32 SGD steps of the 6-stage norm-LM/LN (``MESH_PIPE``: V
8192, H 512, batch 8 x 2048, 8 microbatches) through ``PipelineOptimizer``
on 6 ranks sharing the card, and the same 3 steps through
``LocalOptimizer`` on one rank, with the fused-kernel switch on and TF32
off; the update-relative distance reads ~1e-3 on the card. This runs the
same check (no planted fault) in three settings:

    python3 tools/torch_gpipe_split.py                  # all three, in turns
    python3 tools/torch_gpipe_split.py card-fused card-unfused cpu
    python3 tools/torch_gpipe_split.py --tiny cpu       # a rehearsal at V 64, H 32

- ``card-fused``: as [23a] (the LayerNorm kernels #4/#5 under the switch);
- ``card-unfused``: the switch off, the norms as torch ops on the card;
- ``cpu``: the ranks on the CPU (gloo) at the same widths.

Each setting prints one JSON line: the loss and update distances, the
update distance of each parameter group (embedding, stage norms, stage
FFNs, final norm, head), and the wall time. The card settings need one
CUDA card; ``cpu`` needs none (the widths take several GiB a rank).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MODES = ("card-fused", "card-unfused", "cpu")
TINY = {"vocab": 64, "hidden": 32, "seq": 16, "n_seq": 8, "check_batch": 8}


def _rank(rank, world, folder, mode, tiny):
    """One spawned rank: join the group, run the check, save rank0's."""
    import torch

    import chip_smoke as cs

    cs.MESH_DEVICE = "cpu" if mode == "cpu" else "cuda"
    if tiny:
        cs.MESH_PIPE.update(TINY)
    from bigdl_tpu_torch import Engine
    from bigdl_tpu_torch.parallel import make_mesh

    Engine.init_distributed(f"file://{folder}/group", world, rank,
                            device="cpu" if mode == "cpu" else None)
    if mode != "cpu":
        from bigdl_tpu_torch.ops import _build

        _build.load()
    out = {}
    try:
        c = cs.MESH_PIPE
        x, y = cs._pipe_data(c, cs.SEED)
        cs._pipe_f32_check(rank, make_mesh({"pipe": c["stages"]}), x, y, out,
                           fused=mode == "card-fused", planted=False)
    finally:
        Engine.shutdown_distributed()
    if rank == 0:
        torch.save(out, os.path.join(folder, "rank0.pt"))


def _groups(names, sizes):
    """Parameter name -> its group's label, by where it sits in the norm-LM."""
    out = []
    for n in names:
        if "stages" in n:
            out.append("stage_norms" if "Norm" in n else "stage_ffns")
        elif "LookupTable" in n or "embed" in n.lower():
            out.append("embedding")
        elif "Norm" in n:
            out.append("final_norm")
        else:
            out.append("head")
    return out


def run(mode: str, tiny: bool = False) -> dict:
    import torch

    import chip_smoke as cs
    from bigdl_tpu_torch.examples._common import spawn

    world = cs.MESH_PIPE["stages"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gpipe_split_") as folder:
        spawn(_rank, (folder, mode, tiny), world, 1800.0, stderr_dir=folder)
        r0 = torch.load(os.path.join(folder, "rank0.pt"), weights_only=False)
    dist = cs._distance(r0["check"], r0["ref"], r0["p0"])
    p1, p2, p0 = r0["check"][1], r0["ref"][1], r0["p0"]
    by_group = {}
    offset = 0
    for g, size in zip(_groups(r0["names"], r0["sizes"]), r0["sizes"]):
        sl = slice(offset, offset + size)
        offset += size
        d, u = by_group.get(g, (0.0, 0.0))
        by_group[g] = (d + float(((p1[sl] - p2[sl]) ** 2).sum()),
                       u + float(((p2[sl] - p0[sl]) ** 2).sum()))
    res = {"mode": mode, "loss": dist["loss"], "update": dist["update"],
           "update_by_group": {g: (d / u) ** 0.5 if u else None
                               for g, (d, u) in by_group.items()},
           "losses_pipe": r0["check"][0], "losses_seq": r0["ref"][0],
           "wall_s": time.perf_counter() - t0}
    if mode != "cpu":
        res["card"] = cs.nvidia_smi()
    return res


def main(argv) -> int:
    tiny = "--tiny" in argv
    modes = [a for a in argv if a != "--tiny"] or list(MODES)
    bad = [m for m in modes if m not in MODES]
    if bad:
        print(f"unknown mode(s) {bad}; choose from {MODES}", file=sys.stderr)
        return 2
    for mode in modes:
        print(json.dumps(run(mode, tiny)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
