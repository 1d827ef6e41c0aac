#!/usr/bin/env python3
"""Where the flagship's card route and CPU route part, layer by layer.

    python3 tools/torch_flagship_route.py [TABLE]    # needs one CUDA card

``chip_smoke.py`` [7] holds 3 SGD steps of an f32 ResNet-50 on the card
against the same steps on the CPU, and its limits there are far wider than
those of the other networks' routes. This script looks at step 1 from one
set of weights (numpy-made from a seed: the weights and BN statistics of a
CPU-built model, copied to the card), at [7]'s size (batch 8 of 112x112,
f32, TF32 off), for both stems (``s2d``, the trained flagship, and
``conv7``, the served one) and in train mode (batch statistics) and eval
mode (running statistics). For every leaf module in graph order it prints:

- ``fwd``: the relative L2 distance of the card's output from the CPU's,
  each route fed its own previous outputs (what the routes' forwards do);
- ``local``: the same leaf on the card fed the CPU's input to it, against
  the CPU's output: the difference that leaf adds by itself;
- ``grad``: the relative L2 distance of d(loss)/d(output) of that leaf
  (``ClassNLLCriterion`` on the raw logits, as [7]);
- for a BatchNorm leaf in train mode, ``min_std``: the smallest batch
  standard deviation of a channel of its input over that input's RMS (a
  channel that is nearly constant over the batch divides its rounding noise
  by that standard deviation).

Then, per stem and mode: the leaves with the largest ``local``, the first
leaf where ``fwd`` passes 1e-6 / 1e-5 / 1e-4 / 1e-3, the logits' and the
loss's distance, and the parameter gradients' distance (all parameters and
the worst tensor). The whole table goes to ``TABLE`` (default
``build/torch_flagship_route.txt`` under the checkout).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

THRESHOLDS = (1e-6, 1e-5, 1e-4, 1e-3)
ROUTES = {"cpu": "cpu", "card": "cuda"}  # route -> device


def rel(a, b) -> float:
    import numpy as np

    den = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / den if den else float(np.linalg.norm(a))


def leaves(model, params, state, x, training, record):
    """Run ``model`` (a Graph of Sequentials and leaves) leaf by leaf;
    ``record(path, module, x_in, y)`` sees every leaf; returns the output."""
    from bigdl_tpu_torch.nn.graph import Graph
    from bigdl_tpu_torch.nn.module import Sequential
    from bigdl_tpu_torch.utils.table import T

    def run(m, p, s, v, path):
        if isinstance(m, Graph):
            values = {}
            for node in m._topo:
                if node in m.input_nodes:
                    values[node.id] = v
                    continue
                ins = [values[q.id] for q in node.parents]
                arg = ins[0] if len(ins) == 1 else T(*ins)
                c = node.module
                values[node.id] = run(c, p[c.name()], s[c.name()], arg, f"{path}{c.name()}/")
            return values[m.output_nodes[0].id]
        if isinstance(m, Sequential):
            for c in m._layers:
                v = run(c, p[c.name()], s[c.name()], v, f"{path}{c.name()}/")
            return v
        y, _ = m._apply_params(p, s, v, training, None)
        record(path.rstrip("/"), m, v, y)
        return y

    return run(model, params, state, x, "")


def compare(stem: str, training: bool, out):
    import numpy as np
    import torch
    from bigdl_tpu_torch import RandomGenerator
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.nn.normalization import SpatialBatchNormalization
    from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 3, 112, 112)).astype(np.float32)
    y = rng.integers(0, 1000, 8)
    models = {}
    for route, device in ROUTES.items():
        RandomGenerator.set_seed(3)
        m = ResNet(50, stem=stem, device=device)
        m.init(sample_input=x)
        models[route] = m
    cpu, card = models["cpu"], models["card"]
    load_jax_params(card, {k: v.detach().numpy() for k, v in cpu.named_parameters()})
    state = {}
    for path, t in _flat(cpu.get_state()).items():
        node = state
        *heads, last = path.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    load_jax_state(card, state)

    runs = {}
    for route, m in models.items():
        device, rows = ROUTES[route], []

        def record(path, mod, v, o, rows=rows):
            if o.requires_grad:
                o.retain_grad()
            rows.append((path, mod, v.detach() if torch.is_tensor(v) else v, o))

        for p in m.parameters():
            p.grad = None
        t0 = time.perf_counter()
        logits = leaves(m, m.get_parameters(), m.get_state(),
                        torch.from_numpy(x).to(device), training, record)
        loss = ClassNLLCriterion()._apply(logits, torch.from_numpy(y).to(device))
        loss.backward()
        runs[route] = dict(rows=rows, logits=logits.detach().cpu().numpy(),
                            loss=float(loss.detach()), s=time.perf_counter() - t0,
                            grads={k: p.grad.cpu().numpy() for k, p in m.named_parameters()})
    rc, rg = runs["cpu"]["rows"], runs["card"]["rows"]
    assert [r[0] for r in rc] == [r[0] for r in rg]
    mode = "train" if training else "eval"
    table = []
    for (path, mod_c, in_c, out_c), (_, mod_g, _, out_g) in zip(rc, rg):
        oc, og = out_c.detach().cpu().numpy(), out_g.detach().cpu().numpy()
        with torch.no_grad():
            dev = ROUTES["card"]
            arg = in_c.to(dev) if torch.is_tensor(in_c) else _table_to(in_c, dev)
            local = mod_g._apply_params(mod_g.get_parameters(), mod_g.get_state(), arg,
                                        training, None)[0].cpu().numpy()
        gc = out_c.grad.cpu().numpy() if out_c.grad is not None else None
        gg = out_g.grad.cpu().numpy() if out_g.grad is not None else None
        row = dict(path=path, fwd=rel(og, oc), local=rel(local, oc),
                   grad=None if gc is None or gg is None else rel(gg, gc))
        if training and isinstance(mod_c, SpatialBatchNormalization):
            v = in_c.double()
            std = v.std(dim=(0, 2, 3), unbiased=False)
            row["min_std"] = float(std.min() / v.pow(2).mean().sqrt())
        table.append(row)
    gc_all, gg_all = runs["cpu"]["grads"], runs["card"]["grads"]
    worst_g = max(gc_all, key=lambda k: rel(gg_all[k], gc_all[k]))
    g_all = float(np.sqrt(sum(np.sum((gg_all[k] - gc_all[k]) ** 2) for k in gc_all))
                  / np.sqrt(sum(np.sum(v ** 2) for v in gc_all.values())))
    head = f"== ResNet-50 {stem}, {mode} mode, batch 8 of 112x112 f32 (TF32 off)"
    lines = [head, f"{'leaf':58s} {'fwd':>9s} {'local':>9s} {'grad':>9s} {'min_std':>9s}"]
    for r in table:
        lines.append(f"{r['path']:58s} {r['fwd']:9.2e} {r['local']:9.2e} "
                     + (f"{r['grad']:9.2e}" if r["grad"] is not None else f"{'-':>9s}")
                     + (f" {r['min_std']:9.2e}" if "min_std" in r else ""))
    out.write("\n".join(lines) + "\n\n")
    print(head)
    for t in THRESHOLDS:
        first = next((r for r in table if r["fwd"] > t), None)
        print(f"  first leaf with fwd > {t:g}: "
              + ("none" if first is None else
                 f"{first['path']} (fwd {first['fwd']:.2e}, local {first['local']:.2e})"))
    print("  largest local: " + "; ".join(
        f"{r['path']} {r['local']:.2e}" for r in sorted(table, key=lambda r: -r["local"])[:5]))
    bns = [r for r in table if "min_std" in r]
    if bns:
        low = sorted(bns, key=lambda r: r["min_std"])[:3]
        print("  smallest BN batch std / input RMS: " + "; ".join(
            f"{r['path']} {r['min_std']:.2e} (fwd {r['fwd']:.2e}, grad {r['grad']:.2e})"
            for r in low))
    grads = [r["grad"] for r in table if r["grad"] is not None]
    print(f"  logits rel L2 {rel(runs['card']['logits'], runs['cpu']['logits']):.2e}; loss "
          f"{runs['card']['loss']:.6f} card vs {runs['cpu']['loss']:.6f} CPU (diff "
          f"{abs(runs['card']['loss'] - runs['cpu']['loss']):.2e}); output grads rel L2 "
          f"max {max(grads):.2e} (at {max(table, key=lambda r: r['grad'] or 0)['path']}); "
          f"parameter grads rel L2 {g_all:.2e} overall, worst {worst_g} "
          f"{rel(gg_all[worst_g], gc_all[worst_g]):.2e}; CPU {runs['cpu']['s']:.1f} s, card "
          f"{runs['card']['s']:.1f} s")
    return table


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach().cpu().numpy()
    return out


def _table_to(t, device):
    from bigdl_tpu_torch.utils.table import T

    return T(*[v.detach().to(device) for v in t.to_list()])


def main() -> int:
    import subprocess

    import torch
    from bigdl_tpu_torch import Engine

    if not torch.cuda.is_available():
        print("torch_flagship_route.py: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"card: {card}")
    Engine.set_compute_dtype("float32")
    Engine.set_activation_dtype(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    table = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "build" / "torch_flagship_route.txt"
    table.parent.mkdir(parents=True, exist_ok=True)
    with open(table, "w") as out:
        out.write(f"card: {card}\n\n")
        for stem in ("s2d", "conv7"):
            for training in (True, False):
                compare(stem, training, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
