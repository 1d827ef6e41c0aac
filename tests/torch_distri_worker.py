"""The rank side of ``test_torch_distri.py``: spawned processes joined into
one gloo group through a file, each running a list of training cases
through the port's ``DistriOptimizer`` and writing its results as ``.npz``.
It imports torch and the port only (never JAX), so a rank starts in a few
seconds.

``spawn_cases(world, cases, folder, deadline_s, device)`` starts the ranks
(on the CPU, or on the card with ``device=None``) through the examples'
``spawn``, which joins them under the deadline (a rank that fails, or is
still running then and is killed, raises with the end of its stderr), then
returns ``{case name: [rank 0's arrays, rank 1's, ...]}``.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List

import numpy as np

from bigdl_tpu_torch.examples._common import spawn


def cnn(nn, d):
    """conv -> BN -> ReLU -> max-pool -> Linear -> LogSoftMax over (3, 8, 8)
    images, 5 classes (``test_torch_validation.cnn``)."""
    return nn.Sequential(
        nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1, **d), nn.SpatialBatchNormalization(4, **d),
        nn.ReLU(**d), nn.SpatialMaxPooling(2, 2, 2, 2, **d), nn.Reshape([64], **d),
        nn.Linear(64, 5, **d), nn.LogSoftMax(**d), **d)


def method_of(optim, spec):
    """An optimization method of ``optim`` from ``(name, kwargs)``."""
    name, kw = spec
    return getattr(optim, name)(**kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v.detach().cpu().numpy()
    return out


def run_case(case: Dict[str, Any], device="cpu") -> Dict[str, np.ndarray]:
    """One training case on this rank: the model from the case's initial
    weights and state, ``steps`` steps of ``DistriOptimizer(**kw)`` over the
    case's global batches; then the results (parameters ``p.*``, state
    ``s.*``, the losses, the gradient-exchange bytes a step, the stored
    master's and slots' bytes, and a sharded evaluation when asked)."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch import optim as poptim
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.parallel import DistriOptimizer, _comm
    from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.random import RandomGenerator

    n = Engine.device_count()
    x, y, batch = case["x"], case["y"], case["batch"]
    RandomGenerator.set_seed(case["seed"])
    model = cnn(nn, {"device": device})
    model.init(sample_input=torch.from_numpy(x[:batch // n]))
    load_jax_params(model, case["init"])
    load_jax_state(model, case["state"])
    ds = DataSet.distributed(DataSet.array(x, y, batch_size=batch), n)
    opt = DistriOptimizer(model, ds, nn.ClassNLLCriterion(), **case["kw"])
    opt.set_optim_method(method_of(poptim, case["method"]))
    if case.get("clip") is not None:
        opt.set_gradient_clipping_by_l2_norm(case["clip"])
    opt.set_end_when(poptim.Trigger.max_iteration(case["steps"]))
    tel = None
    if case.get("health"):  # ZeRO-1 health: every step's record
        from bigdl_tpu_torch.obs import HealthConfig, Telemetry

        tel = Telemetry(heartbeat_interval_s=None)
        opt.set_telemetry(tel).set_health(HealthConfig(every_n_steps=1))
    plan = None
    if case.get("ckpt") is not None:  # checkpoints, a failure policy, maybe a fault
        from bigdl_tpu_torch.resilience import FailurePolicy, FaultPlan

        opt.set_checkpoint(case["ckpt"], poptim.Trigger.several_iteration(1))
        opt.set_failure_policy(FailurePolicy(backoff_base_s=0.0))
        if case.get("fault") is not None:
            plan = FaultPlan().arm(*case["fault"])
    _comm.reset_counts()
    if plan is not None:
        with plan:
            opt.optimize()
    else:
        opt.optimize()
    counts = _comm.counts()
    out = {f"p.{k}": v for k, v in _flat(model.get_parameters()).items()}
    out.update({f"s.{k}": v for k, v in _flat(model.get_state()).items()})
    out["losses"] = np.asarray([h["loss"] for h in opt.history], np.float64)
    if tel is not None:
        out["health"] = health_rows([r for r in tel.ring.records if r["type"] == "health"])
    if opt.failure_policy is not None:
        out["attempts"] = np.asarray(opt.failure_policy.total_attempts)
    out["exchange_bytes"] = np.asarray(
        (counts["psum_scatter"]["bytes"] + counts["all_to_all"]["bytes"]) / case["steps"])
    fs = opt._flat
    if fs is not None:
        out["master_bytes"] = np.asarray(fs.master.numel() * fs.master.element_size())
        out["slot_bytes"] = np.asarray(sum(v.numel() * v.element_size()
                                           for v in fs.slots.values()))
    if "eval_x" in case:
        ev = DataSet.array(case["eval_x"], case["eval_y"], batch_size=case["eval_batch"])
        res = model.evaluate(ev, [poptim.Top1Accuracy(), poptim.Loss(nn.ClassNLLCriterion())])
        out["eval"] = np.asarray([res["Top1Accuracy"].correct, res["Top1Accuracy"].count,
                                  res["Loss"].result()[0], res["Loss"].count], np.float64)
    return out


def health_rows(records) -> np.ndarray:
    """``health`` records as rows: the global grad norm, weight norm and
    update ratio, the non-finite counts, then each layer's three norms."""
    rows = []
    for h in records:
        g = h["global"]
        row = [g["grad_norm"], g["weight_norm"], g["update_ratio"], g["nonfinite_grads"],
               g["nonfinite_params"]]
        for path in sorted(h.get("layers", {})):
            lay = h["layers"][path]
            row += [lay["grad_norm"], lay["weight_norm"], lay["update_ratio"]]
        rows.append(row)
    return np.asarray(rows, np.float64)


def rank_main(rank: int, world: int, folder: str, device="cpu") -> None:
    """One rank: join the group, run every case, write ``<case>.<rank>.npz``."""
    from bigdl_tpu_torch.utils.engine import Engine

    with open(os.path.join(folder, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    Engine.init_distributed(f"file://{folder}/group", world, rank, device=device)
    try:
        for case in cases:
            np.savez(os.path.join(folder, f"{case['name']}.{rank}.npz"),
                     **run_case(case, "cpu" if device == "cpu" else "cuda"))
    finally:
        Engine.shutdown_distributed()


def spawn_cases(world: int, cases: List[Dict[str, Any]], folder: str,
                deadline_s: float = 150.0, device="cpu"
                ) -> Dict[str, List[Dict[str, np.ndarray]]]:
    with open(os.path.join(folder, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    spawn(rank_main, (folder, device), world, deadline_s, stderr_dir=folder)
    return {c["name"]: [dict(np.load(os.path.join(folder, f"{c['name']}.{r}.npz")))
                        for r in range(world)] for c in cases}
