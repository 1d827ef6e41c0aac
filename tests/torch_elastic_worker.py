"""The rank side of ``test_torch_elastic.py``: spawned processes joined into
one gloo group through a file, each running the cases of ``cases.pkl`` in
order and writing ``<case>.<rank>.npz`` and ``<case>.<rank>.json``. It
imports torch and the port only (never JAX).

A case trains ``Linear(8, 4) -> LogSoftMax`` (or, for the hybrid ones,
``Linear(8, 8) -> ReLU -> Linear(8, 4) -> LogSoftMax`` with the first
weight's rows over ``model``, and with ``data_plan`` the second's over
``data``) from the case's initial weights with SGD 0.1
on the case's records. An elastic case runs the JAX package's chaos
schedule: a fake clock advanced by one second at every ``end_when`` call;
rank 0 holds a thread-free :class:`SimulatedFleet` whose peers write the
other ranks' heartbeats under it; the peers of ``kill`` stop beating after
step ``kill_at`` and beat again after step ``revive_at``. Every rank keeps
its warn records, losses, final parameters, coordinator snapshot and the
outcome (``"ok"`` or the raised exception's class).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, List

import numpy as np

from bigdl_tpu_torch.examples._common import spawn


def _model(nn, hybrid: bool, device: str):
    d = {"device": device}
    if hybrid:
        return nn.Sequential(nn.Linear(8, 8, **d), nn.ReLU(**d), nn.Linear(8, 4, **d),
                             nn.LogSoftMax(**d), **d)
    return nn.Sequential(nn.Linear(8, 4, **d), nn.LogSoftMax(**d), **d)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().cpu().numpy()
    return out


def run_case(case: Dict[str, Any], rank: int, device: str = "cpu"):
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch import optim as poptim
    from bigdl_tpu_torch.dataset import DataSet
    from bigdl_tpu_torch.obs import HealthConfig, Telemetry
    from bigdl_tpu_torch.parallel import DistriOptimizer, _comm
    from bigdl_tpu_torch.parallel.hybrid import HybridParallelOptimizer, make_mesh
    from bigdl_tpu_torch.parallel.sharding import P, ShardingPlan
    from bigdl_tpu_torch.resilience import (ElasticConfig, ElasticCoordinator, FaultPlan,
                                            SimulatedFleet)
    from bigdl_tpu_torch.utils.convert import load_jax_params
    from bigdl_tpu_torch.utils.engine import Engine
    from bigdl_tpu_torch.utils.random import RandomGenerator

    folder = case["folder"]
    hybrid = case.get("hybrid", False)
    n = Engine.device_count()
    RandomGenerator.set_seed(7)
    model = _model(nn, hybrid, device)
    model.init(sample_input=torch.from_numpy(case["x"][:2]))
    if case.get("init") is not None:
        load_jax_params(model, case["init"])
    base = DataSet.array(case["x"], case["y"], batch_size=case["batch"])
    if hybrid:
        mesh = make_mesh({"data": 2, "model": 2})
        rules = [(r"^Linear_0/weight$", P("model", None))]
        if case.get("data_plan"):  # the second weight's rows over the shrinking axis
            rules.append((r"^Linear_2/weight$", P("data", None)))
        plan = ShardingPlan(rules)
        opt = HybridParallelOptimizer(model, base, nn.ClassNLLCriterion(), plan=plan, mesh=mesh,
                                      donate=case.get("donate", True))
    else:
        opt = DistriOptimizer(model, DataSet.distributed(base, n), nn.ClassNLLCriterion(),
                              parameter_sync=case.get("sync", "sharded"),
                              donate=case.get("donate", True))
    opt.set_optim_method(poptim.SGD(learningrate=0.1))
    ckpt = os.path.join(folder, case["name"], "ckpt")
    every = case.get("ckpt_every", 10 ** 6)
    opt.set_checkpoint(ckpt, poptim.Trigger.several_iteration(every))
    run_dir = os.path.join(folder, case["name"], "run")
    Engine.set_run_dir(run_dir)
    tel = Telemetry(heartbeat_interval_s=0.0 if rank == 0 else None)
    opt.set_telemetry(tel)
    if case.get("health"):
        opt.set_health(HealthConfig(every_n_steps=1))
    clk = {"t": 1000.0}

    def clock():
        return clk["t"]

    fleet = None
    coord = None
    if case.get("elastic"):
        cfg = ElasticConfig(stale_after_s=2.5, poll_interval_s=0.0, min_fleet_steps=0,
                            wall_clock=clock, min_processes=case.get("min_processes", 1),
                            timeout_s=60.0)
        coord = ElasticCoordinator(cfg)
        opt.set_elastic(coord)
        if rank == 0:
            fleet = SimulatedFleet(run_dir, n, threads=False, clock=clock)
    kill, kill_at, revive_at = case.get("kill", ()), case.get("kill_at"), case.get("revive_at")
    end_epoch, max_iter = case.get("end_epoch"), case.get("max_iteration")

    def end_when(state):
        step = int(state.get("neval", 0))
        clk["t"] += 1.0
        if fleet is not None:
            fleet.beat_all(step)
            if step == kill_at:
                for k in kill:
                    fleet.kill(k)
            if revive_at is not None and step == revive_at:
                for k in kill:
                    fleet.revive(k)
        if max_iter is not None:
            return step >= max_iter
        return int(state.get("epoch", 1)) > end_epoch

    opt.set_end_when(end_when)
    cut_rows = []  # with data_plan: the data-sharded leaf's block rows at each cut
    if case.get("data_plan"):
        init_state = opt._init_step_state

        def init_and_look(method, params):
            slots = init_state(method, params)
            cut_rows.append(int(model.get_parameters()["Linear_2"]["weight"].shape[0]))
            return slots

        opt._init_step_state = init_and_look
    outcome = "ok"
    _comm.reset_counts()
    try:
        if fleet is not None:
            fleet.__enter__()
        if case.get("fault"):
            with FaultPlan().arm(case["fault"]):
                opt.optimize()
        else:
            opt.optimize()
    except Exception as e:  # the case's outcome: the typed error's class
        outcome = type(e).__name__
    finally:
        if fleet is not None:
            fleet.__exit__(None, None, None)
        tel.close()
    recs = [r for r in tel.ring.records if r.get("type") in ("warn", "health", "step")]
    meta = {"outcome": outcome, "records": recs, "folder": folder,
            "snapshot": coord.snapshot() if coord is not None else None,
            "step_cache": ([list(k) for k in opt._distri_step_cache]
                           if hasattr(opt, "_distri_step_cache") else None)}
    with open(os.path.join(folder, f"{case['name']}.{rank}.json"), "w") as f:
        json.dump(meta, f, default=float)
    out = {f"p.{k}": v for k, v in _flat(model.get_parameters()).items()}
    out["losses"] = np.asarray([h["loss"] for h in opt.history], np.float64)
    out["nevals"] = np.asarray([h["neval"] for h in opt.history], np.int64)
    out["cut_rows"] = np.asarray(cut_rows, np.int64)
    np.savez(os.path.join(folder, f"{case['name']}.{rank}.npz"), **out)


def rank_main(rank: int, world: int, folder: str, device: str = "cpu") -> None:
    import torch

    from bigdl_tpu_torch.utils.engine import Engine

    torch.set_num_threads(1)
    with open(os.path.join(folder, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    Engine.init_distributed(f"file://{folder}/group", world, rank,
                            device=None if device == "cuda" else device)
    try:
        for case in cases:
            run_case(dict(case, folder=folder), rank, device)
    finally:
        Engine.set_run_dir(None)
        Engine.shutdown_distributed()


def spawn_cases(world: int, cases: List[Dict[str, Any]], folder: str,
                deadline_s: float = 240.0, device: str = "cpu"
                ) -> Dict[str, List[Dict[str, Any]]]:
    """Run the cases on ``world`` spawned ranks (on the CPU, or sharing the
    card with ``device="cuda"``) under one deadline; returns ``{case: [rank
    0's results, ...]}``, each the npz arrays and the json under
    ``"meta"``."""
    with open(os.path.join(folder, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    spawn(rank_main, (folder, device), world, deadline_s, stderr_dir=folder)
    out = {}
    for c in cases:
        ranks = []
        for r in range(world):
            d = dict(np.load(os.path.join(folder, f"{c['name']}.{r}.npz")))
            with open(os.path.join(folder, f"{c['name']}.{r}.json")) as f:
                d["meta"] = json.load(f)
            ranks.append(d)
        out[c["name"]] = ranks
    return out
