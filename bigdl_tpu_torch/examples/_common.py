"""What the example mains share (counterpart of ``examples/_common.py``):
the flags of its ``base_parser``, the device an ``--platform`` names,
logging, ``finish`` (the trained model written by ``--model-save`` in
``nn.load_module`` 's format, and the optimizer's metrics line) and the
ranks of a data-parallel main (:func:`run_ranks`). Every main takes every
flag of ``base_parser`` as its JAX main does: ``--summary-dir`` writes
summaries where the JAX main writes them (``lenet_train``) and nothing
elsewhere, as there.

``--n-devices N`` (N > 1) trains a ``DistriOptimizer`` main (``resnet_train``,
``vgg_train``) on N ranks, one process each: run as it is, the main starts
the N processes itself (spawned, joined through a file in a temporary
folder, each joined under a deadline: a rank that fails or hangs fails the
run); under ``torchrun --nproc-per-node N`` every process takes its rank
from the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``). On the card the ranks take a card each over NCCL when
there are enough, else they share ``cuda:0`` over gloo; ``--platform cpu``
runs them on the CPU over gloo. The mesh mains (``pipeline_train``,
``longctx_train``, ``moe_train``) take their world from their own flags
(``--dp`` x ``--n-stages``, ``--sp``, ``--n-experts``) and start those ranks
the same way (:func:`mesh_ranks`), each rank running the JAX main's
replicated program on its mesh. The other mains train through
``LocalOptimizer`` on one device, as their JAX mains do, and refuse N > 1.
"""

from __future__ import annotations

import argparse
import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

RANK_DEADLINE_S = 1800.0  # a spawned rank still running after this fails the run


def base_parser(description: str, batch_size: int = 128) -> argparse.ArgumentParser:
    """The JAX mains' common flags and defaults."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-f", "--data-dir", default=None,
                   help="dataset folder; synthetic data when absent (hermetic default)")
    p.add_argument("-b", "--batch-size", type=int, default=batch_size)
    p.add_argument("--max-epoch", type=int, default=2)
    p.add_argument("--learning-rate", type=float, default=0.01)
    p.add_argument("--checkpoint", default=None, help="checkpoint directory")
    p.add_argument("--model-save", default=None, help="save the trained model here")
    p.add_argument("--model", default=None, help="(test.py) model file to load; not used")
    p.add_argument("--summary-dir", default=None, help="TensorBoard event dir")
    p.add_argument("--platform", choices=["auto", "cpu"], default="auto",
                   help="'cpu' trains on the CPU; 'auto' on the card")
    p.add_argument("--n-devices", type=int, default=None,
                   help="data-parallel ranks (DistriOptimizer mains; one process each)")
    p.add_argument("--synthetic-size", type=int, default=None,
                   help="synthetic dataset size when no --data-dir")
    return p


def device_of(args, distributed: bool = False) -> Optional[str]:
    """The device the run trains on (None: the card), after refusing
    ``--n-devices`` above 1 on a main that trains on one device (not
    ``distributed``)."""
    if args.n_devices not in (None, 1) and not distributed:
        raise ValueError(
            f"--n-devices {args.n_devices}: this main trains through LocalOptimizer on one "
            "card, as its JAX main does; the data-parallel mains are resnet_train and "
            "vgg_train")
    return "cpu" if args.platform == "cpu" else None


def finish(model, args, opt=None) -> None:
    """Write the trained model to ``--model-save`` when given (rank 0's,
    under a group) and print the optimizer's metrics when it has any, as
    the JAX mains' ``finish`` does."""
    from ..utils.engine import Engine

    sl = Engine.process_slice()
    if getattr(args, "model_save", None) and (sl is None or sl[0] == 0):
        model.save_module(args.model_save)
        print(f"saved model to {args.model_save}")
    if opt is not None and opt.metrics.summary():
        print(f"metrics: {opt.metrics!r}")


def setup_logging() -> None:
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(name)s %(levelname)s %(message)s")


@dataclass
class Run:
    """What an example's ``main`` did: the optimizer (its ``history`` holds
    each iteration's loss), the trained model, the parsed arguments, the
    validation set, and what it printed at the end by name."""

    optimizer: Any
    model: Any
    args: Any
    val_dataset: Any = None
    results: Dict[str, Any] = field(default_factory=dict)


def join_from_env(args) -> bool:
    """Under torchrun (``WORLD_SIZE`` set) join the group from the
    environment; True when this process is a rank of a group now."""
    from ..utils.engine import Engine

    if Engine.backend() is not None:
        return True
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        Engine.init_distributed(device=device_of(args, distributed=True))
        return True
    return False


def _rank_entry(rank: int, world: int, module: str, argv: List[str], folder: str,
                device: Optional[str]) -> None:
    """One spawned rank: join the group, run the main, write its summary."""
    import importlib
    import json

    from ..utils.engine import Engine

    Engine.init_distributed(f"file://{folder}/group", world, rank, device=device)
    try:
        run = importlib.import_module(module).main(argv)
        with open(os.path.join(folder, f"rank{rank}.json"), "w") as f:
            json.dump(rank_summary(run), f)
    finally:
        Engine.shutdown_distributed()


def rank_summary(run) -> Dict[str, Any]:
    """What a rank sends back: its history and its final results."""
    opt = run.optimizer
    results = getattr(run, "results", None) or {}
    return {"history": [{k: v for k, v in h.items() if isinstance(v, (int, float))}
                        for h in opt.history],
            "results": {k: list(v.result()) if hasattr(v, "result") else v
                        for k, v in results.items()}}


def spawn(target, args: tuple, world: int, deadline_s: float,
          stderr_dir: Optional[str] = None) -> None:
    """Run ``target(rank, world, *args)`` in ``world`` spawned processes,
    all joined under one deadline ``deadline_s`` seconds from their start.
    A rank that exits with an error, or is still running at the deadline
    (then killed), raises ``RuntimeError`` naming it; with ``stderr_dir``
    each rank's stderr goes to ``rank<r>.err`` there and the error carries
    the end of it. ``target`` must be importable by name in a new process."""
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_spawned, args=(target, r, world, args, stderr_dir),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    failed = [(r, f"still running after {deadline_s:.0f} s, killed") for r in hung]
    failed += [(r, f"exit code {p.exitcode}") for r, p in enumerate(procs)
               if r not in hung and p.exitcode != 0]
    if failed:
        tails = ""
        for r, _ in failed if stderr_dir is not None else ():
            with open(os.path.join(stderr_dir, f"rank{r}.err")) as f:
                tails += f"\n--- the end of rank {r}'s stderr:\n{f.read()[-3000:]}"
        raise RuntimeError(f"ranks failed (rank, why) of {world}: {failed}{tails}")


def _spawned(target, rank: int, world: int, args: tuple, stderr_dir: Optional[str]) -> None:
    """A spawned process of :func:`spawn`."""
    if stderr_dir is not None:
        err = open(os.path.join(stderr_dir, f"rank{rank}.err"), "w")
        os.dup2(err.fileno(), 2)
    target(rank, world, *args)


def run_ranks(module: str, argv: List[str], args,
              deadline_s: float = RANK_DEADLINE_S) -> List[Dict[str, Any]]:
    """Run ``module`` 's main as ``--n-devices`` spawned ranks and return
    each rank's :func:`rank_summary` (:func:`spawn`: a rank that fails or
    hangs fails the run)."""
    import json
    import tempfile

    world = int(args.n_devices)
    device = device_of(args, distributed=True)
    with tempfile.TemporaryDirectory(prefix="bigdl_ranks_") as folder:
        spawn(_rank_entry, (module, list(argv), folder, device), world, deadline_s,
              stderr_dir=folder)
        out = []
        for r in range(world):
            with open(os.path.join(folder, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out


def mesh_ranks(module: str, argv: List[str], args, world: int,
               deadline_s: float = RANK_DEADLINE_S) -> Optional[List[Dict[str, Any]]]:
    """For a mesh main: None when this process is a rank of a group already
    (spawned, or under torchrun: the main then trains here), else the
    ``world`` ranks are spawned running ``module`` 's main and their
    :func:`rank_summary` s returned."""
    if join_from_env(args):
        from ..utils.engine import Engine

        if Engine.device_count() != world:
            raise ValueError(f"{module} needs {world} ranks, the group has "
                             f"{Engine.device_count()}")
        return None
    args.n_devices = world
    return run_ranks(module, argv, args, deadline_s)
