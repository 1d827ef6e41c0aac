"""What the example mains share (counterpart of ``examples/_common.py``):
the flags of its ``base_parser``, the refusal of what the port does not
have, the device an ``--platform`` names, logging, and ``finish`` (the
trained model written by ``--model-save``, ``nn.load_module`` 's format)."""

from __future__ import annotations

import argparse
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


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
    p.add_argument("--n-devices", type=int, default=None, help="cards to use (1)")
    p.add_argument("--synthetic-size", type=int, default=None,
                   help="synthetic dataset size when no --data-dir")
    return p


def device_of(args, saves: bool = False) -> Optional[str]:
    """The device the run trains on (None: the card), after refusing the
    flags the port does not have yet (``--model-save`` too, unless the main
    ``saves`` through :func:`finish`)."""
    if args.n_devices not in (None, 1):
        raise NotImplementedError(
            f"--n-devices {args.n_devices}: the port trains on one card (DistriOptimizer "
            "is ROADMAP Queue 1 item 8)")
    flags = ("summary_dir",) if saves else ("model_save", "summary_dir")
    for flag in flags:
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag.replace('_', '-')} is not ported yet")
    return "cpu" if args.platform == "cpu" else None


def finish(model, args) -> None:
    """Write the trained model to ``--model-save`` when given."""
    if getattr(args, "model_save", None):
        model.save_module(args.model_save)
        print(f"saved model to {args.model_save}")


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
