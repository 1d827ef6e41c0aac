"""The parallel runtime of the port: data-parallel training across
processes (``DistriOptimizer`` over ``torch.distributed``, the ZeRO-1 flat
layout ``FlatParameter``, the compressed gradient exchange) and the
single-device part of the mixture-of-experts routing (``moe.py``). The
hybrid and sequence-parallel runtimes, the expert-parallel ``moe_ffn`` and
the pipeline schedules are ROADMAP Queue 1 item 8's last bullet."""

from .moe import moe_capacity, moe_ffn_reference
from .parameter import FlatParameter


def __getattr__(name):
    # the optimizer imports nn, whose MoE layer imports this package: it
    # loads on first use
    if name in ("DistriOptimizer", "simulate_step"):
        from . import distri_optimizer

        return getattr(distri_optimizer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = ["DistriOptimizer", "FlatParameter", "moe_capacity", "moe_ffn_reference",
           "simulate_step"]
