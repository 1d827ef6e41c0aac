"""The parallel runtime of the port: so far the single-device part of the
mixture-of-experts routing (``moe.py``). The multi-process runtime
(``DistriOptimizer``, the expert-parallel ``moe_ffn``, the pipeline
schedules) is ROADMAP Queue 1 item 8."""

from .moe import moe_capacity, moe_ffn_reference

__all__ = ["moe_capacity", "moe_ffn_reference"]
