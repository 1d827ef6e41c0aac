"""bigdl_tpu_torch — the PyTorch/CUDA port of bigdl_tpu, for one NVIDIA H100.

It mirrors the JAX package's module paths (``nn/attention.py``,
``ops/flash_attention.py``, ``serving/server.py``, ...), imports ``torch``
and never ``jax`` or ``bigdl_tpu``, and runs its entry points on the card
unless the caller passes ``device="cpu"``. Each kernel the JAX package wrote
in Pallas becomes a hand-written CUDA kernel under ``csrc/``, built at first
use (``ops/_build.py``).
"""

from .utils.engine import Engine
from .utils.random import RandomGenerator, set_seed

__all__ = ["Engine", "RandomGenerator", "set_seed"]
