"""The gate of the fused kernels (counterpart of
``bigdl_tpu/ops/fused_common.py``).

``fused_kernels_active()`` is ``Engine.fused_kernels()`` and nothing else:
the port has no compile probe (a kernel that does not build or launch
raises), and the TPU kernels' row-block geometry, sized to their VMEM, has
no counterpart here; the CUDA kernels choose their own blocks.
"""

from __future__ import annotations


def fused_kernels_active() -> bool:
    """True when the fused-kernel paths engage (read at every call)."""
    from ..utils.engine import Engine

    return Engine.fused_kernels()
