#!/usr/bin/env python3
"""Time one checkout's max-pool backward kernel at the main path's pool shapes on one CUDA card.

    python3 tools/torch_maxpool_bwd_ab.py ROOT LABEL

Imports ``bigdl_tpu_torch`` from the checkout at ROOT (building its kernel
library there) and prints, after LABEL, one line per shape: the kernel's ms
a call, launched through its C entry point ``bigdl_maxpool2d_bwd`` (the
signature has not changed since the kernel was first ported), ATen's
``max_pool2d_with_indices_backward`` on the same x and dy from indices saved
by the forward, and the bound (read x and dy once, write dx once, at the
card's memory rate). The shapes (bf16, contiguous NCHW) are the flagship's
stem pool (128, 64, 112, 112) 3x3/s2/p1 and VGG-16's five 2x2/s2 pools at
batch 64; VGG's inputs are ReLU outputs, as in training. Run it for two
checkouts in turns (a, b, b, a), one after another on one card, to compare
them.
"""

import subprocess
import sys

sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

MEM_RATE = 3.35e12  # bytes/s, H100 SXM data sheet
STEM = ((3, 3), (2, 2), (1, 1))
VGG = ((2, 2), (2, 2), (0, 0))
SHAPES = [("stem", (128, 64, 112, 112), STEM), ("pool2", (64, 64, 224, 224), VGG),
          ("pool5", (64, 128, 112, 112), VGG), ("pool9", (64, 256, 56, 56), VGG),
          ("pool13", (64, 512, 28, 28), VGG), ("pool17", (64, 512, 14, 14), VGG)]


def ms(fn, iters=50):
    for _ in range(5):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def pool_inputs(shape, geometry, g):
    """x (bf16; ReLU outputs for VGG's pools) and dy of the pool at shape."""
    (kh, kw), (sh, sw), (ph, pw) = geometry
    n, c, h, w = shape
    x = torch.randn(shape, generator=g, device="cuda")
    if ph == 0:
        x = torch.relu(x)
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    dy = torch.randn((n, c, ho, wo), generator=g, device="cuda")
    return x.bfloat16(), dy.bfloat16()


def kernel_ms(lib, x, dy, dx, geometry):
    (kh, kw), (sh, sw), (ph, pw) = geometry
    n, c, h, w = x.shape
    ho, wo = dy.shape[2:]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.bigdl_maxpool2d_bwd(x.data_ptr(), dy.data_ptr(), dx.data_ptr(), 1, n * c, h, w,
                                     ho, wo, kh, kw, sh, sw, ph, pw, stream)
        if rc != 0:
            raise RuntimeError(f"max-pool kernel launch failed with CUDA error {rc}")

    return ms(launch)


def aten_ms(x, dy, geometry):
    (kh, kw), (sh, sw), (ph, pw) = geometry
    _, idx = F.max_pool2d(x, (kh, kw), (sh, sw), (ph, pw), return_indices=True)
    t = ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
        dy, x, [kh, kw], [sh, sw], [ph, pw], [1, 1], False, idx))
    return t


def bound_ms(x, dy):
    return (2 * x.numel() + dy.numel()) * x.element_size() / MEM_RATE * 1e3


if __name__ == "__main__":
    root, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    from bigdl_tpu_torch.ops import _build

    lib = _build.load()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, shape, geometry in SHAPES:
        x, dy = pool_inputs(shape, geometry, g)
        dx = torch.empty_like(x)
        k, a, b = kernel_ms(lib, x, dy, dx, geometry), aten_ms(x, dy, geometry), bound_ms(x, dy)
        print(f"POOL_AB {label} {name} {tuple(shape)}: kernel {k:.4f} ms, aten {a:.4f} ms, "
              f"bound {b:.4f} ms, kernel/bound {k / b:.2f}, aten/kernel {a / k:.2f}; card {card}",
              flush=True)
        del x, dy, dx
    torch.cuda.empty_cache()
