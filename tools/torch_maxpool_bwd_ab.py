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
stem pool (128, 64, 112, 112) 3x3/s2/p1, VGG-16's five 2x2/s2 pools at
batch 64 and Inception-v1's ten pool shapes at batch 128 (its four
ceil-mode 3x3/s2 pools, whose overhang is on the high side only, and the
six shapes of its nine 3x3/s1/p1 branch pools); VGG's and Inception's
inputs are ReLU outputs, as in training. Run it for two checkouts in turns
(a, b, b, a), one after another on one card, to compare them.
"""

import subprocess
import sys

sys.modules["jax"] = None
sys.modules["bigdl_tpu"] = None

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

MEM_RATE = 3.35e12  # bytes/s, H100 SXM data sheet
# (kernel, stride, ((top, bottom), (left, right)) padding)
STEM = ((3, 3), (2, 2), ((1, 1), (1, 1)))
VGG = ((2, 2), (2, 2), ((0, 0), (0, 0)))
CEIL = ((3, 3), (2, 2), ((0, 1), (0, 1)))  # Inception's ceil mode: the overhang high only
BRANCH = ((3, 3), (1, 1), ((1, 1), (1, 1)))
# (name, x shape, geometry, input kind)
SHAPES = [("stem", (128, 64, 112, 112), STEM, "normal"),
          ("pool2", (64, 64, 224, 224), VGG, "relu"), ("pool5", (64, 128, 112, 112), VGG, "relu"),
          ("pool9", (64, 256, 56, 56), VGG, "relu"), ("pool13", (64, 512, 28, 28), VGG, "relu"),
          ("pool17", (64, 512, 14, 14), VGG, "relu"),
          ("inc-pool1", (128, 64, 112, 112), CEIL, "relu"),
          ("inc-pool2", (128, 192, 56, 56), CEIL, "relu"),
          ("inc-3a", (128, 192, 28, 28), BRANCH, "relu"),
          ("inc-3b", (128, 256, 28, 28), BRANCH, "relu"),
          ("inc-pool3", (128, 480, 28, 28), CEIL, "relu"),
          ("inc-4a", (128, 480, 14, 14), BRANCH, "relu"),
          ("inc-4b-4d", (128, 512, 14, 14), BRANCH, "relu"),
          ("inc-4e", (128, 528, 14, 14), BRANCH, "relu"),
          ("inc-pool4", (128, 832, 14, 14), CEIL, "relu"),
          ("inc-5a-5b", (128, 832, 7, 7), BRANCH, "relu")]
# pools a training step runs at each shape, for the sums a net a step
PER_STEP = {"inc-4b-4d": 3, "inc-5a-5b": 2}


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


def pool_inputs(shape, geometry, kind, g):
    """x (bf16; normal, or its ReLU) and dy of the pool at shape."""
    (kh, kw), (sh, sw), ((pt, pb), (pl, pr)) = geometry
    n, c, h, w = shape
    x = torch.randn(shape, generator=g, device="cuda")
    if kind == "relu":
        x = torch.relu(x)
    ho, wo = (h + pt + pb - kh) // sh + 1, (w + pl + pr - kw) // sw + 1
    dy = torch.randn((n, c, ho, wo), generator=g, device="cuda")
    return x.bfloat16(), dy.bfloat16()


def kernel_ms(lib, x, dy, dx, geometry):
    (kh, kw), (sh, sw), ((ph, _), (pw, _)) = geometry
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
    """ATen's backward from saved indices; a high-side-only overhang is its
    ceil mode with no padding."""
    (kh, kw), (sh, sw), ((pt, pb), (pl, pr)) = geometry
    ceil = pb > pt
    _, idx = F.max_pool2d(x, (kh, kw), (sh, sw), (pt, pl), ceil_mode=ceil, return_indices=True)
    if idx.shape != dy.shape:
        raise AssertionError(f"ATen's pool is {tuple(idx.shape)}, not {tuple(dy.shape)}")
    t = ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
        dy, x, [kh, kw], [sh, sw], [pt, pl], [1, 1], ceil, idx))
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
    sums = {}
    for name, shape, geometry, kind in SHAPES:
        x, dy = pool_inputs(shape, geometry, kind, g)
        dx = torch.empty_like(x)
        k, a, b = kernel_ms(lib, x, dy, dx, geometry), aten_ms(x, dy, geometry), bound_ms(x, dy)
        print(f"POOL_AB {label} {name} {tuple(shape)}: kernel {k:.4f} ms, aten {a:.4f} ms, "
              f"bound {b:.4f} ms, kernel/bound {k / b:.2f}, aten/kernel {a / k:.2f}; card {card}",
              flush=True)
        net = "inception" if name.startswith("inc-") else "vgg" if name.startswith("pool") else ""
        if net:
            n = PER_STEP.get(name, 1)
            s = sums.setdefault(net, [0, 0.0, 0.0, 0.0])
            s[0] += n
            s[1], s[2], s[3] = s[1] + n * k, s[2] + n * a, s[3] + n * b
        del x, dy, dx
    for net, (n, k, a, b) in sums.items():
        print(f"POOL_AB {label} {net}'s {n} pools a step: kernel {k:.4f} ms, aten {a:.4f} ms, "
              f"bound {b:.4f} ms", flush=True)
    torch.cuda.empty_cache()
