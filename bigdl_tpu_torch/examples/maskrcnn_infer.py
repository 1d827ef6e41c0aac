"""MaskRCNN inference on synthetic images (counterpart of
``examples/maskrcnn/infer.py``; reference: the maskrcnn inference examples of
the 0.10+ zoo).

    python3 -m bigdl_tpu_torch.examples.maskrcnn_infer --platform cpu

Runs the detector (random weights from a seed, the JAX example's narrow
widths: backbone (16, 32, 64, 128), FPN 32, 128 pre-NMS and 32 post-NMS
proposals, 8 detections an image) on ``--batch-size`` seeded standard
normal images of ``--image-size`` squared and prints what the JAX example
prints: the first batch's time, a steady-state batch's time, the output
shapes and the first image's first three detections. It runs on the card,
or on the CPU with ``--platform cpu``.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from ._common import Run, base_parser, device_of, setup_logging


def parser():
    p = base_parser("MaskRCNN inference on synthetic images", batch_size=2)
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--classes", type=int, default=8)
    return p


def build(args):
    """``(model, images)``: the eval-mode detector on the run's device and
    the numpy images."""
    import numpy as np

    from ..models import MaskRCNN
    from ..utils.random import RandomGenerator

    RandomGenerator.set_seed(1)
    model = MaskRCNN(n_classes=args.classes, backbone_channels=(16, 32, 64, 128),
                     fpn_channels=32, pre_nms_top_n=128, post_nms_top_n=32,
                     detections_per_image=8, device=device_of(args))
    x = np.random.default_rng(0).standard_normal(
        (args.batch_size, 3, args.image_size, args.image_size)).astype(np.float32)
    model.evaluate()
    return model, x


def main(argv: Optional[Sequence[str]] = None) -> Run:
    """Parse ``argv`` (the command line when None), run two batches and print
    the detections; ``results`` holds the outputs and the two times."""
    import numpy as np
    import torch

    args = parser().parse_args(argv)
    setup_logging()
    model, x = build(args)
    sync = torch.cuda.synchronize if model.device.type == "cuda" else (lambda: None)
    with torch.no_grad():
        t0 = time.perf_counter()
        out = model.forward(x)
        sync()
        first_s = time.perf_counter() - t0
        print(f"first batch: {first_s:.1f}s")
        t0 = time.perf_counter()
        out = model.forward(x)
        float(out[2].float().sum())  # the scores, read back on the host
        steady_s = time.perf_counter() - t0
    print(f"steady state: {steady_s:.3f}s/batch")
    boxes, scores, labels, masks = (v.cpu().numpy() for v in out)
    print(f"boxes {boxes.shape} scores {scores.shape} labels {labels.shape} masks {masks.shape}")
    for i in range(min(3, boxes.shape[1])):
        print(f"det[{i}]: box={boxes[0, i].round(1).tolist()} score={float(scores[0, i]):.3f} "
              f"label={int(labels[0, i])}")
    results = {"boxes": boxes, "scores": scores, "labels": labels, "masks": masks,
               "first_s": first_s, "steady_s": steady_s}
    return Run(None, model, args, results=results)


if __name__ == "__main__":
    main()
