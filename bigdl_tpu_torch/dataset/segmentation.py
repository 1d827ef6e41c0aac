"""Segmentation / COCO data (counterpart of ``bigdl_tpu/dataset/segmentation.py``;
reference: ``$DL/dataset/segmentation/{COCODataset,MaskUtils,SegmentationMasks}.scala``):
COCO annotation-JSON loading, polygon masks and COCO's run-length encoding,
both the raw counts form and the compressed LEB128-style ascii form used
inside annotation files.

The port's own copy of the JAX package's numpy code, line for line (that
module imports no JAX, but the port imports nothing of the JAX package):
masks are data preparation on the host, decoded to dense uint8 (H, W)
arrays. The RLE codec follows the public COCO format: column-major runs
alternating 0s and 1s; the compressed form packs run-length deltas 5 bits
at a time with a continuation bit, offset by 48. Polygons rasterize through
PIL, imported only when a polygon is decoded.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


class RLEMasks:
    """A run-length-encoded mask (COCO 'counts' + size)."""

    __slots__ = ("counts", "height", "width")

    def __init__(self, counts: Sequence[int], height: int, width: int):
        self.counts = list(int(c) for c in counts)
        self.height = height
        self.width = width

    def size(self) -> Tuple[int, int]:
        return (self.height, self.width)

    def area(self) -> int:
        return sum(self.counts[1::2])  # odd runs are the 1s

    def decode(self) -> np.ndarray:
        return rle_decode(self)

    def __eq__(self, other) -> bool:
        return (isinstance(other, RLEMasks) and self.counts == other.counts
                and self.size() == other.size())


def rle_encode(mask: np.ndarray) -> RLEMasks:
    """Dense (H, W) 0/1 mask -> column-major alternating run lengths."""
    h, w = mask.shape
    flat = np.asarray(mask, np.uint8).reshape(h, w).T.reshape(-1)  # col-major
    # runs always start counting 0s (possibly a 0-length first run)
    changes = np.flatnonzero(np.diff(flat)) + 1
    boundaries = np.concatenate([[0], changes, [flat.size]])
    runs = np.diff(boundaries).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    if not flat.size:
        runs = []
    return RLEMasks(runs, h, w)


def rle_decode(rle: RLEMasks) -> np.ndarray:
    """Run lengths -> dense (H, W) uint8 mask."""
    total = rle.height * rle.width
    flat = np.zeros(total, np.uint8)
    pos, val = 0, 0
    for run in rle.counts:
        if val:
            flat[pos : pos + run] = 1
        pos += run
        val ^= 1
    return flat.reshape(rle.width, rle.height).T  # undo column-major


def rle_to_string(rle: RLEMasks) -> str:
    """COCO compressed counts: 5-bit groups + continuation bit, offset 48.

    Runs after the first two are delta-encoded against the run two back.
    """
    out = []
    for i, c in enumerate(rle.counts):
        x = c - (rle.counts[i - 2] if i > 2 else 0)
        more = True
        while more:
            chunk = x & 0x1F
            x >>= 5
            # sign-aware termination (negative deltas sign-extend)
            more = not (x == 0 and not (chunk & 0x10)) and not (
                x == -1 and (chunk & 0x10)
            )
            if more:
                chunk |= 0x20
            out.append(chr(chunk + 48))
    return "".join(out)


def rle_from_string(s: str, height: int, width: int) -> RLEMasks:
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            chunk = ord(s[i]) - 48
            x |= (chunk & 0x1F) << (5 * k)
            more = bool(chunk & 0x20)
            i += 1
            k += 1
            if not more and (chunk & 0x10):
                x |= -1 << (5 * k)  # sign-extend
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return RLEMasks(counts, height, width)


def poly_to_mask(polygons: Sequence[Sequence[float]], height: int,
                 width: int) -> np.ndarray:
    """Rasterize COCO polygon(s) [x1,y1,x2,y2,...] to a dense binary mask."""
    from PIL import Image, ImageDraw

    img = Image.new("L", (width, height), 0)
    draw = ImageDraw.Draw(img)
    for poly in polygons:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, np.uint8)


class PolyMasks:
    """Polygon-form mask (list of rings), decodable to dense."""

    __slots__ = ("polygons", "height", "width")

    def __init__(self, polygons: Sequence[Sequence[float]], height: int,
                 width: int):
        self.polygons = [list(map(float, p)) for p in polygons]
        self.height = height
        self.width = width

    def size(self) -> Tuple[int, int]:
        return (self.height, self.width)

    def decode(self) -> np.ndarray:
        return poly_to_mask(self.polygons, self.height, self.width)

    def to_rle(self) -> RLEMasks:
        return rle_encode(self.decode())


class COCOAnnotation:
    __slots__ = ("bbox", "category_id", "mask", "is_crowd", "area")

    def __init__(self, bbox, category_id, mask, is_crowd, area):
        self.bbox = bbox  # (x, y, w, h) COCO convention
        self.category_id = category_id
        self.mask = mask  # PolyMasks | RLEMasks | None
        self.is_crowd = is_crowd
        self.area = area


class COCOImage:
    __slots__ = ("image_id", "file_name", "height", "width", "annotations")

    def __init__(self, image_id, file_name, height, width):
        self.image_id = image_id
        self.file_name = file_name
        self.height = height
        self.width = width
        self.annotations: List[COCOAnnotation] = []


class COCODataset:
    """COCO annotation-JSON reader (reference: ``COCODataset.scala``).

    Parses the instances JSON into images + per-image annotations with lazy
    masks; ``category_id`` is remapped to a contiguous 1-based index the way
    the reference's ``categoryId2Idx`` does.
    """

    def __init__(self, images: List[COCOImage], categories: List[Dict[str, Any]]):
        self.images = images
        self.categories = categories
        self.cat_id_to_idx = {
            c["id"]: i + 1 for i, c in enumerate(categories)
        }

    @staticmethod
    def load(json_path: str, image_root: Optional[str] = None) -> "COCODataset":
        with open(json_path) as f:
            blob = json.load(f)
        images: Dict[int, COCOImage] = {}
        for im in blob.get("images", []):
            images[im["id"]] = COCOImage(
                im["id"],
                os.path.join(image_root, im["file_name"]) if image_root
                else im["file_name"],
                im["height"], im["width"],
            )
        for ann in blob.get("annotations", []):
            img = images.get(ann["image_id"])
            if img is None:
                continue
            seg = ann.get("segmentation")
            mask = None
            if isinstance(seg, list) and seg:
                mask = PolyMasks(seg, img.height, img.width)
            elif isinstance(seg, dict):
                counts = seg["counts"]
                h, w = seg["size"]
                mask = (rle_from_string(counts, h, w)
                        if isinstance(counts, str) else RLEMasks(counts, h, w))
            img.annotations.append(COCOAnnotation(
                tuple(ann.get("bbox", (0, 0, 0, 0))),
                ann.get("category_id", 0),
                mask,
                bool(ann.get("iscrowd", 0)),
                ann.get("area", 0.0),
            ))
        return COCODataset(list(images.values()),
                           blob.get("categories", []))

    def __len__(self) -> int:
        return len(self.images)
