"""The port's COCO mask codec and annotation reader
(``bigdl_tpu_torch.dataset.segmentation``) against the JAX package's: the
JAX package's ``TestRLE`` / ``TestPolyAndCoco`` cases and more, each run
through both modules, with equal arrays, counts, strings and annotations
(both are numpy on the host; nothing may differ)."""

import json

import numpy as np
import pytest

import bigdl_tpu.dataset.segmentation as jseg
import bigdl_tpu_torch.dataset.segmentation as pseg

MODULES = (jseg, pseg)


def _masks():
    rng = np.random.default_rng(0)
    out = [(rng.random((13, 17)) > 0.5).astype(np.uint8) for _ in range(5)]
    out += [(rng.random((9, 11)) > 0.3).astype(np.uint8) for _ in range(5)]
    out += [np.zeros((5, 5), np.uint8), np.ones((5, 5), np.uint8),
            np.array([[0, 1], [0, 0]], np.uint8), np.eye(4, 5, dtype=np.uint8),
            np.zeros((0, 3), np.uint8)]
    big = np.zeros((64, 48), np.uint8)
    big[3:60, 5:40] = 1  # long runs: multi-chunk deltas, negative ones too
    big[20:22, :] = 0
    out.append(big)
    return out


@pytest.mark.parametrize("i", range(len(_masks())))
def test_rle_codec_equal(i):
    mask = _masks()[i]
    j, p = (m.rle_encode(mask) for m in MODULES)
    assert p.counts == j.counts and p.size() == j.size() and p.area() == j.area()
    np.testing.assert_array_equal(p.decode(), j.decode())
    np.testing.assert_array_equal(p.decode(), mask)
    s = pseg.rle_to_string(p)
    assert s == jseg.rle_to_string(j)
    h, w = mask.shape
    back_p, back_j = pseg.rle_from_string(s, h, w), jseg.rle_from_string(s, h, w)
    assert back_p.counts == back_j.counts == p.counts
    np.testing.assert_array_equal(pseg.rle_decode(back_p), mask)


def test_known_counts_column_major():
    mask = np.array([[0, 1], [0, 0]], np.uint8)
    assert pseg.rle_encode(mask).counts == jseg.rle_encode(mask).counts == [2, 1, 1]


def test_rle_equality_and_handmade_counts():
    a, b = pseg.RLEMasks([2, 1, 1], 2, 2), pseg.RLEMasks([2, 1, 1], 2, 2)
    assert a == b and a != pseg.RLEMasks([2, 1, 1], 1, 4)
    counts = [5, 40, 3, 200, 1, 1]  # deltas of every sign against the run two back
    s = pseg.rle_to_string(pseg.RLEMasks(counts, 10, 25))
    assert s == jseg.rle_to_string(jseg.RLEMasks(counts, 10, 25))
    assert pseg.rle_from_string(s, 10, 25).counts == counts


@pytest.mark.parametrize("polys,h,w", [
    ([[1, 1, 4, 1, 4, 4, 1, 4]], 6, 6),
    ([[0.5, 0.5, 9.2, 1.0, 5.0, 7.7], [2, 8, 3, 8, 3, 9, 2, 9]], 10, 11),
    ([[1, 1, 2, 2]], 5, 5),  # fewer than 3 points: skipped
])
def test_polygons_equal(polys, h, w):
    j, p = jseg.PolyMasks(polys, h, w), pseg.PolyMasks(polys, h, w)
    assert p.polygons == j.polygons and p.size() == j.size()
    np.testing.assert_array_equal(p.decode(), j.decode())
    assert p.to_rle() == pseg.RLEMasks(j.to_rle().counts, h, w)


def test_square_polygon_rasterizes():
    m = pseg.PolyMasks([[1, 1, 4, 1, 4, 4, 1, 4]], 6, 6).decode()
    assert m[2, 2] == 1 and m[0, 0] == 0 and m[5, 5] == 0 and m.sum() >= 9


def _blob():
    return {
        "images": [{"id": 7, "file_name": "a.jpg", "height": 4, "width": 5},
                   {"id": 9, "file_name": "b.jpg", "height": 6, "width": 6}],
        "annotations": [
            {"image_id": 7, "category_id": 18, "bbox": [0, 0, 2, 2],
             "segmentation": [[0, 0, 2, 0, 2, 2, 0, 2]], "iscrowd": 0, "area": 4.0},
            {"image_id": 7, "category_id": 22,
             "segmentation": {"size": [4, 5], "counts": jseg.rle_to_string(
                 jseg.rle_encode(np.eye(4, 5, dtype=np.uint8)))}, "iscrowd": 1},
            {"image_id": 9, "category_id": 18, "bbox": [1, 1, 3, 2],
             "segmentation": {"size": [6, 6], "counts": [7, 4, 2, 4, 19]}, "iscrowd": 1},
            {"image_id": 9, "category_id": 22, "bbox": [2, 2, 1, 1], "segmentation": []},
            {"image_id": 99, "category_id": 18, "bbox": [0, 0, 1, 1]},  # no such image
        ],
        "categories": [{"id": 18, "name": "dog"}, {"id": 22, "name": "cat"}],
    }


def _ann(a):
    mask = None if a.mask is None else (type(a.mask).__name__, a.mask.decode().tolist())
    return (a.bbox, a.category_id, a.is_crowd, a.area, mask)


@pytest.mark.parametrize("root", [None, "/imgs"])
def test_coco_json_load_equal(tmp_path, root):
    path = tmp_path / "instances.json"
    path.write_text(json.dumps(_blob()))
    j, p = (m.COCODataset.load(str(path), image_root=root) for m in MODULES)
    assert len(p) == len(j) == 2
    assert p.cat_id_to_idx == j.cat_id_to_idx == {18: 1, 22: 2}
    assert p.categories == j.categories
    for pi, ji in zip(p.images, j.images):
        assert (pi.image_id, pi.file_name, pi.height, pi.width) == \
            (ji.image_id, ji.file_name, ji.height, ji.width)
        assert [_ann(a) for a in pi.annotations] == [_ann(a) for a in ji.annotations]
    img = p.images[0]
    assert img.file_name == ("/imgs/a.jpg" if root else "a.jpg")
    np.testing.assert_array_equal(img.annotations[1].mask.decode(), np.eye(4, 5, dtype=np.uint8))
    assert img.annotations[1].is_crowd and p.images[1].annotations[1].mask is None
