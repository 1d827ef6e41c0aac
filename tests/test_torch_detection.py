"""The port's ``nn/detection.py`` against the JAX package's, stage by stage,
each stage fed the JAX stage's own input and run on the JAX stage's
parameters (``load_jax_params``).

Tolerances, fixed before the first run:

* continuous outputs (box arithmetic, RoiAlign, the FPN, the heads, the
  RPN's proposal boxes): within 1e-5 absolute plus 1e-5 relative. The same
  f32 formulas in both packages; they part only where XLA and ATen sum a
  convolution's or a matmul's products in another order, or round ``exp``
  / ``log`` a unit in the last place apart;
* discrete outputs equal: NMS indices (on the JAX package's own NMS cases,
  on planted exact ties and on all-zero scores, where only a stable order
  decides), anchor grids (exact arithmetic), FPN level assignments,
  matches and the sampler's weights given the JAX function's own draws;
* the losses and their gradients (``jax.grad`` against autograd): within
  1e-5 relative plus 1e-6 absolute (``logaddexp`` and ``log_softmax``
  differ by a few ulps between the packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn.detection as jdet
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import Engine
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.nn import detection as pdet
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state
from bigdl_tpu_torch.utils.table import T

ATOL = RTOL = 1e-5
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(y):
    if isinstance(y, (list, tuple)):
        return [_np(v) for v in y]
    return y.detach().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _boxes(n, seed, lo=0.0, hi=40.0, size=(4.0, 20.0)):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(lo, hi, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(*size, (n, 2))], 1).astype(np.float32)


# ------------------------------------------------------------------ box utils
def test_box_utils_match_jax():
    a, b = _boxes(12, 1), _boxes(9, 2)
    a[3] = [5, 5, 5, 9]  # zero width
    b[4] = [30, 30, 20, 20]  # inverted: area clamps at 0
    np.testing.assert_allclose(_np(pdet.bbox_area(_t(a))), jdet.bbox_area(a), rtol=RTOL)
    np.testing.assert_allclose(_np(pdet.bbox_iou(_t(a), _t(b))), jdet.bbox_iou(a, b),
                               atol=ATOL, rtol=RTOL)
    enc = _np(pdet.bbox_encode(_t(b[:9]), _t(a[:9])))
    np.testing.assert_allclose(enc, jdet.bbox_encode(b[:9], a[:9]), atol=ATOL, rtol=RTOL)
    deltas = _x((12, 4), 3)
    deltas[0, 2:] = 9.0  # beyond the log(1000/16) clip
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        np.testing.assert_allclose(_np(pdet.bbox_decode(_t(deltas), _t(a), w)),
                                   jdet.bbox_decode(deltas, a, w), atol=ATOL, rtol=RTOL)
    big = _boxes(12, 4, -20, 60, (10, 60))
    np.testing.assert_array_equal(_np(pdet.bbox_clip(_t(big), 30, 50)),
                                  jdet.bbox_clip(big, 30, 50))
    # batched leading dims give the per-image results
    np.testing.assert_array_equal(_np(pdet.bbox_iou(_t(np.stack([a, a])), _t(np.stack([a, a]))))[1],
                                  _np(pdet.bbox_iou(_t(a), _t(a))))


# ------------------------------------------------------------------------ nms
def _np_nms(boxes, scores, thr):
    """The JAX package's numpy greedy NMS oracle (``TestBoxOps``)."""
    keep, alive = [], np.ones(len(boxes), bool)
    for i in np.argsort(-scores, kind="stable"):
        if alive[i]:
            keep.append(int(i))
            alive &= ~(np.asarray(jdet.bbox_iou(boxes[i:i + 1], boxes))[0] > thr)
    return keep


def _nms_cases():
    rng = np.random.default_rng(3)
    boxes = _boxes(30, 3)
    scores = rng.random(30).astype(np.float32)
    tied = np.repeat(rng.random(6).astype(np.float32), 5)  # exact 5-way ties
    yield "oracle", boxes, scores, 0.5, 30
    yield "padding", np.float32([[0, 0, 10, 10], [100, 100, 110, 110]]), np.float32([0.9, 0.8]), \
        0.5, 5
    yield "planted_ties", boxes, tied, 0.5, 20
    yield "all_zero", boxes, np.zeros(30, np.float32), 0.3, 12
    yield "identical_boxes", np.tile(np.float32([[1, 1, 9, 9]]), (8, 1)), \
        np.float32([0.5, 0.7, 0.7, 0.2, 0.7, 0.0, 0.0, 0.5]), 0.5, 4
    yield "neg_zero", boxes[:10], np.float32([0.0, -0.0] * 5), 0.5, 10


@pytest.mark.parametrize("case", [c[0] for c in _nms_cases()])
def test_nms_indices_equal_jax(case):
    _, boxes, scores, thr, k = next(c for c in _nms_cases() if c[0] == case)
    want = np.asarray(jdet.nms(jnp.asarray(boxes), jnp.asarray(scores), thr, k))
    got = _np(pdet.nms(_t(boxes), _t(scores), thr, k))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    oracle = _np_nms(boxes, scores, thr)[:k]
    assert got[: len(oracle)].tolist() == oracle and (got[len(oracle):] == -1).all()


def test_batched_nms_is_per_image():
    boxes = np.stack([_boxes(20, 5), _boxes(20, 6)])
    scores = np.stack([_x((20,), 7), np.zeros(20, np.float32)])
    got = _np(pdet.batched_nms(_t(boxes), _t(scores), 0.4, 9))
    for i in range(2):
        np.testing.assert_array_equal(got[i], _np(pdet.nms(_t(boxes[i]), _t(scores[i]), 0.4, 9)))


# --------------------------------------------------------------------- anchor
@pytest.mark.parametrize("ratios,sizes,hw,stride", [
    ([0.5, 1.0, 2.0], [8.0, 16.0], (2, 3), 16.0),
    ([0.5, 1.0, 2.0], [32.0], (5, 7), 2.0),  # non-square, MaskRCNN's
    ([1.0], [16.0], (6, 6), 8.0),
])
def test_anchor_grid_equal(ratios, sizes, hw, stride):
    j = jdet.Anchor(ratios, sizes)
    p = pdet.Anchor(ratios, sizes)
    np.testing.assert_array_equal(p.base_anchors(), j.base_anchors())
    np.testing.assert_array_equal(_np(p.generate(*hw, stride)), np.asarray(j.generate(*hw, stride)))


# ------------------------------------------------------------------- RoiAlign
def _rois(n, seed, h, w, scale):
    b = _boxes(n, seed, -4, max(h, w) / scale, (0.3, 60))
    b[0] = [2, 2, 2.5, 2.4]  # under one cell: roi size clamps to 1
    b[1] = [-10, -10, 500, 500]  # past every edge
    return b


@pytest.mark.parametrize("out,scale,s", [((2, 2), 1.0, 2), ((7, 7), 0.25, 2), ((3, 5), 0.5, 3)])
def test_roi_align_matches_jax(out, scale, s):
    feats = _x((5, 11, 14), 8)
    rois = _rois(9, 9, 11, 14, scale)
    want = np.asarray(jdet.roi_align(jnp.asarray(feats), jnp.asarray(rois), out, scale, s))
    got = _np(pdet.roi_align(_t(feats), _t(rois), out, scale, s))
    assert got.shape == want.shape == (9, 5) + out
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# sqrt(area) on an octave of 224 (112, 224, 448, 896) and a hair on either
# side: the +1e-6 inside the log2 puts an exact octave on the upper level in
# both packages
BOUNDARY_SIDES = [111.99, 112.0, 112.01, 223.99, 224.0, 224.01, 447.9, 448.0, 896.0, 10.0,
                  2000.0]


def _boundary_rois():
    return np.float32([[0, 0, s, s] for s in BOUNDARY_SIDES])


def _levels_read_back(multilevel, rois, scales):
    """The level each roi is pooled from, read from ``multilevel``'s output
    over maps whose every cell holds their level's index."""
    feats = [np.full((1, 4, 4), i, np.float32) for i in range(len(scales))]
    return np.rint(np.asarray(multilevel(feats, rois, scales, (1, 1)))[:, 0, 0, 0]).astype(int)


def test_level_assignment_on_octave_boundaries():
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32, 1 / 64]
    rois = _boundary_rois()
    want = _levels_read_back(lambda f, r, *a: jdet.multilevel_roi_align(
        [jnp.asarray(v) for v in f], jnp.asarray(r), *a), rois, scales)
    got = _levels_read_back(lambda f, r, *a: pdet.multilevel_roi_align(
        [_t(v) for v in f], _t(r), *a), rois, scales)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _np(pdet.roi_levels(_t(rois), len(scales), pdet._canonical_level_index(scales))), got)
    # canonical level 2 (1/16) for a 224 roi; each exact octave goes up a level
    assert got.tolist() == [0, 1, 1, 1, 2, 2, 2, 3, 4, 0, 4]


def test_multilevel_roi_align_matches_jax():
    scales = [1 / 2, 1 / 4, 1 / 8, 1 / 16]
    feats = [_x((3, 64 // 2 ** i, 80 // 2 ** i), 10 + i) for i in range(4)]
    rois = np.concatenate([_rois(10, 11, 64, 80, 0.5) * 1.0, _boundary_rois()[:8] / 4.0])
    want = np.asarray(jdet.multilevel_roi_align([jnp.asarray(f) for f in feats],
                                                jnp.asarray(rois), scales, (4, 4)))
    got = _np(pdet.multilevel_roi_align([_t(f) for f in feats], _t(rois), scales, (4, 4)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # the batched form is the per-image one
    b = _np(pdet.batched_multilevel_roi_align([_t(np.stack([f, f])) for f in feats],
                                              _t(np.stack([rois, rois[::-1].copy()])),
                                              scales, (4, 4)))
    np.testing.assert_array_equal(b[0], got)
    np.testing.assert_array_equal(b[1], got[::-1])


def test_pooler_matches_jax():
    scales = [1 / 16, 1 / 32]
    feats = [_x((3, 16, 16), 12), _x((3, 8, 8), 13)]
    rois = np.float32([[0, 0, 32, 32], [0, 0, 500, 500], [8, 40, 100, 90]])
    jp = jdet.Pooler((2, 2), scales)
    want = np.asarray(jp.forward(JT([jnp.asarray(f) for f in feats], jnp.asarray(rois))))
    pp = pnn.Pooler((2, 2), scales, device="cpu")
    got = _np(pp.forward(T([_t(f) for f in feats], _t(rois))))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------- FPN and heads
def _port_of(jm, pm, sample):
    jp, js = jm.init(jax.random.PRNGKey(0), sample_input=sample)
    pm.init(sample_input=[_t(s) for s in sample] if isinstance(sample, list) else _t(sample))
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jp))
    load_jax_state(pm, jax.tree_util.tree_map(np.asarray, js))
    return jp, js


@pytest.mark.parametrize("shapes", [[(2, 4, 8, 8), (2, 8, 4, 4)],
                                    [(1, 4, 25, 25), (1, 8, 13, 13)],  # 25 over 13
                                    [(2, 3, 20, 30), (2, 5, 10, 15), (2, 6, 5, 8), (2, 7, 3, 4)]])
def test_fpn_matches_jax(shapes):
    xs = [_x(s, i) for i, s in enumerate(shapes)]
    cin = [s[1] for s in shapes]
    jm, pm = jdet.FPN(cin, out_channels=6), pnn.FPN(cin, out_channels=6, device="cpu")
    jp, js = _port_of(jm, pm, xs)
    want = jm.apply(jp, js, [jnp.asarray(x) for x in xs])[0]
    got = pm.forward([_t(x) for x in xs])
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATOL, rtol=RTOL)
    assert [n for n, _ in pm.named_parameters()][:2] == ["SpatialConvolution_0.weight",
                                                         "SpatialConvolution_0.bias"]


RPN_CASES = {
    "square_1_anchor": (dict(in_channels=8, ratios=[1.0], sizes=[16.0], stride=8.0, pre=64,
                             post=10), (2, 8, 6, 6)),
    "nonsquare_3_anchors_cut": (dict(in_channels=6, ratios=[0.5, 1.0, 2.0], sizes=[8.0],
                                     stride=4.0, pre=40, post=12), (2, 6, 7, 9)),
}


def _rpn_pair(kw, shape):
    args = dict(stride=kw["stride"], pre_nms_top_n=kw["pre"], post_nms_top_n=kw["post"])
    jm = jdet.RegionProposal(kw["in_channels"], jdet.Anchor(kw["ratios"], kw["sizes"]), **args)
    pm = pnn.RegionProposal(kw["in_channels"], pnn.Anchor(kw["ratios"], kw["sizes"]), **args,
                            device="cpu")
    x = _x(shape, 4)
    jp, js = _port_of(jm, pm, x)
    return jm, pm, jp, js, x


def _jax_rpn_head(jm, jp, js, x):
    conv, cls_head, box_head = jm.modules
    t = jnp.maximum(conv._apply(jp[conv.name()], js[conv.name()], x, False, None)[0], 0.0)
    return (cls_head._apply(jp[cls_head.name()], js[cls_head.name()], t, False, None)[0],
            box_head._apply(jp[box_head.name()], js[box_head.name()], t, False, None)[0])


@pytest.mark.parametrize("case", sorted(RPN_CASES))
def test_region_proposal_matches_jax(case):
    jm, pm, jp, js, x = _rpn_pair(*RPN_CASES[case])
    jl, jd = _jax_rpn_head(jm, jp, js, jnp.asarray(x))
    with torch.no_grad():
        pl, pd, _ = pm.head(pm.get_parameters(), pm.get_state(), _t(x))
        np.testing.assert_allclose(_np(pl), np.asarray(jl), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(_np(pd), np.asarray(jd), atol=ATOL, rtol=RTOL)
        # the discrete part on the JAX head's own outputs: the same proposals
        props = _np(pm.proposals(_t(jl), _t(jd)))
        want = np.asarray(jm.apply(jp, js, jnp.asarray(x))[0])
        np.testing.assert_allclose(props, want, atol=ATOL, rtol=RTOL)
        # and end to end from the image features
        np.testing.assert_allclose(_np(pm.forward(x)), want, atol=ATOL, rtol=RTOL)
    assert props.shape == (2, RPN_CASES[case][0]["post"], 4)


def test_box_head_matches_jax():
    jm, pm = jdet.BoxHead(3 * 2 * 2, 16, n_classes=5), pnn.BoxHead(12, 16, 5, device="cpu")
    x = _x((7, 3, 2, 2), 5)
    jp, js = _port_of(jm, pm, x)
    (js_, jd), _ = jm.apply(jp, js, jnp.asarray(x))
    ps, pd = pm.forward(x)
    np.testing.assert_allclose(_np(ps), np.asarray(js_), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_np(pd), np.asarray(jd), atol=ATOL, rtol=RTOL)


def test_mask_head_matches_jax():
    jm, pm = jdet.MaskHead(3, 8, 2, 4), pnn.MaskHead(3, 8, 2, 4, device="cpu")
    x = _x((5, 3, 7, 7), 6)
    jp, js = _port_of(jm, pm, x)
    want = np.asarray(jm.apply(jp, js, jnp.asarray(x))[0])
    got = _np(pm.forward(x))
    assert got.shape == want.shape == (5, 4, 14, 14)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert (want < 0).any()  # no ReLU after the predictor
    assert type(pm[2]).__name__ == "SpatialFullConvolution"


# --------------------------------------------------------- training machinery
def _match_case():
    anchors = np.float32([[0, 0, 10, 10], [0, 0, 10, 11], [0, 0, 10, 16], [50, 50, 60, 60],
                          [100, 100, 110, 110]])
    gt = np.float32([[0, 0, 10, 10], [50, 50, 60, 60], [0, 0, 0, 0]])
    return anchors, gt, np.float32([1, 1, 0])


@pytest.mark.parametrize("kw", [dict(high_threshold=0.7, low_threshold=0.3),
                                dict(high_threshold=0.5, low_threshold=0.5,
                                     allow_low_quality=False)])
def test_match_targets_equal(kw):
    anchors, gt, valid = _match_case()
    cases = [(anchors, gt, valid),
             (np.float32([[0, 0, 0.1, 0.1]]), gt, valid),
             (np.float32([[0, 0, 4, 4]]), np.float32([[0, 0, 20, 20]]), np.float32([1])),
             # the padded gt's best anchor is the valid gt's: still forced positive
             (np.float32([[0, 0, 4, 4], [50, 50, 54, 54]]),
              np.float32([[0, 0, 20, 20], [0, 0, 0, 0]]), np.float32([1, 0])),
             (_boxes(40, 20), _boxes(6, 21), np.float32([1, 1, 0, 1, 0, 0]))]
    for a, g, v in cases:
        want = np.asarray(jdet.match_targets(jnp.asarray(a), jnp.asarray(g), jnp.asarray(v), **kw))
        got = _np(pdet.match_targets(_t(a), _t(g), _t(v), **kw))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    if kw.get("allow_low_quality", True):
        a, g, v = cases[3]
        assert _np(pdet.match_targets(_t(a), _t(g), _t(v), **kw)).tolist() == [0, -1]


def _jax_draws(key, n):
    kp, kn = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kp, (n,))), np.asarray(jax.random.uniform(kn, (n,))))


@pytest.mark.parametrize("batch,frac,seed", [(32, 0.25, 0), (8, 0.5, 1), (256, 0.5, 2)])
def test_sample_matches_from_the_jax_draws(batch, frac, seed):
    match = np.int32([0] * 10 + [-1] * 90 + [-2] * 7 + [1] * 3)
    key = jax.random.PRNGKey(seed)
    jpos, jneg = jdet.sample_matches(jnp.asarray(match), key, batch, frac)
    ppos, pneg = pdet.sample_matches(_t(match), tuple(map(_t, _jax_draws(key, len(match)))),
                                     batch, frac)
    np.testing.assert_array_equal(_np(ppos), np.asarray(jpos))
    np.testing.assert_array_equal(_np(pneg), np.asarray(jneg))


def test_sample_matches_with_a_generator_keeps_the_budget():
    match = torch.tensor([0] * 10 + [-1] * 90, dtype=torch.int32)
    pos_w, neg_w = pdet.sample_matches(match, torch.Generator().manual_seed(0), 32, 0.25)
    assert float(pos_w.sum()) == 8.0 and float(neg_w.sum()) == 24.0
    assert float((pos_w * (match != 0)).sum()) == 0 and float((neg_w * (match != -1)).sum()) == 0


def _close(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want), rtol=LOSS_RTOL, atol=LOSS_ATOL,
                               err_msg=what)


def test_rpn_loss_and_gradients_match_jax():
    anchors = np.concatenate([_match_case()[0], _boxes(60, 22)])
    gt = np.float32([[0, 0, 10, 10], [50, 50, 60, 60], [20, 5, 45, 30], [0, 0, 0, 0]])
    valid = np.float32([1, 1, 1, 0])
    obj, deltas = _x((len(anchors),), 23, 2.0), _x((len(anchors), 4), 24, 0.3)
    key = jax.random.PRNGKey(5)
    draws = tuple(map(_t, _jax_draws(key, len(anchors))))
    for batch in (256, 16):
        def jloss(o, d):
            c, b = jdet.rpn_loss(o, d, jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid),
                                 key, batch)
            return c + 2.0 * b, (c, b)

        (_, (jc, jb)), (jgo, jgd) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
            jnp.asarray(obj), jnp.asarray(deltas))
        o, d = _t(obj).requires_grad_(True), _t(deltas).requires_grad_(True)
        pc, pb = pdet.rpn_loss(o, d, _t(anchors), _t(gt), _t(valid), draws, batch)
        go, gd = torch.autograd.grad(pc + 2.0 * pb, [o, d])
        _close(float(pc.detach()), jc, "cls")
        _close(float(pb.detach()), jb, "box")
        _close(_np(go), jgo, "d objectness")
        _close(_np(gd), jgd, "d deltas")
        assert float(pb.detach()) > 0


def test_fast_rcnn_loss_and_gradients_match_jax():
    n, c = 48, 5
    props = np.concatenate([_boxes(n - 4, 25, 0, 50, (10, 40)),
                            np.float32([[0, 0, 60, 60], [2, 2, 58, 61], [40, 40, 90, 90],
                                        [0, 0, 0, 0]])])
    gt = np.float32([[0, 0, 60, 60], [40, 42, 88, 90], [0, 0, 0, 0]])
    labels, valid = np.int32([2, 4, 0]), np.float32([1, 1, 0])
    logits, deltas = _x((n, c), 26), _x((n, 4 * c), 27, 0.1)
    key = jax.random.PRNGKey(2)
    draws = tuple(map(_t, _jax_draws(key, n)))

    def jloss(lg, dl):
        cl, bx = jdet.fast_rcnn_loss(lg, dl, jnp.asarray(props), jnp.asarray(gt),
                                     jnp.asarray(labels), jnp.asarray(valid), key, 16)
        return cl + 3.0 * bx, (cl, bx)

    (_, (jc, jb)), (jgl, jgd) = jax.value_and_grad(jloss, (0, 1), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(deltas))
    lg, dl = _t(logits).requires_grad_(True), _t(deltas).requires_grad_(True)
    pc, pb = pdet.fast_rcnn_loss(lg, dl, _t(props), _t(gt), _t(labels), _t(valid), draws, 16)
    gl, gd = torch.autograd.grad(pc + 3.0 * pb, [lg, dl])
    _close(float(pc.detach()), jc, "cls")
    _close(float(pb.detach()), jb, "box")
    _close(_np(gl), jgl, "d logits")
    _close(_np(gd), jgd, "d deltas")
    assert float(pb.detach()) > 0 and np.abs(_np(gd)).sum() > 0


def test_smooth_l1_matches_jax():
    x = np.concatenate([_x((50,), 28, 0.3), np.float32([0.0, 1 / 9, -1 / 9, 1e-8])])
    for beta in (1.0 / 9, 1.0):
        np.testing.assert_allclose(_np(pdet.smooth_l1(_t(x), beta)),
                                   jdet.smooth_l1(jnp.asarray(x), beta), rtol=1e-6, atol=1e-7)


# -------------------------------------------------- the card (marked gpu)
def test_true_div_rounds_once():
    """``precision.true_div`` is IEEE division on the CPU (ATen's card
    divides by a host scalar through its reciprocal: see the gpu twin)."""
    from bigdl_tpu_torch.utils.precision import true_div

    x = torch.rand(100000, generator=torch.Generator().manual_seed(0)) * 300
    for c in (7.0, 14.0, 224.0, float(np.float32(np.log(2.0))), 1 / 9):
        np.testing.assert_array_equal(true_div(x, c).numpy(), x.numpy() / np.float32(c))


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "`python -m pytest -m gpu tests/test_torch_detection.py`")


@pytest.mark.gpu
def test_true_div_on_the_card_matches_the_cpu(cuda_card):
    from bigdl_tpu_torch.utils.precision import true_div

    x = torch.rand(100000, generator=torch.Generator().manual_seed(0)) * 300
    for c in (7.0, 224.0, 1 / 9):
        assert torch.equal(true_div(x.cuda(), c).cpu(), x / c)


@pytest.mark.gpu
def test_maskrcnn_forward_has_no_host_sync_on_the_card(cuda_card):
    """The whole detector forward under ``set_sync_debug_mode("error")``
    (a ReLU that copied its bound from the host failed it), and card vs CPU
    RoiAlign of the same rois within 1e-6 (true division on both)."""
    from bigdl_tpu_torch.models import MaskRCNN

    model = MaskRCNN(4, backbone_channels=(8, 16, 32, 64), fpn_channels=16,
                     pre_nms_top_n=32, post_nms_top_n=8, detections_per_image=4).evaluate()
    x = torch.from_numpy(_x((2, 3, 64, 96), 30)).cuda()
    with torch.no_grad():
        model.forward(x)  # builds; the anchors' base reaches the card once
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = model.forward(x)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert [tuple(o.shape) for o in out] == [(2, 4, 4), (2, 4), (2, 4), (2, 4, 4, 28, 28)]
    feats, rois = _x((5, 11, 14), 8), _rois(9, 9, 11, 14, 0.25)
    cpu = pdet.roi_align(_t(feats), _t(rois), (7, 7), 0.25)
    card = pdet.roi_align(_t(feats).cuda(), _t(rois).cuda(), (7, 7), 0.25).cpu()
    assert float((card - cpu).abs().max()) <= 1e-6 * float(cpu.abs().max())
