"""The port's ``MaskRCNN`` against the JAX package's, on the JAX package's
weights (``load_jax_params`` / ``load_jax_state``; the children's names,
``backbone_level0.SpatialConvolution_0``, ``fpn.SpatialConvolution_4``,
..., are the same in both trees).

* the narrow detector of ``tests/test_models.py``'s
  ``test_maskrcnn_inference_shapes_and_jit`` (one 64x64 image) and the same
  model on a 2-image non-square batch (48x80): boxes, scores and masks
  within 1e-5 absolute plus 1e-5 relative (fixed before the first run: the
  f32 convolutions and matmuls sum their products in another order, a few
  ulps; the boxes' magnitudes reach 80), the labels and the proposals'
  selection equal; a mismatch prints each detection's score gap to the
  next one, so a near-tie that flips shows as one (the test is not
  re-seeded or loosened for it);
* ``infer_module_shape`` of an unbuilt detector: the JAX package's specs,
  no parameter allocated;
* the model file both ways: a JAX-written MaskRCNN file loaded by the port's
  ``nn.load_module`` gives the JAX detections, and the port's file read by
  the JAX package's gives the port's (the same limits);
* the example's ``main`` at a tiny size on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.models import MaskRCNN as JMaskRCNN
from bigdl_tpu.nn.module import infer_module_shape as jax_infer_module_shape
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import Engine, RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.examples import maskrcnn_infer
from bigdl_tpu_torch.models import MaskRCNN
from bigdl_tpu_torch.nn.module import infer_module_shape, spec
from bigdl_tpu_torch.utils.convert import load_jax_params, load_jax_state

ATOL = RTOL = 1e-5
NARROW = dict(n_classes=4, backbone_channels=(8, 16, 32, 64), fpn_channels=16,
              pre_nms_top_n=32, post_nms_top_n=8, detections_per_image=4)
IMAGES = {"one_64x64": ((1, 3, 64, 64), 1), "two_48x80": ((2, 3, 48, 80), 2)}


@pytest.fixture(autouse=True)
def _policy():
    Engine.set_compute_dtype("float32")
    yield
    Engine.set_compute_dtype(None)


def _images(name):
    shape, seed = IMAGES[name]
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_infer(model):
    return jax.jit(lambda p, s, x: model.apply(p, s, x)[0].to_list())


@pytest.fixture(scope="module")
def jax_ref():
    JRandom.set_seed(51)
    jm = JMaskRCNN(**NARROW)
    params, state = jm.init(sample_input=_images("one_64x64"))
    infer = _jax_infer(jm)
    outs = {k: [np.asarray(v) for v in infer(params, state, _images(k))] for k in IMAGES}
    return {"model": jm, "params": params, "state": state, "outs": outs, "infer": infer}


def _port(jax_ref):
    RandomGenerator.set_seed(3)
    pm = MaskRCNN(**NARROW, device="cpu")
    pm.init(sample_input=_images("one_64x64"))
    load_jax_params(pm, jax.tree_util.tree_map(np.asarray, jax_ref["params"]))
    load_jax_state(pm, jax.tree_util.tree_map(np.asarray, jax_ref["state"]))
    return pm.evaluate()


def _forward(pm, x):
    with torch.no_grad():
        return [v.numpy() for v in pm.forward(x)]


def _hold(got, want, what=""):
    """Boxes, scores and masks within the limits, labels equal; on a
    mismatch the message carries each detection's score gap to the next."""
    gaps = np.abs(np.diff(want[1], axis=-1))
    msg = f"{what}: JAX scores {want[1].tolist()}, gaps to the next {gaps.tolist()}"
    assert [g.shape for g in got] == [w.shape for w in want], msg
    assert [g.dtype for g in got] == [np.float32, np.float32, np.int32, np.float32]
    np.testing.assert_array_equal(got[2], want[2], err_msg=msg)
    for i, name in ((0, "boxes"), (1, "scores"), (3, "masks")):
        np.testing.assert_allclose(got[i], want[i], atol=ATOL, rtol=RTOL, err_msg=f"{name} {msg}")


@pytest.mark.parametrize("images", sorted(IMAGES))
def test_detections_match_jax(jax_ref, images):
    pm = _port(jax_ref)
    got, want = _forward(pm, _images(images)), jax_ref["outs"][images]
    _hold(got, want, images)
    n, d = IMAGES[images][0][0], NARROW["detections_per_image"]
    assert got[0].shape == (n, d, 4) and got[3].shape == (n, d, 4, 28, 28)
    b = got[0]
    h, w = IMAGES[images][0][2:]
    assert (b[..., 2] >= b[..., 0]).all() and (b[..., 3] >= b[..., 1]).all()
    assert (b >= 0).all() and (b[..., 2] <= w).all() and (b[..., 3] <= h).all()
    assert (np.diff(got[1], axis=-1) <= 0).all()  # NMS keeps score order
    assert ((got[2] >= 0) & (got[2] < NARROW["n_classes"])).all()


def test_stages_match_jax(jax_ref):
    """The FPN levels and the RPN's proposals of the 2-image batch."""
    jm, jp, js = jax_ref["model"], jax_ref["params"], jax_ref["state"]
    x = _images("two_48x80")
    feats, y = [], jnp.asarray(x)
    for m in jm.modules[: jm.n_backbone]:
        y = m._apply(jp[m.name()], js[m.name()], y, False, None)[0]
        feats.append(y)
    fpn, rpn = jm.modules[jm.n_backbone], jm.modules[jm.n_backbone + 1]
    jlevels = fpn._apply(jp[fpn.name()], js[fpn.name()], feats, False, None)[0]
    jprops = rpn._apply(jp[rpn.name()], js[rpn.name()], jlevels[0], False, None)[0]
    pm = _port(jax_ref)
    with torch.no_grad():
        levels, _ = pm.features(pm.get_parameters(), pm.get_state(), torch.from_numpy(x))
        for g, w in zip(levels, jlevels):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
        rpn_p = pm[pm.n_backbone + 1]
        props = rpn_p.forward(torch.from_numpy(np.array(jlevels[0])))
    np.testing.assert_allclose(props.numpy(), np.asarray(jprops), atol=ATOL, rtol=RTOL)


def test_parameter_paths_are_the_jax_trees(jax_ref):
    pm = _port(jax_ref)
    names = [n for n, _ in pm.named_parameters()]
    assert names[0] == "backbone_level0.SpatialConvolution_0.weight"
    assert "fpn.SpatialConvolution_7.bias" in names
    assert "mask_head.SpatialFullConvolution_2.weight" in names
    assert "rpn.SpatialConvolution_2.weight" in names and "box_head.Linear_3.bias" in names


@pytest.mark.parametrize("shape", [(1, 3, 64, 64), (3, 3, 48, 80)])
def test_infer_module_shape_matches_jax(shape):
    jout = jax_infer_module_shape(JMaskRCNN(**NARROW), jax.ShapeDtypeStruct(shape, jnp.float32))
    pm = MaskRCNN(**NARROW, device="cpu")
    out = infer_module_shape(pm, spec(shape, torch.float32))
    assert not pm.is_built() and not list(pm.parameters())
    assert [(tuple(o.shape), str(o.dtype).replace("torch.", "")) for o in out] == \
        [(tuple(o.shape), str(o.dtype)) for o in jout]
    with pytest.raises(ValueError, match="backbone_level0|SpatialConvolution"):
        infer_module_shape(pm, spec((1, 4, 64, 64), torch.float32))


def test_jax_file_loads_in_the_port_and_back(jax_ref, tmp_path):
    jm = jax_ref["model"]
    path = str(tmp_path / "maskrcnn_jax.npz")
    jm.save_module(path)
    pm = pnn.load_module(path, device="cpu").evaluate()
    assert type(pm).__name__ == "MaskRCNN"
    for images in sorted(IMAGES):
        _hold(_forward(pm, _images(images)), jax_ref["outs"][images], f"JAX file, {images}")
    # the port's file, read by the JAX package
    pm2 = _port(jax_ref)
    path2 = str(tmp_path / "maskrcnn_port.npz")
    pm2.save_module(path2)
    jm2 = jnn.load_module(path2)
    got = [np.asarray(v) for v in _jax_infer(jm2)(jm2.get_parameters(), jm2.get_state(),
                                                   _images("two_48x80"))]
    _hold(got, _forward(pm2, _images("two_48x80")), "port file in JAX")


def test_port_file_roundtrip_is_exact(jax_ref, tmp_path):
    pm = _port(jax_ref)
    path = str(tmp_path / "m.npz")
    pm.save_module(path)
    pm2 = pnn.load_module(path, device="cpu").evaluate()
    for a, b in zip(_forward(pm, _images("two_48x80")), _forward(pm2, _images("two_48x80"))):
        np.testing.assert_array_equal(a, b)


def test_example_main_on_the_cpu(capsys):
    run = maskrcnn_infer.main(["--platform", "cpu", "--image-size", "48", "-b", "1",
                               "--classes", "3"])
    text = capsys.readouterr().out
    assert "first batch:" in text and "steady state:" in text
    assert "boxes (1, 8, 4) scores (1, 8) labels (1, 8) masks (1, 8, 3, 28, 28)" in text
    assert text.count("det[") == 3
    r = run.results
    assert r["labels"].dtype == np.int32 and np.isfinite(r["masks"]).all()
    assert run.model.device.type == "cpu"
