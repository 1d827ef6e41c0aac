"""The port's vision pipeline and the small dataset helpers against the JAX
package's: each of the 20 augmentations under a seeded chunk RNG
(``scoped_numpy_rng``, the ``DataPipeline`` 's seam) at two seeds, an
ImageNet chain through a ``DataPipeline`` at 0 and 4 workers, ``ImageFrame``
(PNG files written here with PIL, in-memory arrays, ``to_dataset`` with and
without the native normalize route), the classic BGR helpers,
``template_images``, ``load_cifar10``, the text helpers and
``synthetic_news20``. Everything is numpy arithmetic on the same inputs,
compared byte for byte; the one exception is the fused normalize route,
held within 1e-5 (the host library multiplies by ``1 / std``) unless the
JAX package's own library is loaded, when it is bit-equal.
"""

import io
import pickle

import numpy as np
import pytest

import bigdl_tpu.transform.vision.image as jv
from bigdl_tpu.dataset import cifar as jcifar
from bigdl_tpu.dataset import dataset as jd
from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset import pipeline as jp
from bigdl_tpu.dataset import synthetic as jsyn
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import RandomGenerator
from bigdl_tpu_torch.dataset import cifar as pcifar
from bigdl_tpu_torch.dataset import dataset as pd
from bigdl_tpu_torch.dataset import image as pimage
from bigdl_tpu_torch.dataset import pipeline as pp
from bigdl_tpu_torch.dataset import synthetic as psyn
from bigdl_tpu_torch.dataset import text as ptext
import bigdl_tpu_torch.transform.vision.image as pv

from test_torch_dataset_chains import _seed_both, assert_same_batches

SEEDS = [3, 17]


def _augmentations(v):
    """(name, transformer) of all 20, built the same way in package ``v``."""
    return [
        ("AspectScale", v.AspectScale(9, max_size=14)),
        ("Brightness", v.Brightness(-20.0, 30.0)),
        ("CenterCrop", v.CenterCrop(7, 5)),
        ("ChannelNormalize", v.ChannelNormalize(104.0, 117.0, 123.0, 58.0, 57.0, 59.0)),
        ("ChannelScaledNormalizer", v.ChannelScaledNormalizer(104.0, 117.0, 123.0, 0.017)),
        ("ColorJitter", v.ColorJitter()),
        ("Contrast", v.Contrast()),
        ("Expand", v.Expand(max_expand_ratio=2.5)),
        ("FixedCrop", v.FixedCrop(0.1, 0.2, 0.8, 0.9)),
        ("Hue", v.Hue()),
        ("HFlip", v.HFlip()),
        ("ImageFrameToSample", v.MatToTensor() >> v.ImageFrameToSample()),
        ("Lighting", v.Lighting()),
        ("MatToFloats", v.MatToFloats()),
        ("MatToTensor", v.MatToTensor()),
        ("PixelBytesToMat", v.PixelBytesToMat()),
        ("RandomCrop", v.RandomCrop(6, 8)),
        ("RandomTransformer", v.RandomTransformer(v.HFlip(), 0.5)),
        ("Resize", v.Resize(7, 9)),
        ("Saturation", v.Saturation()),
    ]


NAMES = [n for n, _ in _augmentations(jv)]


def _mat(seed=0, h=11, w=13):
    return np.random.default_rng(seed).uniform(0, 255, (h, w, 3)).astype(np.float32)


def _png_bytes(seed=0, h=11, w=13):
    from PIL import Image

    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def _feature(v, name, i):
    if name == "PixelBytesToMat":
        return v.ImageFeature(bytes_=_png_bytes(i), label=i)
    return v.ImageFeature(mat=_mat(i), label=i)


def _outputs(f):
    """What a transformer leaves on a feature, as arrays to compare."""
    out = [f.mat()]
    for key in ("floats", "tensor"):
        if key in f:
            out.append(np.asarray(f[key]))
    if f.sample() is not None:
        out += [np.asarray(f.sample()[0]), np.asarray(f.sample()[1])]
    return out


def _run(v, random, name, seed):
    """Eight images through the named transformer under the chunk RNG of
    (seed, epoch 0, chunk 0)."""
    t = dict(_augmentations(v))[name]
    rng = np.random.default_rng((seed, 0, 0, 0x9E3779B9))
    with random.scoped_numpy_rng(rng):
        return [_outputs(t(_feature(v, name, i))) for i in range(8)]


@pytest.mark.parametrize("name", NAMES)
def test_each_augmentation_matches_jax_at_two_seeds(name):
    if name in ("Resize", "AspectScale", "PixelBytesToMat"):
        pytest.importorskip("PIL")
    runs = {}
    for seed in SEEDS:
        want = _run(jv, JRandom, name, seed)
        got = _run(pv, RandomGenerator, name, seed)
        assert len(want) == len(got)
        for w, g in zip(want, got):
            assert len(w) == len(g)
            for a, b in zip(w, g):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert a.tobytes() == b.tobytes()
        runs[seed] = got
    random_ones = {"Brightness", "ColorJitter", "Contrast", "Expand", "Hue", "Lighting",
                   "RandomCrop", "RandomTransformer", "Saturation"}
    differ = any(a.tobytes() != b.tobytes()
                 for ra, rb in zip(runs[SEEDS[0]], runs[SEEDS[1]]) for a, b in zip(ra, rb))
    assert differ == (name in random_ones), name  # the seed reaches exactly the random ones


def test_the_global_stream_is_used_outside_a_scope():
    _seed_both(5)
    jm = jv.Brightness()(jv.ImageFeature(mat=_mat())).mat()
    pm = pv.Brightness()(pv.ImageFeature(mat=_mat())).mat()
    assert jm.tobytes() == pm.tobytes()


def test_a_failing_stage_marks_the_feature_invalid():
    f = pv.ImageFeature(label=1)  # no mat
    chain = pv.CenterCrop(2, 2) >> pv.MatToTensor()
    out = chain(f)
    assert not out.is_valid() and "tensor" not in out
    assert isinstance(chain, pv.Pipeline) and len((chain >> pv.HFlip()).stages) == 3


def _imagenet_chain(v, d):
    """The [21b] chain as a Lambda: HWC uint8 record -> feature -> sample."""
    ft = (v.RandomCrop(12, 12) >> v.RandomTransformer(v.HFlip(), 0.5)
          >> v.ChannelNormalize(104.0, 117.0, 123.0, 58.0, 57.0, 59.0) >> v.MatToTensor()
          >> v.ImageFrameToSample())

    def fn(s):
        f = ft(v.ImageFeature(mat=s.feature, label=s.label))
        x, t = f.sample()
        return d.Sample(x, t)
    return d.Lambda(fn)


@pytest.mark.parametrize("workers", [0, 4])
def test_imagenet_chain_through_the_pipeline_matches_jax(workers):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, (37, 16, 16, 3), dtype=np.uint8)
    y = rng.integers(0, 10, 37)
    streams = {}
    for seed in SEEDS:
        _seed_both(seed)
        jpipe = jp.DataPipeline(jd.LocalArrayDataSet(x, y, batch_size=8),
                                _imagenet_chain(jv, jd), num_workers=workers)
        ppipe = pp.DataPipeline(pd.LocalArrayDataSet(x, y, batch_size=8),
                                _imagenet_chain(pv, pd), num_workers=workers)
        jpipe.shuffle(1)
        ppipe.shuffle(1)
        batches = list(ppipe.data(True))
        assert assert_same_batches(jpipe.data(True), batches) == 4
        assert batches[0].get_input().shape == (8, 3, 12, 12)
        streams[seed] = b"".join(b.get_input().tobytes() for b in batches)
    assert streams[SEEDS[0]] != streams[SEEDS[1]]


# ---------------------------------------------------------------- ImageFrame
def _png_dir(root):
    from PIL import Image

    rng = np.random.default_rng(4)
    for c in ("cat", "dog"):
        (root / c).mkdir()
        for i in range(3):
            img = rng.integers(0, 256, (9, 8, 3), dtype=np.uint8)
            Image.fromarray(img).save(root / c / f"{i}.png")
    (root / "dog" / "junk.png").write_bytes(b"junk")
    return str(root)


def test_image_frame_read_and_to_dataset_match_jax(tmp_path):
    pytest.importorskip("PIL")
    root = _png_dir(tmp_path)
    jf = jv.ImageFrame.read(root, with_label_from_dirs=True)
    pf = pv.ImageFrame.read(root, with_label_from_dirs=True)
    assert len(pf) == len(jf) == 7 and pf.is_local() and not pf.is_distributed()
    assert [f.is_valid() for f in pf] == [f.is_valid() for f in jf]
    assert [f.label() for f in pf.to_valid()] == [f.label() for f in jf.to_valid()] == [
        0, 0, 0, 1, 1, 1]
    chain = lambda v: v.CenterCrop(6, 6) >> v.MatToTensor() >> v.ImageFrameToSample()  # noqa
    jds = jv.ImageFrame.read(root, True).to_valid().transform(chain(jv)).to_dataset(4)
    pds = pv.ImageFrame.read(root, True).to_valid().transform(chain(pv)).to_dataset(4)
    assert assert_same_batches(jds.data(False), pds.data(False)) == 2


def test_to_dataset_native_normalize_route():
    """``normalize=(mean, std)``: the port's host library against its plain
    version within 1e-5 and against the JAX package's route (bit-equal when
    the JAX package's library is loaded)."""
    import bigdl_tpu.native as jnative
    from bigdl_tpu_torch import native as pnative

    mats = [np.random.default_rng(i).integers(0, 256, (5, 7, 3)).astype(np.float32)
            for i in range(6)]
    mean, std = (104.0, 117.0, 123.0), (58.0, 57.0, 59.0)
    jds = jv.ImageFrame.from_arrays(mats, list(range(6))).to_dataset(3, normalize=(mean, std))
    pds = pv.ImageFrame.from_arrays(mats, list(range(6))).to_dataset(3, normalize=(mean, std))
    jx = np.concatenate([b.get_input() for b in jds.data(False)])
    px = np.concatenate([b.get_input() for b in pds.data(False)])
    plain = pnative.u8hwc_to_f32chw_plain(np.stack(mats).astype(np.uint8), mean, std)
    np.testing.assert_allclose(px, plain, atol=1e-5, rtol=0)
    if jnative.available():
        assert px.tobytes() == jx.tobytes()
    else:
        np.testing.assert_allclose(px, jx, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="0-255"):
        pv.ImageFrame.from_arrays([mats[0] - 300]).to_dataset(1, normalize=(mean, std))


def test_distributed_image_frame_shards():
    mats = [_mat(i, 4, 4) for i in range(7)]
    pf = pv.DistributedImageFrame(pv.ImageFrame.from_arrays(mats).features)
    jf = jv.DistributedImageFrame(jv.ImageFrame.from_arrays(mats).features)
    assert pf.is_distributed() and not pf.is_local()
    assert [len(s) for s in pf.shards(3)] == [len(s) for s in jf.shards(3)] == [3, 2, 2]


# ------------------------------------------------------ the classic helpers
@pytest.mark.parametrize("seed", SEEDS)
def test_bgr_helpers_match_jax(seed):
    def chain(m):
        return (m.BGRImgRdmCropper(8, 8, padding=2) >> m.RandomHFlip(0.5)
                >> m.BGRImgNormalizer(104.0, 117.0, 123.0, 58.0, 57.0, 59.0)
                >> m.BGRImgCropper(6, 6, "center") >> m.BGRImgToSample())

    outs = []
    for m, v, random in ((jimage, jv, JRandom), (pimage, pv, RandomGenerator)):
        t = chain(m)
        with random.scoped_numpy_rng(np.random.default_rng(seed)):
            outs.append([np.asarray(t(v.ImageFeature(mat=_mat(i, 9, 9), label=i)).sample()[0])
                         for i in range(6)])
    assert all(a.tobytes() == b.tobytes() for a, b in zip(*outs))
    with pytest.raises(ValueError, match="center"):
        pimage.BGRImgCropper(2, 2, "corner")
    assert pimage.BGRImgToSample(with_label=False).stages[1].target_keys == []


@pytest.mark.parametrize("layout,dtype", [("CHW", "float32"), ("HWC", "uint8")])
def test_template_images_match_jax(layout, dtype):
    jx, jy = jsyn.template_images(9, 4, 28, seed=2, layout=layout, dtype=dtype)
    px, py = psyn.template_images(9, 4, 28, seed=2, layout=layout, dtype=dtype)
    assert px.dtype == jx.dtype and px.tobytes() == jx.tobytes() and np.array_equal(py, jy)
    with pytest.raises(ValueError, match="multiple"):
        psyn.template_images(1, 1, 30, 0)


@pytest.mark.parametrize("train", [True, False])
def test_load_cifar10_matches_jax(tmp_path, train):
    jx, jy = jcifar.load_cifar10(None, train=train, synthetic_size=20)
    px, py = pcifar.load_cifar10(None, train=train, synthetic_size=20)
    assert px.tobytes() == jx.tobytes() and np.array_equal(px.shape, (20, 3, 32, 32))
    assert np.array_equal(py, jy)
    rng = np.random.default_rng(0)
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    for n in names:
        d = {b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
             b"labels": list(rng.integers(0, 10, 4))}
        (tmp_path / n).write_bytes(pickle.dumps(d))
    jx, jy = jcifar.load_cifar10(str(tmp_path), train=train, normalize=False)
    px, py = pcifar.load_cifar10(str(tmp_path), train=train, normalize=False)
    assert px.tobytes() == jx.tobytes() and np.array_equal(py, jy)
    assert len(px) == 4 * len(names)


def test_text_helpers_match_jax():
    corpus = ["The cat sat on the mat", "the dog ate the cat", "A bird"]
    jdict, pdict = jtext.Dictionary(8), ptext.Dictionary(8)
    jtok = list(jtext.SentenceTokenizer()(corpus))
    ptok = list(ptext.SentenceTokenizer()(corpus))
    assert ptok == jtok
    jdict.build(jtok)
    pdict.build(ptok)
    assert pdict.idx2word == jdict.idx2word and len(pdict) == len(jdict) == 8
    assert pdict.index("zebra") == 0
    jl = list(jtext.TextToLabeledSentence(jdict, 5)(zip(jtok, [0, 1, 2])))
    pl = list(ptext.TextToLabeledSentence(pdict, 5)(zip(ptok, [0, 1, 2])))
    assert [s.feature.tobytes() for s in pl] == [s.feature.tobytes() for s in jl]
    assert [int(s.label) for s in pl] == [0, 1, 2]
    jx, jy = jtext.synthetic_news20(16, 50, 12, 5, seed=3)
    px, py = ptext.synthetic_news20(16, 50, 12, 5, seed=3)
    assert px.tobytes() == jx.tobytes() and py.tobytes() == jy.tobytes()
