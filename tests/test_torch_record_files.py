"""The port's file-backed datasets against the JAX package's: ``BDLSHRD1``
record shards and TFRecord files, each package reading what the other
wrote, ``ShardedRecordDataSet`` / ``TFRecordDataSet`` / ``ImageFolderDataSet``
batch streams byte for byte (train and eval, two epochs, 1 and 3 decode
threads, ``shard(index, count)``), ``tf.Example`` parsing, the protobuf
wire reader and writer, and the masked CRC (the port's through its host
library). PNG files for the image folder are written here with PIL.
"""

import io
import os

import numpy as np
import pytest

from bigdl_tpu.dataset import dataset as jd
from bigdl_tpu.dataset import files as jf
from bigdl_tpu.dataset import tfrecord as jt
from bigdl_tpu.utils import protowire as jw
from bigdl_tpu_torch.dataset import dataset as pd
from bigdl_tpu_torch.dataset import files as pf
from bigdl_tpu_torch.dataset import tfrecord as pt
from bigdl_tpu_torch.utils import protowire as pw

from test_torch_dataset_chains import _seed_both, assert_same_batches

SEED = 9
H = W = 6


def _records(n=53, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    return [(imgs[i].tobytes(), int(rng.integers(0, 7))) for i in range(n)]


def _decoder(sample_cls):
    def decode(payload, label):
        img = np.frombuffer(payload, np.uint8).reshape(H, W, 3)
        x = (img.astype(np.float32) / 255.0 - 0.449) / 0.226
        return sample_cls(x.transpose(2, 0, 1), np.int64(label))
    return decode


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_record_shards_cross_read(tmp_path, writer):
    recs = _records()
    write = (jf if writer == "jax" else pf).write_record_shards
    paths = write(recs, str(tmp_path), records_per_shard=10, prefix="p")
    assert len(paths) == 6 and all(os.path.basename(p).startswith("p-") for p in paths)
    for mod in (jf, pf):
        got = [r for p in paths for r in mod.read_record_shard(p)]
        assert got == recs
        assert [mod.record_shard_count(p) for p in paths] == [10] * 5 + [3]
    other = (pf if writer == "jax" else jf).write_record_shards(recs, str(tmp_path / "o"),
                                                                records_per_shard=10,
                                                                prefix="p")
    for a, b in zip(paths, other):
        assert open(a, "rb").read() == open(b, "rb").read()  # the same bytes
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"NOTASHARD")
    with pytest.raises(ValueError, match="magic"):
        pf.read_record_shard(str(bad))


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("train", [True, False])
def test_sharded_record_dataset_matches_jax(tmp_path, workers, train):
    paths = jf.write_record_shards(_records(), str(tmp_path), records_per_shard=10)
    _seed_both(SEED)
    jds = jd.DataSet.record_shards(paths, _decoder(jd.Sample), batch_size=8, n_workers=workers)
    pds = pd.DataSet.record_shards(paths, _decoder(pd.Sample), batch_size=8, n_workers=workers)
    assert pds.size() == jds.size() == 53
    for epoch in (0, 1):
        jds.shuffle(epoch)
        pds.shuffle(epoch)
        assert assert_same_batches(jds.data(train), pds.data(train)) == (6 if train else 7)


def test_shard_slices_partition_the_records(tmp_path):
    paths = pf.write_record_shards(_records(), str(tmp_path), records_per_shard=10)
    _seed_both(SEED)
    seen = []
    for index in range(3):
        jds = jf.ShardedRecordDataSet(paths, _decoder(jd.Sample), batch_size=4).shard(index, 3)
        pds = pf.ShardedRecordDataSet(paths, _decoder(pd.Sample), batch_size=4).shard(index, 3)
        assert pds.size() == jds.size()
        assert assert_same_batches(jds.data(False), pds.data(False)) > 0
        seen += [s.label for s in pds.samples(False)]
    assert len(seen) == 53
    with pytest.raises(ValueError, match="index"):
        pf.ShardedRecordDataSet(paths, _decoder(pd.Sample)).shard(3, 3)
    with pytest.raises(ValueError, match="no shard"):
        pf.ShardedRecordDataSet([], _decoder(pd.Sample))


def test_decode_faults_reach_the_consumer(tmp_path):
    paths = pf.write_record_shards(_records(), str(tmp_path), records_per_shard=10)

    def decode(payload, label):
        if label == 3:
            raise RuntimeError("undecodable")
        return pd.Sample(np.frombuffer(payload, np.uint8), label)

    with pytest.raises(RuntimeError, match="undecodable"):
        list(pf.ShardedRecordDataSet(paths, decode, batch_size=4).data(False))


# ------------------------------------------------------------------ TFRecord
def _examples(n=23, seed=1):
    rng = np.random.default_rng(seed)
    return [{"image/encoded": [rng.bytes(int(rng.integers(1, 40)))],
             "image/class/label": np.asarray([int(rng.integers(-5, 1000))], np.int64),
             "bbox": rng.standard_normal(int(rng.integers(0, 5))).astype(np.float32)}
            for _ in range(n)]


def test_example_build_and_parse_match_jax():
    for ex in _examples():
        blob = pt.build_example(ex)
        assert blob == jt.build_example(ex)
        for parsed in (pt.parse_example(blob), jt.parse_example(blob)):
            assert parsed["image/encoded"] == ex["image/encoded"]
            assert np.array_equal(parsed["image/class/label"], ex["image/class/label"])
            assert parsed["bbox"].dtype == np.float32
            assert np.array_equal(parsed["bbox"], ex["bbox"])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tfrecords_cross_read(tmp_path, writer):
    blobs = [jt.build_example(ex) for ex in _examples()]
    path = str(tmp_path / "a.tfrecord")
    assert (jt if writer == "jax" else pt).write_tfrecords(iter(blobs), path) == len(blobs)
    for mod in (jt, pt):
        assert list(mod.read_tfrecords(path)) == blobs
    data = bytearray(open(path, "rb").read())
    data[20] ^= 0xFF  # a payload byte of the first record
    bad = tmp_path / "bad.tfrecord"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="crc"):
        list(pt.read_tfrecords(str(bad)))
    assert len(list(pt.read_tfrecords(str(bad), verify_crc=False))) == len(blobs)
    bad.write_bytes(bytes(data[:-3]))
    with pytest.raises(ValueError, match="truncated"):
        list(pt.read_tfrecords(str(bad), verify_crc=False))


def test_masked_crc_matches_jax():
    rng = np.random.default_rng(2)
    for n in (0, 1, 7, 8, 9, 100, 4096):
        data = rng.bytes(n)
        assert pt._masked_crc(data) == jt._masked_crc(data)


def _tf_decode(sample_cls):
    def decode(feats):
        raw = np.frombuffer(feats["image/encoded"][0], np.uint8)
        x = np.zeros(40, np.float32)
        x[: len(raw)] = raw
        return sample_cls(x, np.int64(feats["image/class/label"][0]))
    return decode


@pytest.mark.parametrize("train", [True, False])
def test_tfrecord_dataset_matches_jax(tmp_path, train):
    exs = _examples(31)
    paths = []
    for i in range(4):
        paths.append(str(tmp_path / f"part-{i}.tfrecord"))
        pt.write_tfrecords((pt.build_example(e) for e in exs[i::4]), paths[-1])
    _seed_both(SEED)
    jds = jt.TFRecordDataSet(paths, _tf_decode(jd.Sample), batch_size=4, n_workers=2)
    pds = pt.TFRecordDataSet(paths, _tf_decode(pd.Sample), batch_size=4, n_workers=2)
    assert pds.size() == jds.size() == 31
    pds.shuffle(1)
    jds.shuffle(1)
    assert assert_same_batches(jds.data(train), pds.data(train)) == (7 if train else 8)


def test_protowire_round_trip_matches_jax():
    for mod in (jw, pw):
        w = mod.WireWriter().varint(1, 300).string(2, "héllo").f32(3, 1.5).varint(4, -2)
        w.message(5, mod.WireWriter().bytes_(1, b"\x00\xff"))
        blob = w.blob()
        assert blob == jw.WireWriter().varint(1, 300).string(2, "héllo").f32(3, 1.5).varint(
            4, -2).message(5, jw.WireWriter().bytes_(1, b"\x00\xff")).blob()
        r = pw.WireReader(blob)
        assert r.field() == (1, 0) and r.varint() == 300
        assert r.field() == (2, 2) and r.bytes_().decode() == "héllo"
        assert r.field() == (3, 5) and r.f32() == 1.5
        assert r.field() == (4, 0) and pw.signed64(r.varint()) == -2
        assert r.field() == (5, 2)
        sub = r.sub()
        assert sub.field() == (1, 2) and sub.bytes_() == b"\x00\xff" and r.done()
    with pytest.raises(ValueError, match="wire type"):
        pw.WireReader(b"").skip(3)


# --------------------------------------------------------------- image folder
def _png_tree(root, n_per_class=(5, 3, 4), seed=3):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c, n in enumerate(n_per_class):
        d = root / f"class_{c}"
        d.mkdir()
        for i in range(n):
            img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="PNG")
            (d / f"img_{i}.png").write_bytes(buf.getvalue())
    (root / "class_1" / "notes.txt").write_text("not an image")
    (root / "class_2" / "broken.png").write_bytes(b"\x89PNG broken")
    return root


@pytest.mark.parametrize("train", [True, False])
def test_image_folder_matches_jax(tmp_path, train):
    pytest.importorskip("PIL")
    root = str(_png_tree(tmp_path))
    _seed_both(SEED)
    jds = jd.DataSet.image_folder(root, batch_size=3, files_per_unit=4, n_workers=2)
    pds = pd.DataSet.image_folder(root, batch_size=3, files_per_unit=4, n_workers=2)
    assert pds.class_names == jds.class_names == ["class_0", "class_1", "class_2"]
    assert pds.size() == jds.size() == 13
    for epoch in (0, 1):
        jds.shuffle(epoch)
        pds.shuffle(epoch)
        # the broken PNG is skipped by both: 12 images
        assert assert_same_batches(jds.data(train), pds.data(train)) == 4
