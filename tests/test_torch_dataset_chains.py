"""The port's dataset core against the JAX package's: ``LocalArrayDataSet``
(positional construction, with and without a ``Transformer`` chain),
``SampleToMiniBatch`` with padding, ``BucketedTextDataSet``,
``DistributedDataSet``, ``MiniBatch.slice``; and the walk of both trees:
every class and function of the JAX package's host data path exists at the
port's path, and every ``bigdl_tpu.dataset`` class has the JAX
constructor's signature.

Both packages run the same numpy arithmetic on the same numpy inputs with
the same global seed, so every batch stream is compared byte for byte
(``tobytes`` and dtype, no tolerance).
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest

import bigdl_tpu.dataset as jdataset
from bigdl_tpu.dataset import dataset as jd
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu_torch import RandomGenerator
from bigdl_tpu_torch.dataset import dataset as pd

SEED = 11

# JAX package modules of the host data path; their port counterparts sit
# at the same path under bigdl_tpu_torch
DATA_PATH_MODULES = [
    *(f"bigdl_tpu.dataset.{m}" for m in ("dataset", "pipeline", "files", "tfrecord", "cifar",
                                         "image", "synthetic", "text")),
    *(f"bigdl_tpu.transform.vision.image.{m}" for m in ("__init__", "augmentation", "feature",
                                                        "frame", "transformer")),
    "bigdl_tpu.native", "bigdl_tpu.utils.protowire",
]
# what the port leaves out, and why
NOT_PORTED = {}  # every method is ported (DataPipeline._process_traced with obs/trace)


def _seed_both(seed=SEED):
    JRandom.set_seed(seed)
    RandomGenerator.set_seed(seed)


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [np.asarray(tree)]


def assert_same_batches(jbatches, pbatches):
    """Two batch streams equal byte for byte (dtype, shape and bytes of
    every input and target leaf); returns the count."""
    jbatches, pbatches = list(jbatches), list(pbatches)
    assert len(jbatches) == len(pbatches)
    for i, (j, p) in enumerate(zip(jbatches, pbatches)):
        for jl, pl in zip(_leaves(j.get_input()) + _leaves(j.get_target()),
                          _leaves(p.get_input()) + _leaves(p.get_target())):
            assert jl.dtype == pl.dtype and jl.shape == pl.shape, (i, jl.dtype, pl.dtype)
            assert jl.tobytes() == pl.tobytes(), f"batch {i} differs"
        assert len(_leaves(j.get_input()) + _leaves(j.get_target())) == len(
            _leaves(p.get_input()) + _leaves(p.get_target()))
    return len(jbatches)


def _data(n=37, seed=0, width=5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, width)).astype(np.float32), rng.integers(0, 4, n)


# ------------------------------------------------------------------ signatures
def test_local_array_dataset_has_the_jax_signature():
    sig = lambda c: [(p.name, p.default) for p in  # noqa: E731
                     inspect.signature(c.__init__).parameters.values()]
    assert sig(pd.LocalArrayDataSet) == sig(jd.LocalArrayDataSet)
    assert sig(pd.LocalArrayDataSet)[1:] == [("features", inspect.Parameter.empty),
                                             ("labels", None), ("transformer", None),
                                             ("batch_size", 32)]


@pytest.mark.parametrize("train", [True, False])
def test_positional_construction_means_the_same_in_both_packages(train):
    """``LocalArrayDataSet(x, y, chain, 8)``: the third positional argument
    is the transformer, the fourth the batch size, in both packages."""
    x, y = _data()
    _seed_both()
    jds = jd.LocalArrayDataSet(x, y, jd.SampleToMiniBatch(8, drop_remainder=train), 8)
    pds = pd.LocalArrayDataSet(x, y, pd.SampleToMiniBatch(8, drop_remainder=train), 8)
    assert pds.batch_size == jds.batch_size == 8
    jds.shuffle(1)
    pds.shuffle(1)
    assert assert_same_batches(jds.data(train), pds.data(train)) == (4 if train else 5)


def _dataset_classes():
    out = []
    for m in pkgutil.walk_packages(jdataset.__path__, "bigdl_tpu.dataset."):
        mod = importlib.import_module(m.name)
        for name, obj in vars(mod).items():
            if inspect.isclass(obj) and obj.__module__ == m.name:
                out.append((m.name, name))
    return sorted(out)


@pytest.mark.parametrize("module,name", _dataset_classes())
def test_dataset_constructor_signatures_match(module, name):
    """Every ``bigdl_tpu.dataset`` class has the JAX constructor's
    parameters, in order, with the same defaults."""
    jcls = getattr(importlib.import_module(module), name)
    pcls = getattr(importlib.import_module(module.replace("bigdl_tpu", "bigdl_tpu_torch", 1)),
                   name)
    sig = lambda c: [(p.name, p.kind, p.default) for p in  # noqa: E731
                     inspect.signature(c.__init__).parameters.values()]
    assert sig(pcls) == sig(jcls)


@pytest.mark.parametrize("module", DATA_PATH_MODULES)
def test_every_class_and_function_is_ported(module):
    """Each top-level class and function the JAX module defines exists in the
    port's module of the same path, and each method of such a class on the
    port's class."""
    jm = importlib.import_module(module.replace(".__init__", ""))
    pm = importlib.import_module(module.replace(".__init__", "").replace("bigdl_tpu",
                                                                        "bigdl_tpu_torch", 1))
    own = module.replace(".__init__", "")
    names = [n for n, o in vars(jm).items()
             if (inspect.isclass(o) or inspect.isfunction(o))
             and getattr(o, "__module__", None) == own]
    exported = getattr(jm, "__all__", None)
    if module.endswith("__init__"):
        names = list(exported)
    assert names, module
    for name in names:
        assert hasattr(pm, name), f"{module}.{name} has no counterpart"
        jobj, pobj = getattr(jm, name), getattr(pm, name)
        if not inspect.isclass(jobj):
            continue
        for attr, val in vars(jobj).items():
            if not (callable(val) or isinstance(val, (staticmethod, classmethod, property))):
                continue
            if (module, name, attr) in NOT_PORTED:
                assert not hasattr(pobj, attr)
                continue
            assert hasattr(pobj, attr), f"{module}.{name}.{attr} has no counterpart"


def test_port_dataset_exports_cover_the_jax_ones():
    import bigdl_tpu_torch.dataset as pdataset

    jnames = {n for n in dir(jdataset) if not n.startswith("_")}
    assert jnames <= set(dir(pdataset)), sorted(jnames - set(dir(pdataset)))


# ----------------------------------------------------------- batch streams
@pytest.mark.parametrize("epoch", [None, 0, 3])
@pytest.mark.parametrize("train", [True, False])
def test_local_array_dataset_without_a_chain_matches_jax(epoch, train):
    """The fast path: one ``gather_rows`` a batch (the native route at 1 MiB
    and more: batches of 8 records of 160 KiB)."""
    x, _ = _data(37, 1, 40960)
    y = np.arange(37)
    _seed_both()
    jds, pds = jd.LocalArrayDataSet(x, y, batch_size=8), pd.LocalArrayDataSet(x, y, batch_size=8)
    jds.shuffle(epoch)
    pds.shuffle(epoch)
    assert assert_same_batches(jds.data(train), pds.data(train)) == (4 if train else 5)


def _jitter(sample_cls, random):
    """A Lambda body that adds noise drawn from the package's numpy stream."""
    def fn(s):
        noise = random.numpy_rng().normal(0, 0.1, np.shape(s.feature)).astype(np.float32)
        return sample_cls(s.feature + noise, s.label)
    return fn


@pytest.mark.parametrize("train", [True, False])
def test_local_array_dataset_with_a_chain_matches_jax(train):
    """``Lambda`` (drawing from the global numpy stream) // ``SampleToMiniBatch``."""
    x, y = _data()
    _seed_both()
    jchain = jd.Lambda(_jitter(jd.Sample, JRandom)) // jd.SampleToMiniBatch(6, drop_remainder=train)
    pchain = pd.Lambda(_jitter(pd.Sample, RandomGenerator)) // pd.SampleToMiniBatch(6,
                                                                         drop_remainder=train)
    jds = jd.DataSet.array(x, y, batch_size=6, transformer=jchain)
    pds = pd.DataSet.array(x, y, batch_size=6, transformer=pchain)
    assert isinstance(pds, pd.LocalArrayDataSet) and pds.transformer is pchain
    jds.shuffle(2)
    pds.shuffle(2)
    assert assert_same_batches(jds.data(train), pds.data(train)) == (6 if train else 7)


@pytest.mark.parametrize("padding", [None, -1.0])
def test_sample_to_minibatch_with_padding_matches_jax(padding):
    rng = np.random.default_rng(4)
    lens = rng.integers(1, 9, 13)
    feats = [rng.standard_normal((int(n), 3)).astype(np.float32) for n in lens]
    if padding is None:
        feats = [f[:1] for f in feats]
    js = [jd.Sample(f, np.int64(i)) for i, f in enumerate(feats)]
    ps = [pd.Sample(f, np.int64(i)) for i, f in enumerate(feats)]
    jb = jd.SampleToMiniBatch(5, padding_value=padding).apply(iter(js))
    pb = pd.SampleToMiniBatch(5, padding_value=padding).apply(iter(ps))
    assert assert_same_batches(jb, pb) == 3
    # drop_remainder drops the ragged tail
    assert len(list(pd.SampleToMiniBatch(5, padding_value=0.0, drop_remainder=True)
                    .apply(iter(ps[:12])))) == 2


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("train", [True, False])
def test_bucketed_text_dataset_matches_jax(epoch, train):
    rng = np.random.default_rng(5)
    seqs = [rng.integers(1, 50, int(n)).astype(np.int32) for n in rng.integers(1, 40, 57)]
    labels = rng.integers(0, 3, 57)
    _seed_both()
    jds = jd.DataSet.bucket_by_length(seqs, labels, boundaries=(8, 16, 32), batch_size=4)
    pds = pd.DataSet.bucket_by_length(seqs, labels, boundaries=(8, 16, 32), batch_size=4)
    assert pds.truncated_count == jds.truncated_count > 0
    jds.shuffle(epoch)
    pds.shuffle(epoch)
    assert assert_same_batches(jds.data(train), pds.data(train)) > 0
    with pytest.raises(ValueError, match="ascending"):
        pd.BucketedTextDataSet(seqs, boundaries=(16, 8))


@pytest.mark.parametrize("train", [True, False])
def test_distributed_dataset_matches_jax(train):
    """Batches whose rows do not divide into n_devices are dropped in
    training (a ragged tail from a chain), kept in evaluation."""
    x, y = _data(30)
    _seed_both()
    jds = jd.DataSet.distributed(
        jd.LocalArrayDataSet(x, y, jd.SampleToMiniBatch(8), 8), 4)
    pds = pd.DataSet.distributed(
        pd.LocalArrayDataSet(x, y, pd.SampleToMiniBatch(8), 8), 4)
    jds.shuffle(1)
    pds.shuffle(1)
    n = assert_same_batches(jds.data(train), pds.data(train))
    assert n == (3 if train else 4)
    assert pds.size() == 30 and not pds.supports_skip_positions
    stream = pds.data(train)
    assert stream.qsize() == 0
    stream.close()


def test_minibatch_slice_matches_jax():
    x, y = _data(10)
    jb, pb = jd.MiniBatch(x, y).slice(2, 5), pd.MiniBatch(x, y).slice(2, 5)
    assert assert_same_batches([jb], [pb]) == 1 and pb.size() == 5
    tb = pd.MiniBatch([x, x * 2], None).slice(1, 3)
    assert tb.target is None and np.array_equal(tb.input[1], x[1:4] * 2)


def test_table_features_refuse_a_chain():
    from bigdl_tpu_torch.utils.table import T

    x, y = _data(8)
    with pytest.raises(ValueError, match="Table"):
        pd.DataSet.array(T(x, x), y, transformer=pd.SampleToMiniBatch(4))
