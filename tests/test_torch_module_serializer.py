"""The port's model file (``save_module`` / ``nn.load_module``) within the
port and across the two packages.

The rows are those of the JAX package's sweep
(``tests/test_module_serializer.py::SWEEP``) whose classes the port has: each
row's port module is the JAX module's topology record read by the port's
``spec_to_module``, so the two are built from the same constructor
arguments. For each row, for two graphs (one with a module at two nodes, one
with branches) and for LeNet-5, a CIFAR ResNet(8) and the BiLSTM
classifier at small inputs:

* within the port: save, load with no reference to the original, eval
  outputs equal to the bit;
* JAX ``save_module`` -> port ``nn.load_module``, and port ``save_module``
  -> JAX ``nn.load_module``: eval outputs within 1e-5 absolute plus 1e-5
  relative (fixed before the first run: the same f32 weights, products
  summed in another order; LRN's and the recurrences' tanh/exp differ by a
  few units in the last place);
* a fresh process (``jax`` and ``bigdl_tpu`` blocked) loads a file;
* a file naming a class outside ``bigdl_tpu.`` is refused, and a module
  whose constructor argument cannot be encoded falls back to the arrays
  alone, which instance ``load_module`` reads back.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu.utils.module_serializer import module_to_spec as jax_module_to_spec
from bigdl_tpu.utils.random import RandomGenerator as JRandom
from bigdl_tpu.utils.table import Table as JTable
from bigdl_tpu_torch import RandomGenerator
from bigdl_tpu_torch import nn as pnn
from bigdl_tpu_torch.utils.module_serializer import spec_to_module
from bigdl_tpu_torch.utils.table import Table

from test_module_serializer import SWEEP
from test_torch_lenet import _fp32_policy  # noqa: F401 (fixture)

ATOL = RTOL = 1e-5


def _classes(spec, out):
    if isinstance(spec, dict):
        if "class" in spec and "module" in spec:
            out.add(spec["class"])
        for v in spec.values():
            _classes(v, out)
    elif isinstance(spec, list):
        for v in spec:
            _classes(v, out)
    return out


def _ported(i):
    """The row's JAX topology record, or None when the port lacks a class."""
    spec = jax_module_to_spec(SWEEP[i][0]())
    return spec if all(hasattr(pnn, c) for c in _classes(spec, set())) else None


PORTED = [i for i in range(len(SWEEP)) if _ported(i) is not None]


def _torch(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    return [_torch(v) for v in x]


def _leaves(y):
    if isinstance(y, (Table, JTable, list, tuple)):
        return [a for v in y for a in _leaves(v)]
    return [np.asarray(y.detach().float().numpy() if isinstance(y, torch.Tensor) else y,
                       np.float32)]


def _port_eval(m, x):
    m.evaluate()
    with torch.no_grad():
        return _leaves(m.apply(m.get_parameters(), m.get_state(), _torch(x))[0])


def _port_built(spec, x):
    RandomGenerator.set_seed(11)
    m = spec_to_module(spec, "cpu")
    m.build(RandomGenerator.generator(), _torch(x))
    return m


def test_the_port_has_the_sweep_rows_it_claims():
    assert len(PORTED) >= 70, PORTED


@pytest.mark.parametrize("i", PORTED)
def test_roundtrip_within_the_port(i, tmp_path):
    x = SWEEP[i][1]
    m = _port_built(_ported(i), x)
    y0 = _port_eval(m, x)
    path = str(tmp_path / "m.npz")
    m.save_module(path)
    with np.load(path) as z:
        assert "__bigdl__" in z.files
    m2 = pnn.load_module(path, device="cpu")
    for a, b in zip(y0, _port_eval(m2, x)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("i", PORTED)
def test_jax_file_loads_in_the_port_and_back(i, tmp_path):
    x = SWEEP[i][1]
    JRandom.set_seed(11)
    jm = SWEEP[i][0]()
    jm.evaluate()
    jy = _leaves(jm.forward(x))
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jm.save_module(jpath)
    pm = pnn.load_module(jpath, device="cpu")
    py = _port_eval(pm, x)
    assert len(py) == len(jy)
    for a, b in zip(py, jy):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    # and the port's file, of a module built in the port, in the JAX package
    m = _port_built(_ported(i), x)
    y0 = _port_eval(m, x)
    m.save_module(ppath)
    jm2 = jnn.load_module(ppath)
    jm2.evaluate()
    for a, b in zip(_leaves(jm2.forward(x)), y0):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)


def _tied(nn, **d):
    a, b = nn.Input(), nn.Input()
    enc = nn.Linear(6, 4, **d).set_name("enc")
    return nn.Graph([a, b], nn.CAddTable(**d).set_name("sum").inputs(enc.inputs(a),
                                                                     enc.inputs(b)), **d)


def _branchy(nn, **d):
    inp = nn.Input()
    a = nn.ReLU(**d).inputs(nn.Linear(6, 5, **d).inputs(inp))
    c = nn.Linear(6, 5, **d).inputs(inp)
    return nn.Graph(inp, nn.Linear(5, 2, **d).inputs(nn.CAddTable(**d).inputs(a, c)), **d)


def _zoo(nn, models, **d):
    return {"lenet": (models.LeNet5(10, **d), np.zeros((2, 1, 28, 28), np.float32)),
            "resnet8": (models.ResNet(8, class_num=10, dataset="cifar10", with_log_softmax=True,
                                      **d), np.zeros((2, 3, 16, 16), np.float32)),
            "bilstm": (models.BiLSTMClassifier(50, 8, 6, class_num=3, **d),
                       np.ones((2, 7), np.int32)),
            "tied": (_tied(nn, **d), [np.zeros((3, 6), np.float32)] * 2),
            "branchy": (_branchy(nn, **d), np.zeros((3, 6), np.float32))}


def _rand(x, seed):
    rng = np.random.default_rng(seed)
    if isinstance(x, list):
        return [_rand(v, seed + i) for i, v in enumerate(x)]
    if x.dtype.kind == "i":
        return rng.integers(1, 50, x.shape).astype(x.dtype)
    return rng.standard_normal(x.shape).astype(np.float32)


@pytest.mark.parametrize("name", ["lenet", "resnet8", "bilstm", "tied", "branchy"])
def test_graphs_and_zoo_both_ways(name, tmp_path):
    import bigdl_tpu.models as jmodels
    import bigdl_tpu_torch.models as pmodels

    RandomGenerator.set_seed(5)
    m, x = _zoo(pnn, pmodels, device="cpu")[name]
    x = _rand(x, 5)
    m.init(sample_input=_torch(x))
    y0 = _port_eval(m, x)
    path = str(tmp_path / "p.npz")
    m.save_module(path)
    m2 = pnn.load_module(path, device="cpu")
    for a, b in zip(y0, _port_eval(m2, x)):
        np.testing.assert_array_equal(a, b)
    if name == "tied":  # sharing survives: one module at two nodes, one child
        assert [c.name() for c in m2.children()] == ["enc", "sum"]
        mods = [n.module for n in m2._topo if n.module.name() == "enc"]
        assert len(mods) == 2 and mods[0] is mods[1]
    jm2 = jnn.load_module(path)
    jm2.evaluate()
    for a, b in zip(_leaves(jm2.forward(x)), y0):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)
    JRandom.set_seed(5)
    jm, _ = _zoo(jnn, jmodels)[name]
    jm.evaluate()
    jy = _leaves(jm.forward(x))
    jm.save_module(path)
    for a, b in zip(_port_eval(pnn.load_module(path, device="cpu"), x), jy):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)


def test_fresh_process_load(tmp_path):
    RandomGenerator.set_seed(9)
    m = pnn.Sequential(pnn.SpatialConvolution(1, 4, 3, 3, device="cpu"), pnn.ReLU(device="cpu"),
                       pnn.Reshape((-1,), device="cpu"), pnn.Linear(4 * 6 * 6, 3, device="cpu"),
                       pnn.LogSoftMax(device="cpu"), device="cpu")
    x = np.random.default_rng(9).standard_normal((2, 1, 8, 8)).astype(np.float32)
    m.init(sample_input=x)
    y0 = _port_eval(m, x)[0]
    path, xpath, ypath = (str(tmp_path / n) for n in ("fresh.npz", "x.npy", "y.npy"))
    m.save_module(path)
    np.save(xpath, x)
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['bigdl_tpu'] = None\n"
            "import numpy as np, torch\n"
            "from bigdl_tpu_torch import nn\n"
            f"m = nn.load_module({path!r}, device='cpu').evaluate()\n"
            f"y = m.forward(np.load({xpath!r}))\n"
            f"np.save({ypath!r}, y.detach().numpy())\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300, env=env, cwd=root)
    np.testing.assert_array_equal(y0, np.load(ypath))


def test_a_class_outside_the_package_is_refused(tmp_path):
    m = pnn.Linear(4, 2, device="cpu")
    m.init(sample_input=np.zeros((2, 4), np.float32))
    path = str(tmp_path / "m.npz")
    m.save_module(path)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat["__bigdl__"]).decode())
    assert meta["topology"]["module"] == "bigdl_tpu.nn.linear"
    meta["topology"]["module"] = "os.path"
    flat["__bigdl__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **flat)
    with pytest.raises(ValueError, match="refusing to import 'os.path'"):
        pnn.load_module(path, device="cpu")


def test_unencodable_argument_falls_back_to_arrays(tmp_path):
    m = pnn.RnnCell(4, 3, activation=lambda v: torch.tanh(v), device="cpu")
    rec = pnn.Recurrent(m, device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 5, 4)).astype(np.float32)
    rec.init(sample_input=x)
    path = str(tmp_path / "arrays.npz")
    rec.save_module(path)
    with np.load(path) as z:
        assert "__bigdl__" not in z.files
    with pytest.raises(ValueError, match="no topology record"):
        pnn.load_module(path, device="cpu")
    other = pnn.Recurrent(pnn.RnnCell(4, 3, activation=lambda v: torch.tanh(v), device="cpu"),
                          device="cpu")
    other.init(sample_input=x)
    other.load_module(path)
    np.testing.assert_array_equal(_port_eval(other, x)[0], _port_eval(rec, x)[0])
