"""A pool's ceil mode through the model file, in both packages: reference-
side behaviour that the port follows.

``save_module`` records a module's constructor arguments, and
``SpatialMaxPooling(3, 3, 2, 2).ceil()`` sets ``ceil_mode`` after the
constructor, so the file does not carry it: ``nn.load_module`` rebuilds a
floor-mode pool in each package. On an 8x8 input the ceil-mode pool gives
4x4 and the loaded one 3x3, whichever package wrote the file and whichever
reads it. The port keeps the JAX package's file format (each package reads
the other's files), so it keeps this too.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import bigdl_tpu.nn as jnn
from bigdl_tpu_torch import nn as pnn

X = np.random.default_rng(0).standard_normal((2, 3, 8, 8)).astype(np.float32)


def _jax_model():
    m = jnn.Sequential(jnn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    m.evaluate()
    return m


def _port_model():
    m = pnn.Sequential(pnn.SpatialMaxPooling(3, 3, 2, 2, device="cpu").ceil(), device="cpu")
    m.evaluate()
    return m


def _jax_shape(m):
    return tuple(np.asarray(m.forward(X)).shape)


def _port_shape(m):
    with torch.no_grad():
        return tuple(m.forward(torch.from_numpy(X)).shape)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ceil_mode_is_not_in_the_file_of_either_package(writer, tmp_path):
    jm, pm = _jax_model(), _port_model()
    assert _jax_shape(jm) == _port_shape(pm) == (2, 3, 4, 4)  # ceil mode before the save
    path = str(tmp_path / f"{writer}.npz")
    (jm if writer == "jax" else pm).save_module(path)
    jl = jnn.load_module(path)
    jl.evaluate()
    pl = pnn.load_module(path, device="cpu")
    pl.evaluate()
    assert _jax_shape(jl) == _port_shape(pl) == (2, 3, 3, 3)  # both loads: floor mode
