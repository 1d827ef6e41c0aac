"""Criteo-style click data for Wide&Deep, BASELINE config 5 (counterpart of
``bigdl_tpu/dataset/criteo.py``).

``load_criteo(path, n)`` reads the TSV format (label, 13 numeric and 26
categorical columns) when ``path`` names a file, and otherwise draws the JAX
package's learnable synthetic click log from the same seeded numpy
generators, so both packages return the same arrays bit for bit. The
categorical columns of a file are hash-bucketed with Python's ``hash()``,
as in the JAX package: for strings it is salted per process, so the two
packages' buckets agree only within one process.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..tensor.sparse import SparseTensor
from ..utils.table import T, Table

N_NUMERIC = 13
N_CATEGORICAL = 26


def _hash_bucket(values: np.ndarray, buckets: int) -> np.ndarray:
    return np.asarray([hash(v) % buckets for v in values], np.int64)


def _read_tsv(path: str, n: int, wide_dim: int, embed_vocab: int, n_embed: int):
    rows, labels = [], []
    with open(path) as f:
        for i, line in enumerate(f):
            if i >= n:
                break
            parts = line.rstrip("\n").split("\t")
            labels.append(int(parts[0]))
            numeric = [float(p) if p else 0.0 for p in parts[1:1 + N_NUMERIC]]
            rows.append((numeric, parts[1 + N_NUMERIC:1 + N_NUMERIC + N_CATEGORICAL]))
    n = len(rows)
    numeric = np.log1p(np.maximum(np.asarray([r[0] for r in rows], np.float32), 0))
    cat_hash = np.stack([_hash_bucket(np.asarray([r[1][j] for r in rows]), wide_dim)
                         for j in range(N_CATEGORICAL)], axis=1)
    wide = SparseTensor.from_coo(np.repeat(np.arange(n), N_CATEGORICAL), cat_hash.reshape(-1),
                                 np.ones(n * N_CATEGORICAL, np.float32), (n, wide_dim))
    deep_cat = (cat_hash[:, :n_embed] % embed_vocab).astype(np.float32)
    return T(wide, np.concatenate([deep_cat, numeric], axis=1)), np.asarray(labels, np.int64)


def load_criteo(path: Optional[str] = None, n: int = 1024, wide_dim: int = 5000,
                embed_vocab: int = 100, n_embed: int = 3, seed: int = 0
                ) -> Tuple[Table, np.ndarray]:
    """``(Table(wide SparseTensor, deep dense matrix), labels)``: the wide
    column holds hashed feature ids (one entry a record in the synthetic
    log, 26 from a file), the deep matrix ``n_embed`` categorical ids as
    floats, then 13 numeric columns; labels are int64 clicks."""
    if path and os.path.exists(path):
        return _read_tsv(path, n, wide_dim, embed_vocab, n_embed)
    rng = np.random.default_rng(seed)
    # click iff (wide bucket < wide_dim/2) and (first categorical < vocab/2),
    # an additive rule, with buckets from a fixed 256-id vocabulary seeded on
    # its own, so that each wide weight sees ~n/256 records
    bucket_vocab = np.sort(np.random.default_rng(12345).choice(wide_dim, 256, replace=False))
    buckets = bucket_vocab[rng.integers(0, len(bucket_vocab), n)]
    cat0 = rng.integers(0, embed_vocab, n)
    labels = ((buckets < wide_dim // 2) & (cat0 < embed_vocab // 2)).astype(np.int64)
    wide = SparseTensor.from_coo(np.arange(n), buckets, np.ones(n, np.float32), (n, wide_dim))
    deep_cat = np.stack([cat0] + [rng.integers(0, embed_vocab, n) for _ in range(n_embed - 1)],
                        axis=1).astype(np.float32)
    numeric = rng.standard_normal((n, N_NUMERIC)).astype(np.float32)
    return T(wide, np.concatenate([deep_cat, numeric], axis=1)), labels
