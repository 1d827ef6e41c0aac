"""Global seed plumbing as a factory of seeded ``torch.Generator`` s
(counterpart of ``bigdl_tpu/utils/random.py``'s ``RandomGenerator``).

``RandomGenerator.set_seed(s)`` fixes the stream; each ``generator()`` call
returns a fresh CPU generator seeded from ``(seed, counter)`` and advances
the counter, so weight initialisation is reproducible for a given seed and
independent of the device the weights end up on. ``get_seed()`` and
``numpy_rng()`` serve the data path as in the JAX package (the epoch order
is ``np.random.default_rng((seed, epoch))``, identical in both packages);
``scoped_numpy_rng`` routes one thread's ``numpy_rng()`` draws through a
generator of its own (a ``DataPipeline`` chunk's, seeded from the global
seed, the epoch and the chunk's index), so seeded augmentations draw the
same numbers for any worker count. The draws differ from
``jax.random``'s: tests hand both packages the same numpy-made inputs and
copy weights across, never comparing initialisations.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

# the thread-local numpy-rng override of scoped_numpy_rng
_tls = threading.local()


class RandomGenerator:
    _lock = threading.Lock()
    _seed: int = 1
    _counter: int = 0
    _np_rng: np.random.Generator = np.random.default_rng(1)

    @classmethod
    def set_seed(cls, seed: int) -> None:
        with cls._lock:
            cls._seed = int(seed)
            cls._counter = 0
            cls._np_rng = np.random.default_rng(int(seed))

    @classmethod
    def get_seed(cls) -> int:
        return cls._seed

    @classmethod
    def numpy_rng(cls) -> np.random.Generator:
        """The host numpy generator: the calling thread's
        :meth:`scoped_numpy_rng` override when one is installed, else the
        process-wide one (seeded by ``set_seed``)."""
        rng = getattr(_tls, "np_rng", None)
        return rng if rng is not None else cls._np_rng

    @classmethod
    @contextlib.contextmanager
    def scoped_numpy_rng(cls, rng: np.random.Generator):
        """Route this thread's :meth:`numpy_rng` draws through ``rng`` for the
        scope (re-entrant: the previous override comes back at its end)."""
        prev = getattr(_tls, "np_rng", None)
        _tls.np_rng = rng
        try:
            yield rng
        finally:
            _tls.np_rng = prev

    @classmethod
    def generator(cls) -> torch.Generator:
        """A fresh CPU generator; each call advances the global stream."""
        with cls._lock:
            cls._counter += 1
            seed = cls._seed * 1_000_003 + cls._counter
        return torch.Generator().manual_seed(seed)

    @classmethod
    def restore(cls, seed: int, counter: int) -> None:
        """Checkpoint-resume hook: continue the stream where it left off."""
        with cls._lock:
            cls._seed = int(seed)
            cls._counter = int(counter)
            cls._np_rng = np.random.default_rng(int(seed))


def set_seed(seed: int) -> None:
    RandomGenerator.set_seed(seed)
