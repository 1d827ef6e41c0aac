"""MovieLens-style ratings for NCF (counterpart of
``bigdl_tpu/dataset/movielens.py``; reference: ``$PY/dataset/movielens.py``).

``load_movielens(path, ...)`` parses a ``ratings.dat`` in ml-1m's
``user::item::rating::timestamp`` format when ``path`` names it (or the
folder holding it; a path that does not exist raises), and otherwise draws
the JAX package's synthetic log (users and items in 4 latent genres, a user
rating an item of its genre) from the same seeded numpy generator, so both
packages return the same arrays. Ids are 1-based; labels are implicit
feedback, 1 for a rated pair and 0 for sampled unseen pairs
(``neg_per_pos`` a positive). Host numpy only: no download.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def load_movielens(
    path: Optional[str] = None,
    n: Optional[int] = 2048,
    n_users: int = 100,
    n_items: int = 200,
    neg_per_pos: int = 1,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Returns ((N, 2) int [user, item] 1-based, (N,) int labels {0,1},
    user_count, item_count). ``n=None`` with a real file means use ALL rows
    (for synthetic data ``None`` falls back to the 2048 default)."""
    rng = np.random.default_rng(seed)
    if path and os.path.isdir(path):
        # the examples' -f/--data-dir convention passes the dataset FOLDER
        path = os.path.join(path, "ratings.dat")
    if path and not os.path.exists(path):
        # an explicit path that doesn't resolve must NOT silently fall back to
        # synthetic data — the caller believes they're training on a real log
        raise FileNotFoundError(f"ratings file not found: {path}")
    if path:
        # parse the WHOLE file (ml-1m is sorted by user — a line-prefix cut
        # would keep only the first few users), then subsample n rows uniformly
        users, items = [], []
        with open(path) as f:
            for line in f:
                parts = line.strip().split("::")
                if len(parts) < 3:
                    continue
                users.append(int(parts[0]))
                items.append(int(parts[1]))
        if not users:
            raise ValueError(f"no 'user::item::rating' rows parsed from {path}")
        users = np.asarray(users, np.int64)
        items = np.asarray(items, np.int64)
        user_count = int(users.max())
        item_count = int(items.max())
        # negatives must be checked against EVERY interaction in the file, not
        # just the subsampled training positives — otherwise a dropped positive
        # could be re-sampled as a "negative"
        full_seen = set(zip(users.tolist(), items.tolist()))
        if n is not None and n < len(users):
            keep = rng.choice(len(users), n, replace=False)
            users, items = users[keep], items[keep]
        pos = np.stack([users, items], axis=1)
        labels_pos = np.ones(len(pos), np.int64)
    else:
        if n is None:
            n = 2048
        full_seen = None
        # synthetic: users and items each belong to one of 4 latent genres;
        # a user rates an item iff genres match (learnable by NeuMF embeddings).
        # Round-robin item genres so no bucket is ever empty (random assignment
        # can leave a genre with zero items at small n_items).
        n_genres = min(4, n_items)
        user_genre = rng.integers(0, n_genres, n_users)
        item_genre = np.arange(n_items) % n_genres
        u = rng.integers(0, n_users, n)
        g = user_genre[u]
        matching = [np.flatnonzero(item_genre == gg) for gg in range(n_genres)]
        it = np.asarray([rng.choice(matching[gg]) for gg in g])
        pos = np.stack([u + 1, it + 1], axis=1)
        user_count, item_count = n_users, n_items
        labels_pos = np.ones(n, np.int64)

    # implicit-feedback negatives: random items the user did NOT interact with.
    # Bounded attempts — a small/dense log can have fewer unseen pairs than
    # requested negatives, so stop short rather than spin forever.
    seen = full_seen if full_seen is not None else set(map(tuple, pos.tolist()))
    want = neg_per_pos * len(pos)
    neg = []
    attempts = 0
    max_attempts = 50 * max(want, 1)
    while len(neg) < want and attempts < max_attempts:
        attempts += 1
        uu = int(rng.integers(1, user_count + 1))
        ii = int(rng.integers(1, item_count + 1))
        if (uu, ii) not in seen:
            neg.append((uu, ii))
            seen.add((uu, ii))
    neg = np.asarray(neg, np.int64).reshape(-1, 2)

    x = np.concatenate([pos, neg], axis=0)
    y = np.concatenate([labels_pos, np.zeros(len(neg), np.int64)])
    perm = rng.permutation(len(x))
    return x[perm], y[perm], user_count, item_count
