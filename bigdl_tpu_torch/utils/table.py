"""``Table`` — BigDL's activity container, reduced to what ``Graph`` and the
table layers need (counterpart of ``bigdl_tpu/utils/table.py``).

An insertion-ordered map with Torch's 1-based integer keys; ``T(a, b)``
builds ``Table({1: a, 2: b})``. Iterating yields the values in order.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional


class Table:
    """Ordered int-keyed container (reference: ``$DL/utils/Table.scala``)."""

    __slots__ = ("_d",)

    def __init__(self, d: Optional[Dict[Any, Any]] = None):
        self._d: Dict[Any, Any] = dict(d) if d else {}

    def __getitem__(self, k):
        return self._d[k]

    def __setitem__(self, k, v):
        self._d[k] = v

    def __len__(self) -> int:
        return len(self._d)

    def __iter__(self) -> Iterator:
        return iter(self._d.values())

    def items(self):
        return self._d.items()

    def insert(self, v) -> "Table":
        """Append with the next 1-based integer key."""
        self._d[len(self._d) + 1] = v
        return self

    def to_list(self) -> List[Any]:
        return list(self._d.values())

    def __repr__(self):
        return f"Table({self._d!r})"


def T(*items) -> Table:
    """A Table of the positional entries under keys 1, 2, ..."""
    t = Table()
    for it in items:
        t.insert(it)
    return t
