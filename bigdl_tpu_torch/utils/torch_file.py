"""Torch7 ``.t7`` serialization (counterpart of
``bigdl_tpu/utils/torch_file.py``; BigDL's ``TorchFile``).

From-scratch reader/writer for the public torch7 binary format (the one the
lua ``torch.save``/``torch.load`` pair and the reference's TorchFile speak):

* little-endian; each value starts with a 4-byte type tag:
  0 nil, 1 number (f64), 2 string (i32 len + bytes), 3 table,
  4 torch class, 5 boolean.
* tables and torch objects carry a 4-byte heap index — repeated indices
  reference the already-deserialized object (cycles/sharing).
* a torch object is: index, then a version string ("V 1"; absent in the
  oldest files, in which case that string IS the class name), then the class
  name, then the class payload.
* ``torch.XxxTensor`` payload: i32 ndim, ndim i64 sizes, ndim i64 strides,
  i64 storageOffset (1-based), then the Storage object.
  ``torch.XxxStorage`` payload: i64 size, then raw elements.
* any other torch class serializes its fields as a table payload.

Reading returns numpy arrays for tensors, dict/list for tables (a table
whose keys are 1..n becomes a list), and ``T7Object`` wrappers for other
torch classes. Writing supports numbers, bools, strings, dicts/lists and
numpy arrays (stored as the matching tensor class). A ``torch.Tensor`` is
written as its host copy (a bfloat16 one as float32: torch7 has no bfloat16
tensor class), so a model's weights on the card save as they are. Reading
and writing are numpy in and out, as in the JAX package, so a file written
by either package reads back the same in both.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Dict

import numpy as np
import torch

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5

_TENSOR_DTYPES = {
    "torch.DoubleTensor": np.float64,
    "torch.FloatTensor": np.float32,
    "torch.LongTensor": np.int64,
    "torch.IntTensor": np.int32,
    "torch.ShortTensor": np.int16,
    "torch.CharTensor": np.int8,
    "torch.ByteTensor": np.uint8,
}
_STORAGE_DTYPES = {
    k.replace("Tensor", "Storage"): v for k, v in _TENSOR_DTYPES.items()
}
_DTYPE_TENSORS = {np.dtype(v): k for k, v in _TENSOR_DTYPES.items()}


class T7Object:
    """A non-tensor torch class instance: class name + field table."""

    def __init__(self, torch_class: str, fields: Any):
        self.torch_class = torch_class
        self.fields = fields

    def __repr__(self):
        return f"T7Object({self.torch_class!r})"


class _Reader:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.memo: Dict[int, Any] = {}

    def _read(self, fmt: str):
        size = struct.calcsize(fmt)
        blob = self.f.read(size)
        if len(blob) != size:
            raise ValueError("truncated .t7 file")
        return struct.unpack(fmt, blob)[0]

    def i32(self) -> int:
        return self._read("<i")

    def i64(self) -> int:
        return self._read("<q")

    def f64(self) -> float:
        return self._read("<d")

    def string(self) -> str:
        n = self.i32()
        return self.f.read(n).decode("latin-1")

    def obj(self) -> Any:
        tag = self.i32()
        if tag == TYPE_NIL:
            return None
        if tag == TYPE_NUMBER:
            v = self.f64()
            return int(v) if float(v).is_integer() and abs(v) < 2**53 else v
        if tag == TYPE_STRING:
            return self.string()
        if tag == TYPE_BOOLEAN:
            return bool(self.i32())
        if tag == TYPE_TABLE:
            return self._table()
        if tag == TYPE_TORCH:
            return self._torch()
        raise ValueError(f"unsupported .t7 type tag {tag}")

    def _table(self):
        index = self.i32()
        if index in self.memo:
            return self.memo[index]
        out: Dict[Any, Any] = {}
        self.memo[index] = out
        count = self.i32()
        for _ in range(count):
            key = self.obj()
            out[key] = self.obj()
        # a lua array-table (keys exactly 1..n) reads back as a list
        if out and all(isinstance(k, int) for k in out) and \
                sorted(out) == list(range(1, len(out) + 1)):
            lst = [out[i] for i in range(1, len(out) + 1)]
            self.memo[index] = lst
            return lst
        return out

    def _torch(self):
        index = self.i32()
        if index in self.memo:
            return self.memo[index]
        version = self.string()
        class_name = version if not version.startswith("V ") else self.string()
        if class_name in _TENSOR_DTYPES:
            value = self._tensor(class_name)
        elif class_name in _STORAGE_DTYPES:
            value = self._storage(class_name)
        else:
            value = T7Object(class_name, None)
            self.memo[index] = value  # register BEFORE fields (cycles)
            value.fields = self.obj()
            return value
        self.memo[index] = value
        return value

    def _tensor(self, class_name: str) -> np.ndarray:
        ndim = self.i32()
        sizes = [self.i64() for _ in range(ndim)]
        strides = [self.i64() for _ in range(ndim)]
        offset = self.i64() - 1  # torch is 1-based
        storage = self.obj()
        if storage is None:
            return np.zeros(sizes, _TENSOR_DTYPES[class_name])
        # bounds-check the view BEFORE as_strided: header-claimed geometry on
        # a malformed file must raise, never read out of the storage buffer
        last = offset
        for size, stride in zip(sizes, strides):
            if size < 0 or offset < 0:
                raise ValueError("corrupt .t7 tensor header")
            if size > 0:
                last += (size - 1) * stride
        if sizes and (last >= storage.size or last < 0):
            raise ValueError(
                f"corrupt .t7: tensor view [{offset}..{last}] exceeds "
                f"storage of {storage.size} elements"
            )
        return np.lib.stride_tricks.as_strided(
            storage[offset:],
            shape=sizes,
            strides=[s * storage.itemsize for s in strides],
        ).copy()

    def _storage(self, class_name: str) -> np.ndarray:
        size = self.i64()
        dtype = np.dtype(_STORAGE_DTYPES[class_name])
        blob = self.f.read(size * dtype.itemsize)
        if len(blob) != size * dtype.itemsize:
            raise ValueError("truncated .t7 file")
        return np.frombuffer(blob, dtype).copy()


class _Writer:
    def __init__(self, f: BinaryIO):
        self.f = f
        self.next_index = 1
        self.memo: Dict[int, int] = {}  # id(obj) -> heap index

    def i32(self, v: int) -> None:
        self.f.write(struct.pack("<i", v))

    def i64(self, v: int) -> None:
        self.f.write(struct.pack("<q", v))

    def string(self, s: str) -> None:
        blob = s.encode("latin-1")
        self.i32(len(blob))
        self.f.write(blob)

    def obj(self, v: Any) -> None:
        if v is None:
            self.i32(TYPE_NIL)
        elif isinstance(v, bool):
            self.i32(TYPE_BOOLEAN)
            self.i32(int(v))
        elif isinstance(v, (int, float)):
            self.i32(TYPE_NUMBER)
            self.f.write(struct.pack("<d", float(v)))
        elif isinstance(v, str):
            self.i32(TYPE_STRING)
            self.string(v)
        elif isinstance(v, np.ndarray):
            if not self._ref(v, TYPE_TORCH):
                self._tensor(v)
        elif isinstance(v, torch.Tensor):
            if not self._ref(v, TYPE_TORCH):
                host = v.detach().cpu()
                if host.dtype == torch.bfloat16:
                    host = host.float()
                self._tensor(host.numpy(), key=v)
        elif isinstance(v, (list, tuple)):
            if not self._ref(v, TYPE_TABLE):
                self._table({i + 1: x for i, x in enumerate(v)},
                            memo_key=id(v))
        elif isinstance(v, dict):
            if not self._ref(v, TYPE_TABLE):
                self._table(v, memo_key=id(v))
        else:
            raise TypeError(f"cannot serialize {type(v)} to .t7")

    def _alloc(self, obj=None) -> int:
        idx = self.next_index
        self.next_index += 1
        if obj is not None:
            self.memo[id(obj)] = idx
        return idx

    def _ref(self, obj, tag: int) -> bool:
        """Write a back-reference if ``obj`` was already serialized (the
        reader's heap-index memo handles sharing and cycles)."""
        idx = self.memo.get(id(obj))
        if idx is None:
            return False
        self.i32(tag)
        self.i32(idx)
        return True

    def _table(self, items: Dict[Any, Any], memo_key=None) -> None:
        self.i32(TYPE_TABLE)
        idx = self._alloc()
        if memo_key is not None:
            self.memo[memo_key] = idx
        self.i32(idx)
        self.i32(len(items))
        for k, val in items.items():
            self.obj(k)
            self.obj(val)

    def _tensor(self, arr: np.ndarray, key=None) -> None:
        key = arr if key is None else key
        arr = np.ascontiguousarray(arr)
        cls = _DTYPE_TENSORS.get(arr.dtype)
        if cls is None:
            arr = arr.astype(np.float64)
            cls = "torch.DoubleTensor"
        self.i32(TYPE_TORCH)
        self.i32(self._alloc(key))
        self.string("V 1")
        self.string(cls)
        self.i32(arr.ndim)
        for s in arr.shape:
            self.i64(s)
        elem_strides = [st // arr.itemsize for st in arr.strides]
        for s in elem_strides:
            self.i64(s)
        self.i64(1)  # storageOffset, 1-based
        # storage object
        self.i32(TYPE_TORCH)
        self.i32(self._alloc())
        self.string("V 1")
        self.string(cls.replace("Tensor", "Storage"))
        self.i64(arr.size)
        self.f.write(arr.tobytes())


def load_t7(path: str) -> Any:
    """Read a .t7 file (reference: ``TorchFile.load``)."""
    with open(path, "rb") as f:
        return _Reader(f).obj()


def save_t7(path: str, value: Any) -> None:
    """Write numbers/strings/tables/numpy arrays as .t7 (``TorchFile.save``)."""
    with open(path, "wb") as f:
        _Writer(f).obj(value)
