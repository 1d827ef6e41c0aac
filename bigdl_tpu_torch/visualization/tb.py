"""TensorBoard event files, written and read without a ``tensorboard`` or
TensorFlow package (counterpart of ``bigdl_tpu/visualization/tb.py``; the
port's own copy, byte for byte the same format).

As the reference's ``$DL/visualization/tensorboard/FileWriter.scala`` and
``EventWriter``, the files are CRC-framed records of serialized ``Event``
protos; the protobuf wire format and the masked CRC32C are encoded by hand
(the ``Event`` / ``Summary`` / ``HistogramProto`` schemas are small and
frozen). The CRC runs in the port's host library (``native.crc32c``).

Record framing (TFRecord):  len(uint64 LE) · masked_crc32c(len) · data · masked_crc32c(data)
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# ----------------------------------------------------------------------- crc32c
_CRC_TABLE: List[int] = []


def _make_table() -> None:
    poly = 0x82F63B78  # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_make_table()


def _py_crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    """Castagnoli CRC through the port's host library
    (``csrc/bigdl_host.cpp``); ``_py_crc32c`` is its plain version."""
    from ..native import crc32c as _native

    return _native(data)


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf encode
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _pb_str(field: int, v: str) -> bytes:
    return _pb_bytes(field, v.encode("utf-8"))


def _pb_packed_doubles(field: int, vals) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in vals)
    return _pb_bytes(field, payload)


def encode_scalar_summary(tag: str, value: float) -> bytes:
    # Summary{ value: [ Value{ tag=1, simple_value=2 } ] }
    val = _pb_str(1, tag) + _pb_float(2, float(value))
    return _pb_bytes(1, val)


def encode_histogram_summary(tag: str, values: np.ndarray) -> bytes:
    """Summary{ value: [ Value{ tag=1, histo=5: HistogramProto } ] }.

    HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5
    bucket_limit=6(packed) bucket=7(packed). Buckets follow TF convention:
    exponential bins around 0.
    """
    a = np.asarray(values, np.float64).ravel()
    a = a[np.isfinite(a)]  # inf/NaN (diverged weights) must not stop the writer
    if a.size == 0:
        a = np.zeros(1)
    limits: List[float] = []
    v = 1e-12
    while v < 1e20:
        limits.append(v)
        v *= 1.1
    limits = [-x for x in reversed(limits)] + limits + [1.7976931348623157e308]
    edges = np.asarray(limits)
    idx = np.searchsorted(edges, a, side="left")
    counts = np.bincount(idx, minlength=edges.size)
    keep = counts.nonzero()[0]
    if keep.size == 0:
        keep = np.asarray([edges.size // 2])
    histo = (
        _pb_double(1, float(a.min()))
        + _pb_double(2, float(a.max()))
        + _pb_double(3, float(a.size))
        + _pb_double(4, float(a.sum()))
        + _pb_double(5, float((a * a).sum()))
        + _pb_packed_doubles(6, edges[keep])
        + _pb_packed_doubles(7, counts[keep])
    )
    val = _pb_str(1, tag) + _pb_bytes(5, histo)
    return _pb_bytes(1, val)


def encode_event(
    wall_time: float,
    step: Optional[int] = None,
    summary: Optional[bytes] = None,
    file_version: Optional[str] = None,
) -> bytes:
    # Event{ wall_time=1(double), step=2(int64), file_version=3, summary=5 }
    out = _pb_double(1, wall_time)
    if step is not None:
        out += _pb_int(2, int(step))
    if file_version is not None:
        out += _pb_str(3, file_version)
    if summary is not None:
        out += _pb_bytes(5, summary)
    return out


# ------------------------------------------------------------- protobuf decode
def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
            yield field, wire, v
        elif wire == 1:
            yield field, wire, buf[i : i + 8]
            i += 8
        elif wire == 5:
            yield field, wire, buf[i : i + 4]
            i += 4
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            yield field, wire, buf[i : i + ln]
            i += ln
        else:  # pragma: no cover
            raise ValueError(f"unsupported wire type {wire}")


def decode_event(buf: bytes) -> Dict:
    ev: Dict = {"wall_time": 0.0, "step": 0, "scalars": {}}
    for field, wire, v in _iter_fields(buf):
        if field == 1 and wire == 1:
            ev["wall_time"] = struct.unpack("<d", v)[0]
        elif field == 2 and wire == 0:
            ev["step"] = v
        elif field == 5 and wire == 2:
            for f2, w2, v2 in _iter_fields(v):
                if f2 == 1 and w2 == 2:  # Summary.Value
                    tag = None
                    sval = None
                    for f3, w3, v3 in _iter_fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode("utf-8")
                        elif f3 == 2 and w3 == 5:
                            sval = struct.unpack("<f", v3)[0]
                    if tag is not None and sval is not None:
                        ev["scalars"][tag] = sval
    return ev


# ---------------------------------------------------------------- file writer
class EventWriter:
    """Appends CRC-framed Event records to one tfevents file (the
    reference's ``EventWriter.scala``)."""

    def __init__(self, log_dir: str, flush_secs: float = 10.0):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._lock = threading.Lock()
        self._flush_secs = flush_secs
        # the flush interval is a duration: perf_counter, not the wall clock
        self._last_flush = time.perf_counter()
        self.write_event(encode_event(time.time(), file_version="brain.Event:2"))

    def write_event(self, data: bytes) -> None:
        hdr = struct.pack("<Q", len(data))
        rec = (
            hdr
            + struct.pack("<I", _masked_crc(hdr))
            + data
            + struct.pack("<I", _masked_crc(data))
        )
        with self._lock:
            self._f.write(rec)
            if time.perf_counter() - self._last_flush > self._flush_secs:
                self._f.flush()
                self._last_flush = time.perf_counter()

    def flush(self) -> None:
        with self._lock:
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


def read_events(log_dir: str) -> List[Dict]:
    """Parse every tfevents file under ``log_dir`` (``TrainSummary.read_scalar``
    and the tests read through it)."""
    events: List[Dict] = []
    if not os.path.isdir(log_dir):
        return events
    for name in sorted(os.listdir(log_dir)):
        if "tfevents" not in name:
            continue
        with open(os.path.join(log_dir, name), "rb") as f:
            buf = f.read()
        i = 0
        while i + 12 <= len(buf):
            (ln,) = struct.unpack("<Q", buf[i : i + 8])
            data = buf[i + 12 : i + 12 + ln]
            if len(data) < ln:
                break
            events.append(decode_event(data))
            i += 12 + ln + 4
    return events
