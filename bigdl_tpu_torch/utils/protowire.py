"""Minimal protobuf wire-format reader and writer (counterpart of
``bigdl_tpu/utils/protowire.py``; reference: the protobuf parsing inside
``$DL/utils/tf`` and ``$DL/utils/caffe``), without a protobuf runtime or
compiled schemas. The port's TFRecord reader parses ``tf.Example`` with it.

Wire format facts used (public protobuf spec): a message is a stream of
(tag = field_no << 3 | wire_type) varints; wire type 0 = varint, 1 = 64-bit,
2 = length-delimited (submessage / string / packed), 5 = 32-bit.
"""

from __future__ import annotations

import struct
from typing import Optional


def signed64(v: int) -> int:
    """Protobuf int64 varints are two's complement: -1 arrives as 2^64-1."""
    return v - (1 << 64) if v >= (1 << 63) else v


class WireReader:
    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: bytes, start: int = 0, end: Optional[int] = None):
        self.buf = buf
        self.pos = start
        self.end = len(buf) if end is None else end

    def done(self) -> bool:
        return self.pos >= self.end

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def field(self):
        tag = self.varint()
        return tag >> 3, tag & 0x7

    def skip(self, wire_type: int) -> None:
        if wire_type == 0:
            self.varint()
        elif wire_type == 1:
            self.pos += 8
        elif wire_type == 2:
            # NOT `self.pos += self.varint()`: augmented assignment loads the
            # old pos BEFORE varint() advances it, silently desyncing the
            # stream by the tag-length (golden-fixture finding, round 3)
            n = self.varint()
            self.pos += n
        elif wire_type == 5:
            self.pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire_type}")

    def bytes_(self) -> bytes:
        n = self.varint()
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def sub(self) -> "WireReader":
        n = self.varint()
        r = WireReader(self.buf, self.pos, self.pos + n)
        self.pos += n
        return r

    def f32(self) -> float:
        (v,) = struct.unpack_from("<f", self.buf, self.pos)
        self.pos += 4
        return v

    def f64(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.pos)
        self.pos += 8
        return v


class WireWriter:
    """Encoder counterpart (used by the Caffe/TF EXPORT paths —
    CaffePersister / TensorflowSaver analogs)."""

    __slots__ = ("out",)

    def __init__(self):
        self.out = bytearray()

    @staticmethod
    def varint_bytes(n: int) -> bytes:
        if n < 0:
            n += 1 << 64
        out = bytearray()
        while True:
            b = n & 0x7F
            n >>= 7
            if n:
                out.append(b | 0x80)
            else:
                out.append(b)
                return bytes(out)

    def varint(self, field: int, n: int) -> "WireWriter":
        self.out += self.varint_bytes((field << 3) | 0)
        self.out += self.varint_bytes(n)
        return self

    def bytes_(self, field: int, payload: bytes) -> "WireWriter":
        self.out += self.varint_bytes((field << 3) | 2)
        self.out += self.varint_bytes(len(payload))
        self.out += payload
        return self

    def string(self, field: int, s: str) -> "WireWriter":
        return self.bytes_(field, s.encode())

    def f32(self, field: int, v: float) -> "WireWriter":
        self.out += self.varint_bytes((field << 3) | 5)
        self.out += struct.pack("<f", v)
        return self

    def message(self, field: int, inner: "WireWriter") -> "WireWriter":
        return self.bytes_(field, bytes(inner.out))

    def blob(self) -> bytes:
        return bytes(self.out)
