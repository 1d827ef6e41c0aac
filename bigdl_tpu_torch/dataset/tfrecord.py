"""TFRecord files and ``tf.Example`` parsing (counterpart of
``bigdl_tpu/dataset/tfrecord.py``; reference: ``$DL/nn/ops/ParseExample.scala``
and the TFRecord readers under ``$DL/utils/tf``).

The host data pipeline decodes records in worker threads and only dense
batches reach the card. This module has (a) a TFRecord reader and writer
(the public wire format: ``uint64 length | uint32 masked-crc32c(length) |
payload | uint32 masked-crc32c(payload)``, the CRC from the port's host
library, :func:`bigdl_tpu_torch.native.crc32c`), (b) a schema-free
``tf.Example`` parser and builder on :mod:`..utils.protowire`, and (c)
``TFRecordDataSet`` on the same worker-threaded shard machinery as
``ShardedRecordDataSet`` (deterministic unit order, ``shard(index,
count)``, the ``samples(train)`` stream a ``DataPipeline`` consumes).

Wire facts used (public specs): Example{features=1}; Features{feature=1
map<string, Feature>}; Feature oneof {bytes_list=1, float_list=2,
int64_list=3}; BytesList.value=1 (bytes), FloatList.value=1 (packed f32),
Int64List.value=1 (varints). CRC mask: ((crc>>15 | crc<<17) + 0xa282ead8).
"""

from __future__ import annotations

import os
import struct
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from ..native import crc32c
from ..utils.protowire import WireReader, signed64
from .dataset import Sample, Transformer
from .files import _ShardedDataSet

_MASK_DELTA = 0xA282EAD8


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + _MASK_DELTA) & 0xFFFFFFFF


def read_tfrecords(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) != 12:
                raise ValueError(f"{path}: truncated TFRecord length header")
            (length,), (len_crc,) = struct.unpack("<Q", header[:8]), struct.unpack(
                "<I", header[8:]
            )
            if verify_crc and _masked_crc(header[:8]) != len_crc:
                raise ValueError(f"{path}: TFRecord length crc mismatch")
            payload = f.read(length)
            tail = f.read(4)
            if len(payload) != length or len(tail) != 4:
                raise ValueError(f"{path}: truncated TFRecord payload")
            if verify_crc and _masked_crc(payload) != struct.unpack("<I", tail)[0]:
                raise ValueError(f"{path}: TFRecord payload crc mismatch")
            yield payload


def write_tfrecords(records: Iterator[bytes], path: str) -> int:
    """Write raw payloads in TFRecord framing (for fixtures/export); returns count."""
    n = 0
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for payload in records:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))
            n += 1
    os.replace(tmp, path)
    return n


FeatureValue = Union[List[bytes], np.ndarray]


def parse_example(blob: bytes) -> Dict[str, FeatureValue]:
    """Serialized tf.Example -> {name: bytes list | float32/int64 array}."""
    out: Dict[str, FeatureValue] = {}
    r = WireReader(blob)
    while not r.done():
        f, wt = r.field()
        if f == 1 and wt == 2:  # Features
            fr = r.sub()
            while not fr.done():
                ff, fwt = fr.field()
                if ff == 1 and fwt == 2:  # map entry
                    entry = fr.sub()
                    # an omitted Feature value submessage means "empty" — keep
                    # the same [] shape as an explicitly empty Feature
                    key, value = "", []
                    while not entry.done():
                        ef, ewt = entry.field()
                        if ef == 1 and ewt == 2:
                            key = entry.bytes_().decode()
                        elif ef == 2 and ewt == 2:
                            value = _parse_feature(entry.sub())
                        else:
                            entry.skip(ewt)
                    if key:
                        out[key] = value
                else:
                    fr.skip(fwt)
        else:
            r.skip(wt)
    return out


def _parse_feature(r: WireReader) -> FeatureValue:
    while not r.done():
        f, wt = r.field()
        if f == 1 and wt == 2:  # BytesList
            values: List[bytes] = []
            br = r.sub()
            while not br.done():
                bf, bwt = br.field()
                if bf == 1 and bwt == 2:
                    values.append(br.bytes_())
                else:
                    br.skip(bwt)
            return values
        if f == 2 and wt == 2:  # FloatList (packed or repeated)
            floats: List[float] = []
            fr = r.sub()
            while not fr.done():
                ff, fwt = fr.field()
                if ff == 1 and fwt == 2:  # packed
                    sub = fr.sub()
                    while not sub.done():
                        floats.append(sub.f32())
                elif ff == 1 and fwt == 5:
                    floats.append(fr.f32())
                else:
                    fr.skip(fwt)
            return np.asarray(floats, np.float32)
        if f == 3 and wt == 2:  # Int64List (packed or repeated varints)
            ints: List[int] = []
            ir = r.sub()
            while not ir.done():
                iff, iwt = ir.field()
                if iff == 1 and iwt == 2:
                    sub = ir.sub()
                    while not sub.done():
                        ints.append(signed64(sub.varint()))
                elif iff == 1 and iwt == 0:
                    ints.append(signed64(ir.varint()))
                else:
                    ir.skip(iwt)
            return np.asarray(ints, np.int64)
        r.skip(wt)
    return []


def build_example(features: Dict[str, FeatureValue]) -> bytes:
    """Inverse of ``parse_example`` (writer side for fixtures/export)."""
    from ..utils.protowire import WireWriter

    feats = WireWriter()
    for key, value in features.items():
        fv = WireWriter()
        if isinstance(value, (list, tuple)) and all(
            isinstance(v, bytes) for v in value
        ):
            bl = WireWriter()
            for v in value:
                bl.bytes_(1, v)
            fv.message(1, bl)
        else:
            arr = np.asarray(value)
            if np.issubdtype(arr.dtype, np.floating):
                fl = WireWriter()
                fl.bytes_(1, np.ascontiguousarray(arr, "<f4").tobytes())
                fv.message(2, fl)
            else:
                il = WireWriter()
                packed = b"".join(
                    WireWriter.varint_bytes(int(v)) for v in arr.ravel()
                )
                il.bytes_(1, packed)
                fv.message(3, il)
        entry = WireWriter()
        entry.string(1, key)
        entry.message(2, fv)
        feats.message(1, entry)
    ex = WireWriter()
    ex.message(1, feats)
    return ex.blob()


class TFRecordDataSet(_ShardedDataSet):
    """Worker-threaded DataSet over TFRecord files of tf.Example records.

    ``decode(features_dict) -> Sample`` receives ``parse_example`` output.
    The standard ImageNet-TFRecord convention is
    ``{'image/encoded': [bytes], 'image/class/label': int64 array}``.
    """

    def __init__(self, paths: Sequence[str], decode: Callable[[Dict], Sample],
                 batch_size: int = 32, n_workers: int = 4,
                 transformer: Optional[Transformer] = None,
                 verify_crc: bool = True):
        super().__init__(batch_size, n_workers, transformer)
        self.paths = sorted(paths)
        if not self.paths:
            raise ValueError("TFRecordDataSet needs at least one file")
        self.decode = decode
        self.verify_crc = verify_crc
        self._counts: Optional[List[int]] = None

    def _n_units(self) -> int:
        return len(self.paths)

    def _decode_unit(self, unit_index: int, epoch_rng) -> List[Sample]:
        # FILE order — the base machinery applies the intra-unit training
        # shuffle itself and relies on deterministic order for eval
        return [
            self.decode(parse_example(blob))
            for blob in read_tfrecords(self.paths[unit_index], self.verify_crc)
        ]

    @staticmethod
    def _count_records(path: str) -> int:
        """Header-seek count: ~16 bytes touched per record, payloads skipped."""
        n = 0
        file_size = os.path.getsize(path)
        with open(path, "rb") as f:
            while True:
                header = f.read(12)
                if not header:
                    return n
                if len(header) != 12:
                    raise ValueError(f"{path}: truncated TFRecord header")
                (length,) = struct.unpack("<Q", header[:8])
                # seek past EOF succeeds silently — verify the payload+tail-crc
                # actually exists so truncation fails here, not mid-epoch
                f.seek(length + 4, 1)
                if f.tell() > file_size:
                    raise ValueError(f"{path}: truncated TFRecord payload")
                n += 1

    def size(self) -> int:
        if self._counts is None:
            self._counts = [self._count_records(p) for p in self.paths]
        # this host's slice under shard(); the full set when unsharded
        return sum(self._counts[u] for u in self._owned_units())
