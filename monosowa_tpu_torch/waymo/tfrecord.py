"""Pure-python TFRecord framing (reader + writer, no tensorflow).

A TFRecord file is a sequence of records, each framed as

    uint64 little-endian  length
    uint32 little-endian  masked crc32c of the 8 length bytes
    byte[length]          data
    uint32 little-endian  masked crc32c of data

with crc32c the Castagnoli CRC (poly 0x1EDC6F41, reflected 0x82F63B78)
and TF's mask ``((crc >> 15 | crc << 17) + 0xa282ead8) mod 2^32``.

Replaces ``tf.data.TFRecordDataset(..., compression_type='')`` in the
Waymo converter (pseudo_label_generator/waymo_to_kitti_projected.py:116);
the writer exists so tests can synthesize byte-faithful sequence files.
A copy of the JAX package's ``waymo/tfrecord.py``.
"""

from __future__ import annotations

import struct
from typing import Iterator

_MASK_DELTA = 0xA282EAD8


def _make_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def read_tfrecord(path: str, verify: bool = True) -> Iterator[bytes]:
    """Yield each record's payload bytes."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise IOError(f"{path}: truncated record header")
            (length,), (len_crc,) = (struct.unpack("<Q", header[:8]),
                                     struct.unpack("<I", header[8:]))
            if verify and masked_crc32c(header[:8]) != len_crc:
                raise IOError(f"{path}: length crc mismatch")
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"{path}: truncated record body")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if verify and masked_crc32c(data) != data_crc:
                raise IOError(f"{path}: data crc mismatch")
            yield data


def write_tfrecord(path: str, records) -> None:
    with open(path, "wb") as f:
        for data in records:
            header = struct.pack("<Q", len(data))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(data)
            f.write(struct.pack("<I", masked_crc32c(data)))
