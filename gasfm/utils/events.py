"""TensorBoard scalar event files, written with the standard library only.

An event file is a sequence of records ``len:u64 | crc(len):u32 | data |
crc(data):u32`` (little endian, masked CRC-32C), each ``data`` a serialized
``tensorflow.Event`` protobuf. Only the two messages the trainer logs are
encoded: the file-version header and one scalar summary per record, which
TensorBoard's scalar dashboard reads.
"""

from __future__ import annotations

import os
import socket
import struct
import time


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF  # int64 two's complement
    out = bytearray()
    while True:
        byte = v & 0x7F
        v >>= 7
        if v:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(num: int, wire: int, payload: bytes) -> bytes:
    return _varint((num << 3) | wire) + payload


def _bytes_field(num: int, data: bytes) -> bytes:
    return _field(num, 2, _varint(len(data)) + data)


def _event(wall_time: float, step: int = 0, file_version: str = None, summary: bytes = None) -> bytes:
    msg = _field(1, 1, struct.pack("<d", wall_time))  # Event.wall_time
    if step:
        msg += _field(2, 0, _varint(step))  # Event.step
    if file_version is not None:
        msg += _bytes_field(3, file_version.encode())  # Event.file_version
    if summary is not None:
        msg += _bytes_field(5, summary)  # Event.summary
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    # Summary.value[0] = Value{tag: 1, simple_value: 2 (float32)}
    val = _bytes_field(1, tag.encode()) + _field(2, 5, struct.pack("<f", value))
    return _bytes_field(1, val)


class EventWriter:
    """Append-only writer of scalar summaries into ``log_dir``.

    Mirrors the part of ``torch.utils.tensorboard.SummaryWriter`` the trainer
    uses: ``add_scalar(tag, value, global_step)`` and ``close()``. Every
    record is flushed as it is written."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}"
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header + struct.pack("<I", _masked_crc(header)))
        self._f.write(data + struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def add_scalar(self, tag: str, value, global_step: int = 0) -> None:
        summary = _scalar_summary(tag, float(value))
        self._write(_event(time.time(), step=int(global_step), summary=summary))

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def _read_varint(buf: bytes, i: int):
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return result, i


def _fields(buf: bytes):
    """(field number, value) pairs of one protobuf message: ints for
    varints, bytes for the fixed and length-delimited wire types."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(buf, i)
            val, i = buf[i:i + n], i + n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield num, val


def read_scalars(path: str):
    """[(tag, step, value)] of the scalar summaries in an event file written
    by :class:`EventWriter`; checks every record's CRCs."""
    with open(path, "rb") as f:
        buf = f.read()
    out, i = [], 0
    while i < len(buf):
        header = buf[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        if struct.unpack("<I", buf[i + 8:i + 12])[0] != _masked_crc(header):
            raise ValueError(f"{path}: bad length CRC at byte {i}")
        data = buf[i + 12:i + 12 + n]
        if struct.unpack("<I", buf[i + 12 + n:i + 16 + n])[0] != _masked_crc(data):
            raise ValueError(f"{path}: bad data CRC at byte {i}")
        i += 16 + n
        step = 0
        for num, val in _fields(data):
            if num == 2:
                step = val - (1 << 64) if val >= 1 << 63 else val
            elif num == 5:
                for _, value in _fields(val):
                    fields = dict(_fields(value))
                    out.append((fields[1].decode(), step, struct.unpack("<f", fields[2])[0]))
    return out
