"""Dependency-free TensorBoard scalar event writer (a copy of the JAX
package's ``utils/tensorboard.py``, which imports no JAX; the port keeps its
own copy because it imports nothing of the JAX package).

It writes the TFRecord + Event-protobuf format TensorBoard reads,
hand-encoded (the Event/Summary messages are tiny and stable — wall_time,
step, tag, simple_value), so training curves land in standard dashboards
without TensorFlow or TensorBoard on the host.

Format notes (tensorflow/core/util/event.proto + TFRecord framing):

- TFRecord record = u64le(len) + u32le(masked_crc32c(len_bytes))
  + payload + u32le(masked_crc32c(payload))
- Event: field 1 wall_time (double), field 2 step (int64),
  field 3 file_version (string, first record only: "brain.Event:2"),
  field 5 summary (Summary message)
- Summary: repeated field 1 Value; Value: field 1 tag (string),
  field 2 simple_value (float)
- masked crc = ((crc >> 15 | crc << 17) + 0xa282ead8) mod 2^32, crc32c
  (Castagnoli) — NOT zlib's IEEE crc32.
"""

from __future__ import annotations

import itertools
import os
import socket
import struct
import time
from pathlib import Path
from typing import Dict

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven. Verified against the standard test
# vector crc32c(b"123456789") == 0xE3069283 in tests/test_tensorboard.py.
# ---------------------------------------------------------------------------

_CRC_TABLE = []
_POLY = 0x82F63B78  # reversed Castagnoli polynomial
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding (varint / fixed / length-delimited)
# ---------------------------------------------------------------------------


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
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(wall_time: float, step: int, tag: str, value: float) -> bytes:
    val = _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))
    summary = _pb_bytes(1, val)
    return _pb_double(1, wall_time) + _pb_varint(2, int(step)) + _pb_bytes(5, summary)


def _version_event(wall_time: float) -> bytes:
    return _pb_double(1, wall_time) + _pb_bytes(3, b"brain.Event:2")


class SummaryWriter:
    """Append TensorBoard scalar events to ``logdir``.

    Usage mirrors torch.utils.tensorboard at the subset this framework
    needs: ``add_scalar(tag, value, step)`` + ``flush()``/``close()``.
    Non-finite values are skipped (TensorBoard renders them as gaps
    anyway, and a NaN float32 round-trips confusingly).
    """

    _serial = itertools.count()  # per-process uniquifier: two writers created
    # in the same second must not append into one file (duplicate steps)

    def __init__(self, logdir):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        host = socket.gethostname() or "host"
        name = (
            f"events.out.tfevents.{int(time.time())}.{host}.{os.getpid()}"
            f".{next(self._serial)}"
        )
        self.path = self.logdir / name
        self._f = open(self.path, "ab")
        self._write(_version_event(time.time()))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value, step: int) -> None:
        v = float(value)
        if v != v or v in (float("inf"), float("-inf")):
            return
        self._write(_scalar_event(time.time(), step, tag, v))

    def add_scalars(self, scalars: Dict[str, float], step: int) -> None:
        for tag, v in scalars.items():
            self.add_scalar(tag, v, step)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# reader (for tests and quick inspection without TensorBoard installed)
# ---------------------------------------------------------------------------


def read_scalar_events(path) -> Dict[str, list]:
    """Parse a tfevents file back into {tag: [(step, value), ...]}.

    Validates TFRecord CRCs; raises ValueError on corruption. Used by the
    round-trip tests and handy for headless inspection.
    """
    out: Dict[str, list] = {}
    data = Path(path).read_bytes()
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated TFRecord header")
        header = data[pos : pos + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[pos + 8 : pos + 12])
        if hcrc != _masked_crc(header):
            raise ValueError("TFRecord header CRC mismatch")
        if pos + 16 + length > len(data):
            raise ValueError("truncated TFRecord payload")
        payload = data[pos + 12 : pos + 12 + length]
        (pcrc,) = struct.unpack("<I", data[pos + 12 + length : pos + 16 + length])
        if pcrc != _masked_crc(payload):
            raise ValueError("TFRecord payload CRC mismatch")
        pos += 16 + length
        step, summary = 0, None
        for field, wire, value in _iter_fields(payload):
            if field == 2 and wire == 0:
                step = value
            elif field == 5 and wire == 2:
                summary = value
        if summary is None:
            continue
        for field, wire, value in _iter_fields(summary):
            if field == 1 and wire == 2:
                tag, sv = None, None
                for f2, w2, v2 in _iter_fields(value):
                    if f2 == 1 and w2 == 2:
                        tag = v2.decode()
                    elif f2 == 2 and w2 == 5:
                        (sv,) = struct.unpack("<f", v2)
                if tag is not None and sv is not None:
                    out.setdefault(tag, []).append((step, sv))
    return out


def _iter_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos : pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos : pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, value


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
