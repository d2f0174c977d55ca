"""Dependency-free TensorBoard event-file writer.

Writes standard `events.out.tfevents.*` files readable by
`tensorboard --logdir`, as the reference's SummaryWriter scalars are; the
training loop keeps the structured `_scalars.jsonl` as the primary record
and mirrors scalars here, without a tensorflow or tensorboard dependency.
A copy of fldrx/utils/tbevents.py, so the port imports nothing of fldrx.

Format: each record is TFRecord-framed (little-endian u64 length,
masked CRC32C of the length bytes, payload, masked CRC32C of the payload)
and the payload is a hand-encoded `tensorflow.Event` protobuf carrying
either the `file_version` header or a `Summary` with one
`simple_value` per scalar. Only the protobuf wire format is needed:

    Event:   1=wall_time(double) 2=step(varint) 3=file_version(bytes)
             5=summary(message)
    Summary: 1=repeated Value;  Value: 1=tag(bytes) 2=simple_value(f32)
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import List, Tuple

_CRC_TABLE: List[int] = []


def _crc32c_init() -> None:
    poly = 0x82F63B78                     # Castagnoli, reflected
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)


_crc32c_init()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, file_version: str = "",
           scalars: Tuple[Tuple[str, float], ...] = ()) -> bytes:
    msg = bytearray()
    msg += b"\x09" + struct.pack("<d", wall_time)          # 1: wall_time
    if step:
        msg += b"\x10" + _varint(step)                     # 2: step
    if file_version:
        msg += _field_bytes(3, file_version.encode())      # 3: file_version
    if scalars:
        summ = bytearray()
        for tag, value in scalars:
            val = (_field_bytes(1, tag.encode())
                   + b"\x15" + struct.pack("<f", float(value)))
            summ += _field_bytes(1, bytes(val))
        msg += _field_bytes(5, bytes(summ))                # 5: summary
    return bytes(msg)


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", _masked_crc(header))
            + payload + struct.pack("<I", _masked_crc(payload)))


class EventWriter:
    """Minimal SummaryWriter-compatible scalar logger (one file per run)."""

    def __init__(self, log_dir: str, suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname()
        name = f"events.out.tfevents.{int(time.time())}.{host}{suffix}"
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "wb")
        self._f.write(_record(_event(time.time(),
                                     file_version="brain.Event:2")))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(_record(_event(time.time(), step=step,
                                     scalars=((tag, value),))))

    def add_scalars(self, scalars, step: int) -> None:
        """scalars: mapping tag → value, one Event with a multi-value
        Summary (fewer records than per-tag events)."""
        self._f.write(_record(_event(time.time(), step=step,
                                     scalars=tuple(scalars.items()))))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def read_events(path: str):
    """Parse an event file back into (step, {tag: value}) tuples — the
    test-side inverse (and a no-dependency debugging aid)."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        lcrc = struct.unpack_from("<I", data, pos + 8)[0]
        assert lcrc == _masked_crc(data[pos:pos + 8]), "length CRC mismatch"
        payload = data[pos + 12:pos + 12 + length]
        pcrc = struct.unpack_from("<I", data, pos + 12 + length)[0]
        assert pcrc == _masked_crc(payload), "payload CRC mismatch"
        pos += 12 + length + 4
        step, scalars = 0, {}
        mp = 0
        while mp < len(payload):
            key = payload[mp]
            if key == 0x09:                                # wall_time
                mp += 9
            elif key == 0x10:                              # step varint
                mp += 1
                step = 0
                shift = 0
                while True:
                    b = payload[mp]
                    mp += 1
                    step |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
            elif key in (0x1A, 0x2A):                      # fv / summary
                mp += 1
                ln = 0
                shift = 0
                while True:
                    b = payload[mp]
                    mp += 1
                    ln |= (b & 0x7F) << shift
                    shift += 7
                    if not b & 0x80:
                        break
                body = payload[mp:mp + ln]
                mp += ln
                if key == 0x2A:                            # summary
                    bp = 0
                    while bp < len(body):
                        assert body[bp] == 0x0A
                        bp += 1
                        vl = body[bp]
                        bp += 1
                        val = body[bp:bp + vl]
                        bp += vl
                        # Value: 1=tag 2=simple_value
                        assert val[0] == 0x0A
                        tl = val[1]
                        tag = val[2:2 + tl].decode()
                        assert val[2 + tl] == 0x15
                        (v,) = struct.unpack_from("<f", val, 3 + tl)
                        scalars[tag] = v
            else:
                raise ValueError(f"unknown field key {key:#x}")
        if scalars:
            out.append((step, scalars))
    return out
