"""Dependency-free TensorBoard scalar writer, the port's copy of
``nbasr_tpu/utils/tbwriter.py``.

The reference logs scalars to TensorBoard every 10 train batches and per
epoch (``training/tf/callbacks/tensorboard.py:16-28``).  Neither package
depends on TF or tensorboard, so the event-file format (TFRecord framing
with masked CRC32C + a hand-encoded ``Event`` protobuf) is implemented
directly — ~100 lines, no protobuf/tensorboard import, readable by any
standard TensorBoard.

Wire format per record::

    uint64 length | uint32 masked_crc32c(length) | bytes data
                  | uint32 masked_crc32c(data)

``Event`` proto fields used: wall_time(1, double), step(2, int64),
file_version(3, string), summary(5, message); ``Summary.Value``:
tag(1, string), simple_value(2, float).
"""

import os
import socket
import struct
import time

__all__ = ['SummaryWriter']

_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78  # CRC-32C (Castagnoli), reflected
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def _crc32c(data):
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data):
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n):
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        out.append(bits | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num, wire, payload):
    return _varint((num << 3) | wire) + payload


def _f_double(num, v):
    return _field(num, 1, struct.pack('<d', v))


def _f_float(num, v):
    return _field(num, 5, struct.pack('<f', v))


def _f_varint(num, v):
    return _field(num, 0, _varint(v))


def _f_bytes(num, b):
    if isinstance(b, str):
        b = b.encode('utf-8')
    return _field(num, 2, _varint(len(b)) + b)


def _event(wall_time, step=None, file_version=None, summary=None):
    msg = _f_double(1, wall_time)
    if step is not None:
        msg += _f_varint(2, step)
    if file_version is not None:
        msg += _f_bytes(3, file_version)
    if summary is not None:
        msg += _f_bytes(5, summary)
    return msg


def _scalar_summary(tag, value):
    val = _f_bytes(1, tag) + _f_float(2, float(value))
    return _f_bytes(1, val)  # Summary.value (repeated field 1)


class SummaryWriter:
    """Append-only scalar event writer, TensorBoard-compatible.

    >>> w = SummaryWriter(log_dir)
    >>> w.scalar('epoch_ctc_loss', 2.31, step=epoch)
    >>> w.flush()
    """

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname()
        fname = f'events.out.tfevents.{int(time.time())}.{host}.{os.getpid()}'
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, 'ab')
        self._write(_event(time.time(), file_version='brain.Event:2'))

    def _write(self, record):
        header = struct.pack('<Q', len(record))
        self._f.write(header)
        self._f.write(struct.pack('<I', _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack('<I', _masked_crc(record)))

    def scalar(self, tag, value, step):
        self._write(_event(time.time(), step=int(step),
                           summary=_scalar_summary(tag, value)))

    def scalars(self, values, step):
        for tag, value in values.items():
            self.scalar(tag, value, step)

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
