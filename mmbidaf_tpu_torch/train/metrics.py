"""Metrics utilities: running means, JSONL logging, tensorboard scalars,
ROUGE evaluation — the port's copy of ``mmbidaf_tpu.train.metrics``.

Replaces the reference's ``AverageMeter`` + tensorboard scalars (SURVEY.md
§6) with the same scalar names, logged as JSONL and as a tensorboard event
file that the port writes itself (no tensorflow or tensorboard needed).
ROUGE stays host-side, as in the reference eval path (SURVEY §4.3).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import IO, Mapping


class AverageMeter:
    """Running mean, same contract as the reference's util.AverageMeter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, num_samples: int = 1):
        self.count += num_samples
        self.sum += val * num_samples
        self.avg = self.sum / self.count


class JsonlLogger:
    def __init__(self, path: str):
        self._f: IO = open(path, "a")

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def _crc32c_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of TFRecord framing."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def encode_event(wall_time: float, step: int = 0, file_version: str | None = None,
                 scalars: Mapping[str, float] | None = None) -> bytes:
    """A ``tensorflow.Event`` protobuf: wall_time (1, double), step (2,
    int64), file_version (3) or a ``Summary`` (5) of ``simple_value``
    scalars (``Summary.Value``: tag 1, simple_value 2, a float) — the
    legacy scalar form tensorboardX writes and tensorboard reads."""
    out = b"\x09" + struct.pack("<d", wall_time) + b"\x10" + _varint(step & (2**64 - 1))
    if file_version is not None:
        out += _field(3, file_version.encode())
    if scalars:
        values = b"".join(_field(1, _field(1, tag.encode()) + b"\x15" + struct.pack("<f", v))
                          for tag, v in scalars.items())
        out += _field(5, values)
    return out


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC32C, the data, its masked CRC32C."""
    head = struct.pack("<Q", len(data))
    return (head + struct.pack("<I", masked_crc32c(head)) + data
            + struct.pack("<I", masked_crc32c(data)))


class TensorboardWriter:
    """Tensorboard scalars (the reference logs loss/ROUGE/LR curves to
    tensorboardX) in an event file under ``log_dir``, written by the port
    itself: TFRecord framing with masked CRC32C around hand-encoded
    ``Event`` protobufs, ``file_version`` first, flushed after every
    ``log``. It needs neither tensorflow nor tensorboard, and it has no
    quiet no-op: a directory or file it cannot write raises."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(now)}.{socket.gethostname()}.{os.getpid()}")
        self._f: IO = open(self.path, "ab")
        self._write(encode_event(now, file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._f.write(tfrecord(event))
        self._f.flush()

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        self._write(encode_event(time.time(), step,
                                 scalars={k: float(v) for k, v in scalars.items()}))

    def close(self) -> None:
        self._f.close()


def _fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message's fields."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            val, pos = buf[pos:pos + n], pos + n
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield num, wire, val


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, pos


def read_tensorboard_scalars(path: str) -> tuple[str, list[tuple[str, int, float]]]:
    """Read an event file of ``simple_value`` scalars back: its
    ``file_version`` and every (tag, step, value) in file order. Raises
    ``ValueError`` on a record whose length or data CRC does not match."""
    with open(path, "rb") as f:
        data = f.read()
    pos, version, out = 0, "", []
    while pos < len(data):
        head = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", head)
        (head_crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        body = data[pos + 12:pos + 12 + n]
        (body_crc,) = struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])
        if head_crc != masked_crc32c(head) or body_crc != masked_crc32c(body):
            raise ValueError(f"{path}: bad CRC in the record at byte {pos}")
        pos += 16 + n
        step = 0
        for num, _, val in _fields(body):
            if num == 2:
                step = val
            elif num == 3:
                version = val.decode()
            elif num == 5:
                for vnum, _, value in _fields(val):
                    if vnum != 1:
                        continue
                    tag, x = "", None
                    for fnum, _, fval in _fields(value):
                        if fnum == 1:
                            tag = fval.decode()
                        elif fnum == 2:
                            (x,) = struct.unpack("<f", fval)
                    out.append((tag, step, x))
    return version, out


def rouge_scores(summary: str, reference: str) -> dict[str, float]:
    """ROUGE-1/2/L F-measure, host-side like the reference: the JAX
    package's ``rouge_score`` scorer (Porter-stemmed tokens), computed by the
    port's own ``train/rouge.py``."""
    from mmbidaf_tpu_torch.train.rouge import rouge_f

    return rouge_f(summary, reference)


def summary_from_picks(picks, sentences: list[str]) -> str:
    """Assemble the extractive summary: ordered selected-sentence subset."""
    seen = []
    for i in picks:
        i = int(i)
        if 0 <= i < len(sentences) and i not in seen:
            seen.append(i)
    return " ".join(sentences[i] for i in sorted(seen))


def batch_rouge(
    picks, sentences_list: list[list[str]], golds: list[str | None]
) -> tuple[dict[str, float], int]:
    """Average ROUGE over a batch of decoded sentence-index picks.

    ``picks[b]`` are the decode-step indices for example b,
    ``sentences_list[b]`` its REAL transcript sentences, ``golds[b]`` its
    gold summary text (examples with no gold are skipped). Returns
    (mean scores, number of scored examples). This is the reference's eval
    metric (SURVEY.md §4.3): the hypothesis is assembled from on-disk
    transcript text, not fabricated strings.
    """
    agg = {"ROUGE-1": 0.0, "ROUGE-2": 0.0, "ROUGE-L": 0.0}
    n = 0
    for b in range(min(len(sentences_list), len(golds))):
        if golds[b] is None or not sentences_list[b]:
            continue
        hyp = summary_from_picks(picks[b], sentences_list[b])
        for k, v in rouge_scores(hyp, golds[b]).items():
            agg[k] += v
        n += 1
    return {k: v / max(n, 1) for k, v in agg.items()}, n

