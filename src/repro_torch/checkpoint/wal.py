"""Append-only, crc-per-record write-ahead log.  Port of
``repro.checkpoint.wal`` (stdlib only, unchanged).

The durability primitive under a serving layer's request journal:
each record is one line, ``<crc32 hex8> <compact json>\n``, with the
checksum computed over the serialized payload bytes.  Appends are
flushed (and optionally fsynced) before the caller proceeds, so a
record either fully lands or is a torn tail the reader skips —
mirroring the per-leaf crc32 discipline of ``checkpoint.checkpointer``
at line granularity.

Reads are tolerant by design: a crash mid-append leaves at most one
torn final line, and any line that fails to parse or checksum is
counted and dropped rather than failing the replay (a journal that
cannot be read at all is worse than one missing its last record).
"""
from __future__ import annotations

import json
import os
import zlib
from pathlib import Path
from typing import Any, List, Tuple


def _encode(record: Any) -> bytes:
    payload = json.dumps(record, separators=(",", ":"),
                         sort_keys=True).encode("utf-8")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return b"%08x %s\n" % (crc, payload)


def _decode_line(line: bytes) -> Any:
    """Parse one WAL line; raises ``ValueError`` on any corruption."""
    head, _, payload = line.rstrip(b"\n").partition(b" ")
    if len(head) != 8 or not payload:
        raise ValueError("malformed WAL line")
    if int(head, 16) != (zlib.crc32(payload) & 0xFFFFFFFF):
        raise ValueError("WAL line checksum mismatch")
    return json.loads(payload.decode("utf-8"))


class WriteAheadLog:
    """One append-only log file; create parents lazily, append-then-
    flush per record.  ``fsync=True`` trades append latency for
    power-loss durability (the default covers process crashes, the
    serving drill's failure model)."""

    def __init__(self, path, *, fsync: bool = False):
        self.path = Path(path)
        self.fsync = fsync
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "ab")

    def append(self, record: Any) -> None:
        self._fh.write(_encode(record))
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def read(path) -> Tuple[List[Any], int]:
        """All valid records in append order plus the number of
        skipped (torn/corrupt) lines.  A missing file reads as empty —
        the cold-start case."""
        path = Path(path)
        if not path.exists():
            return [], 0
        records: List[Any] = []
        skipped = 0
        with open(path, "rb") as fh:
            for line in fh:
                try:
                    records.append(_decode_line(line))
                except (ValueError, json.JSONDecodeError):
                    skipped += 1
        return records, skipped
