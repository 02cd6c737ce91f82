"""Packed record store for training data: the LMDB-pipeline analogue.

Reference: pytorch_arcloss/image2lmdb/{txt2lmdb.py,main.py,
train_data_flow.py} — converts an ImageFolder txt listing into LMDB and
feeds it to a DataLoader. A copy of `cvt_tpu.train.records` (numpy only,
the same bytes on disk, so each package reads the other's files): a
single append-only record file with an offset table (one fseek+fread per
record, no LMDB dependency), plus a batched, seeded-shuffle iterator that
yields fixed-shape numpy batches, which the caller moves to its device.

Format (little-endian):
  header : magic 'CVTR' | u32 version | u64 num_records
  body   : concatenated payload bytes
  footer : u64 offsets[num+1] | i32 labels[num]
  tail   : u64 footer_start
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterator

import numpy as np

_MAGIC = b"CVTR"
_VERSION = 1


class RecordWriter:
    """Append (payload bytes, int label) records; finalize on close."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._f = open(self.path, "wb")
        self._f.write(_MAGIC + struct.pack("<IQ", _VERSION, 0))
        self._offsets = [self._f.tell()]
        self._labels: list[int] = []

    def append(self, payload: bytes, label: int) -> None:
        self._f.write(payload)
        self._offsets.append(self._f.tell())
        self._labels.append(int(label))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        if self._f.closed:
            return
        footer_start = self._f.tell()
        n = len(self._labels)
        self._f.write(np.asarray(self._offsets, dtype="<u8").tobytes())
        self._f.write(np.asarray(self._labels, dtype="<i4").tobytes())
        self._f.write(struct.pack("<Q", footer_start))
        # patch num_records in the header
        self._f.seek(len(_MAGIC) + 4)
        self._f.write(struct.pack("<Q", n))
        self._f.close()


@dataclass
class RecordDataset:
    """Random-access reader over a RecordWriter file.

    `decode` maps payload bytes -> a fixed-shape float array (e.g. a
    decoded image or a stored feature vector); batches stack these.
    """

    path: Path
    decode: Callable[[bytes], np.ndarray] = field(
        default=lambda b: np.frombuffer(b, dtype=np.float32))

    def __post_init__(self):
        self.path = Path(self.path)
        with open(self.path, "rb") as f:
            magic = f.read(4)
            if magic != _MAGIC:
                raise ValueError(f"{self.path}: not a CVTR record file")
            version, n = struct.unpack("<IQ", f.read(12))
            if version != _VERSION:
                raise ValueError(f"unsupported record version {version}")
            f.seek(-8, 2)
            (footer_start,) = struct.unpack("<Q", f.read(8))
            f.seek(footer_start)
            self.offsets = np.frombuffer(
                f.read(8 * (n + 1)), dtype="<u8").astype(np.int64)
            self.labels = np.frombuffer(
                f.read(4 * n), dtype="<i4").astype(np.int32)
        self._f = open(self.path, "rb")

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def num_classes(self) -> int:
        return int(self.labels.max()) + 1 if len(self.labels) else 0

    def payload(self, i: int) -> bytes:
        self._f.seek(self.offsets[i])
        return self._f.read(int(self.offsets[i + 1] - self.offsets[i]))

    def __getitem__(self, i: int) -> tuple[np.ndarray, int]:
        return self.decode(self.payload(i)), int(self.labels[i])

    def batches(self, batch_size: int, *, seed: int = 0, epochs: int = 1,
                drop_remainder: bool = True,
                ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Seeded-shuffle epoch iterator of (x [B,...], y [B]) batches.

        drop_remainder keeps every batch the same shape.
        """
        rng = np.random.default_rng(seed)
        n = len(self)
        for _ in range(epochs):
            order = rng.permutation(n)
            stop = n - n % batch_size if drop_remainder else n
            for s in range(0, stop, batch_size):
                idx = order[s:s + batch_size]
                xs = np.stack([self.decode(self.payload(i)) for i in idx])
                yield xs, self.labels[idx]

    @staticmethod
    def from_arrays(path: str | Path, x: np.ndarray,
                    y: np.ndarray) -> "RecordDataset":
        """Pack float32 feature rows + labels into a record file."""
        x = np.ascontiguousarray(x, dtype=np.float32)
        with RecordWriter(path) as w:
            for row, label in zip(x, y):
                w.append(row.tobytes(), int(label))
        return RecordDataset(path)
