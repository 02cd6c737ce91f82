"""Host-side TexMex vector formats (fvecs/bvecs/ivecs).

Little-endian [int32 d][d x elem] per row. All readers return numpy
(host) arrays; moving them to a device is the caller's job.
"""

from __future__ import annotations

import numpy as np


def _read_vecs(path: str, dtype, elem_size: int) -> np.ndarray:
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0:
        return np.zeros((0, 0), dtype=dtype)
    d = int(np.frombuffer(raw[:4], dtype="<i4")[0])
    row_bytes = 4 + d * elem_size
    if raw.size % row_bytes != 0:
        raise ValueError(
            f"{path}: size {raw.size} not a multiple of row size {row_bytes}")
    n = raw.size // row_bytes
    rows = raw.reshape(n, row_bytes)
    dims = rows[:, :4].copy().view("<i4")[:, 0]
    if not np.all(dims == d):
        raise ValueError(f"{path}: inconsistent dims")
    return rows[:, 4:].copy().view(dtype).reshape(n, d)


def read_fvecs(path: str) -> np.ndarray:
    """Read .fvecs -> float32 [N, D]."""
    return _read_vecs(path, "<f4", 4)


def read_bvecs(path: str) -> np.ndarray:
    """Read .bvecs -> uint8 [N, D]."""
    return _read_vecs(path, np.uint8, 1)


def read_ivecs(path: str) -> np.ndarray:
    """Read .ivecs -> int32 [N, D] (ground-truth neighbor lists)."""
    return _read_vecs(path, "<i4", 4)


def _write_vecs(path: str, x: np.ndarray, dtype) -> None:
    x = np.ascontiguousarray(x.astype(dtype))
    n, d = x.shape
    with open(path, "wb") as f:
        dim_col = np.full((n, 1), d, dtype="<i4")
        interleaved = np.concatenate(
            [dim_col.view(np.uint8).reshape(n, 4),
             x.view(np.uint8).reshape(n, -1)], axis=1)
        interleaved.tofile(f)


def write_fvecs(path: str, x: np.ndarray) -> None:
    _write_vecs(path, x, "<f4")


def write_ivecs(path: str, x: np.ndarray) -> None:
    _write_vecs(path, x, "<i4")


def write_bvecs(path: str, x: np.ndarray) -> None:
    _write_vecs(path, x, np.uint8)
