"""Host-side binary vector formats (counterpart of `cvt_tpu.io.vecs`).

Two families:
  * TexMex fvecs/bvecs/ivecs (SIFT1M et al.): little-endian
    [int32 d][d x elem] per row.
  * cvt's id+feature record stream, as read by
    brute_force_search/src/brute_force.cpp:24-61:
    [int32 n] then per record [int32 idlen][idlen bytes id]
    [int32 d][d x float32]. Read and written in one pass by the native
    `vecs_io.cc` (`native.load_library`); the Python loops remain for a
    machine without a C++ compiler.

All readers return numpy (host) arrays; moving them to a device is the
caller's job, so large databases can be sharded before transfer.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from cvt_tpu_torch.native import NativeBuildError, load_library


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


def _vecs_io():
    """The native record stream library with its signatures, or None where
    it cannot be built (no compiler)."""
    try:
        lib = load_library("vecs_io")
    except NativeBuildError:
        return None
    i64, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.cvt_records_scan.restype = i64
    lib.cvt_records_scan.argtypes = [ctypes.c_char_p, p64, p64, p64]
    lib.cvt_records_read.restype = i64
    lib.cvt_records_read.argtypes = [ctypes.c_char_p, i64, i64, f32p,
                                     ctypes.c_char_p, p64]
    lib.cvt_records_write.restype = i64
    lib.cvt_records_write.argtypes = [ctypes.c_char_p, i64, i64, f32p,
                                      ctypes.c_char_p, p64]
    return lib


def _decode_ids(raw: bytes, offs: np.ndarray) -> list[str]:
    return [raw[offs[i]:offs[i + 1]].split(b"\x00")[0].decode("utf-8")
            for i in range(len(offs) - 1)]


def _read_cvt_records_native(lib, path: str):
    """One-pass C++ reader (native/vecs_io.cc); None when the stream
    needs the Python loop, which then reports what is wrong with it (no
    file, a truncated stream, records of different dims)."""
    i64 = ctypes.c_int64
    n, d, idb = i64(), i64(), i64()
    p = path.encode()
    if lib.cvt_records_scan(p, ctypes.byref(n), ctypes.byref(d),
                            ctypes.byref(idb)) != 0 or d.value < 0:
        return None
    feats = np.empty((n.value, d.value), "<f4")
    ids_buf = np.empty(max(idb.value, 1), np.uint8)
    offs = np.empty(n.value + 1, np.int64)
    if lib.cvt_records_read(
            p, n.value, d.value,
            feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ids_buf.ctypes.data_as(ctypes.c_char_p),
            offs.ctypes.data_as(ctypes.POINTER(i64))) != 0:
        return None
    return _decode_ids(ids_buf[:idb.value].tobytes(), offs), feats


def _read_cvt_records_py(path: str):
    ids: list[str] = []
    feats: list[np.ndarray] = []
    with open(path, "rb") as f:
        (n,) = struct.unpack("<i", f.read(4))
        for _ in range(n):
            (idlen,) = struct.unpack("<i", f.read(4))
            ids.append(f.read(idlen).split(b"\x00")[0].decode("utf-8"))
            (d,) = struct.unpack("<i", f.read(4))
            feats.append(np.frombuffer(f.read(4 * d), dtype="<f4"))
    dims = {v.shape[0] for v in feats}
    if len(dims) > 1:
        raise ValueError(f"{path}: inconsistent dims {dims}")
    return ids, (np.stack(feats) if feats
                 else np.zeros((0, 0), np.float32))


def read_cvt_records(path: str):
    """Read cvt's [n][idlen,id,d,float[d]]* stream -> (ids, feats).

    ids: list[str], feats: float32 [N, D]. Mirrors the loop in
    brute_force_search/src/brute_force.cpp:37-61. The native one-pass
    reader (native/vecs_io.cc) reads it; the pure-Python loop only where
    that library cannot be built, or for a stream of mixed dims."""
    path = str(path)
    lib = _vecs_io()
    if lib is not None:
        out = _read_cvt_records_native(lib, path)
        if out is not None:
            return out
    return _read_cvt_records_py(path)


def _write_cvt_records_py(path: str, ids, feats: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(ids)))
        for name, row in zip(ids, feats):
            raw = name.encode("utf-8")
            f.write(struct.pack("<i", len(raw)))
            f.write(raw)
            f.write(struct.pack("<i", row.shape[0]))
            f.write(row.tobytes())


def write_cvt_records(path: str, ids, feats) -> None:
    """Write the cvt id+feature record stream: ids (list of str), feats
    [N, D] float32 (numpy or a tensor, which comes to the host). The
    native streamed writer (native/vecs_io.cc `cvt_records_write`) writes
    it; the Python struct loop only where that library cannot be built.
    Both write the same bytes."""
    if hasattr(feats, "detach"):
        feats = feats.detach().cpu().numpy()
    feats = np.ascontiguousarray(feats, dtype="<f4")
    if feats.ndim != 2 or len(ids) != feats.shape[0]:
        raise ValueError(f"{len(ids)} ids for features {feats.shape}")
    n, d = feats.shape
    if n > 2 ** 31 - 1 or d > 2 ** 31 - 1:   # the format stores int32 n/d
        raise ValueError(f"record stream limits n/d to int32: {n}x{d}")
    path = str(path)
    lib = _vecs_io()
    if lib is None:
        _write_cvt_records_py(path, ids, feats)
        return
    raw = [s.encode("utf-8") for s in ids]
    ids_buf = np.frombuffer(b"".join(raw) or b"\x00", np.uint8).copy()
    offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(r) for r in raw], out=offs[1:])
    rc = lib.cvt_records_write(
        path.encode(), n, d,
        feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ids_buf.ctypes.data_as(ctypes.c_char_p),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise IOError(f"cvt_records_write failed ({rc}): {path}")
