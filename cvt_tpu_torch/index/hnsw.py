"""HNSW graph index — ctypes binding over the native C++ core
(counterpart of `cvt_tpu.index.hnsw`).

Capability parity: the reference's hnswlib usage surface
(hnsw_sifts_retrieval/hnswlib/hnswalg.h: HierarchicalNSW ctor
M/ef_construction, addPoint, searchKnn, saveIndex/loadIndex;
brute_force_search/src/hnswlib.hpp:22-57). The graph core is
`cvt_tpu_torch/native/hnsw.cc`, a copy of `cvt_tpu`'s, built by
`native.load_library` into `cvt_tpu_torch/_build/`; saved graphs are the
same bytes in both packages.

HNSW is host-only: it has no device and no `device=` argument. It takes
numpy arrays or tensors (moved to the host) and returns numpy. On the
card the ANN engines are the flat and IVF scans; HnswIndex is the
host-side complement for latency-sensitive small indexes and for recall
parity at the reference operating point (M=32, efC=80, IP, d=128).

Insertion runs under OpenMP with dynamic scheduling and one shared level
generator (`hnsw.cc`), so a build repeats exactly only with
`num_threads=1`.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

METRIC_L2 = 0
METRIC_IP = 1
_METRICS = {"l2": METRIC_L2, "ip": METRIC_IP}
_MAGIC, _VERSION = 0x48565354, 1             # hnsw.cc's save header


def _lib():
    from cvt_tpu_torch.native import load_library
    lib = load_library("hnsw")
    if not getattr(lib, "_cvt_hnsw_ready", False):
        c = ctypes
        lib.cvt_hnsw_new.restype = c.c_void_p
        lib.cvt_hnsw_new.argtypes = [c.c_int, c.c_int, c.c_int64, c.c_int,
                                     c.c_int, c.c_uint64]
        lib.cvt_hnsw_free.restype = None
        lib.cvt_hnsw_free.argtypes = [c.c_void_p]
        lib.cvt_hnsw_size.restype = c.c_int64
        lib.cvt_hnsw_size.argtypes = [c.c_void_p]
        lib.cvt_hnsw_dim.restype = c.c_int
        lib.cvt_hnsw_dim.argtypes = [c.c_void_p]
        lib.cvt_hnsw_add.restype = c.c_int64
        lib.cvt_hnsw_add.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                     c.c_int64, c.c_int]
        lib.cvt_hnsw_search.restype = c.c_int
        lib.cvt_hnsw_search.argtypes = [c.c_void_p, c.c_void_p, c.c_int64,
                                        c.c_int, c.c_int, c.c_int,
                                        c.c_void_p, c.c_void_p]
        lib.cvt_hnsw_save.restype = c.c_int
        lib.cvt_hnsw_save.argtypes = [c.c_void_p, c.c_char_p]
        lib.cvt_hnsw_load.restype = c.c_void_p
        lib.cvt_hnsw_load.argtypes = [c.c_char_p, c.c_int64]
        lib._cvt_hnsw_ready = True
    return lib


def _host(x, dtype) -> np.ndarray:
    """A C-contiguous numpy array of `x` (a tensor comes to the host)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype))


def _saved_metric(path: str) -> str:
    """The metric recorded in a saved graph's header."""
    with open(path, "rb") as f:
        head = f.read(64)
    if len(head) < 64:
        raise IOError(f"hnsw load failed: {path}: truncated header")
    magic, version, _, metric = struct.unpack("<4q", head[:32])
    if magic != _MAGIC or version != _VERSION:
        raise IOError(f"hnsw load failed: {path}: not an HNSW graph")
    names = {v: k for k, v in _METRICS.items()}
    if metric not in names:
        raise IOError(f"hnsw load failed: {path}: unknown metric {metric}")
    return names[metric]


class HnswIndex:
    """Layered proximity-graph ANN index (host-side, native core)."""

    def __init__(self, dim: int, *, metric: str = "l2",
                 capacity: int = 1 << 20, m: int = 32,
                 ef_construction: int = 80, seed: int = 0,
                 _handle=None):
        if metric not in _METRICS:
            raise ValueError(f"unknown metric {metric!r}")
        self._lib = _lib()
        self.dim = int(dim)
        self.metric = metric
        if _handle is not None:
            self._h = _handle
            return
        self._h = self._lib.cvt_hnsw_new(
            self.dim, _METRICS[metric], int(capacity), int(m),
            int(ef_construction), int(seed))
        if not self._h:
            raise MemoryError("hnsw allocation failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.cvt_hnsw_free(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.cvt_hnsw_size(self._h))

    def add(self, vectors, labels=None, *, num_threads: int = 0) -> int:
        """Add [N, dim] float32 vectors (numpy or a tensor); labels default
        to running ids. num_threads 0 takes OpenMP's default; only 1 builds
        the same graph on every run."""
        x = _host(vectors, np.float32)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"vectors {x.shape}, index dim {self.dim}")
        n = x.shape[0]
        if labels is None:
            start = len(self)
            labels = np.arange(start, start + n, dtype=np.int64)
        lab = _host(labels, np.int64)
        if lab.shape != (n,):
            raise ValueError(f"labels {lab.shape} for {n} vectors")
        added = self._lib.cvt_hnsw_add(
            self._h, x.ctypes.data, lab.ctypes.data, n, num_threads)
        if added < 0:
            raise RuntimeError("hnsw add failed (capacity exceeded?)")
        return int(added)

    def search(self, queries, k: int = 10, *, ef: int = 50,
               num_threads: int = 0):
        """[B, dim] queries -> (dists [B, k] f32, labels [B, k] i64), numpy.

        Unfilled slots (index smaller than k) hold dist=+inf, label=-1.
        """
        q = _host(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries {q.shape}, index dim {self.dim}")
        b = q.shape[0]
        out_l = np.empty((b, k), np.int64)
        out_d = np.empty((b, k), np.float32)
        rc = self._lib.cvt_hnsw_search(
            self._h, q.ctypes.data, b, k, max(ef, k), num_threads,
            out_l.ctypes.data, out_d.ctypes.data)
        if rc != 0:
            raise RuntimeError("hnsw search failed")
        return out_d, out_l

    def save(self, path: str) -> None:
        if self._lib.cvt_hnsw_save(self._h, str(path).encode()) != 0:
            raise IOError(f"hnsw save failed: {path}")

    @classmethod
    def load(cls, path: str, *, metric: str | None = None,
             capacity: int = 0) -> "HnswIndex":
        """A saved graph (either package's). `metric` defaults to the one
        the file records; a different one raises. `capacity` grows the
        graph's room (at least its size)."""
        path = str(path)
        saved = _saved_metric(path)
        if metric is not None and metric != saved:
            raise ValueError(f"{path} holds a {saved!r} graph, not "
                             f"{metric!r}")
        lib = _lib()
        h = lib.cvt_hnsw_load(path.encode(), int(capacity))
        if not h:
            raise IOError(f"hnsw load failed: {path}")
        dim = lib.cvt_hnsw_dim(h)
        return cls(dim, metric=saved, _handle=h)
