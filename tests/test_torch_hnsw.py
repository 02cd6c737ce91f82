"""cvt_tpu_torch.index.hnsw and io.vecs' record stream held against
cvt_tpu's on the CPU.

Both packages build the same `hnsw.cc` (each into its own place). With
`num_threads=1` insertion is sequential and the level draws come from one
seeded generator, so a build repeats: ids and distances bitwise equal to
cvt_tpu's, saved graphs byte-equal. With OpenMP's default threads the
insertion order is dynamic (`hnsw.cc`'s schedule(dynamic)), so those
builds are held to the reference's recall bars instead
(tests/test_hnsw.py: top-1 >= 0.95 at ef 100 / 80). Record streams:
byte-equal files and equal arrays both ways, on the native path and on
the Python loop.
"""

import numpy as np
import pytest
import torch

from cvt_tpu.index.hnsw import HnswIndex as JHnsw
from cvt_tpu.io import vecs as JV
from cvt_tpu_torch.index import HnswIndex
from cvt_tpu_torch.io import read_cvt_records, write_cvt_records
from cvt_tpu_torch.io import vecs as TV


@pytest.fixture(scope="module")
def small_db():
    rng = np.random.default_rng(7)
    base = rng.normal(size=(2000, 32)).astype(np.float32)
    queries = rng.normal(size=(50, 32)).astype(np.float32)
    return base, queries


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _build(cls, base, metric, **kw):
    idx = cls(32, metric=metric, capacity=len(base), m=16,
              ef_construction=100, seed=5)
    idx.add(base, num_threads=1, **kw)
    return idx


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_single_thread_build_equals_reference(tmp_path, small_db, metric):
    base, queries = small_db
    if metric == "ip":
        base, queries = _unit(base), _unit(queries)
    port, ref = (_build(c, base, metric) for c in (HnswIndex, JHnsw))
    again = _build(HnswIndex, base, metric)
    d, i = port.search(queries, k=10, ef=100, num_threads=1)
    dj, ij = ref.search(queries, k=10, ef=100, num_threads=1)
    np.testing.assert_array_equal(i, ij)
    np.testing.assert_array_equal(d, dj)
    np.testing.assert_array_equal(again.search(queries, k=10, ef=100)[1], i)
    paths = [tmp_path / n for n in ("port.hnsw", "ref.hnsw", "again.hnsw")]
    for idx, p in zip((port, ref, again), paths):
        idx.save(str(p))
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert paths[0].read_bytes() == paths[2].read_bytes()


def test_recall_at_reference_bars(small_db):
    """OpenMP's default threads: tests/test_hnsw.py's bars."""
    base, queries = small_db
    idx = HnswIndex(32, metric="l2", capacity=len(base), m=16,
                    ef_construction=100)
    assert idx.add(base) == len(base) and len(idx) == len(base)
    dists, labels = idx.search(queries, k=10, ef=100)
    gt = np.argsort(((queries[:, None] - base[None]) ** 2).sum(-1), 1)
    assert (labels[:, 0] == gt[:, 0]).mean() >= 0.95
    assert np.all(np.diff(dists, axis=1) >= -1e-4)
    d0 = ((queries - base[labels[:, 0]]) ** 2).sum(-1)
    np.testing.assert_allclose(dists[:, 0], d0, rtol=1e-4)
    bn, qn = _unit(base), _unit(queries)
    ip = HnswIndex(32, metric="ip", capacity=len(bn), m=16,
                   ef_construction=100)
    ip.add(torch.from_numpy(bn))                 # a tensor comes to the host
    _, lab = ip.search(torch.from_numpy(qn), k=5, ef=80)
    assert (lab[:, 0] == np.argmax(qn @ bn.T, axis=1)).mean() >= 0.95


def test_save_load_across_packages(tmp_path, small_db):
    base, queries = small_db
    labels = np.arange(1000, 1000 + len(base))
    for metric in ("l2", "ip"):
        port = HnswIndex(32, metric=metric, capacity=len(base), m=8,
                         ef_construction=60, seed=3)
        port.add(base, labels=labels)
        ref = JHnsw(32, metric=metric, capacity=len(base), m=8,
                    ef_construction=60, seed=3)
        ref.add(base, labels=labels)
        pp, pr = str(tmp_path / f"p_{metric}"), str(tmp_path / f"r_{metric}")
        port.save(pp)
        ref.save(pr)
        for saved, built in ((pp, port), (pr, ref)):
            want = built.search(queries, k=5, ef=60)
            for loaded in (HnswIndex.load(saved),
                           JHnsw.load(saved, metric=metric)):
                assert len(loaded) == len(base) and loaded.dim == 32
                assert loaded.metric == metric
                got = loaded.search(queries, k=5, ef=60)
                np.testing.assert_array_equal(got[1], want[1])
                np.testing.assert_array_equal(got[0], want[0])
                assert got[1].min() >= 1000       # custom labels kept
        with pytest.raises(ValueError):
            HnswIndex.load(pp, metric="ip" if metric == "l2" else "l2")
    # a loaded graph grows with capacity
    grown = HnswIndex.load(pp, capacity=len(base) + 10)
    assert grown.add(base[:10]) == 10 and len(grown) == len(base) + 10


def test_padded_slots_and_custom_labels(small_db):
    base, _ = small_db
    idx = HnswIndex(32, capacity=100, m=8, ef_construction=40)
    idx.add(base[:3], labels=np.array([7, 8, 9]))
    d, lab = idx.search(base[0], k=10, ef=20)
    assert lab.shape == (1, 10) and lab.dtype == np.int64
    assert lab[0, 0] == 7 and d[0, 0] < 1e-5      # self-query hits itself
    assert sorted(lab[0, :3]) == [7, 8, 9]
    assert np.all(lab[0, 3:] == -1)               # padded slots
    assert np.all(np.isinf(d[0, 3:]))
    idx.add(base[3:5])                            # running ids continue
    assert idx.search(base[4], k=1)[1][0, 0] == 4
    with pytest.raises(ValueError):
        idx.add(base[:2, :16])
    with pytest.raises(ValueError):
        idx.search(base[:2, :16])
    with pytest.raises(RuntimeError):
        idx.add(base[:200])                       # past capacity


@pytest.fixture(params=["native", "python"])
def stream_path(request, monkeypatch):
    """The port's record stream on its native library or, with that
    library unavailable, on the Python loop."""
    if request.param == "python":
        monkeypatch.setattr(TV, "_vecs_io", lambda: None)
    else:
        assert TV._vecs_io() is not None
    return request.param


@pytest.mark.parametrize("n", [0, 1, 37])
def test_cvt_records_both_ways(tmp_path, stream_path, n):
    rng = np.random.default_rng(n)
    feats = rng.normal(size=(n, 24)).astype(np.float32)
    ids = [f"img_{i:04d}.jpg" for i in range(n)]
    if n > 2:
        ids[1], ids[2] = "", "ñandú/π.png"          # empty and UTF-8 ids
    tp, jp = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    write_cvt_records(tp, ids, torch.from_numpy(feats) if n else feats)
    JV.write_cvt_records(jp, ids, feats)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    for path in (tp, jp):
        for read in (read_cvt_records, JV.read_cvt_records):
            got_ids, got = read(path)
            assert got_ids == ids
            assert got.dtype == np.float32
            if n:
                np.testing.assert_array_equal(got, feats)
            else:
                assert got.size == 0


def test_cvt_records_mixed_dims_raise(tmp_path, stream_path):
    path = str(tmp_path / "mixed.bin")
    JV.write_cvt_records(path, ["a"], np.zeros((1, 3), np.float32))
    with open(path, "r+b") as f:                   # append a 2-d record
        f.write(np.int32(2).tobytes())
        f.seek(0, 2)
        f.write(np.int32(1).tobytes() + b"b" + np.int32(2).tobytes()
                + np.zeros(2, np.float32).tobytes())
    with pytest.raises(ValueError, match="inconsistent dims"):
        read_cvt_records(path)
    with pytest.raises(ValueError):
        write_cvt_records(path, ["a", "b"], np.zeros((1, 3), np.float32))


def test_native_build_falls_back_to_gxx(tmp_path, monkeypatch):
    """A $CXX that cannot build (one set for other builds, without
    OpenMP's files, say) gives way to g++; with neither, the error names
    every attempt."""
    from cvt_tpu_torch import native
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")             # exists, always fails
    path = native.build("vecs_io")
    assert path == str(tmp_path / "libvecs_io.so")
    monkeypatch.setattr(native.shutil, "which",
                        lambda c: "/bin/false" if c == "false" else None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "none"))
    with pytest.raises(native.NativeBuildError, match="false -O3"):
        native.build("hnsw")
