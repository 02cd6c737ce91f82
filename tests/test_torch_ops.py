"""cvt_tpu_torch ops, io and utils held against cvt_tpu on the same numpy
inputs (JAX on the CPU, PyTorch on the CPU).

Tolerances: integer outputs (ids, assignments, tie order) bitwise;
float32 distances rtol 1e-5 (summation order differs between XLA and
PyTorch); Lloyd centroids from the same start rtol 1e-4."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.index import FlatIndex as JFlatIndex
from cvt_tpu.io import datasets as jdatasets
from cvt_tpu.ops import linalg as jlinalg
from cvt_tpu.ops import topk as jtopk
from cvt_tpu.utils import metrics as jmetrics
from cvt_tpu_torch.index import FlatIndex
from cvt_tpu_torch.io import (datasets, read_bvecs, read_fvecs, read_ivecs,
                              write_bvecs, write_fvecs, write_ivecs)
from cvt_tpu_torch.ops import linalg, topk
from cvt_tpu_torch.utils import recall_at_k

# the packages re-export the function `kmeans` over the module's name
jkmeans = importlib.import_module("cvt_tpu.ops.kmeans")
tkmeans = importlib.import_module("cvt_tpu_torch.ops.kmeans")
t = torch.from_numpy


def test_synthetic_sift_matches_reference():
    for mode in ("fresh", "perturbed"):
        a = datasets.synthetic_sift(512, 32, n_queries=16, seed=3,
                                    query_mode=mode)
        b = jdatasets.synthetic_sift(512, 32, n_queries=16, seed=3,
                                     query_mode=mode)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        datasets.synthetic_sift(8, 4, n_queries=2, query_mode="bogus")


def test_vecs_roundtrip(tmp_path, rng):
    x = rng.normal(size=(7, 5)).astype(np.float32)
    write_fvecs(str(tmp_path / "a.fvecs"), x)
    np.testing.assert_array_equal(read_fvecs(str(tmp_path / "a.fvecs")), x)
    xi = rng.integers(-9, 9, size=(4, 3)).astype(np.int32)
    write_ivecs(str(tmp_path / "a.ivecs"), xi)
    np.testing.assert_array_equal(read_ivecs(str(tmp_path / "a.ivecs")), xi)
    xb = rng.integers(0, 255, size=(4, 6)).astype(np.uint8)
    write_bvecs(str(tmp_path / "a.bvecs"), xb)
    np.testing.assert_array_equal(read_bvecs(str(tmp_path / "a.bvecs")), xb)
    assert datasets.load_sift1m(str(tmp_path / "missing")) is None


def test_recall_at_k_matches_reference(rng):
    pred = rng.integers(0, 50, size=(40, 10))
    gt = rng.integers(0, 50, size=(40, 3))
    for k, g in ((1, 1), (10, 1), (5, 3)):
        assert recall_at_k(t(pred), gt, k=k, gt_count=g) == \
            jmetrics.recall_at_k(pred, gt, k=k, gt_count=g)


def test_l2_normalize_and_pairwise(rng):
    q = rng.normal(size=(9, 16)).astype(np.float32)
    db = rng.normal(size=(33, 16)).astype(np.float32)
    np.testing.assert_allclose(linalg.l2_normalize(t(q)).numpy(),
                               np.asarray(jlinalg.l2_normalize(q)),
                               rtol=1e-5)
    for metric in ("l2", "ip"):
        np.testing.assert_allclose(
            linalg.pairwise_distance(t(q), t(db), metric).numpy(),
            np.asarray(jlinalg.pairwise_distance(q, db, metric)),
            rtol=1e-5, atol=1e-5)
    # the max(d, 0) clamp: a point against itself
    assert float(linalg.pairwise_l2sq(t(q), t(q)).diagonal().min()) >= 0.0
    with pytest.raises(ValueError):
        linalg.pairwise_distance(t(q), t(db), "cos")


def test_topk_tie_order_matches_lax_top_k(rng):
    # few distinct values: most selections cross ties
    x = rng.integers(0, 4, size=(16, 50)).astype(np.float32)
    v, i = topk.top_k_smallest(t(x), 7)
    jv, ji = jtopk.top_k_smallest(jnp.asarray(x), 7)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    v, i = topk.top_k_largest(t(x), 7)
    jv, ji = jtopk.top_k_largest(jnp.asarray(x), 7)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    ids = rng.permutation(16 * 50).reshape(16, 50).astype(np.int32)
    for largest in (False, True):
        v, i = topk.merge_topk(t(x), t(ids), 5, largest=largest)
        jv, ji = jtopk.merge_topk(jnp.asarray(x), jnp.asarray(ids), 5,
                                  largest=largest)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_chunked_topk_scan_and_flat_index(metric, rng, tmp_path):
    db = rng.normal(size=(1000, 24)).astype(np.float32)
    q = rng.normal(size=(12, 24)).astype(np.float32)
    # ragged last chunk (1000 = 3*300 + 100)
    d, i = topk.chunked_topk_scan(t(q), t(db), 8, metric, chunk=300)
    jd, ji = jtopk.chunked_topk_scan(jnp.asarray(q), jnp.asarray(db), 8,
                                     metric, chunk=300)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)
    idx = FlatIndex(24, metric, chunk=256)
    idx.add(db[:600])
    idx.add(db[600:])
    jidx = JFlatIndex(24, metric, chunk=256)
    jidx.add(db)
    d, i = idx.search(q, 5)
    jd, ji = jidx.search(q, 5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    idx.save(str(tmp_path / "f.npz"))
    d2, i2 = FlatIndex.load(str(tmp_path / "f.npz")).search(q, 5)
    np.testing.assert_array_equal(i2.numpy(), i.numpy())
    with pytest.raises(ValueError):
        idx.add(db[:, :5])
    with pytest.raises(RuntimeError):
        FlatIndex(24).search(q, 1)


@pytest.mark.parametrize("chunk", [None, 70])
def test_kmeans_assign_matches_reference(chunk, rng):
    x = rng.normal(size=(300, 8)).astype(np.float32)
    c = rng.normal(size=(20, 8)).astype(np.float32)
    a, d = tkmeans.kmeans_assign(t(x), t(c), chunk=chunk)
    ja, jd = jkmeans.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                   chunk=chunk)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)


def test_repair_empty_matches_reference(rng):
    x = rng.normal(size=(64, 4)).astype(np.float32)
    c = rng.normal(size=(10, 4)).astype(np.float32)
    counts = np.array([3, 0, 5, 0, 0, 2, 1, 0, 9, 4], np.float32)
    far = rng.permutation(64).astype(np.float32)
    far[5] = far[9]                      # a tie among the donors
    got = tkmeans._repair_empty(t(c), t(counts), t(x), t(far))
    want = jkmeans._repair_empty(jnp.asarray(c), jnp.asarray(counts),
                                 jnp.asarray(x), jnp.asarray(far))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lloyd_matches_reference_from_same_start(rng):
    x, _ = jdatasets.synthetic_sift(2048, 16, n_queries=1, seed=1)
    c0 = x[rng.permutation(2048)[:32]]
    c, a, obj = tkmeans._lloyd(t(x), t(c0), 32, 6, None)
    jc, ja, jobj = jkmeans._lloyd(jnp.asarray(x), jnp.asarray(c0), 32, 6,
                                  None)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-3)
    assert np.mean(a.numpy() == np.asarray(ja)) >= 0.999
    np.testing.assert_allclose(float(obj), float(jobj), rtol=1e-4)
    # batched over a leading dimension, as ProductQuantizer trains
    cb, _, _ = tkmeans._lloyd(t(np.stack([x, x[::-1].copy()])),
                              t(np.stack([c0, c0])), 32, 6, None)
    np.testing.assert_allclose(cb[0].numpy(), c.numpy(), rtol=1e-5)


@pytest.mark.parametrize("init", ["random", "kmeans++"])
def test_kmeans_deterministic_and_improves(init, rng):
    x = rng.normal(size=(500, 6)).astype(np.float32)
    r1 = tkmeans.kmeans(torch.Generator().manual_seed(0), x, 8, iters=5,
                        init=init)
    r2 = tkmeans.kmeans(torch.Generator().manual_seed(0), x, 8, iters=5,
                        init=init)
    np.testing.assert_array_equal(r1.centroids.numpy(),
                                  r2.centroids.numpy())
    r0 = tkmeans.kmeans(torch.Generator().manual_seed(0), x, 8, iters=0,
                        init=init)
    assert float(r1.objective) <= float(r0.objective)
    assert r1.assignments.dtype == torch.int32
    with pytest.raises(ValueError):
        tkmeans.kmeans(torch.Generator(), x, 8, init="bogus")


def test_jax_key_and_generator_both_seed(rng):
    """The port takes a torch.Generator where cvt_tpu takes a key; both
    give a valid k-means from the same data."""
    x = rng.normal(size=(400, 4)).astype(np.float32)
    jr = jkmeans.kmeans(jax.random.key(0), x, 6, iters=8)
    tr = tkmeans.kmeans(torch.Generator().manual_seed(0), x, 6, iters=8)
    assert abs(float(tr.objective) - float(jr.objective)) \
        < 0.25 * float(jr.objective)
