"""The port's large-vocabulary quantizers (cvt_tpu_torch/ops/kmeans.py:
kmeans_assign_blocked, _masked_lloyd_batch, hierarchical_kmeans,
hierarchical_assign) held against cvt_tpu.ops.kmeans on the same numpy
inputs, on the CPU.

Tolerances: word ids bitwise, except a counted near-tie: a point whose
two packages' chosen words lie within 1e-4 relative of each other in
squared distance (the matrix products sum in another order); distances
rtol 1e-5 plus the expansion's cancellation error as atol; Lloyd
centroids from the same inits 1e-5 (rtol and atol, data of unit scale).
The port's own training (another generator) is held to
tests/test_ops.py's bars."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jk = importlib.import_module("cvt_tpu.ops.kmeans")
tk = importlib.import_module("cvt_tpu_torch.ops.kmeans")
t = torch.from_numpy


def _assert_ids_match_up_to_near_ties(got, want, x, words):
    """got/want [N] word ids; every mismatch must be a near-tie of the
    exact squared distances to both words (float64 on the host)."""
    got, want = np.asarray(got), np.asarray(want)
    bad = np.nonzero(got != want)[0]
    xd = x[bad].astype(np.float64)
    dg = np.sum((xd - words[got[bad]]) ** 2, -1)
    dw = np.sum((xd - words[want[bad]]) ** 2, -1)
    assert np.all(np.abs(dg - dw) <= 1e-4 * np.maximum(dw, 1e-6)), (
        bad, dg, dw)
    assert len(bad) <= max(2, len(got) // 500), len(bad)
    return len(bad)


@pytest.mark.parametrize("chunk,word_block,k", [(256, 32, 96), (512, 48, 72),
                                                (4096, 16384, 200)])
def test_kmeans_assign_blocked_matches_reference(chunk, word_block, k, rng):
    x = (rng.normal(size=(1000, 32)) * 5).astype(np.float32)
    c = (rng.normal(size=(k, 32)) * 5).astype(np.float32)
    c[7] = c[70 % k]                       # duplicate words: exact ties
    w, d = tk.kmeans_assign_blocked(t(x), t(c), chunk=chunk,
                                    word_block=word_block)
    jw, jd = jk.kmeans_assign_blocked(x, c, chunk=chunk,
                                      word_block=word_block)
    _assert_ids_match_up_to_near_ties(w.numpy(), jw, x, c)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-3)
    # the running minimum equals the flat argmin
    fw, _ = tk.kmeans_assign(t(x), t(c))
    np.testing.assert_array_equal(w.numpy(), fw.numpy())
    assert w.dtype == torch.int32


def test_masked_lloyd_batch_matches_reference(rng):
    """Same cells, masks and inits: centroids to 1e-5 and the last step's
    objective; a cell with no valid point keeps its inits, and cells with
    fewer points than k re-seed their empty clusters. The points lie on
    an integer grid, so that a one-point cluster's distance to its own
    point is exactly 0 in both packages (in general it is +-rounding, and
    the farthest-point donors then tie in another order)."""
    c, s, d, k = 5, 96, 8, 16
    xs = rng.integers(-4, 5, size=(c, s, d)).astype(np.float32)
    mask = (rng.random((c, s)) < 0.8).astype(np.float32)
    mask[2] = 0.0                          # an empty cell
    mask[3, 10:] = 0.0                     # 10 points for 16 clusters
    c0 = rng.normal(size=(c, k, d)).astype(np.float32)
    got_c, got_o = tk._masked_lloyd_batch(t(xs), t(mask), t(c0), k, 5)
    want_c, want_o = jk._masked_lloyd_batch(jnp.asarray(xs),
                                            jnp.asarray(mask),
                                            jnp.asarray(c0), k, 5)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_c[2].numpy(), c0[2])


@pytest.mark.parametrize("probes", [1, 4])
def test_hierarchical_assign_matches_reference(probes, rng):
    """A cvt_tpu-trained two-level vocabulary carried across: ids equal
    up to counted near-ties, distances rtol 1e-5, across chunks."""
    x = rng.gamma(1.5, 20.0, size=(3000, 32)).astype(np.float32)
    res = jk.hierarchical_kmeans(jax.random.key(0), x[:2048], k1=8, k2=8,
                                 coarse_iters=6, fine_iters=6,
                                 sample_per_cell=512)
    coarse, fine = np.array(res.coarse), np.array(res.fine)
    w, d = tk.hierarchical_assign(t(x), t(coarse), t(fine), probes=probes,
                                  chunk=700)
    jw, jd = jk.hierarchical_assign(x, res.coarse, res.fine, probes=probes)
    _assert_ids_match_up_to_near_ties(w.numpy(), jw, x,
                                      fine.reshape(64, 32))
    # the expansion |x|^2 - 2 x.c + |c|^2 cancels from |x|^2 ~ 3e4: about
    # 1e-7 * 3e4 * sqrt(32) absolute error in float32, so atol 0.1
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=0.1)
    assert w.dtype == torch.int32


def test_hierarchical_kmeans_agreement(rng):
    """tests/test_ops.py's bar on the port's own training: multi-probe
    assignment agrees >= 95% with the exact flat argmin, and the probed
    distance never beats the flat minimum."""
    x = rng.gamma(1.5, 20.0, size=(8192, 32)).astype(np.float32)
    res = tk.hierarchical_kmeans(torch.Generator().manual_seed(0), t(x),
                                 k1=8, k2=8, coarse_iters=8, fine_iters=8,
                                 sample_per_cell=2048)
    assert res.fine.shape == (8, 8, 32) and res.n_words == 64
    w_h, d_h = tk.hierarchical_assign(t(x[:2048]), res.coarse, res.fine,
                                      probes=4)
    w_f, d_f = tk.kmeans_assign(t(x[:2048]), res.flat_words())
    assert (w_h == w_f).float().mean() >= 0.95
    assert bool((d_h >= d_f - 1e-4 * d_f.abs() - 1e-2).all())


def test_hierarchical_kmeans_quality(rng):
    """tests/test_ops.py's bar: the 64-word hierarchical quantizer is
    within 25% of flat 64-means error on clustered data; deterministic
    for one generator seed."""
    centers = rng.normal(size=(64, 16)).astype(np.float32) * 10
    x = (centers[rng.integers(0, 64, 4096)]
         + rng.normal(size=(4096, 16)).astype(np.float32))
    flat = tk.kmeans(torch.Generator().manual_seed(1), x, 64, iters=15,
                     device="cpu")
    runs = [tk.hierarchical_kmeans(torch.Generator().manual_seed(1), x,
                                   k1=8, k2=8, coarse_iters=10,
                                   fine_iters=10, device="cpu")
            for _ in range(2)]
    assert torch.equal(runs[0].fine, runs[1].fine)
    _, d_h = tk.hierarchical_assign(x, runs[0].coarse, runs[0].fine,
                                    probes=4, device="cpu")
    assert float(d_h.mean()) <= float(flat.objective) * 1.25
    assert float(runs[0].objective) > 0
