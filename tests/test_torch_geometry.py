"""The port's matching and two-view geometry (cvt_tpu_torch/match/nn.py,
guided.py, epipolar.py, pose.py, two_view.py) held against cvt_tpu.match
on the same numpy inputs, on the CPU.

Tolerances:
- integer outputs (idx2, valid, inlier masks, configurations) equal,
  except counted near-ties: a row whose top-2 gap, ratio margin or
  max-distance margin is within 1e-5 relative (float32 products summed
  in another order), or, guided, whose candidate's gate margin is; at
  most 0.5% of the rows;
- distances, F, E, H, R and t 1e-4 after sign and scale normalisation
  (unit Frobenius norm, largest entry positive);
- the minimal solvers get `cvt_tpu`'s null-space basis (the SVD of a
  rank-deficient design returns any orthonormal basis of the null space,
  and LAPACK builds differ): solutions as sets, 1e-4 for the 7-point;
  the 5-point's solutions that satisfy its constraints in float64
  (residual < 1e-4) each have a counterpart within 2e-3 (its eigenvalues
  come from a fixed number of float32 Aberth and inverse-iteration steps
  whose rounding moves clustered roots by up to ~1e-3) and the true E
  within 1e-4 on noise-free points;
- the RANSAC cores get `cvt_tpu`'s Gumbel picks; `estimate_two_view_
  geometry` draws its own samples (a torch.Generator cannot reproduce
  jax.random), so on the reference tests' clean scenes it is held to the
  same configuration and inlier mask, and the pose within the reference
  tests' 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.match import epipolar as je
from cvt_tpu.match import guided as jg
from cvt_tpu.match import nn as jn
from cvt_tpu.match import pose as jp
from cvt_tpu.match import two_view as jt
from cvt_tpu.match.solvers import _hartley_normalize as j_hartley
from cvt_tpu_torch.match import epipolar as te
from cvt_tpu_torch.match import guided as tg
from cvt_tpu_torch.match import nn as tn
from cvt_tpu_torch.match import pose as tp
from cvt_tpu_torch.match import two_view as tt
from test_geometry_wired import _two_view_scene
from test_minimal_solvers import _synthetic_two_view

t = torch.from_numpy
TIE = 1e-5


def unit(m) -> np.ndarray:
    """m / ||m||_F with its largest-magnitude entry positive."""
    m = np.asarray(m, np.float64)
    m = m / np.linalg.norm(m)
    return m * np.sign(m.flat[np.argmax(np.abs(m))])


def assert_models(got, want, tol=1e-4):
    np.testing.assert_allclose(unit(got), unit(want), atol=tol)


# ---------------------------------------------------------------------------
# 2-NN matching
# ---------------------------------------------------------------------------

def near_tie_rows(d1, d2, valid1, valid2, ratio, max_dist, gate=None,
                  margin=None):
    """Rows of a [K1, K2] match whose outcome float32 rounding may flip:
    top-2 gap, ratio margin or max-distance margin within TIE relative
    (float64 distances), a cross-check column whose two best rows are
    that close, or (guided) a candidate at least as near as the second
    whose gate margin is within 1e-4 relative."""
    d = (np.sum(d1.astype(np.float64) ** 2, 1)[:, None]
         - 2.0 * d1.astype(np.float64) @ d2.T.astype(np.float64)
         + np.sum(d2.astype(np.float64) ** 2, 1)[None, :])
    ok = valid2[None, :] if gate is None else gate & valid2[None, :]
    d = np.where(ok, d, np.inf)
    srt = np.sort(d, 1)
    best, second = srt[:, 0], srt[:, 1]
    scale = np.maximum(np.abs(second), 1e-12)
    with np.errstate(invalid="ignore"):
        tie = np.isfinite(second) & (
            ((second - best) <= TIE * scale)
            | (np.abs(best - ratio * ratio * second) <= TIE * scale))
        if np.isfinite(max_dist):
            tie |= np.abs(best - max_dist) <= TIE * max_dist
        col = np.sort(np.where(valid1[:, None], d, np.inf), 0)
        ctie = np.isfinite(col[1]) & (
            (col[1] - col[0]) <= TIE * np.maximum(np.abs(col[1]), 1e-12))
    tie |= ctie[np.argmin(d, 1)]
    if margin is not None:
        near = np.abs(margin) <= 1e-4
        tie |= np.any(near & (np.where(valid2[None, :], d, np.inf)
                              <= second[:, None]), 1)
    return tie & valid1


def assert_match(got, want, tie):
    idx_g, ok_g = got.idx2.numpy(), got.valid.numpy()
    idx_w, ok_w = np.asarray(want.idx2), np.asarray(want.valid)
    differ = (ok_g != ok_w) | (ok_w & (idx_g != idx_w))
    assert not np.any(differ & ~tie), np.nonzero(differ & ~tie)[0]
    assert tie.mean() <= 0.005, tie.mean()
    same = ~tie & ok_w
    np.testing.assert_allclose(got.dist.numpy()[same],
                               np.asarray(want.dist)[same], rtol=1e-4,
                               atol=1e-5)


def descriptor_sets(rng, k1=300, k2=340, dim=32, n_true=200, noise=0.15):
    """d2's first n_true rows are noisy copies of d1's; the rest, and d1's
    last rows, are independent; nonnegative unit rows (SIFT-like)."""
    d1 = np.abs(rng.normal(size=(k1, dim)))
    d2 = np.abs(rng.normal(size=(k2, dim)))
    d2[:n_true] = np.abs(d1[:n_true] + noise * rng.normal(size=(n_true,
                                                                dim)))
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return d1.astype(np.float32), d2.astype(np.float32)


@pytest.mark.parametrize("ratio,cross,max_dist,pad", [
    (0.8, True, np.inf, False), (0.8, False, np.inf, False),
    (0.9, True, 0.7 ** 2 * 2.0, True), (0.6, False, 0.3, True),
    (1.0, True, np.inf, True)])
def test_match_descriptors(rng, ratio, cross, max_dist, pad):
    d1, d2 = descriptor_sets(rng)
    v1 = np.ones(len(d1), bool)
    v2 = np.ones(len(d2), bool)
    if pad:                     # padded slots, as the pipeline's buckets
        v1[250:] = False
        v2[300:] = False
        d1[250:] = 0.0
        d2[300:] = 0.0
    want = jn.match_descriptors(d1, d2, v1, v2, ratio=ratio,
                                cross_check=cross, max_dist=max_dist)
    got = tn.match_descriptors(t(d1), t(d2), t(v1), t(v2), ratio=ratio,
                               cross_check=cross, max_dist=max_dist)
    assert got.idx2.shape == (len(d1),) and got.valid.dtype == torch.bool
    assert_match(got, want, near_tie_rows(d1, d2, v1, v2, ratio, max_dist))
    assert got.valid.sum() > 50 or ratio < 0.7


def test_match_descriptors_ties_take_lower_index():
    """Exact duplicates in set 2: the top-2 keeps the lower index first, as
    lax.top_k does, and the cross-check's argmin the first row."""
    d1 = np.eye(4, 8, dtype=np.float32)
    d2 = np.concatenate([np.eye(4, 8, dtype=np.float32)] * 2)
    want = jn.match_descriptors(d1, d2, ratio=1.1)
    got = tn.match_descriptors(t(d1), t(d2), ratio=1.1)
    np.testing.assert_array_equal(got.idx2.numpy(), np.asarray(want.idx2))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.idx2.numpy(), [0, 1, 2, 3])


@pytest.mark.parametrize("model_type,pad", [
    ("fundamental", False), ("fundamental", True), ("essential", False),
    ("homography", False), ("homography", True)])
def test_match_guided(rng, model_type, pad):
    d1, d2 = descriptor_sets(rng, noise=0.3)
    k1, k2 = len(d1), len(d2)
    if model_type == "homography":
        model = np.array([[1.05, 0.02, 6.0], [-0.03, 0.97, -4.0],
                          [1e-4, -5e-5, 1.0]], np.float32)
        p1 = rng.uniform(0, 640, (k1, 2)).astype(np.float32)
        x = np.c_[p1[:200], np.ones(200)] @ model.T
        p2 = rng.uniform(0, 640, (k2, 2))
        p2[:200] = x[:, :2] / x[:, 2:]
        err = 4.0
    else:
        p1n, p2n, e, _, _ = _two_view_scene(k1, seed=3)
        focal = 500.0
        kmat = np.array([[focal, 0, 320], [0, focal, 240], [0, 0, 1]])
        model = (np.linalg.inv(kmat).T @ e @ np.linalg.inv(kmat)).astype(
            np.float32)
        p1 = (p1n * focal + [320, 240]).astype(np.float32)
        p2 = rng.uniform(0, 640, (k2, 2))
        p2[:200] = p2n[:200] * focal + [320, 240]
        err = 4.0
    p2 = (p2 + rng.normal(0, 0.3, p2.shape)).astype(np.float32)
    v1 = np.ones(k1, bool)
    v2 = np.ones(k2, bool)
    if pad:
        v1[280:] = False
        v2[320:] = False
    kw = dict(model_type=model_type, max_error=err, ratio=0.8,
              cross_check=True, max_dist=0.98)
    want = jg.match_guided(d1, d2, p1, p2, model, valid1=v1, valid2=v2,
                           **kw)
    got = tg.match_guided(t(d1), t(d2), t(p1), t(p2), t(model),
                          valid1=t(v1), valid2=t(v2), **kw)
    resid = (jg._homography_residual_matrix if model_type == "homography"
             else jg._epipolar_residual_matrix)(
        jnp.asarray(model), jnp.asarray(p1), jnp.asarray(p2))
    resid = np.asarray(resid, np.float64)
    margin = (resid - err * err) / (err * err)
    tie = near_tie_rows(d1, d2, v1, v2, 0.8, 0.98, gate=margin <= 0,
                        margin=margin)
    assert_match(got, want, tie)
    assert got.valid.sum() > 100


def test_match_guided_rejects_unknown_model():
    with pytest.raises(ValueError, match="model_type"):
        tg.match_guided(torch.zeros(4, 8), torch.zeros(4, 8),
                        torch.zeros(4, 2), torch.zeros(4, 2),
                        torch.eye(3), model_type="affine")


# ---------------------------------------------------------------------------
# minimal solvers
# ---------------------------------------------------------------------------

def test_solve_cubic_real(rng):
    cases = [(1.0, -6.0, 11.0, -6.0), (1.0, 0.0, 1.0, 0.0),
             (0.0, 1.0, 0.0, -1.0), (0.0, 0.0, 2.0, 1.0),
             (0.0, 1.0, 0.0, 1.0), (2.0, -3.0, -3.0, 2.0)]
    c = np.concatenate([np.array(cases, np.float32).T,
                        rng.normal(size=(4, 200)).astype(np.float32)], 1)
    want_r, want_v = (np.asarray(a) for a in je.solve_cubic_real(*c))
    got_r, got_v = (a.numpy() for a in te.solve_cubic_real(*map(t, c)))
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_allclose(np.where(got_v, got_r, 0),
                               np.where(want_v, want_r, 0), rtol=1e-4,
                               atol=1e-4)


def _null_basis(p1, p2, rows):
    """Rows of cvt_tpu's SVD of the epipolar design (Hartley-normalised
    for the 7-point: rows 7-8; raw for the 5-point: rows 5-8), and the
    Hartley transforms."""
    sn, t1 = j_hartley(jnp.asarray(p1))
    dn, t2 = j_hartley(jnp.asarray(p2))
    if rows == slice(5, 9):
        sn, dn = jnp.asarray(p1), jnp.asarray(p2)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    a = jnp.stack([u * x, u * y, u, v * x, v * y, v, x, y,
                   jnp.ones_like(x)], -1)
    vt = jnp.linalg.svd(a, full_matrices=True)[2]
    return (t(np.asarray(vt[..., rows, :])), t(np.asarray(t1)),
            t(np.asarray(t2)))


def _as_sets(got, got_v, want, want_v, tol):
    a = [unit(m) for m in np.asarray(want)[np.asarray(want_v)]]
    b = [unit(m) for m in np.asarray(got)[np.asarray(got_v)]]
    assert len(a) == len(b)
    for x, others in ((x, b) for x in a):
        assert min(np.abs(x - y).max() for y in others) <= tol
    for x in b:
        assert min(np.abs(x - y).max() for y in a) <= tol


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_fit_fundamental_7pt(seed):
    """On cvt_tpu's inputs (tests/test_minimal_solvers.py): fed the same
    null-space basis, the same solutions as sets; from its own SVD the
    port also recovers the true E (normalised coordinates: F == E)."""
    p1, p2, e, _, _ = _synthetic_two_view(7, seed=seed)
    want, want_v = je.fit_fundamental_7pt(p1, p2)
    null, t1, t2 = _null_basis(p1, p2, slice(7, 9))
    got, got_v = te._fundamental_from_null(null, t1, t2)
    _as_sets(got.numpy(), got_v.numpy(), want, want_v, 1e-4)
    own, own_v = te.fit_fundamental_7pt(t(p1), t(p2))
    assert min(np.abs(unit(m) - unit(e)).max()
               for m in own.numpy()[own_v.numpy()]) < 5e-3


def test_fit_fundamental_7pt_batched():
    ps = [_synthetic_two_view(7, seed=s) for s in range(4)]
    p1 = np.stack([p[0] for p in ps])
    p2 = np.stack([p[1] for p in ps])
    want, want_v = je.fit_fundamental_7pt(p1, p2)
    null, t1, t2 = _null_basis(p1, p2, slice(7, 9))
    got, got_v = te._fundamental_from_null(null, t1, t2)
    assert got.shape == (4, 3, 3, 3) and got_v.shape == (4, 3)
    for b in range(4):
        _as_sets(got[b].numpy(), got_v[b].numpy(), want[b], want_v[b], 1e-4)


def _constraint_residual(e, p1, p2) -> float:
    e = unit(e)
    x1 = np.c_[p1, np.ones(len(p1))]
    x2 = np.c_[p2, np.ones(len(p2))]
    return max(np.abs(np.einsum("ni,ij,nj->n", x2, e, x1)).max(),
               abs(np.linalg.det(e)),
               np.abs(2 * e @ e.T @ e - np.trace(e @ e.T) * e).max())


@pytest.mark.parametrize("seed", [1, 10, 11, 12])
def test_fit_essential_5pt(seed):
    """cvt_tpu's inputs (test_essential_5pt_recovers_geometry, _batched)."""
    p1, p2, e, _, _ = _synthetic_two_view(5, seed=seed)
    want, want_v = (np.asarray(a) for a in je.fit_essential_5pt(p1, p2))
    null, _, _ = _null_basis(p1, p2, slice(5, 9))
    got, got_v = (a.numpy() for a in te._essential_from_basis(null))
    assert got.shape == (10, 3, 3) and got_v.shape == (10,)
    assert got_v.sum() == want_v.sum()
    for mine, theirs, theirs_v in ((got[got_v], want, want_v),
                                   (want[want_v], got, got_v)):
        for m in mine:
            if _constraint_residual(m, p1, p2) < 1e-4:
                assert min(np.abs(unit(m) - unit(x)).max()
                           for x in theirs[theirs_v]) <= 2e-3
    for cands in (got[got_v], want[want_v]):
        assert min(np.abs(unit(m) - unit(e)).max() for m in cands) < 1e-4
    # the port's own SVD basis recovers the true E too
    own, own_v = (a.numpy() for a in te.fit_essential_5pt(t(p1), t(p2)))
    assert min(np.abs(unit(m) - unit(e)).max() for m in own[own_v]) < 1e-4


def test_fit_essential_5pt_batched():
    ps = [_synthetic_two_view(5, seed=10 + s) for s in range(3)]
    p1 = np.stack([p[0] for p in ps])
    p2 = np.stack([p[1] for p in ps])
    cands, valid = te.fit_essential_5pt(t(p1), t(p2))
    assert cands.shape == (3, 10, 3, 3)
    for b in range(3):
        c = cands[b].numpy()[valid[b].numpy()]
        assert min(np.abs(unit(m) - unit(ps[b][2])).max() for m in c) < 1e-4


# ---------------------------------------------------------------------------
# 8-point, Sampson, RANSAC cores, pose
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_fit_fundamental_8pt_and_essential_from_f(rng, weighted):
    p1, p2, _, _, _ = _two_view_scene(40, seed=6, noise=1e-3)
    src = (p1 * 500 + 320).astype(np.float32)
    dst = (p2 * 500 + 240).astype(np.float32)
    w = (rng.uniform(size=40) > 0.3).astype(np.float32) if weighted else None
    want = je.fit_fundamental_8pt(src, dst, w)
    got = te.fit_fundamental_8pt(t(src), t(dst), None if w is None
                                 else t(w))
    assert_models(got.numpy(), want)
    kmat = np.array([[500, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    assert_models(te.essential_from_fundamental(got, t(kmat), t(kmat)),
                  je.essential_from_fundamental(want, kmat, kmat))
    # batched hypotheses
    idx = rng.integers(0, 40, (16, 8))
    assert_models(te.fit_fundamental_8pt(t(src[idx]), t(dst[idx]))[3],
                  je.fit_fundamental_8pt(src[idx], dst[idx])[3])


def test_sampson_error(rng):
    f = rng.normal(size=(5, 3, 3)).astype(np.float32)
    src = rng.uniform(-2, 2, (5, 30, 2)).astype(np.float32)
    dst = rng.uniform(-2, 2, (5, 30, 2)).astype(np.float32)
    np.testing.assert_allclose(te.sampson_error(t(f), t(src), t(dst)),
                               je.sampson_error(f, src, dst), rtol=1e-4,
                               atol=1e-6)
    got = tt.epipolar_inliers(t(f[0]), t(src[0]), t(dst[0]), threshold=0.5)
    want = jt.epipolar_inliers(f[0], src[0], dst[0], threshold=0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_picks(key, valid, n_hypotheses, mn):
    """cvt_tpu's sampling: Gumbel top-mn over the valid points."""
    logits = jnp.where(valid, 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (n_hypotheses, len(valid))) + logits[None]
    return t(np.asarray(jax.lax.top_k(g, mn)[1])).long()


@pytest.mark.parametrize("method", ["8pt", "7pt"])
def test_fundamental_core_on_cvt_tpu_picks(method):
    n, n_out = 60, 15
    p1, p2, _, _, _ = _two_view_scene(n, seed=9, noise=1e-4,
                                      outliers=n_out)
    valid = np.ones(n, bool)
    valid[-3:] = False
    key = jax.random.key(1)
    want = je.ransac_fundamental(key, p1, p2, valid, threshold=0.005,
                                 n_hypotheses=64, method=method)
    picks = _jax_picks(key, valid, 64, 7 if method == "7pt" else 8)
    got = te._fundamental_core(t(p1), t(p2), t(valid), picks, 0.005,
                               method)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2]) >= 0.9 * (n - n_out - 3)
    # the 8-point hypotheses are the same fits; the 7-point's come from
    # another null-space basis, and the winner may be another hypothesis
    # of the same support
    assert_models(got[0].numpy(), want[0], 1e-4 if method == "8pt" else 1e-2)


def test_essential_core_on_cvt_tpu_picks():
    n, n_out = 60, 18
    p1, p2, e, _, _ = _two_view_scene(n, seed=4, noise=1e-4, outliers=n_out)
    key = jax.random.key(0)
    want = je.ransac_essential(key, p1, p2, threshold=0.0005,
                               n_hypotheses=48)
    picks = _jax_picks(key, np.ones(n, bool), 48, 5)
    got = te._essential_core(t(p1), t(p2), torch.ones(n, dtype=torch.bool),
                             picks, 0.0005)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])
    assert_models(got[0].numpy(), e, 0.05)


def test_essential_core_keeps_first_full_support_hypothesis():
    """At a loose threshold (4 px at f = 600 against 0.3 px of noise) every
    point is an inlier of most 5-point hypotheses. The LO refit then never
    supports strictly more, so both packages keep the first hypothesis of
    full support: the pose is that of one minimal sample, not of the refit
    over all points."""
    n, thr = 80, 4.0 / 600.0
    p1, p2, _, r, _ = _two_view_scene(n, seed=4, noise=5e-4)
    key = jax.random.key(0)
    want = je.ransac_essential(key, p1, p2, threshold=thr, n_hypotheses=48)
    picks = _jax_picks(key, np.ones(n, bool), 48, 5)
    x1, x2 = t(p1), t(p2)
    got = te._essential_core(x1, x2, torch.ones(n, dtype=torch.bool), picks,
                             thr)
    assert int(got[2]) == int(want[2]) == n and bool(got[1].all())
    cands, ok = te.fit_essential_5pt(x1[picks], x2[picks])
    flat = cands.reshape(-1, 3, 3)
    full = ((te.sampson_error(flat, x1[None], x2[None]) < thr * thr).all(-1)
            & ok.reshape(-1) & torch.isfinite(flat).reshape(-1, 9).all(-1))
    first = flat[int(torch.nonzero(full)[0])].numpy()
    np.testing.assert_array_equal(got[0].numpy(), first)
    assert_models(np.asarray(want[0]), first)
    refit = te._rank2(te.fit_fundamental_8pt(x1, x2, torch.ones(n)),
                      unit=True).numpy()
    assert np.abs(unit(refit) - unit(first)).max() > 5e-3
    got_r = tp.pose_from_essential(got[0], x1, x2)[0].numpy()
    want_r = np.asarray(jp.pose_from_essential(want[0], jnp.asarray(p1),
                                               jnp.asarray(p2))[0])
    np.testing.assert_allclose(got_r, want_r, atol=2e-3)
    np.testing.assert_allclose(got_r, r, atol=0.05)


def test_ransac_own_draws_and_errors():
    """The public RANSACs draw their own samples (other draws than
    cvt_tpu's): on its reference scenes they keep >= 90% of the true
    inliers and at most 2 outliers, as cvt_tpu's tests demand of it; an
    unknown method raises."""
    gen = torch.Generator().manual_seed(3)
    for fit, kw, n, n_out, seed in (
            (te.ransac_fundamental, dict(threshold=0.005, n_hypotheses=64,
                                         method="7pt"), 50, 12, 9),
            (te.ransac_fundamental, dict(threshold=0.005, n_hypotheses=64),
             50, 12, 9),
            (te.ransac_essential, dict(threshold=0.0005, n_hypotheses=48),
             60, 18, 4)):
        p1, p2, _, _, _ = _two_view_scene(n, seed=seed, noise=1e-4,
                                          outliers=n_out)
        _, inl, n_inl = fit(gen, t(p1), t(p2), **kw)
        inl = inl.numpy()
        assert inl[n_out:].sum() >= 0.9 * (n - n_out)
        assert inl[:n_out].sum() <= 2 and int(n_inl) == inl.sum()
    with pytest.raises(ValueError, match="6pt"):
        te.ransac_fundamental(gen, t(p1), t(p2), method="6pt")


def test_pose_from_essential():
    p1, p2, e, r, tr = _two_view_scene(80, seed=2, noise=1e-4)
    valid = np.ones(80, bool)
    valid[::7] = False
    want = jp.pose_from_essential(jnp.asarray(e), jnp.asarray(p1),
                                  jnp.asarray(p2), jnp.asarray(valid))
    got = tp.pose_from_essential(t(e), t(p1), t(p2), t(valid))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-4)
    assert int(got[2]) == int(want[2]) == valid.sum()
    np.testing.assert_allclose(got[0].numpy(), r, atol=1e-3)
    r4, t4 = tp.decompose_essential(t(e))
    jr4, jt4 = jp.decompose_essential(jnp.asarray(e))
    for i in range(4):      # the same four candidates, up to u's sign
        assert any(np.allclose(r4[i].numpy(), np.asarray(jr4[j]), atol=1e-4)
                   and np.allclose(np.abs(t4[i].numpy()),
                                   np.abs(np.asarray(jt4[j])), atol=1e-4)
                   for j in range(4))


def test_triangulate_dlt():
    p1, p2, _, r, tr = _two_view_scene(30, seed=7)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    r, tr = r.astype(np.float32), tr.astype(np.float32)
    want = jp.triangulate_dlt(eye, zero, r, tr, p1, p2)
    got = tp.triangulate_dlt(t(eye), t(zero), t(r), t(tr), t(p1), t(p2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# estimate_two_view_geometry on the reference tests' scenes
# ---------------------------------------------------------------------------

def _pose_scene():
    """tests/test_pose.py:206-234's calibrated scene."""
    rng = np.random.default_rng(8)
    n = 200
    world = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                      rng.uniform(2, 12, n)], -1).astype(np.float32)
    ang = 0.15
    r2 = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                   [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    t2 = np.array([1.2, 0.1, 0.0], np.float32)
    cam2 = world @ r2.T + t2
    k = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    uv1 = ((world[:, :2] / world[:, 2:3]) * 500.0 + [320, 240]).astype(
        np.float32)
    uv2 = ((cam2[:, :2] / cam2[:, 2:3]) * 500.0 + [320, 240]).astype(
        np.float32) + rng.normal(scale=0.3, size=(n, 2)).astype(np.float32)
    return uv1, uv2, dict(k1=k, k2=k), {}


def _planar_scene():
    """tests/test_pose.py:242-252."""
    rng = np.random.default_rng(9)
    h = np.array([[1.1, 0.05, 8], [-0.04, 0.95, -5], [1e-4, -5e-5, 1]],
                 np.float32)
    uv1 = rng.uniform(0, 640, size=(150, 2)).astype(np.float32)
    ph = np.concatenate([uv1, np.ones((150, 1), np.float32)], -1) @ h.T
    return uv1, (ph[:, :2] / ph[:, 2:3]).astype(np.float32), {}, {}


def _degenerate_scene():
    """tests/test_pose.py:255-261."""
    rng = np.random.default_rng(10)
    uv1 = rng.uniform(0, 640, size=(30, 2)).astype(np.float32)
    uv2 = rng.uniform(0, 640, size=(30, 2)).astype(np.float32)
    return uv1, uv2, {}, dict(min_inliers=25)


def _wired_calibrated_scene():
    """tests/test_geometry_wired.py:79-91."""
    p1n, p2n, _, _, _ = _two_view_scene(80, seed=2, noise=5e-5)
    kmat = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]],
                    np.float32)
    return (p1n * 600.0 + np.array([320, 240], np.float32),
            p2n * 600.0 + np.array([320, 240], np.float32),
            dict(k1=kmat, k2=kmat), dict(f_threshold=2.0, min_inliers=15))


def _general_scene():
    """An uncalibrated general scene with outliers (no intrinsics)."""
    p1n, p2n, _, _, _ = _two_view_scene(120, seed=5, noise=2e-4,
                                        outliers=20)
    return ((p1n * 500 + 320).astype(np.float32),
            (p2n * 500 + 240).astype(np.float32), {}, {})


@pytest.mark.parametrize("scene,config", [
    (_pose_scene, "calibrated"), (_planar_scene, "planar_or_panoramic"),
    (_degenerate_scene, "degenerate"), (_wired_calibrated_scene,
                                        "calibrated"),
    (_general_scene, "uncalibrated")])
def test_estimate_two_view_geometry(scene, config):
    src, dst, intr, kw = scene()
    want = jt.estimate_two_view_geometry(jax.random.key(0), src, dst,
                                         **intr, **kw)
    got = tt.estimate_two_view_geometry(torch.Generator().manual_seed(0),
                                        t(src), t(dst), **intr, **kw)
    assert got.config_name == want.config_name == config
    assert got.n_inliers == want.n_inliers
    np.testing.assert_array_equal(got.inliers, np.asarray(want.inliers))
    assert isinstance(got.inliers, np.ndarray)
    for name in ("f", "h", "e", "r", "t"):
        assert (getattr(got, name) is None) == (getattr(want, name) is None)
    if want.r is not None:
        # the winning E is a hypothesis of other draws: the pose agrees
        # within the reference tests' 0.05 (test_pose.py:236-238)
        np.testing.assert_allclose(got.r, want.r, atol=0.05)
        np.testing.assert_allclose(got.t / np.linalg.norm(got.t),
                                   want.t / np.linalg.norm(want.t),
                                   atol=0.05)
    if config == "calibrated":
        # `f` stays pixel-space: Sampson gating on pixels keeps the inliers
        inl = tt.epipolar_inliers(t(got.f), t(src), t(dst)).numpy()
        assert inl.sum() > 0.8 * len(src)
