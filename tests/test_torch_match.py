"""The port's geometric solvers and vote-and-verify
(cvt_tpu_torch/match/) held against cvt_tpu.match on the same numpy
inputs, on the CPU.

Tolerances: solver models and projections 1e-4 (rtol and atol, points of
unit to tens scale: float32 normal equations and SVDs solved by other
LAPACK calls). vote_and_verify: inliers and n_inliers bitwise, score
(an integer count) and model 1e-4. Its inputs keep every fitted seed
either empty or at >= 3 votes, or the best seed well populated: a seed
fitted from 1-2 matches is a near-singular 3x3 solve whose float32
result (finite or NaN) depends on rounding in either package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.match import solvers as js
from cvt_tpu.match import vote_verify as jv
from cvt_tpu_torch.match import solvers as ts
from cvt_tpu_torch.match import vote_and_verify

t = torch.from_numpy


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.fixture
def pairs(rng):
    """src/dst [3, 40, 2]: a similarity per batch plus noise, weights."""
    src = rng.uniform(-5, 5, (3, 40, 2)).astype(np.float32)
    th = np.array([0.1, -0.4, 1.2])
    s = np.array([1.0, 0.7, 1.5])
    rot = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                    np.stack([np.sin(th), np.cos(th)], -1)], -2) * s[:, None,
                                                                    None]
    dst = (np.einsum("bij,bnj->bni", rot, src) + np.array([2.0, -1.0])
           + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (3, 40)).astype(np.float32)
    return src, dst, w


@pytest.mark.parametrize("weighted", [False, True])
def test_affine_translation_similarity(pairs, weighted):
    src, dst, w = pairs
    tw = t(w) if weighted else None
    jw = jnp.asarray(w) if weighted else None
    for fit, app, jfit, japp in (
            (ts.fit_affine, ts.apply_affine, js.fit_affine,
             js.apply_affine),
            (ts.fit_similarity2d, ts.apply_similarity2d,
             js.fit_similarity2d, js.apply_similarity2d),
            (ts.fit_translation, ts.apply_translation, js.fit_translation,
             js.apply_translation)):
        m = fit(t(src), t(dst), tw)
        jm = jfit(jnp.asarray(src), jnp.asarray(dst), jw)
        _close(m, jm)
        _close(app(m, t(src)), japp(jm, jnp.asarray(src)))


@pytest.mark.parametrize("weighted", [False, True])
def test_homography_and_hartley(pairs, rng, weighted):
    src, _, w = pairs
    h_true = np.array([[1.1, 0.1, 0.5], [-0.05, 0.9, -0.3],
                       [0.01, -0.02, 1.0]], np.float32)
    dst = np.asarray(js.apply_homography(jnp.asarray(h_true),
                                         jnp.asarray(src)))
    dst = (dst + rng.normal(0, 1e-3, dst.shape)).astype(np.float32)
    tw = t(w) if weighted else None
    jw = jnp.asarray(w) if weighted else None
    pn, tn = ts._hartley_normalize(t(src), tw)
    jpn, jtn = js._hartley_normalize(jnp.asarray(src), jw)
    _close(pn, jpn)
    _close(tn, jtn)
    h = ts.fit_homography_dlt(t(src), t(dst), tw)
    jh = js.fit_homography_dlt(jnp.asarray(src), jnp.asarray(dst), jw)
    _close(h, jh)
    _close(ts.apply_homography(h, t(src)),
           js.apply_homography(jh, jnp.asarray(src)))


def _frames(rng, n: int, n_in: int, extent: float = 256.0):
    """n matches: n_in follow one similarity (0.5 px noise), the rest are
    random; frames (x, y, scale, angle)."""
    f1 = np.stack([rng.uniform(0, extent, n), rng.uniform(0, extent, n),
                   rng.uniform(1.5, 8, n), rng.uniform(-3, 3, n)], -1)
    th, s = 0.3, 1.2
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    f2 = f1.copy()
    f2[:, :2] = f1[:, :2] @ (s * rot).T + np.array([12.0, -7.0])
    f2[:, :2] += rng.normal(0, 0.5, (n, 2))
    f2[:, 2] *= s
    f2[:, 3] += th
    out = rng.permutation(n)[n_in:]
    f2[out, 0] = rng.uniform(0, extent, len(out))
    f2[out, 1] = rng.uniform(0, extent, len(out))
    f2[out, 3] = rng.uniform(-3, 3, len(out))
    return f1.astype(np.float32), f2.astype(np.float32)


def _assert_same(res, j):
    np.testing.assert_array_equal(res.inliers.numpy(), np.asarray(j.inliers))
    np.testing.assert_array_equal(res.n_inliers.numpy(),
                                  np.asarray(j.n_inliers))
    _close(res.score, j.score)
    _close(res.model, j.model)


def test_vote_and_verify_matches_reference_batched(rng):
    """Inlier/outlier mixes, verified in one batched call and held
    against cvt_tpu one candidate at a time; a few matches invalid."""
    cases = [_frames(rng, 120, n_in) for n_in in (90, 60, 30)]
    f1 = np.stack([c[0] for c in cases])
    f2 = np.stack([c[1] for c in cases])
    valid = rng.random((3, 120)) < 0.9
    res = vote_and_verify(t(f1), t(f2), t(valid), image_extent=256.0)
    assert res.score.shape == (3,) and res.model.shape == (3, 2, 3)
    for b in range(3):
        j = jv.vote_and_verify(f1[b], f2[b], jnp.asarray(valid[b]),
                               image_extent=256.0)
        _assert_same(type(res)(*(x[b] for x in res)), j)
        assert float(j.n_inliers) >= 20


def test_vote_and_verify_all_invalid_and_few_bins(rng):
    """An all-invalid input (every seed empty: score 0, no inlier) and a
    match set that occupies fewer than 8 finest bins (the spare seeds are
    unoccupied bins, chosen lowest bin first)."""
    f1, f2 = _frames(rng, 64, 64)
    res = vote_and_verify(t(f1), t(f2), t(np.zeros(64, bool)))
    j = jv.vote_and_verify(f1, f2, jnp.zeros(64, bool))
    _assert_same(res, j)
    assert float(res.score) == 0.0 and float(res.n_inliers) == 0.0
    f1, f2 = _frames(rng, 24, 24)
    res = vote_and_verify(t(f1), t(f2), image_extent=256.0)
    j = jv.vote_and_verify(f1, f2, image_extent=256.0)
    _assert_same(res, j)
    assert float(res.n_inliers) >= 20


def test_vote_and_verify_numpy_input_follows_device_rule(monkeypatch, rng):
    """numpy frames go to the card: without one the call raises."""
    f1, f2 = _frames(rng, 16, 16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vote_and_verify(f1, f2)
