"""The port's absolute / relative pose solvers and RANSACs
(`cvt_tpu_torch.match.pose`) held to `cvt_tpu.match.pose` on the same
seeded inputs (tests/test_pose.py's and tests/test_scene_utils.py's
scenes).

Tolerances: the closed-form quartic 1e-5; Kabsch, the DLT, Umeyama and
the linear generalized relative pose 1e-4 (float32 SVDs of two
libraries); valid masks equal; GP3P 1e-3 on the candidates both
packages mark valid; P3P 1e-3 on the candidate that recovers the true
pose (near-double quartic roots amplify float32 rounding elsewhere).
The RANSAC cores are fed `cvt_tpu`'s Gumbel picks (jax.random's draws,
which a torch.Generator cannot give): inlier masks equal, R and t 1e-4.
The public RANSACs, which draw from a torch.Generator, are held to the
true pose and inlier count by property.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.match import pose as jp
from cvt_tpu_torch.match import pose as tp
from test_pose import _rig_scene, _scene


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol)


def jax_picks(key, n_hypotheses, n, k, valid=None):
    """cvt_tpu's samples: the k largest of its Gumbel noise."""
    logits = 0.0 if valid is None else jnp.where(valid, 0.0, -jnp.inf)
    g = jax.random.gumbel(key, (n_hypotheses, n)) + logits
    return t(jax.lax.top_k(g, k)[1]).long()


def test_solve_quartic_matches_reference():
    c = np.array([[1., -10., 35., -50., 24.], [1., -7., 11., -7., 10.],
                  [1., 0., -5., 0., 4.], [2., 0.5, -3., 1., -0.2],
                  [1e-14, 1., -3., 2., 0.]], np.float32)
    want = jp.solve_quartic(*(jnp.asarray(c[:, i]) for i in range(5)))
    got = tp.solve_quartic(*(t(c[:, i]) for i in range(5)))
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    close(want[0], got[0], 1e-5)


def test_kabsch_and_similarity_match_reference():
    rng = np.random.default_rng(2)
    src = rng.normal(size=(5, 20, 3)).astype(np.float32)
    dst = rng.normal(size=(5, 20, 3)).astype(np.float32) + src
    w = rng.random((5, 20)).astype(np.float32)
    for weights in (None, w):
        want = jp.kabsch(src, dst, weights)
        got = tp.kabsch(t(src), t(dst), None if weights is None
                        else t(weights))
        for a, b in zip(want, got):
            close(a, b, 1e-4)
        want = jp.similarity_transform(src, 2.5 * dst, weights)
        got = tp.similarity_transform(t(src), t(2.5 * dst),
                                      None if weights is None
                                      else t(weights))
        for a, b in zip(want, got):
            close(a, b, 1e-4)


@pytest.mark.parametrize("seed", [3, 11, 12])
def test_p3p_matches_reference(seed):
    """Valid masks equal. Near-double quartic roots amplify float32
    rounding (the two libraries round the coefficients differently), so
    the poses are held where cvt_tpu's candidate recovers the true pose
    to 1e-3: there the port's same candidate lies within 1e-3 of it."""
    rng = np.random.default_rng(seed)
    worlds, bears, truth = [], [], []
    for _ in range(16):
        r_true, t_true, world, img = _scene(rng, n=3)
        bear = np.concatenate([img, np.ones((3, 1), np.float32)], -1)
        worlds.append(world)
        bears.append(bear / np.linalg.norm(bear, axis=-1, keepdims=True))
        truth.append((r_true, t_true))
    worlds, bears = np.stack(worlds), np.stack(bears)
    rj, tj, vj = (np.asarray(a) for a in jp.p3p(jnp.asarray(worlds),
                                                jnp.asarray(bears)))
    rt, tt, vt = tp.p3p(t(worlds), t(bears))
    np.testing.assert_array_equal(vj, vt.numpy())
    held = 0
    for i, (r_true, t_true) in enumerate(truth):
        err = [np.abs(rj[i, k] - r_true).max() + np.abs(tj[i, k]
                                                         - t_true).max()
               if vj[i, k] else np.inf for k in range(4)]
        k = int(np.argmin(err))
        if err[k] < 1e-3:
            held += 1
            np.testing.assert_allclose(rt[i, k].numpy(), rj[i, k],
                                       atol=1e-3)
            np.testing.assert_allclose(tt[i, k].numpy(), tj[i, k],
                                       atol=1e-3)
    assert held >= 8, held


def test_fit_pnp_dlt_and_project_match_reference():
    rng = np.random.default_rng(4)
    _, _, world, img = _scene(rng, n=40)
    w = (rng.random(40) < 0.7).astype(np.float32)
    for weights in (None, w):
        want = jp.fit_pnp_dlt(world, img, weights)
        got = tp.fit_pnp_dlt(t(world), t(img), None if weights is None
                             else t(weights))
        for a, b in zip(want, got):
            close(a, b, 1e-4)
    pj = jp.project(want[0], want[1], jnp.asarray(world))
    pt = tp.project(t(want[0]), t(want[1]), t(world))
    for a, b in zip(pj, pt):
        close(a, b, 1e-5)


def _pnp_outliers(seed=5):
    rng = np.random.default_rng(seed)
    r_true, t_true, world, img = _scene(rng, n=80)
    img_noisy = img.copy()
    out = rng.choice(80, 24, replace=False)
    img_noisy[out] += rng.uniform(0.1, 0.5, size=(24, 2)).astype(np.float32)
    return r_true, t_true, world, img_noisy, out


@pytest.mark.parametrize("masked", [False, True])
def test_pnp_core_on_reference_picks(masked):
    """ransac_pnp's core on cvt_tpu's samples: the same winner, LO refit
    (kept on >=) and inliers."""
    _, _, world, img, _ = _pnp_outliers()
    valid = np.ones(80, bool)
    if masked:
        valid[::7] = False
    key = jax.random.PRNGKey(0)
    rj, tj, ij, nj = jp.ransac_pnp(key, world, img, jnp.asarray(valid),
                                   threshold=0.01, n_hypotheses=64)
    picks = jax_picks(key, 64, 80, 3, jnp.asarray(valid))
    rt, tt, it, nt = tp._pnp_core(t(world), t(img), t(valid), picks, 0.01)
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    assert int(nj) == int(nt)
    close(rj, rt, 1e-4)
    close(tj, tt, 1e-4)


def test_ransac_pnp_recovers_pose():
    r_true, t_true, world, img, out = _pnp_outliers()
    r, tv, inl, n_inl = tp.ransac_pnp(torch.Generator().manual_seed(0),
                                      t(world), t(img), threshold=0.01,
                                      n_hypotheses=64)
    assert int(n_inl) >= 50
    np.testing.assert_allclose(r.numpy(), r_true, atol=5e-3)
    np.testing.assert_allclose(tv.numpy(), t_true, atol=5e-3)
    assert not inl.numpy()[out].any()


def test_gp3p_matches_reference():
    batch = [_rig_scene(3, seed=s) for s in (1, 4, 5, 6)]
    o = np.stack([b[0] for b in batch])
    d = np.stack([b[1] for b in batch])
    x = np.stack([b[2] for b in batch])
    rt, tt, okt = tp.gp3p(t(o), t(d), t(x))               # [4, 4, ...]
    for i in range(len(batch)):
        rj, tj, okj = jp.gp3p(o[i], d[i], x[i])
        np.testing.assert_array_equal(np.asarray(okj), okt[i].numpy())
        ok = np.asarray(okj)
        np.testing.assert_allclose(np.asarray(rj)[ok], rt[i].numpy()[ok],
                                   atol=1e-3)
        np.testing.assert_allclose(np.asarray(tj)[ok], tt[i].numpy()[ok],
                                   atol=1e-3)
    # the residual function on a grid, one branch
    lam = jnp.linspace(0.5, 12.0, 7)
    want = jp._gp3p_g(lam, jnp.asarray(o[0]), jnp.asarray(d[0]),
                      jnp.asarray(x[0]), 1.0, -1.0)
    got = tp._gp3p_g(t(np.asarray(lam)), t(o[0]), t(d[0]), t(x[0]),
                     1.0, -1.0)
    for a, b in zip(want, got):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def _rig_outliers():
    o, d, x, r_true, t_true = _rig_scene(60, seed=2, noise=1e-4)
    rng = np.random.default_rng(3)
    d_out = d.copy()
    out_idx = rng.choice(60, 15, replace=False)
    d_out[out_idx] = rng.normal(size=(15, 3))
    d_out /= np.linalg.norm(d_out, axis=-1, keepdims=True)
    return o, d_out.astype(np.float32), x, r_true, t_true


@pytest.mark.parametrize("min_inliers", [6, 200])
def test_gp3p_core_on_reference_picks(min_inliers):
    o, d, x, _, _ = _rig_outliers()
    key = jax.random.key(0)
    want = jp.ransac_gp3p(key, o, d, x, threshold=1e-4, n_hypotheses=256,
                          min_inliers=min_inliers)
    picks = jax_picks(key, 256, 60, 3)
    got = tp._gp3p_core(t(o), t(d), t(x), torch.ones(60, dtype=torch.bool),
                        picks, 1e-4, min_inliers)
    np.testing.assert_array_equal(np.asarray(want[2]), got[2].numpy())
    assert int(want[3]) == int(got[3])
    close(want[0], got[0], 1e-4)
    close(want[1], got[1], 1e-4)


def test_ransac_gp3p_recovers_pose():
    o, d, x, r_true, t_true = _rig_outliers()
    r, tv, inl, n_inl = tp.ransac_gp3p(torch.Generator().manual_seed(0),
                                       t(o), t(d), t(x), threshold=1e-4,
                                       n_hypotheses=256)
    assert int(n_inl) >= 40, int(n_inl)
    assert np.abs(np.trace(r.numpy().T @ r_true)) > 2.97
    assert np.linalg.norm(tv.numpy() - t_true) < 0.1


def _rig_pair(n=80, seed=5, n_out=8):
    rng = np.random.default_rng(seed)
    ang = 0.25
    r_true = np.array([[np.cos(ang), -np.sin(ang), 0],
                       [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                      np.float32)
    t_true = np.array([0.5, 0.2, -0.4], np.float32)
    x1 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    x1[:, 2] += 6.0
    cams = np.array([[0.4, 0, 0], [-0.4, 0.2, 0], [0, -0.3, 0.2]],
                    np.float32)
    o1 = cams[np.arange(n) % 3]
    o2 = cams[(np.arange(n) + 1) % 3]
    d1 = x1 - o1
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    x2 = x1 @ r_true.T + t_true
    d2 = x2 - o2
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    out = rng.choice(n, n_out, replace=False)
    d2[out] = rng.normal(size=(n_out, 3)).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    return o1, d1, o2, d2.astype(np.float32), r_true, t_true


def test_generalized_relative_pose_matches_reference():
    o1, d1, o2, d2, _, _ = _rig_pair(n_out=0)
    want = jp.fit_generalized_relative_pose(o1, d1, o2, d2)
    got = tp.fit_generalized_relative_pose(t(o1), t(d1), t(o2), t(d2))
    for a, b in zip(want, got):
        close(a, b, 1e-4)
    # batched over samples, and the residual
    idx = np.stack([np.arange(20) + 3 * i for i in range(4)])
    want = jp.fit_generalized_relative_pose(o1[idx], d1[idx], o2[idx],
                                            d2[idx])
    got = tp.fit_generalized_relative_pose(t(o1[idx]), t(d1[idx]),
                                           t(o2[idx]), t(d2[idx]))
    for a, b in zip(want, got):
        close(a, b, 1e-4)
    rj = jp.generalized_epipolar_residual(want[0][0], want[1][0], o1, d1,
                                          o2, d2)
    rt = tp.generalized_epipolar_residual(t(want[0][0]), t(want[1][0]),
                                          t(o1), t(d1), t(o2), t(d2))
    close(rj, rt, 1e-6)


def test_generalized_relative_pose_core_on_reference_picks():
    o1, d1, o2, d2, _, _ = _rig_pair()
    key = jax.random.key(0)
    want = jp.ransac_generalized_relative_pose(
        key, o1, d1, o2, d2, threshold=1e-4, n_hypotheses=256,
        sample_size=24)
    picks = jax_picks(key, 256, 80, 24)
    got = tp._grp_core(t(o1), t(d1), t(o2), t(d2),
                       torch.ones(80, dtype=torch.bool), picks, 1e-4, 20)
    np.testing.assert_array_equal(np.asarray(want[2]), got[2].numpy())
    assert int(want[3]) == int(got[3])
    close(want[0], got[0], 1e-4)
    close(want[1], got[1], 1e-4)


def test_ransac_generalized_relative_pose_recovers_pose():
    o1, d1, o2, d2, r_true, t_true = _rig_pair()
    r, tv, inl, n_inl = tp.ransac_generalized_relative_pose(
        torch.Generator().manual_seed(0), t(o1), t(d1), t(o2), t(d2),
        threshold=1e-4, n_hypotheses=256, sample_size=24)
    assert int(n_inl) >= 65, int(n_inl)
    assert np.abs(np.trace(r.numpy().T @ r_true)) > 2.99
    np.testing.assert_allclose(tv.numpy(), t_true, atol=0.02)
