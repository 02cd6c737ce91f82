"""The reconstruction slice of the port (`cvt_tpu_torch.match.cameras`,
`bundle`, `reconstruction`, `scene_graph_utils`, `lad`, `gps`,
`convert.ba_problem_from_numpy`) held to `cvt_tpu` on the same seeded
inputs (the scenes of tests/test_pose.py, test_bundle.py,
test_reconstruction.py, test_scene_utils.py, test_optim_extras.py and
test_cli_admin.py), on the CPU.

Tolerances:
- cameras: world_to_image 1e-4 px (equal in practice), image_to_world
  1e-6 (normalized; 10 Newton steps, the 2x2 solve by Cramer's rule
  where cvt_tpu takes LU), round trips 1e-4 as the reference test;
- rodrigues 1e-6, rotation_to_rvec 1e-5;
- bundle_adjust: one LM step of 5 CG steps (the blocks' J v / J^T u
  against jvp / vjp) poses and points 1e-5, cost rtol 1e-5; 20 steps
  cost rtol 1e-3, and with both gauge poses fixed (n_fixed_poses 2, or
  all) points 5e-3 and poses 5e-4 (float32 LM trajectories on a
  0.3-unit baseline); Reconstruction.bundle_adjust on an 8-camera scene
  cost rtol 1e-4, points 2e-3, poses 1e-3;
- triangulate_tracks 1e-4 (a float64 4x4 Gram SVD where cvt_tpu takes the
  float32 SVD of [T, 2S, 4]), cheirality masks equal; reprojection
  errors 1e-6;
- build_tracks: the same tracks in the same order, bitwise;
- Reconstruction: the same point ids, tracks and image sets; the points
  removed by filter_points equal at a limit no mean lies within 1e-6
  relative of (asserted);
- gps 1e-9 (the same numpy code); scene utilities equal;
- solve_lad 1e-4, iterations and converged equal on problems whose stop
  test is not decided by float32 rounding (the ADMM dual residual of the
  outlier problem at tolerance 1e-4 crosses its bound in float32 noise:
  the two packages stop one iteration apart there, so that problem runs
  at tolerance 1e-3).
"""

import importlib
import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.match import bundle as jb
from cvt_tpu.match import cameras as jc
from cvt_tpu.match import gps as jgps
from cvt_tpu.match import lad as jlad
from cvt_tpu.match import reconstruction as jr
from cvt_tpu.match import scene_graph_utils as js
from cvt_tpu_torch import convert
from cvt_tpu_torch.match import bundle as tb
from cvt_tpu_torch.match import cameras as tc
from cvt_tpu_torch.match import gps as tgps
from cvt_tpu_torch.match import lad as tlad
from cvt_tpu_torch.match import reconstruction as tr
from cvt_tpu_torch.match import scene_graph_utils as ts
from test_bundle import _synthetic_ba
from test_cli_admin import _toy_reconstruction
from test_reconstruction import _synthetic_scene
from test_scene_utils import _two_community_graph

def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the port's exports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["match", "apps"])
def test_exports_cover_reference_names(pkg):
    """Every name of cvt_tpu.<pkg>.__all__ whose module the port has is
    exported by the port under the same name."""
    ref = importlib.import_module(f"cvt_tpu.{pkg}")
    port = importlib.import_module(f"cvt_tpu_torch.{pkg}")
    checked = 0
    for name in ref.__all__:
        obj = getattr(ref, name)
        mod = obj.__name__ if name == "gps" else obj.__module__
        twin = mod.replace("cvt_tpu.", "cvt_tpu_torch.", 1)
        if importlib.util.find_spec(twin) is None:
            continue
        assert name in port.__all__, name
        assert hasattr(port, name), name
        checked += 1
    assert checked >= (40 if pkg == "match" else 5)


# ---------------------------------------------------------------------------
# camera models
# ---------------------------------------------------------------------------

CAMERAS = [
    ("simple_pinhole", [500., 320., 240.]),
    ("pinhole", [500., 510., 320., 240.]),
    ("simple_radial", [500., 320., 240., 0.08]),
    ("radial", [500., 320., 240., 0.05, -0.01]),
    ("opencv", [500., 510., 320., 240., 0.05, -0.01, 1e-3, -5e-4]),
    ("full_opencv", [500., 510., 320., 240., 0.05, -0.01, 1e-3, -5e-4,
                     1e-3, 0.01, -2e-3, 5e-4]),
    ("opencv_fisheye", [500., 510., 320., 240., 0.03, -0.005, 1e-3,
                        -5e-4]),
    ("fov", [500., 510., 320., 240., 0.9]),
    ("fov", [500., 510., 320., 240., -0.9]),
    ("simple_radial_fisheye", [500., 320., 240., 0.04]),
    ("radial_fisheye", [500., 320., 240., 0.03, -0.008]),
    ("thin_prism_fisheye", [500., 510., 320., 240., 0.03, -0.005, 1e-3,
                            -5e-4, 1e-4, -1e-4, 5e-4, -2e-4]),
]


def test_every_model_is_tested():
    assert {m for m, _ in CAMERAS} == set(jc.MODELS) == set(tc.MODELS)


@pytest.mark.parametrize("model,params", CAMERAS)
def test_camera_model_both_directions(model, params):
    rng = np.random.default_rng(0)
    xy = rng.uniform(-0.4, 0.4, size=(64, 2)).astype(np.float32)
    p = np.float32(params)
    uv_j = np.asarray(jc.world_to_image(model, jnp.asarray(p), xy))
    uv_t = tc.world_to_image(model, t(p), t(xy)).numpy()
    np.testing.assert_allclose(uv_t, uv_j, atol=1e-4)
    back_j = np.asarray(jc.image_to_world(model, jnp.asarray(p), uv_j))
    back_t = tc.image_to_world(model, t(p), t(uv_j)).numpy()
    np.testing.assert_allclose(back_t, back_j, atol=1e-6)
    np.testing.assert_allclose(back_t, xy, atol=1e-4)
    np.testing.assert_array_equal(
        tc.calibration_matrix(model, t(p)).numpy(),
        np.asarray(jc.calibration_matrix(model, jnp.asarray(p))))


def test_camera_batched_params():
    params = np.float32([[400., 300., 200., 0.02], [600., 310., 250., -0.03]])
    xy = np.random.default_rng(1).uniform(
        -0.3, 0.3, size=(2, 8, 2)).astype(np.float32)
    uv_j = np.asarray(jc.world_to_image("simple_radial", params, xy))
    uv_t = tc.world_to_image("simple_radial", t(params), t(xy))
    np.testing.assert_allclose(uv_t.numpy(), uv_j, atol=1e-4)
    back = tc.image_to_world("simple_radial", t(params), uv_t)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(jc.image_to_world("simple_radial", params,
                                                   uv_j)), atol=1e-6)
    k = tc.calibration_matrix("simple_radial", t(params))
    np.testing.assert_array_equal(k.numpy(), np.asarray(
        jc.calibration_matrix("simple_radial", params)))


# ---------------------------------------------------------------------------
# rotations and bundle adjustment
# ---------------------------------------------------------------------------

def test_rodrigues_and_inverse_match_reference():
    rng = np.random.default_rng(0)
    rv = np.concatenate([rng.normal(size=(10, 3)), np.zeros((1, 3)),
                         1e-5 * rng.normal(size=(2, 3))]).astype(np.float32)
    r_j = np.asarray(jb.rodrigues(jnp.asarray(rv)))
    r_t = tb.rodrigues(t(rv))
    np.testing.assert_allclose(r_t.numpy(), r_j, atol=1e-6)
    np.testing.assert_allclose(torch.linalg.det(r_t).numpy(), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(tb.rotation_to_rvec(r_t).numpy()[:10],
                               np.asarray(jb.rotation_to_rvec(
                                   jnp.asarray(r_j)))[:10], atol=1e-5)
    np.testing.assert_allclose(tb.rotation_to_rvec(r_t).numpy()[:10],
                               rv[:10], atol=1e-4)


def test_rodrigues_jacobian_finite_at_zero():
    """The safe branches keep the derivative finite at rvec = 0: the
    Jacobian there is the generator matrices, d R / d r_k = [e_k]_x."""
    jac = torch.autograd.functional.jacobian(tb.rodrigues,
                                             torch.zeros(3))
    assert torch.isfinite(jac).all()
    for k in range(3):
        e = torch.zeros(3)
        e[k] = 1.0
        want = torch.tensor([[0., -e[2], e[1]], [e[2], 0., -e[0]],
                             [-e[1], e[0], 0.]])
        np.testing.assert_allclose(jac[..., k].numpy(), want.numpy(),
                                   atol=1e-6)
    fwd = torch.func.jacfwd(tb.rodrigues)(torch.zeros(3))
    assert torch.isfinite(fwd).all()


def _ba_case(seed, noise=1e-3, pad=0, n_cams=4):
    rng = np.random.default_rng(seed)
    poses, pts, cam_idx, pt_idx, uv = _synthetic_ba(rng, n_cams=n_cams,
                                                    noise=noise)
    poses_n = poses.copy()
    poses_n[1:] += rng.normal(scale=0.01, size=poses[1:].shape
                              ).astype(np.float32)
    pts_n = pts + rng.normal(scale=0.05, size=pts.shape).astype(np.float32)
    mask = np.ones(uv.shape[0], np.float32)
    if pad:
        cam_idx = np.concatenate([cam_idx, np.zeros(pad, np.int32)])
        pt_idx = np.concatenate([pt_idx, np.zeros(pad, np.int32)])
        uv = np.concatenate([uv, rng.normal(size=(pad, 2)).astype(
            np.float32) * 100])
        mask = np.concatenate([mask, np.zeros(pad, np.float32)])
    return poses_n, pts_n, cam_idx, pt_idx, uv, mask


def _both_ba(arrays, **kw):
    want = jb.bundle_adjust(jb.BAProblem(*(jnp.asarray(a) for a in arrays)),
                            **kw)
    got = tb.bundle_adjust(convert.ba_problem_from_numpy(*arrays,
                                                         device="cpu"), **kw)
    return [np.asarray(a) for a in want], [b.numpy() for b in got]


@pytest.mark.parametrize("huber", [None, 0.002])
@pytest.mark.parametrize("n_fixed", [1, 4])
@pytest.mark.parametrize("pad", [0, 17])
def test_bundle_adjust_one_step_matches_reference(huber, n_fixed, pad):
    """One LM step: the gradient, the Marquardt diagonal (unweighted under
    Huber) and 5 CG matvecs from the blocks against cvt_tpu's jvp / vjp.
    (Deeper float32 CG on a problem with a free scale, n_fixed_poses 1,
    drifts with rounding: the 20-step test holds the cost there.)"""
    arrays = _ba_case(0, pad=pad)
    (pj, xj, cj), (pt, xt, ct) = _both_ba(
        arrays, iters=1, cg_iters=5, n_fixed_poses=n_fixed,
        huber_delta=huber)
    np.testing.assert_allclose(pt, pj, atol=1e-5)
    np.testing.assert_allclose(xt, xj, atol=1e-5)
    np.testing.assert_allclose(ct, cj, rtol=1e-5)


@pytest.mark.parametrize("huber", [None, 0.002])
@pytest.mark.parametrize("n_fixed", [1, 2, 4])
def test_bundle_adjust_matches_reference(huber, n_fixed):
    arrays = _ba_case(1, pad=9)
    (pj, xj, cj), (pt, xt, ct) = _both_ba(
        arrays, iters=20, cg_iters=30, n_fixed_poses=n_fixed,
        huber_delta=huber)
    np.testing.assert_allclose(ct, cj, rtol=1e-3)
    np.testing.assert_array_equal(pt[:n_fixed], arrays[0][:n_fixed])
    if n_fixed >= 2:          # the gauge (scale included) is fixed
        np.testing.assert_allclose(pt, pj, atol=5e-4)
        np.testing.assert_allclose(xt, xj, atol=5e-3)


def test_bundle_adjust_recovers_exact_scene():
    """tests/test_bundle.py's recovery, in the port: cost ~0 and the
    gauge camera untouched."""
    rng = np.random.default_rng(1)
    poses, pts, cam_idx, pt_idx, uv = _synthetic_ba(rng)
    poses_n = poses.copy()
    poses_n[1:] += rng.normal(scale=0.01, size=poses[1:].shape
                              ).astype(np.float32)
    pts_n = pts + rng.normal(scale=0.05, size=pts.shape).astype(np.float32)
    prob = convert.ba_problem_from_numpy(poses_n, pts_n, cam_idx, pt_idx,
                                         uv, np.ones(len(uv)), device="cpu")
    p_out, _, cost = tb.bundle_adjust(prob, iters=25, cg_iters=40)
    assert float(cost) < 1e-6
    np.testing.assert_allclose(p_out.numpy()[0], poses[0], atol=1e-7)


def test_frozen_nan_pose_is_killed():
    """mask_update zeroes frozen poses by where: a NaN step in a frozen
    pose leaves it as it was."""
    arrays = list(_ba_case(2))
    arrays[4] = arrays[4].copy()
    prob = convert.ba_problem_from_numpy(*arrays, device="cpu")
    poses = prob.poses.clone()
    poses[0, 0] = float("nan")           # NaN residuals in camera 0 only
    prob = prob._replace(poses=poses)
    p_out, x_out, _ = tb.bundle_adjust(prob, iters=2, n_fixed_poses=1)
    assert torch.isnan(p_out[0, 0])
    assert torch.isfinite(p_out[1:]).all()


# ---------------------------------------------------------------------------
# tracks, triangulation, reconstruction
# ---------------------------------------------------------------------------

def _graph_edges(seed, n_img=8, n_pts=40, kp=60, n_false=0):
    """Matches between every image pair: points seen in random subsets of
    the images at random feature indices, plus n_false random rows per
    pair (they merge tracks and make some observe one image twice)."""
    rng = np.random.default_rng(seed)
    fid = np.stack([rng.permutation(kp)[:n_pts] for _ in range(n_img)])
    seen = rng.random((n_img, n_pts)) < 0.5
    edges = []
    for a in range(n_img):
        for b in range(a + 1, n_img):
            both = np.nonzero(seen[a] & seen[b])[0]
            m = np.stack([fid[a, both], fid[b, both]], 1)
            m = np.concatenate([m, rng.integers(0, kp, (n_false, 2))])
            edges.append((a + 1, b + 1, m[rng.permutation(len(m))]))
    # a self-match (a one-node track) and a two-node one in one image
    edges.append((3, 3, np.array([[5, 5], [7, 8]])))
    return edges


@pytest.mark.parametrize("seed,n_false", [(0, 0), (1, 1), (2, 3), (3, 6)])
@pytest.mark.parametrize("min_length", [1, 2, 3])
def test_build_tracks_matches_reference(seed, n_false, min_length):
    gj, gt = jr.CorrespondenceGraph(), tr.CorrespondenceGraph()
    for a, b, m in _graph_edges(seed, n_false=n_false):
        gj.add_correspondences(a, b, m)
        gt.add_correspondences(a, b, m)
    want, got = gj.build_tracks(min_length), gt.build_tracks(min_length)
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert gt.image_ids == gj.image_ids
    assert [gt.num_correspondences(i) for i in gt.image_ids] == \
        [gj.num_correspondences(i) for i in gj.image_ids]


def test_build_tracks_edge_cases():
    g = tr.CorrespondenceGraph()
    assert g.build_tracks() == []
    g.add_correspondences(1, 2, np.zeros((0, 2)))
    assert g.build_tracks() == []
    g.add_correspondences(1, 2, [[0, 3], [1, 3]])      # image 1 twice
    assert g.build_tracks() == []
    g.add_correspondences(2, 3, [[2, 5]])
    g.add_correspondences(1, 3, [[7, 9]])
    tracks = g.build_tracks()          # (-length, first observation)
    assert [x.tolist() for x in tracks] == [[[1, 7], [3, 9]],
                                           [[2, 2], [3, 5]]]


def _scene_arrays(seed=0, n_cams=4, n_pts=30):
    rng = np.random.default_rng(seed)
    poses, pts, uv = _synthetic_scene(rng, n_cams=n_cams, n_pts=n_pts)
    n_cams, n_pts = uv.shape[:2]
    rots = np.asarray(jb.rodrigues(jnp.asarray(poses[:, :3])))
    cam_idx = np.tile(np.arange(n_cams, dtype=np.int32), (n_pts, 1))
    obs = np.transpose(uv, (1, 0, 2)).astype(np.float32)
    obs = obs + rng.normal(scale=1e-3, size=obs.shape).astype(np.float32)
    mask = (rng.random((n_pts, n_cams)) < 0.7).astype(np.float32)
    mask[:, :2] = 1.0
    mask[0, 1:] = 0.0                   # one observation: not ok
    return poses, rots, cam_idx, obs, mask


def test_triangulate_tracks_and_errors_match_reference():
    poses, rots, cam_idx, obs, mask = _scene_arrays()
    tv = poses[:, 3:].astype(np.float32)
    pj, okj = jr.triangulate_tracks(jnp.asarray(rots), jnp.asarray(tv),
                                    jnp.asarray(cam_idx), jnp.asarray(obs),
                                    jnp.asarray(mask))
    pt, okt = tr.triangulate_tracks(t(rots), t(tv), t(cam_idx).long(),
                                    t(obs), t(mask))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj)
    assert ok.sum() == len(ok) - 1
    np.testing.assert_allclose(pt.numpy()[ok], np.asarray(pj)[ok],
                               atol=1e-4)
    ej = jr._track_errors(jnp.asarray(rots), jnp.asarray(tv),
                          jnp.asarray(cam_idx), jnp.asarray(obs),
                          jnp.asarray(mask), pj)
    et = tr._track_errors(t(rots), t(tv), t(cam_idx).long(), t(obs),
                          t(mask), t(pj))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-6)
    # per-observation errors of the flattened problem
    o = mask > 0
    p6 = poses.astype(np.float32)
    ci = cam_idx[o]
    pi = np.nonzero(o)[0].astype(np.int32)
    rj = jr.reprojection_errors(jnp.asarray(p6), pj, jnp.asarray(ci),
                                jnp.asarray(pi), jnp.asarray(obs[o]),
                                jnp.ones(len(ci)))
    rt = tr.reprojection_errors(t(p6), t(pj), t(ci).long(), t(pi).long(),
                                t(obs[o]), torch.ones(len(ci)))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-6)


def _two_scenes(seed=1, noise=2e-3, n_cams=8, n_pts=60):
    """The same Reconstruction in both packages: tests/test_reconstruction
    .py's scene at 8 cameras (a 3.5-unit baseline at depth 4-8), tracks
    from a correspondence graph plus two through an unregistered
    image."""
    rng = np.random.default_rng(seed)
    poses, pts, uv = _synthetic_scene(rng, n_cams=n_cams, n_pts=n_pts)
    uv = uv + rng.normal(scale=noise, size=uv.shape).astype(np.float32)
    recs = [jr.Reconstruction(), tr.Reconstruction(device="cpu")]
    for rec in recs:
        for c in range(n_cams):
            rec.register_image(c, f"im{c}.jpg", poses[c, :3], poses[c, 3:],
                               uv[c])
    g = jr.CorrespondenceGraph()
    for c in range(n_cams - 1):
        keep = rng.random(n_pts) < 0.8
        g.add_correspondences(c, c + 1, np.stack([np.arange(n_pts)] * 2,
                                                 -1)[keep])
    tracks = g.build_tracks() + [np.array([[0, 3], [9, 3]]),
                                 np.array([[0, 5], [9, 5], [2, 5]])]
    return recs, tracks


def _same_scene(a, b, xyz_atol):
    assert sorted(a.images) == sorted(b.images)
    assert list(a.points3d) == list(b.points3d)
    for pid in a.points3d:
        np.testing.assert_array_equal(b.points3d[pid].track,
                                      a.points3d[pid].track)
        np.testing.assert_allclose(b.points3d[pid].xyz, a.points3d[pid].xyz,
                                   atol=xyz_atol)
    assert a._next_pt == b._next_pt


def test_reconstruction_matches_reference():
    (a, b), tracks = _two_scenes()
    assert a.triangulate(tracks, max_error=0.004) == b.triangulate(
        tracks, max_error=0.004) > 40
    _same_scene(a, b, 1e-4)
    for pid in a.points3d:
        assert abs(a.points3d[pid].error - b.points3d[pid].error) < 1e-6
        assert b.points3d[pid].xyz.dtype == a.points3d[pid].xyz.dtype
    pa, ids_a, pts_a = a.to_ba_problem()
    pb, ids_b, pts_b = b.to_ba_problem()
    assert (ids_a, pts_a) == (ids_b, pts_b)
    for name in ("cam_idx", "pt_idx", "uv", "mask", "poses"):
        np.testing.assert_array_equal(getattr(pb, name).numpy(),
                                      np.asarray(getattr(pa, name)))
    np.testing.assert_allclose(pb.points.numpy(), np.asarray(pa.points),
                               atol=1e-4)
    ca = a.bundle_adjust(iters=10, n_fixed_poses=2)
    cb = b.bundle_adjust(iters=10, n_fixed_poses=2)
    np.testing.assert_allclose(cb, ca, rtol=1e-4)
    _same_scene(a, b, 2e-3)
    for iid in a.images:
        np.testing.assert_allclose(b.images[iid].tvec, a.images[iid].tvec,
                                   atol=1e-3)
        np.testing.assert_allclose(b.images[iid].rvec, a.images[iid].rvec,
                                   atol=1e-3)
    # a limit between the points' mean errors, none within 1e-6 of it
    pb_, _, pt_ids = b.to_ba_problem()
    errs = tr.reprojection_errors(*pb_[:4], pb_.uv, pb_.mask).numpy()
    n = np.bincount(pb_.pt_idx.numpy())
    mean = np.bincount(pb_.pt_idx.numpy(), weights=errs) / n
    limit = float(np.sort(mean)[len(mean) * 3 // 4]) * (1 + 1e-5)
    assert np.abs(mean / limit - 1).min() > 1e-6
    assert a.filter_points(limit) == b.filter_points(limit) > 0
    assert sorted(a.points3d) == sorted(b.points3d)
    assert a.num_observations(2) == b.num_observations(2)
    assert a.find_image_id("im3.jpg") == b.find_image_id("im3.jpg") == 3
    assert a.deregister_image(1) and b.deregister_image(1)
    assert not b.deregister_image(1)
    _same_scene(a, b, 2e-3)
    counts = sorted(b.num_observations(i) for i in b.images)
    n = a.filter_images(counts[1] + 1)
    assert b.filter_images(counts[1] + 1) == n >= 2
    _same_scene(a, b, 2e-3)


def test_reconstruction_end_to_end_exact():
    """tests/test_reconstruction.py's end-to-end run in the port."""
    rng = np.random.default_rng(1)
    poses, pts, uv = _synthetic_scene(rng)
    n_cams, n_pts = uv.shape[:2]
    rec = tr.Reconstruction(device="cpu")
    for c in range(n_cams):
        rec.register_image(c, f"im{c}", poses[c, :3], poses[c, 3:], uv[c])
    g = tr.CorrespondenceGraph()
    for c in range(n_cams - 1):
        g.add_correspondences(c, c + 1, np.stack([np.arange(n_pts)] * 2,
                                                 -1))
    tracks = g.build_tracks()
    assert len(tracks) == n_pts and all(len(x) == n_cams for x in tracks)
    assert rec.triangulate(tracks, max_error=0.01) == n_pts
    for p in rec.points3d.values():
        p.xyz = p.xyz + rng.normal(size=3) * 0.05
    assert rec.bundle_adjust(iters=10, n_fixed_poses=n_cams) < 1e-6
    assert rec.filter_points(max_error=1e-3) == 0


def test_empty_scene_is_a_no_op():
    rec = tr.Reconstruction()             # no device needed for a no-op
    assert rec.bundle_adjust() == 0.0
    assert rec.filter_points(1.0) == 0
    assert rec.triangulate([]) == 0


@pytest.mark.parametrize("writer", ["cvt_tpu", "port"])
def test_npz_loads_in_the_other_package(tmp_path, writer):
    rec = _toy_reconstruction(np.random.default_rng(3))
    path = str(tmp_path / "r.npz")
    if writer == "cvt_tpu":
        rec.save(path)
        got = tr.Reconstruction.load(path)
    else:
        mine = tr.Reconstruction(device="cpu")
        mine.images, mine.points3d, mine._next_pt = (rec.images,
                                                     rec.points3d,
                                                     rec._next_pt)
        mine.save(path)
        got = jr.Reconstruction.load(path)
    assert sorted(got.images) == sorted(rec.images)
    assert sorted(got.points3d) == sorted(rec.points3d)
    assert got._next_pt == rec._next_pt
    for iid, im in rec.images.items():
        g = got.images[iid]
        assert (g.name, g.camera_id) == (im.name, im.camera_id)
        for f in ("rvec", "tvec", "keypoints"):
            np.testing.assert_array_equal(getattr(g, f), getattr(im, f))
    for pid, p in rec.points3d.items():
        np.testing.assert_array_equal(got.points3d[pid].xyz, p.xyz)
        np.testing.assert_array_equal(got.points3d[pid].track, p.track)
        assert got.points3d[pid].error == p.error


# ---------------------------------------------------------------------------
# gps, scene utilities, LAD
# ---------------------------------------------------------------------------

def test_gps_matches_reference():
    lla = np.array([[37.7749, -122.4194, 10.0], [-33.8688, 151.2093, 58.0],
                    [0.0, 0.0, 0.0], [89.9, 10.0, -20.0]])
    for ell in ("wgs84", "grs80"):
        xyz = tgps.ell_to_ecef(lla, ell)
        np.testing.assert_allclose(xyz, jgps.ell_to_ecef(lla, ell),
                                   atol=1e-9)
        np.testing.assert_allclose(tgps.ecef_to_ell(xyz, ell),
                                   jgps.ecef_to_ell(xyz, ell), atol=1e-9)
        enu = tgps.ell_to_enu(lla, 48.8566, 2.3522, 35.0, ell)
        np.testing.assert_allclose(
            enu, jgps.ell_to_enu(lla, 48.8566, 2.3522, 35.0, ell), atol=1e-9)
        np.testing.assert_allclose(
            tgps.enu_to_ecef(enu, 48.8566, 2.3522, 35.0, ell),
            jgps.enu_to_ecef(enu, 48.8566, 2.3522, 35.0, ell), atol=1e-6)
    with pytest.raises(ValueError):
        tgps.ell_to_ecef(np.zeros(3), "sphere")


def test_graph_cuts_match_reference():
    edges, weights, n = _two_community_graph(np.random.default_rng(0))
    np.testing.assert_array_equal(ts.normalized_cut(edges, weights, n),
                                  js.normalized_cut(edges, weights, n))
    caps = np.random.default_rng(1).uniform(0.1, 2.0, len(edges))
    ft, lt = ts.min_st_cut(edges, caps, n, 0, n - 1)
    fj, lj = js.min_st_cut(edges, caps, n, 0, n - 1)
    assert ft == fj
    np.testing.assert_array_equal(lt, lj)


@pytest.mark.parametrize("overlap", [0, 2])
def test_cluster_scene_matches_reference(overlap):
    edges, weights, n = _two_community_graph(np.random.default_rng(1),
                                             n_half=16)
    ids = [100 + i for i in range(n)]

    def tree(c):
        return (c.image_ids, [tree(k) for k in c.children])
    got = ts.cluster_scene(ids, edges, weights, leaf_max_images=10,
                           image_overlap=overlap)
    want = js.cluster_scene(ids, edges, weights, leaf_max_images=10,
                            image_overlap=overlap)
    assert tree(got) == tree(want)
    assert [lf.image_ids for lf in got.leaves()] == \
        [lf.image_ids for lf in want.leaves()]


def test_visibility_pyramid_matches_reference():
    rng = np.random.default_rng(4)
    vt, vj = ts.VisibilityPyramid(5, 640, 480), js.VisibilityPyramid(5, 640,
                                                                     480)
    pts = rng.uniform([0, 0], [640, 480], (50, 2))
    for x, y in pts:
        vt.add_point(x, y)
        vj.add_point(x, y)
        assert vt.score == vj.score
    for x, y in pts[::3]:
        vt.remove_point(x, y)
        vj.remove_point(x, y)
        assert vt.score == vj.score


def _lad_outliers():
    rs = np.random.default_rng(1)
    x_true = np.array([2.0, -1.0, 0.5], np.float32)
    a = rs.normal(size=(200, 3)).astype(np.float32)
    b = a @ x_true
    b[:20] += rs.uniform(50, 100, 20)
    return a, b.astype(np.float32)


def _lad_clean():
    rs = np.random.default_rng(2)
    a = rs.normal(size=(50, 4)).astype(np.float32)
    return a, (a @ rs.normal(size=(4,)).astype(np.float32))


@pytest.mark.parametrize("case,kw", [
    ("outliers", dict(max_iters=500, absolute_tolerance=1e-3)),
    ("outliers", dict(max_iters=7)),
    ("outliers", dict(max_iters=12)),
    ("clean", dict(max_iters=400)),
    ("clean", dict(max_iters=400, alpha=1.6, rho=2.0)),
])
def test_solve_lad_matches_reference(case, kw):
    a, b = _lad_outliers() if case == "outliers" else _lad_clean()
    want = jlad.solve_lad(a, b, **kw)
    got = tlad.solve_lad(t(a), t(b), **kw)
    assert int(got.iterations) == int(want.iterations)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-4)
    assert got.iterations.dtype == torch.int32


def test_solve_lad_warm_start_and_robustness():
    a, b = _lad_outliers()
    res = tlad.solve_lad(t(a), t(b), max_iters=500)
    assert bool(res.converged)
    assert np.linalg.norm(res.x.numpy() - [2.0, -1.0, 0.5]) < 0.05
    warm = tlad.solve_lad(t(a), t(b), x0=res.x, max_iters=500)
    want = jlad.solve_lad(a, b, x0=res.x.numpy(), max_iters=500)
    assert int(warm.iterations) <= int(res.iterations)
    np.testing.assert_allclose(warm.x.numpy(), np.asarray(want.x), atol=1e-4)
