"""The reconstruction slice on the card against the same code on the CPU.

Marked `cuda`: every test takes the `card` fixture, which skips when
torch.cuda.is_available() is false (decided in the fixture, never at
import). Needs no JAX:
    python -m pytest tests/test_torch_recon_cuda.py --noconftest -m cuda

Tolerances: `index_add_` adds in atomic order on the card and the
batched SVDs are another library's, so nothing is held bitwise.
bundle_adjust at 20 LM steps on a well-conditioned scene: cost rtol
1e-4, poses 1e-4, points 1e-3 (both gauge poses fixed);
triangulate_tracks 1e-4 with equal cheirality; the PnP and GP3P cores
on the same picks: inlier masks equal, R and t 1e-4; solve_lad 1e-4 with equal iterations on a problem
whose stop is not decided by rounding; image_to_world 1e-5; the warps
1e-4 on values in [0, 1] (a source coordinate's float32 ulp, up to
1.5e-5 px at 160 px, moves a sample by that share of an edge's step);
Reconstruction's triangulate / BA / filter on the card against the CPU:
equal point sets, points 5e-3.
"""

import numpy as np
import pytest
import torch

from cvt_tpu_torch import convert
from cvt_tpu_torch.apps import (undistort_images, warp_between_cameras,
                                warp_image_homography)
from cvt_tpu_torch.match import (CorrespondenceGraph, Reconstruction,
                                 image_to_world, solve_lad,
                                 triangulate_tracks)
from cvt_tpu_torch.match import bundle as tb
from cvt_tpu_torch.match import pose as tp
from cvt_tpu_torch.match.ransac import _gumbel
from cvt_tpu_torch.ops.topk import top_k_largest

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rotation(rng, scale=1.0):
    return tb.rodrigues(torch.from_numpy(
        (rng.normal(size=3) * scale).astype(np.float32))).numpy()


def ba_arrays(seed=0, n_cams=8, n_pts=400, noise=1e-3):
    """Cameras on a 90-degree arc of radius 6 around points in a cube of
    side 2, looking at its centre; poses past the first two and every
    point perturbed. (A well-conditioned problem: inputs moved by one
    float32 ulp move the result by < 3e-5 on the CPU, with and without
    Huber.)"""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n_pts, 3)).astype(np.float32)
    poses = []
    for th in np.deg2rad(np.linspace(-45, 45, n_cams)):
        c = 6.0 * np.array([np.sin(th), 0.2 * rng.uniform(-1, 1),
                            -np.cos(th)])
        fwd = -c / np.linalg.norm(c)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        rot = np.stack([right, np.cross(fwd, right), fwd])
        poses.append(np.r_[Rotation.from_matrix(rot).as_rotvec(), -rot @ c])
    poses = np.stack(poses).astype(np.float32)
    rots = tb.rodrigues(torch.from_numpy(poses[:, :3])).numpy()
    cam_idx = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    pt_idx = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    cam = np.einsum("oij,oj->oi", rots[cam_idx], pts[pt_idx]) + \
        poses[cam_idx, 3:]
    uv = (cam[:, :2] / cam[:, 2:3] + rng.normal(scale=noise, size=(
        len(cam), 2))).astype(np.float32)
    poses_n = poses.copy()
    poses_n[2:] += rng.normal(scale=0.01, size=poses[2:].shape
                              ).astype(np.float32)
    pts_n = pts + rng.normal(scale=0.05, size=pts.shape).astype(np.float32)
    mask = (rng.random(len(uv)) < 0.9).astype(np.float32)
    return poses_n, pts_n, cam_idx, pt_idx, uv, mask


@pytest.mark.parametrize("huber", [None, 0.002])
def test_bundle_adjust_card_vs_cpu(card, huber):
    arrays = ba_arrays()
    out = {}
    for dev in ("cpu", card):
        prob = convert.ba_problem_from_numpy(*arrays, device=dev)
        p, x, c = tb.bundle_adjust(prob, n_fixed_poses=2, huber_delta=huber)
        assert p.device.type == torch.device(dev).type
        out[str(dev)] = (p.cpu().numpy(), x.cpu().numpy(), float(c))
    (pc, xc, cc), (pg, xg, cg) = out["cpu"], out[str(card)]
    np.testing.assert_allclose(cg, cc, rtol=1e-4)
    np.testing.assert_allclose(pg, pc, atol=1e-4)
    np.testing.assert_allclose(xg, xc, atol=1e-3)
    np.testing.assert_array_equal(pg[:2], arrays[0][:2])


def test_triangulate_tracks_card_vs_cpu(card):
    rng = np.random.default_rng(1)
    c, tn, s = 12, 2000, 9
    rots = np.stack([rotation(rng, 0.1) for _ in range(c)])
    tv = rng.normal(size=(c, 3)).astype(np.float32) * 0.5
    pts = np.stack([rng.uniform(-1, 1, tn), rng.uniform(-1, 1, tn),
                    rng.uniform(6, 10, tn)], -1).astype(np.float32)
    cam_idx = np.stack([rng.choice(c, s, replace=False) for _ in range(tn)])
    cam = np.einsum("tsij,tj->tsi", rots[cam_idx], pts) + tv[cam_idx]
    uv = (cam[..., :2] / cam[..., 2:] + rng.normal(
        scale=1e-3, size=cam[..., :2].shape)).astype(np.float32)
    mask = (rng.random((tn, s)) < 0.6).astype(np.float32)
    out = {}
    for dev in ("cpu", card):
        x, ok = triangulate_tracks(*(torch.from_numpy(a).to(dev) for a in (
            rots, tv, cam_idx.astype(np.int64), uv, mask)))
        out[str(dev)] = (x.cpu().numpy(), ok.cpu().numpy())
    (xc, okc), (xg, okg) = out["cpu"], out[str(card)]
    np.testing.assert_array_equal(okg, okc)
    np.testing.assert_allclose(xg[okc], xc[okc], atol=1e-4)


def picks_for(n, n_hyp, k, seed=0):
    g = _gumbel(torch.Generator().manual_seed(seed), (n_hyp, n), "cpu")
    return top_k_largest(g, k)[1]


def test_pnp_core_card_vs_cpu(card):
    rng = np.random.default_rng(5)
    r = rotation(rng)
    t = rng.normal(size=3).astype(np.float32) * 0.2
    cam = np.stack([rng.uniform(-1, 1, 400), rng.uniform(-1, 1, 400),
                    rng.uniform(2, 6, 400)], -1).astype(np.float32)
    world = ((cam - t) @ r).astype(np.float32)
    img = (cam[:, :2] / cam[:, 2:3]).astype(np.float32)
    img[:100] += rng.uniform(0.1, 0.5, (100, 2)).astype(np.float32)
    picks = picks_for(400, 64, 3)
    out = {}
    for dev in ("cpu", card):
        res = tp._pnp_core(torch.from_numpy(world).to(dev),
                           torch.from_numpy(img).to(dev),
                           torch.ones(400, dtype=torch.bool, device=dev),
                           picks.to(dev), 0.01)
        out[str(dev)] = [a.cpu().numpy() for a in res]
    c, g = out["cpu"], out[str(card)]
    np.testing.assert_array_equal(g[2], c[2])
    np.testing.assert_allclose(g[0], c[0], atol=1e-4)
    np.testing.assert_allclose(g[1], c[1], atol=1e-4)
    np.testing.assert_allclose(c[0], r, atol=5e-3)


def test_gp3p_core_card_vs_cpu(card):
    rng = np.random.default_rng(2)
    n = 120
    r = rotation(rng, 0.4)
    t = rng.uniform(-1, 1, 3).astype(np.float32)
    x = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    x[:, 2] += 6.0
    cams = np.array([[0.3, 0, 0], [-0.3, 0.1, 0], [0, -0.2, 0.1]],
                    np.float32)
    o = cams[np.arange(n) % 3]
    d = x @ r.T + t - o
    d[:30] = rng.normal(size=(30, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    picks = picks_for(n, 128, 3, seed=1)
    out = {}
    for dev in ("cpu", card):
        res = tp._gp3p_core(*(torch.from_numpy(a).to(dev) for a in (o, d, x)),
                            torch.ones(n, dtype=torch.bool, device=dev),
                            picks.to(dev), 1e-4, 6)
        out[str(dev)] = [a.cpu().numpy() for a in res]
    c, g = out["cpu"], out[str(card)]
    np.testing.assert_array_equal(g[2], c[2])
    assert int(c[3]) >= 80
    np.testing.assert_allclose(g[0], c[0], atol=1e-4)
    np.testing.assert_allclose(g[1], c[1], atol=1e-4)


def test_solve_lad_card_vs_cpu(card):
    rs = np.random.default_rng(2)
    a = rs.normal(size=(500, 6)).astype(np.float32)
    x_true = rs.normal(size=6).astype(np.float32)
    b = a @ x_true
    b[:40] += rs.uniform(20, 50, 40).astype(np.float32)
    out = {}
    for dev in ("cpu", card):
        res = solve_lad(torch.from_numpy(a).to(dev),
                        torch.from_numpy(b).to(dev), max_iters=500,
                        absolute_tolerance=1e-3)
        out[str(dev)] = res
    c, g = out["cpu"], out[str(card)]
    assert int(g.iterations) == int(c.iterations)
    assert bool(g.converged) == bool(c.converged) is True
    np.testing.assert_allclose(g.x.cpu().numpy(), c.x.numpy(), atol=1e-4)


def test_image_to_world_card_vs_cpu(card):
    rng = np.random.default_rng(0)
    uv = rng.uniform([0, 0], [1600, 1200], (100_000, 2)).astype(np.float32)
    params = np.float32([1400, 1400, 800, 600, -0.2, 0.05, 1e-3, -5e-4])
    out = [image_to_world("opencv", torch.from_numpy(params).to(dev),
                          torch.from_numpy(uv).to(dev)).cpu().numpy()
           for dev in ("cpu", card)]
    np.testing.assert_allclose(out[1], out[0], atol=1e-5)


def test_warps_card_vs_cpu(card):
    rng = np.random.default_rng(1)
    imgs = rng.random((3, 120, 160, 3)).astype(np.float32)
    params = np.float32([140, 140, 80, 60, -0.2, 0.05, 1e-3, -5e-4])
    h = np.float32([[1.02, 0.05, -4.3], [-0.03, 0.98, 7.7],
                    [1e-4, -2e-4, 1]])
    for fn in (lambda dev: undistort_images(torch.from_numpy(imgs).to(dev),
                                            "opencv", params,
                                            blank_pixels=0.3)[0],
               lambda dev: warp_image_homography(
                   torch.from_numpy(imgs[0]).to(dev), h, 100, 150),
               lambda dev: warp_between_cameras(
                   torch.from_numpy(imgs[1, ..., 0]).to(dev), "opencv",
                   params, "simple_radial", [150., 80., 60., 0.05])):
        c, g = fn("cpu"), fn(card)
        assert g.device.type == "cuda"
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), atol=1e-4)


def test_reconstruction_card_vs_cpu(card):
    rng = np.random.default_rng(3)
    n_cams, n_pts = 8, 300
    pts = np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-1, 1, n_pts),
                    rng.uniform(4, 8, n_pts)], -1)
    poses = np.stack([np.r_[rng.normal(size=3) * 0.05, 0.5 * c - 1.75, 0, 0]
                      for c in range(n_cams)])
    rots = tb.rodrigues(torch.from_numpy(poses[:, :3].astype(np.float32))
                        ).numpy().astype(np.float64)
    cam = np.einsum("cij,pj->cpi", rots, pts) + poses[:, None, 3:]
    uv = cam[..., :2] / cam[..., 2:] + rng.normal(scale=1e-3,
                                                  size=cam[..., :2].shape)
    g = CorrespondenceGraph()
    for c in range(n_cams - 1):
        keep = rng.random(n_pts) < 0.8
        g.add_correspondences(c, c + 1, np.stack([np.arange(n_pts)] * 2,
                                                 -1)[keep])
    tracks = g.build_tracks()
    recs = {}
    for dev in ("cpu", card):
        rec = Reconstruction(device=dev)
        for c in range(n_cams):
            rec.register_image(c, f"im{c}", poses[c, :3], poses[c, 3:], uv[c])
        rec.triangulate(tracks, max_error=0.01)
        rec.bundle_adjust(n_fixed_poses=2)
        rec.filter_points(0.004)
        recs[str(dev)] = rec
    c, gpu = recs["cpu"], recs[str(card)]
    assert sorted(c.points3d) == sorted(gpu.points3d)
    assert len(c.points3d) > 200
    for pid in c.points3d:
        np.testing.assert_allclose(gpu.points3d[pid].xyz, c.points3d[pid].xyz,
                                   atol=5e-3)
