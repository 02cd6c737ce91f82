"""The matching front end on the card against the same code on the CPU.

Marked `cuda`: every test takes the `card` fixture, which skips when
torch.cuda.is_available() is false (decided in the fixture, never at
import). Needs no JAX:
    python -m pytest tests/test_torch_match_cuda.py --noconftest -m cuda

Tolerances: idx2 and valid equal up to counted near-tie rows (top-2 gap
or ratio margin within 1e-5 relative: the card's product sums in another
order; at most 0.5% of the rows), distances 1e-5. ransac_fundamental
with one seed: the Gumbel noise is drawn on the CPU generator on both
sides, so the card fits the same samples: inlier masks equal, F 1e-3
after sign and scale normalisation (batched SVDs of another library).
match_pairs on a small database: the matches tables, configurations
and inlier rows equal.
"""

import numpy as np
import pytest
import torch

from cvt_tpu_torch.io.database import FeatureDatabase
from cvt_tpu_torch.match import (match_descriptors, match_guided,
                                 ransac_fundamental)
from cvt_tpu_torch.match import pipelines as pl

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def descriptors(k1=2048, k2=2304, dim=128, seed=0):
    rng = np.random.default_rng(seed)
    d1 = np.abs(rng.normal(size=(k1, dim)))
    d2 = np.abs(rng.normal(size=(k2, dim)))
    d2[:1500] = np.abs(d1[:1500] + 0.2 * rng.normal(size=(1500, dim)))
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return (torch.from_numpy(d1.astype(np.float32)),
            torch.from_numpy(d2.astype(np.float32)))


def near_ties(d1, d2, ratio, gate=None, near=None):
    """Rows whose top-2 gap or ratio margin is within 1e-5 relative, whose
    best column's two best rows are, or (guided) with a candidate at most
    as far as the second whose gate margin is within 1e-4 (`near`)."""
    d = torch.cdist(d1.double(), d2.double()) ** 2
    if gate is not None:
        d = torch.where(gate, d, torch.inf)
    v = torch.sort(d, 1).values
    best, second = v[:, 0], v[:, 1]
    fin = torch.isfinite(second)
    tie = fin & (((second - best) <= 1e-5 * second)
                 | ((best - ratio * ratio * second).abs() <= 1e-5 * second))
    col = torch.sort(d, 0).values
    ctie = torch.isfinite(col[1]) & ((col[1] - col[0]) <= 1e-5 * col[1])
    tie = tie | ctie[torch.argmin(d, 1)]
    if near is not None:
        raw = torch.cdist(d1.double(), d2.double()) ** 2
        tie = tie | (near & (raw <= second[:, None])).any(1)
    return tie.numpy()


def assert_same(got, want, tie):
    ig, vg = got.idx2.cpu().numpy(), got.valid.cpu().numpy()
    iw, vw = want.idx2.numpy(), want.valid.numpy()
    differ = (vg != vw) | (vw & (ig != iw))
    assert not np.any(differ & ~tie)
    assert tie.mean() <= 0.005
    keep = vw & ~tie
    np.testing.assert_allclose(got.dist.cpu().numpy()[keep],
                               want.dist.numpy()[keep], atol=1e-5)


def test_match_descriptors_card_vs_cpu(card):
    d1, d2 = descriptors()
    v2 = torch.ones(len(d2), dtype=torch.bool)
    v2[2200:] = False
    for ratio, cross in ((0.8, True), (0.9, False)):
        want = match_descriptors(d1, d2, None, v2, ratio=ratio,
                                 cross_check=cross, max_dist=0.98)
        got = match_descriptors(d1.to(card), d2.to(card), None, v2.to(card),
                                ratio=ratio, cross_check=cross,
                                max_dist=0.98)
        assert got.valid.device.type == "cuda"
        d2m = d2.clone()
        d2m[~v2] = 1e3
        assert_same(got, want, near_ties(d1, d2m, ratio))
        assert want.valid.sum() > 1000


@pytest.mark.parametrize("model_type", ["fundamental", "homography"])
def test_match_guided_card_vs_cpu(card, model_type):
    rng = np.random.default_rng(1)
    d1, d2 = descriptors(seed=1)
    p1 = torch.from_numpy(rng.uniform(0, 1000, (len(d1), 2)).astype(
        np.float32))
    p2 = torch.from_numpy(rng.uniform(0, 1000, (len(d2), 2)).astype(
        np.float32))
    if model_type == "homography":
        model = torch.tensor([[1.0, 0.02, 5.0], [-0.01, 1.0, -3.0],
                              [1e-5, 0.0, 1.0]])
        x = torch.cat([p1[:1500], torch.ones(1500, 1)], 1) @ model.T
        p2[:1500] = x[:, :2] / x[:, 2:]
        max_error = 40.0
    else:
        # F of a sideways translation: epipolar lines y2 = y1
        model = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, -1.0],
                              [0.0, 1.0, 0.0]])
        p2[:1500, 1] = p1[:1500, 1]
        max_error = 30.0
    kw = dict(model_type=model_type, max_error=max_error, ratio=0.8)
    want = match_guided(d1, d2, p1, p2, model, **kw)
    got = match_guided(d1.to(card), d2.to(card), p1.to(card), p2.to(card),
                       model.to(card), **kw)
    resid = (tg_resid(model_type))(model.double(), p1.double(),
                                   p2.double())
    near = (resid - max_error ** 2).abs() <= 1e-4 * max_error ** 2
    tie = near_ties(d1, d2, 0.8, gate=resid <= max_error ** 2, near=near)
    assert_same(got, want, tie)
    assert want.valid.sum() > 500


def tg_resid(model_type):
    from cvt_tpu_torch.match import guided
    return (guided._homography_residual_matrix if model_type == "homography"
            else guided._epipolar_residual_matrix)


def unit(m):
    m = m.double().cpu().numpy()
    m = m / np.linalg.norm(m)
    return m * np.sign(m.flat[np.argmax(np.abs(m))])


def test_ransac_fundamental_card_vs_cpu(card):
    rng = np.random.default_rng(2)
    n = 3000
    pts = rng.uniform([-3, -2, 6], [3, 2, 12], (n, 3))
    r = np.array([[np.cos(0.1), 0, np.sin(0.1)], [0, 1, 0],
                  [-np.sin(0.1), 0, np.cos(0.1)]])
    cam2 = pts @ r.T + [1.0, 0.1, 0.2]
    src = pts[:, :2] / pts[:, 2:] * 800 + 500 + rng.normal(0, 0.5, (n, 2))
    dst = cam2[:, :2] / cam2[:, 2:] * 800 + 500 + rng.normal(0, 0.5, (n, 2))
    dst[:600] = rng.uniform(0, 1000, (600, 2))            # outliers
    src, dst = (torch.from_numpy(a.astype(np.float32)) for a in (src, dst))
    out = [ransac_fundamental(torch.Generator().manual_seed(7),
                              src.to(dev), dst.to(dev), threshold=4.0,
                              n_hypotheses=256) for dev in ("cpu", card)]
    np.testing.assert_array_equal(out[1][1].cpu().numpy(),
                                  out[0][1].numpy())
    assert int(out[1][2]) == int(out[0][2]) >= 2300
    np.testing.assert_allclose(unit(out[1][0]), unit(out[0][0]), atol=1e-3)


def test_match_pairs_card_vs_cpu(card, tmp_path):
    """Four images of 1,024 keypoints: three views of one set of points
    under sideways translations (parallax of 17-50 px per step: F, not
    H) and a fourth of other points."""
    rng = np.random.default_rng(3)
    base = np.abs(rng.normal(size=(900, 128)))
    xy = rng.uniform(0, 1000, (900, 2))
    depth = rng.uniform(4, 12, 900)
    paths = [str(tmp_path / f"{d}.sqlite") for d in ("cpu", "cuda")]
    for path in paths:
        rs = np.random.default_rng(4)
        with FeatureDatabase(path) as db:
            for i in range(4):
                src = base if i < 3 else np.abs(rs.normal(size=(900, 128)))
                d = np.concatenate([np.abs(src + 0.05 * rs.normal(
                    size=src.shape)), np.abs(rs.normal(size=(124, 128)))])
                d /= np.linalg.norm(d, axis=1, keepdims=True)
                kp = np.concatenate([
                    xy + np.stack([200.0 * i / depth, np.zeros(900)], 1),
                    rs.uniform(0, 1000, (124, 2))])
                iid = db.add_image(f"im{i}.jpg", 1000, 1000)
                db.write_keypoints(iid, np.c_[kp, np.zeros((1024, 2))])
                db.write_descriptors(iid, d.astype(np.float32))
            db.commit()
    pairs = pl.exhaustive_pairs([1, 2, 3, 4])
    stats = []
    for path, dev in zip(paths, ("cpu", "cuda")):
        with FeatureDatabase(path) as db:
            stats.append(pl.match_pairs(db, pairs, device=dev))
    assert vars(stats[1]) == vars(stats[0])
    assert stats[0].n_verified == 3
    with FeatureDatabase(paths[0]) as a, FeatureDatabase(paths[1]) as b:
        for p in pairs:
            np.testing.assert_array_equal(b.read_matches(*p),
                                          a.read_matches(*p))
            ga, gb = a.read_two_view_geometry(*p), b.read_two_view_geometry(*p)
            assert (ga is None) == (gb is None)
            if ga is not None:
                np.testing.assert_array_equal(gb[0], ga[0])
                assert gb[1] == ga[1]
