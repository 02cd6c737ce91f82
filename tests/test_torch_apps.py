"""The port's perceptual hash, detection decode + NMS, motion area and
pupil tracker (`cvt_tpu_torch.apps.{phash,detect,motion_area,pupil}`)
held to `cvt_tpu.apps` on the same seeded numpy inputs, on the CPU.

Tolerances:
  * phash: hashes bitwise, except bits whose coefficient lies within
    1e-5 of its block's mean (counted; the scenes keep the count at 0);
    Hamming distances bitwise; resize_gray_32 1e-5 on [0, 1] images;
    is_pure_image equal.
  * detect: boxes and scores 1e-6, classes and valid bitwise, NMS keep
    masks bitwise (class-aware and not).
  * motion area: the accumulated mask within 8 ulp of the largest
    cumulative sum (float32 scans of another order: eps·8·(H + 5)),
    the box bitwise, coverage 1e-5.
  * pupil: the specular infill 1e-6, Haar responses 1e-5 and the coarse
    centre equal unless the best response is within 1e-5 of another
    (counted), Otsu thresholds equal, conic solves 1e-4 (degenerate
    samples: the minimum-norm solution), and `fit_pupil` fed the picks
    `jax.random.choice` draws from `cvt_tpu`'s keys equal to
    `cvt_tpu.find_pupil`: centre 1e-4 px, inlier counts equal.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu_torch.io.datasets import procedural_images
from cvt_tpu_torch.ops.bits import sigs_to_u32

jp = importlib.import_module("cvt_tpu.apps.phash")
tp = importlib.import_module("cvt_tpu_torch.apps.phash")
from cvt_tpu.apps import detect as jd  # noqa: E402
from cvt_tpu.apps import motion_area as jm  # noqa: E402
from cvt_tpu.apps import pupil as jpp  # noqa: E402
from cvt_tpu_torch.apps import detect as td  # noqa: E402
from cvt_tpu_torch.apps import motion_area as tm  # noqa: E402
from cvt_tpu_torch.apps import pupil as tpp  # noqa: E402

EPS = float(np.finfo(np.float32).eps)


def t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------- phash

def _hash_images(seed, n=48):
    """Procedural 96 x 128 images resized to 32 x 32 (and edited copies)."""
    x = procedural_images(n, 96, 128, seed=seed)
    return np.asarray(jp.resize_gray_32(jnp.asarray(x)))


def _near_mean_bits(small, cons):
    coef = tp.dct_block(t(small), cons).numpy()
    return np.abs(coef - coef.mean(-1, keepdims=True)) < 1e-5


@pytest.mark.parametrize("cons", [0, 15])
@pytest.mark.parametrize("seed", [0, 1])
def test_phash_bitwise_up_to_near_mean_bits(seed, cons):
    # the high-frequency block (cons 15) of a smooth image is all near 0,
    # so that variant hashes seeded white noise
    small = (_hash_images(seed) if cons == 0 else np.random.default_rng(
        seed).random((48, 32, 32)).astype(np.float32))
    want = np.asarray(jp.phash(jnp.asarray(small), cons))
    got = tp.phash(t(small), cons)
    assert got.dtype == torch.int64
    near = _near_mean_bits(small, cons)
    differ = np.unpackbits(
        (sigs_to_u32(got.numpy()) ^ want).view(np.uint8),
        bitorder="little").reshape(near.shape).astype(bool)
    assert not np.any(differ & ~near)
    assert near.sum() == 0 and not differ.any()


def test_hamming_distance_both_forms():
    small = _hash_images(2)
    words = np.asarray(jp.phash(jnp.asarray(small)))
    want = np.asarray(jp.hamming_distance(jnp.asarray(words),
                                          jnp.asarray(words[:7])))
    h = tp.phash(t(small))
    np.testing.assert_array_equal(tp.hamming_distance(h, h[:7]).numpy(), want)
    np.testing.assert_array_equal(
        tp.hamming_distance(words, words[:7], device="cpu").numpy(), want)
    assert np.all(np.diag(want[:7]) == 0)


@pytest.mark.parametrize("shape", [(3, 480, 640), (2, 48, 56), (2, 20, 24)])
def test_resize_gray_32(shape):
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    want = np.asarray(jp.resize_gray_32(jnp.asarray(x)))
    got = tp.resize_gray_32(t(x)).numpy()
    assert got.shape == (shape[0], 32, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_phash_brightness_invariance_and_edits():
    """The reference tests' property on the port: a global gain / offset
    keeps the hash; an unrelated image is far."""
    x = procedural_images(2, 96, 128, seed=4)
    h = tp.phash(tp.resize_gray_32(t(x)))
    h2 = tp.phash(tp.resize_gray_32(t(x * 0.8 + 0.1)))
    d = tp.hamming_distance(h, h2).numpy()
    assert d[0, 0] <= 2 and d[1, 1] <= 2 and d[0, 1] > 10


def test_is_pure_image_matches():
    rng = np.random.default_rng(3)
    imgs = np.stack([np.full((48, 64), 100.0), rng.random((48, 64)) * 255,
                     np.full((48, 64), 300.0), np.where(
                         rng.random((48, 64)) < 0.97, 20.0, 200.0),
                     np.where(rng.random((48, 64)) < 0.9, 20.0, 200.0)]
                    ).astype(np.float32)
    want = np.asarray(jp.is_pure_image(jnp.asarray(imgs)))
    got = tp.is_pure_image(t(imgs)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tp.is_pure_image(t(imgs), ratio=0.5, bins=16).numpy(),
        np.asarray(jp.is_pure_image(jnp.asarray(imgs), ratio=0.5, bins=16)))


# -------------------------------------------------------------------- detect

def _head(seed, b=6, h=22, w=22, nc=80):
    """A seeded FastestDet head with planted strong boxes, some
    overlapping neighbours of the same class."""
    rng = np.random.default_rng(seed)
    head = (rng.normal(size=(b, h, w, 5 + nc)) * 2).astype(np.float32)
    head[..., 0] -= 1.0
    for i in range(b):
        for _ in range(6):
            y, x = rng.integers(0, h - 1, 2)
            c = rng.integers(nc)
            for dx in (0, 1):
                head[i, y, x + dx, 0] = 6.0 - 2 * dx
                head[i, y, x + dx, 5 + c] = 9.0
    return head


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_fastestdet_matches(seed):
    head = _head(seed)
    want = jd.decode_fastestdet(jnp.asarray(head), max_dets=64,
                                score_threshold=0.5)
    got = td.decode_fastestdet(t(head), max_dets=64, score_threshold=0.5)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


@pytest.mark.parametrize("class_aware", [True, False])
@pytest.mark.parametrize("iou", [0.35, 0.1])
def test_nms_keep_masks_bitwise(class_aware, iou):
    head = _head(2)
    want = jd.nms(jd.decode_fastestdet(jnp.asarray(head),
                                       score_threshold=0.5),
                  iou_threshold=iou, class_aware=class_aware)
    got = td.nms(td.decode_fastestdet(t(head), score_threshold=0.5),
                 iou_threshold=iou, class_aware=class_aware)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 0 < int(got.valid.sum()) < int(td.decode_fastestdet(
        t(head), score_threshold=0.5).valid.sum())


def test_detect_reference_scene():
    """tests/test_apps2.py's scene: the overlapping same-class box is
    suppressed, the empty image keeps none."""
    head = np.full((2, 8, 8, 8), -6.0, np.float32)
    head[0, 2, 3, 0] = 6.0
    head[0, 2, 3, 3:5] = 0.0
    head[0, 2, 3, 6] = 8.0
    head[0, 2, 4, 0] = 3.0
    head[0, 2, 4, 3:5] = 0.0
    head[0, 2, 4, 6] = 8.0
    dets = td.decode_fastestdet(t(head), score_threshold=0.4)
    out = td.nms(dets, iou_threshold=0.3)
    want = jd.nms(jd.decode_fastestdet(jnp.asarray(head),
                                       score_threshold=0.4),
                  iou_threshold=0.3)
    assert int(dets.valid[0].sum()) == 2
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(want.valid))
    assert int(out.valid[0].sum()) == 1 and int(out.valid[1].sum()) == 0


def test_iou_matches():
    rng = np.random.default_rng(4)
    a = np.sort(rng.random((2, 16, 4)).astype(np.float32).reshape(
        2, 16, 2, 2), axis=2).transpose(0, 1, 3, 2).reshape(2, 16, 4)
    for i in range(2):
        np.testing.assert_allclose(
            td._iou(t(a[i]), t(a[i])).numpy(),
            np.asarray(jd._iou(jnp.asarray(a[i]), jnp.asarray(a[i]))),
            rtol=0, atol=1e-6)


# --------------------------------------------------------------- motion area

def _pip_clip(seed, t_=12, h=72, w=96, box=(20, 14, 68, 50)):
    rng = np.random.default_rng(seed)
    frames = np.full((t_, h, w), 0.5, np.float32)
    frames += rng.normal(0, 0.01, frames.shape).astype(np.float32)
    x1, y1, x2, y2 = box
    for i in range(t_):
        frames[i, y1:y2, x1:x2] = rng.random((y2 - y1, x2 - x1))
    return frames


@pytest.mark.parametrize("seed", [0, 1])
def test_motion_area_matches(seed):
    frames = _pip_clip(seed)
    want = jm.detect_motion_area(jnp.asarray(frames))
    got = tm.detect_motion_area(t(frames))
    tol = 8 * EPS * (frames.shape[1] + 5)
    np.testing.assert_allclose(got.motion_mask.numpy(),
                               np.asarray(want.motion_mask), rtol=0, atol=tol)
    np.testing.assert_array_equal(got.box.numpy(), np.asarray(want.box))
    assert abs(float(got.coverage) - float(want.coverage)) < 1e-5
    x1, y1, x2, y2 = got.box.tolist()
    assert abs(x1 - 20) <= 4 and abs(y1 - 14) <= 4 and abs(x2 - 68) <= 4


def test_motion_area_reference_scene():
    """tests/test_apps2.py's flickering inner region."""
    rng = np.random.default_rng(0)
    frames = np.zeros((10, 64, 80), np.float32) + 0.5
    for i in range(10):
        frames[i, 16:40, 20:60] = rng.random((24, 40))
    want = jm.detect_motion_area(jnp.asarray(frames))
    got = tm.detect_motion_area(t(frames))
    np.testing.assert_array_equal(got.box.numpy(), np.asarray(want.box))
    assert float(got.coverage) > 0.8


def test_box_blur_matches():
    x = np.random.default_rng(5).random((40, 52)).astype(np.float32)
    for r in (1, 2, 4):
        np.testing.assert_allclose(
            tm._box_blur(t(x), r).numpy(),
            np.asarray(jm._box_blur(jnp.asarray(x), r)), rtol=0,
            atol=8 * EPS * (x.shape[0] + 2 * r + 1))


def test_find_topk_boxes_matches():
    frames = _pip_clip(3)
    rng = np.random.default_rng(9)
    for i in range(frames.shape[0]):
        frames[i, 56:68, 4:16] = rng.random((12, 12))
    want = jm.find_topk_boxes(jnp.asarray(frames), 3)
    got = tm.find_topk_boxes(t(frames), 3)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)


# --------------------------------------------------------------------- pupil

def _eyes(seed, n=6, h=96, w=128, noise=0.01):
    """render_eye crops at seeded centres, axes and angles, plus low
    seeded noise that breaks the exact ties of piecewise-constant
    images."""
    rng = np.random.default_rng(seed)
    eyes = []
    for _ in range(n):
        eyes.append(jpp.render_eye(
            h, w, cx=float(rng.uniform(40, w - 40)),
            cy=float(rng.uniform(35, h - 35)), a=float(rng.uniform(9, 15)),
            b=float(rng.uniform(7, 11)), angle=float(rng.uniform(-1, 1)),
            specular=bool(rng.random() < 0.7)))
    x = np.stack(eyes) + rng.normal(0, noise, (n, h, w)).astype(np.float32)
    return np.clip(x, 0, 1).astype(np.float32)


def test_render_eye_is_a_copy():
    for kw in (dict(), dict(cx=50, cy=40, a=10, b=8, angle=-0.5),
               dict(specular=False)):
        np.testing.assert_array_equal(tpp.render_eye(**kw),
                                      jpp.render_eye(**kw))


def test_remove_specular_matches():
    x = _eyes(0)
    np.testing.assert_allclose(
        tpp.remove_specular(t(x)).numpy(),
        np.asarray(jpp.remove_specular(jnp.asarray(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_coarse_centre_up_to_near_tie_responses(seed):
    x = np.asarray(jpp.remove_specular(jnp.asarray(_eyes(seed))))
    want_c, want_r = (np.asarray(a) for a in jpp.coarse_pupil_center(
        jnp.asarray(x)))
    got_c, got_r = (a.numpy() for a in tpp.coarse_pupil_center(t(x)))
    # the responses themselves, radius by radius
    ii = jnp.pad(jnp.cumsum(jnp.cumsum(jnp.asarray(x), 1), 2),
                 ((0, 0), (1, 0), (1, 0)))
    near = 0
    for r, r2, yy, xx, resp in tpp._haar_responses(t(x), tpp.RADII):
        yy, xx = yy.numpy(), xx.numpy()
        want = np.asarray(jpp._box_mean(ii, yy, xx, 2 * r2, 2 * r2)
                          - jpp._box_mean(ii, yy + r2 - r, xx + r2 - r,
                                          2 * r, 2 * r))
        np.testing.assert_allclose(resp.numpy(), want, rtol=0, atol=1e-5)
        # where the argmax moved, the port's pick must be a near tie
        i_t, i_j = resp.numpy().argmax(1), want.argmax(1)
        rows = np.arange(len(want))
        moved = i_t != i_j
        assert np.all(want[rows, i_j][moved] - want[rows, i_t][moved]
                      < 1e-5)
        near += int(moved.sum())
    same = np.all(got_c == want_c, 1) & (got_r == want_r)
    assert np.all(same) or near > 0, (got_c, want_c)
    assert near == 0                   # the noise leaves no near tie here


def test_otsu_threshold_matches():
    x = _eyes(2)
    mask = np.zeros(x.shape, bool)
    mask[:, 10:80, 20:110] = True
    np.testing.assert_array_equal(
        tpp._otsu_threshold(t(x), t(mask)).numpy(),
        np.asarray(jpp._otsu_threshold(jnp.asarray(x), jnp.asarray(mask))))


def test_conic_solve_matches_lstsq():
    rng = np.random.default_rng(6)
    ang = rng.uniform(0, 2 * np.pi, (16, 5))
    pts = np.stack([1.3 * np.cos(ang), 0.8 * np.sin(ang)], -1) + \
        rng.normal(0, 0.02, (16, 5, 2))
    pts[3, 1] = pts[3, 0]                   # a repeated point: rank 4
    pts[4, :, 1] = 0.0                      # collinear: rank deficient
    pts = pts.astype(np.float32)
    got = tpp._conic_from_points(t(pts)).numpy()
    want = np.stack([np.asarray(jpp._conic_from_points(jnp.asarray(p)))
                     for p in pts])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    res = tpp._conic_residual(t(got), t(pts)).numpy()
    want_res = np.stack([np.asarray(jpp._conic_residual(
        jnp.asarray(c), jnp.asarray(p))) for c, p in zip(want, pts)])
    np.testing.assert_allclose(res, want_res, rtol=1e-3, atol=1e-4)


def _jax_picks(key, valid, n_trials):
    """The picks `cvt_tpu.find_pupil` draws: split the key per image,
    then per trial, then choice(replace=False, p=valid/sum)."""
    n_edge = valid.shape[1]
    out = []
    for bi, k in enumerate(jax.random.split(key, valid.shape[0])):
        p = jnp.asarray(valid[bi], jnp.float32)
        p = p / jnp.maximum(p.sum(), 1)
        out.append(np.stack([
            np.asarray(jax.random.choice(kk, n_edge, (5,), replace=False,
                                         p=p))
            for kk in jax.random.split(k, n_trials)]))
    return torch.from_numpy(np.stack(out)).long()


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_pupil_on_jax_picks_matches(seed):
    x = _eyes(seed)
    key = jax.random.PRNGKey(seed + 1)
    want = jpp.find_pupil(key, jnp.asarray(x), n_trials=32)
    edges = tpp.pupil_edges(t(x))
    got = tpp.fit_pupil(edges, _jax_picks(key, edges.valid.numpy(), 32))
    np.testing.assert_array_equal(got.n_inliers.numpy(),
                                  np.asarray(want.n_inliers))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    np.testing.assert_allclose(got.center.numpy(), np.asarray(want.center),
                               rtol=0, atol=1e-4)
    assert got.ok.all()


def test_find_pupil_reference_scenes():
    """tests/test_apps3.py's eyes through the port's own sampler."""
    eyes = np.stack([tpp.render_eye(cx=64, cy=48, a=14, b=10, angle=0.3),
                     tpp.render_eye(cx=50, cy=40, a=10, b=8, angle=-0.5)])
    res = tpp.find_pupil(torch.Generator().manual_seed(1), t(eyes))
    assert bool(res.ok.all())
    np.testing.assert_allclose(res.center.numpy(), [[64, 48], [50, 40]],
                               atol=4.0)
    a0 = np.sort(res.axes[0].numpy())[::-1]
    assert 9.0 < a0[0] < 20.0 and 6.0 < a0[1] < 15.0


def test_sampler_draws_five_distinct_valid_edges():
    valid = torch.zeros((3, 128), dtype=torch.bool)
    valid[0, :40] = True
    valid[1, 7:100:3] = True
    valid[2, :6] = True
    picks = tpp.sample_edge_picks(torch.Generator().manual_seed(0), valid, 50)
    assert picks.shape == (3, 50, 5)
    for b in range(3):
        p = picks[b].numpy()
        assert all(len(set(row)) == 5 for row in p)
        assert valid[b][p].all()
    again = tpp.sample_edge_picks(torch.Generator().manual_seed(0), valid, 50)
    assert torch.equal(picks, again)
