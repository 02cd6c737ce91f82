"""The port's feature layer (cvt_tpu_torch/features/) held against
cvt_tpu.features on the same numpy inputs, on the CPU, stage by stage:
each stage is fed the upstream tensors that cvt_tpu computed, so that
rounding does not cascade.

Tolerances (float32 sums in other orders; the JAX convolutions and
products against PyTorch's):
- the upsampled base 1e-6; pyramid levels (gauss, DoG, gradients) 1e-5;
- detect_octave on cvt_tpu's DoG / Hessian stack: level and valid equal
  wherever the slot's score clears the k-th score by more than 1e-6;
  x / y / level within 1e-4, response within 1e-5 (relative to the
  stack's largest magnitude for the Hessian);
- orientations on cvt_tpu's gradients and keypoints: angles within
  1e-3 rad (circular) and the same slots valid, where the histogram's
  best O + 1 peaks differ by more than 1e-3 relative; descriptors on the
  same angles at cosine >= 0.9999;
- estimate_affine_shape 1e-4; root_sift 1e-6;
- the whole extract_sift: >= 98% of cvt_tpu's valid keypoints matched by
  a valid port keypoint within 0.01 px (x, y, sigma) and 1e-3 rad, whose
  descriptors agree at cosine >= 0.999.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.features import covdet as jcov
from cvt_tpu.features import descriptor as jdesc
from cvt_tpu.features import detect as jdet
from cvt_tpu.features import scale_space as jss
from cvt_tpu.features.affine import estimate_affine_shape as j_affine
from cvt_tpu.io.datasets import procedural_images as j_procedural
from cvt_tpu_torch.features import covdet as tcov
from cvt_tpu_torch.features import descriptor as tdesc
from cvt_tpu_torch.features import detect as tdet
from cvt_tpu_torch.features import scale_space as tss
from cvt_tpu_torch.features.affine import estimate_affine_shape as t_affine
from cvt_tpu_torch.features.pipeline import FeatureExtractionPipeline
from cvt_tpu_torch.io.database import FeatureDatabase
from cvt_tpu_torch.io.datasets import procedural_images


def t(x):
    return torch.from_numpy(np.array(x))


def n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, rtol=0.0):
    np.testing.assert_allclose(n(got), n(want), rtol=rtol, atol=tol)


@pytest.fixture(scope="module")
def images():
    return procedural_images(2, 64, 96, seed=1)


@pytest.fixture(scope="module")
def pyramids(images):
    """cvt_tpu's pyramids of `images` at first octave -1 and 0."""
    return {fo: jss.build_pyramid(images, first_octave=fo) for fo in (-1, 0)}


def test_procedural_images_equal_cvt_tpu():
    np.testing.assert_array_equal(procedural_images(3, 48, 80, seed=7),
                                  j_procedural(3, 48, 80, seed=7))


def test_upsample2_matches_jax_resize(images):
    """jax.image.resize 'linear' as F.interpolate bilinear (half-pixel
    centres, clamped borders): a 7 x 9 probe and the first octave -1 base
    of real images."""
    probe = np.random.default_rng(3).random((1, 7, 9)).astype(np.float32)
    for x in (probe, images):
        _close(tss._upsample2(t(x)), jss._upsample2(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("first_octave", [-1, 0])
def test_pyramid_levels(images, pyramids, first_octave):
    want = pyramids[first_octave]
    got = tss.build_pyramid(images, first_octave=first_octave, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.octave, g.step, g.sigmas) == (w.octave, w.step, w.sigmas)
        for name in ("gauss", "dog", "grad_dx", "grad_dy"):
            assert getattr(g, name).shape == getattr(w, name).shape
            _close(getattr(g, name), getattr(w, name), 1e-5)


def test_blur_and_gradients_of_one_stack():
    x = np.random.default_rng(4).random((2, 40, 56)).astype(np.float32)
    for sigma in (0.0, 0.8, 3.1):
        _close(tss._blur(t(x), sigma), jss._blur(jnp.asarray(x), sigma), 1e-6)
    lv = x.reshape(2, 1, 40, 56)
    for got, want in zip(tss._gradients(t(lv)),
                         jss._gradients(jnp.asarray(lv))):
        _close(got, want, 1e-7)


def _jax_scores(dog, peak, edge=10.0, border=4):
    """detect_octave's candidate scores [B, L*H*W], computed as cvt_tpu
    computes them (detect.py:87-112)."""
    b, l, h, w = dog.shape
    is_max = (dog >= jdet._window_max(dog)) & (dog > peak)
    is_min = (dog <= jdet._window_min(dog)) & (dog < -peak)
    r = lambda a, s, ax: jnp.roll(a, s, ax)
    dxx = r(dog, -1, 3) + r(dog, 1, 3) - 2 * dog
    dyy = r(dog, -1, 2) + r(dog, 1, 2) - 2 * dog
    dxy = 0.25 * (r(r(dog, -1, 2), -1, 3) + r(r(dog, 1, 2), 1, 3)
                  - r(r(dog, -1, 2), 1, 3) - r(r(dog, 1, 2), -1, 3))
    tr, det = dxx + dyy, dxx * dyy - dxy * dxy
    edge_ok = (det > 0) & (tr * tr * edge < (edge + 1.0) ** 2 * det)
    inb = np.zeros((l, h, w), bool)
    inb[1:l - 1, border:h - border, border:w - border] = True
    ok = (is_max | is_min) & edge_ok & inb
    return np.asarray(jnp.where(ok, jnp.abs(dog), 0.0)).reshape(b, -1)


def test_window_max_min_and_hessian(pyramids):
    for octv in pyramids[-1][:3]:
        d = octv.dog
        _close(tdet._window_max(t(d)), jdet._window_max(d), 0.0)
        _close(tdet._window_min(t(d)), jdet._window_min(d), 0.0)
        want = np.asarray(jdet.hessian_response(octv.gauss))
        _close(tdet.hessian_response(t(octv.gauss)), want,
               1e-6 * np.abs(want).max())


@pytest.mark.parametrize("detector", ["dog", "hessian"])
@pytest.mark.parametrize("octave,max_k", [(0, 48), (1, 48), (2, 512)])
def test_detect_octave_on_cvt_tpu_stack(pyramids, detector, octave, max_k):
    """Octaves 0-2 of the first octave -1 pyramid; K 48 cuts the
    candidates, K 512 exceeds the positions of small octaves (padding)."""
    octv = pyramids[-1][octave]
    peak = 5e-4 if detector == "hessian" else 0.02 / 3
    stack = (jdet.hessian_response(octv.gauss) if detector == "hessian"
             else octv.dog)
    k = min(max_k, int(np.prod(stack.shape[1:])))
    want = jdet.detect_octave(stack, max_k=k, peak_threshold=peak)
    got = tdet.detect_octave(t(stack), max_k=k, peak_threshold=peak)
    top = -np.sort(-_jax_scores(stack, peak), axis=1)[:, :k]
    clear = np.abs(top - top[:, -1:]) > 1e-6
    np.testing.assert_array_equal(n(got[5])[clear], n(want[5])[clear])
    np.testing.assert_array_equal(n(got[3])[clear], n(want[3])[clear])
    v = clear & n(want[5])
    assert v.sum() > 0
    scale = 1.0 if detector == "dog" else np.abs(n(stack)).max()
    for i in range(3):                       # x, y, refined level
        _close(n(got[i])[v], n(want[i])[v], 1e-4)
    _close(n(got[4])[v], n(want[4])[v], 1e-5 * scale)


@pytest.fixture(scope="module")
def flat_stage(images):
    """cvt_tpu's fast path up to the sampling (covdet.py:201-252) at first
    octave -1, K 64: the flat gradient stack, its octave metadata and the
    globally selected keypoints, all as numpy."""
    pyr = jss.build_pyramid(images, first_octave=-1)
    det, base, hs, ws, off = [], [], [], [], 0
    for oi, octv in enumerate(pyr):
        l, h, w = octv.grad_dx.shape[1:]
        x, y, lf, lev, resp, valid = jdet.detect_octave(
            octv.dog, max_k=min(64, l * h * w))
        det.append((x, y, lf, lev, resp, valid,
                    jnp.full(x.shape, oi, jnp.int32)))
        base.append(off)
        hs.append(h)
        ws.append(w)
        off += l * h * w
    cat = [jnp.concatenate(c, 1) for c in zip(*det)]
    score = jnp.where(cat[5], jnp.abs(cat[4]), -1.0)
    _, sel = jax.lax.top_k(score, 64)
    x, y, lf, lev, resp, valid, oct_i = (
        np.asarray(jnp.take_along_axis(c, sel, 1)) for c in cat)
    gf = np.asarray(jnp.concatenate(
        [jnp.stack([o.grad_dx.reshape(2, -1), o.grad_dy.reshape(2, -1)],
                   -1).reshape(2, -1) for o in pyr], 1))
    sig = np.asarray(1.6 * (2.0 ** (jnp.asarray(lf) / 3.0)))
    meta = [np.asarray(m, np.int32) for m in (base, hs, ws)]
    return gf, meta, oct_i, x, y, sig, lev, valid


def _hist_gap_ok(hist: torch.Tensor, o: int) -> np.ndarray:
    """Rows whose orientation peaks rank without near-ties: among the best
    o + 1 peak scores (as _orientation_peaks ranks them) no two real peaks
    lie within 1e-3 of the maximum of each other, and no local maximum
    lies within 1e-3 of the maximum of the 0.8 x maximum bar."""
    hmax = hist.amax(-1, keepdim=True)
    local = ((hist >= torch.roll(hist, 1, -1))
             & (hist >= torch.roll(hist, -1, -1)))
    s = torch.sort(torch.where(local & (hist >= 0.8 * hmax), hist, -1.0), -1,
                   descending=True)[0][:, :o + 1]
    tol = 1e-3 * hmax
    close = ((s[:, 1:] > 0) & (s[:, 1:] >= s[:, :-1] - tol)).any(-1)
    at_bar = (local & (torch.abs(hist - 0.8 * hmax) <= tol)).any(-1)
    return (~close & ~at_bar).numpy()


def _orient_hists(sample, x, y, sig, lev, oct_i, affine=None):
    return torch.cat(tdesc._orientation_rows(
        sample, t(x), t(y), t(sig), t(lev), t(oct_i), affine, 16,
        lambda h: h))


def _angles_close(got, want, tol=1e-3):
    d = np.abs(np.angle(np.exp(1j * (n(got) - n(want)))))
    assert d.max(initial=0.0) <= tol, d.max()


@pytest.mark.parametrize("n_orientations", [1, 2, 4])
def test_orientations_flat_on_cvt_tpu_stack(flat_stage, n_orientations):
    gf, meta, oct_i, x, y, sig, lev, valid = flat_stage
    want = jdesc.assign_orientations_multi_flat(
        gf, *meta, oct_i, x, y, sig, lev, valid,
        n_orientations=n_orientations)
    got = tdesc.assign_orientations_multi_flat(
        t(gf), *map(t, meta), t(oct_i), t(x), t(y), t(sig), t(lev),
        t(valid), n_orientations=n_orientations)
    sample = tdesc._Sampler(t(gf), *map(t, meta))
    rows = _hist_gap_ok(_orient_hists(sample, x, y, sig, lev, oct_i),
                        n_orientations).reshape(x.shape)
    assert rows[valid].mean() > 0.9
    np.testing.assert_array_equal(n(got[1])[rows], n(want[1])[rows])
    m = rows[..., None] & n(want[1])
    _angles_close(n(got[0])[m], n(want[0])[m])


@pytest.mark.parametrize("dsp_ratio", [1.0, 1.0 / 6.0, 3.0])
def test_descriptors_flat_on_cvt_tpu_angles(flat_stage, dsp_ratio):
    """Descriptors at cvt_tpu's keypoints and angles (its dominant peak),
    also at DSP's smallest and largest domain sizes."""
    gf, meta, oct_i, x, y, sig, lev, valid = flat_stage
    ang = np.asarray(jdesc.assign_orientations_multi_flat(
        gf, *meta, oct_i, x, y, sig, lev, valid, n_orientations=1)[0][..., 0])
    s = (sig * np.float32(dsp_ratio)).astype(np.float32)
    want = np.asarray(jdesc.sift_descriptors_flat(
        gf, *meta, oct_i, x, y, s, lev, ang, valid))
    got = tdesc.sift_descriptors_flat(
        t(gf), *map(t, meta), t(oct_i), t(x), t(y), t(s), t(lev), t(ang),
        t(valid)).numpy()
    assert got.shape == want.shape == x.shape + (128,)
    np.testing.assert_array_equal(got[~valid], 0.0)
    cos = np.sum(got[valid] * want[valid], -1)
    assert cos.min() >= 0.9999, cos.min()


@pytest.fixture(scope="module")
def octave_stage(pyramids):
    """Octave 0 of the first octave -1 pyramid: cvt_tpu's keypoints, its
    affine shapes and gradient fields, as numpy."""
    octv = pyramids[-1][1]
    x, y, lf, lev, _, valid = jdet.detect_octave(octv.dog, max_k=48)
    sig = 1.6 * (2.0 ** (lf / 3.0))
    aff = j_affine(octv.grad_dx, octv.grad_dy, x, y, sig, lev, valid)
    return tuple(np.asarray(a) for a in (
        octv.grad_dx, octv.grad_dy, x, y, sig, lev, valid, aff))


def test_estimate_affine_shape(octave_stage):
    dx, dy, x, y, sig, lev, valid, aff = octave_stage
    got = t_affine(t(dx), t(dy), t(x), t(y), t(sig), t(lev), t(valid))
    _close(got, aff, 1e-4)
    assert np.abs(aff[valid] - np.eye(2)).max() > 0.05   # not the identity
    for iters in (0, 2):
        _close(t_affine(t(dx), t(dy), t(x), t(y), t(sig), t(lev), t(valid),
                        iters=iters),
               j_affine(dx, dy, x, y, sig, lev, valid, iters=iters), 1e-4)


@pytest.mark.parametrize("affine", [False, True])
def test_per_octave_orientations_and_descriptors(octave_stage, affine):
    """assign_orientations, assign_orientations_multi and sift_descriptors
    on one octave's fields, with and without cvt_tpu's affine shapes."""
    dx, dy, x, y, sig, lev, valid, aff = octave_stage
    am = aff if affine else None
    ta = t(aff) if affine else None
    args = (x, y, sig, lev, valid)
    targs = tuple(map(t, args))
    sample = tdesc._Sampler(tdesc._interleave(t(dx), t(dy)),
                            *tdesc._one_octave(t(dx)))
    hists = _orient_hists(sample, x, y, sig, lev, np.zeros_like(lev), ta)
    rows = _hist_gap_ok(hists, 2).reshape(x.shape) & valid
    assert rows.sum() >= 0.9 * valid.sum()
    want1 = np.asarray(jdesc.assign_orientations(dx, dy, *args, affine=am))
    got1 = tdesc.assign_orientations(t(dx), t(dy), *targs, affine=ta)
    _angles_close(n(got1)[rows], want1[rows])
    np.testing.assert_array_equal(n(got1)[~valid], 0.0)
    want2 = jdesc.assign_orientations_multi(dx, dy, *args, n_orientations=2,
                                            affine=am)
    got2 = tdesc.assign_orientations_multi(t(dx), t(dy), *targs,
                                           n_orientations=2, affine=ta)
    np.testing.assert_array_equal(n(got2[1])[rows], n(want2[1])[rows])
    m = rows[..., None] & n(want2[1])
    _angles_close(n(got2[0])[m], n(want2[0])[m])
    want = np.asarray(jdesc.sift_descriptors(dx, dy, x, y, sig, lev, want1,
                                             valid, affine=am))
    got = tdesc.sift_descriptors(t(dx), t(dy), t(x), t(y), t(sig), t(lev),
                                 t(want1), t(valid), affine=ta).numpy()
    cos = np.sum(got[valid] * want[valid], -1)
    assert cos.min() >= 0.9999, cos.min()


def test_bilinear_sample_and_root_sift():
    rng = np.random.default_rng(8)
    img = rng.random((20, 30)).astype(np.float32)
    xs = rng.uniform(-3, 33, (50,)).astype(np.float32)
    ys = rng.uniform(-3, 23, (50,)).astype(np.float32)
    _close(tdesc.bilinear_sample(t(img), t(xs), t(ys)),
           jdesc.bilinear_sample(jnp.asarray(img), jnp.asarray(xs),
                                 jnp.asarray(ys)), 1e-6)
    d = rng.random((3, 5, 128)).astype(np.float32)
    d[0, 0] = 0.0
    _close(tdesc.root_sift(t(d)), jdesc.root_sift(jnp.asarray(d)), 1e-6)


EXTRACT_CASES = {
    "dog": dict(),
    "dog_octave0": dict(first_octave=0),
    "hessian": dict(detector="hessian"),
    "orientations2_rootsift": dict(n_orientations=2, rootsift=True),
    "dsp3": dict(dsp_num_scales=3),
    # the per-octave path, at first octave 0 (cvt_tpu compiles it once
    # per octave)
    "affine_orientations2": dict(affine_shape=True, first_octave=0,
                                 n_orientations=2, max_per_octave=24),
}


def match_keypoints(want, got, px=0.01, rad=1e-3):
    """Share of `want`'s valid keypoints matched by a valid keypoint of
    `got` (x, y, sigma within px, angle within rad), and the smallest
    descriptor cosine over the matches."""
    matched, total, cos = 0, 0, 1.0
    for b in range(n(want.valid).shape[0]):
        vw, vg = n(want.valid)[b], n(got.valid)[b]
        fw, fg = n(want.frames)[b][vw], n(got.frames)[b][vg]
        dw, dg = n(want.descriptors)[b][vw], n(got.descriptors)[b][vg]
        for i in range(len(fw)):
            total += 1
            ok = ((np.abs(fg[:, :3] - fw[i, :3]).max(1) <= px)
                  & (np.abs(np.angle(np.exp(1j * (fg[:, 3] - fw[i, 3]))))
                     <= rad))
            if ok.any():
                matched += 1
                cos = min(cos, float(dw[i] @ dg[np.argmax(ok)]))
    return matched / max(total, 1), cos, total


@pytest.mark.parametrize("case", sorted(EXTRACT_CASES))
def test_extract_sift_matches_cvt_tpu(images, case):
    cfg = EXTRACT_CASES[case]
    want = jcov.extract_sift(images, max_features=64, **cfg)
    got = tcov.extract_sift(images, max_features=64, device="cpu", **cfg)
    assert got.frames.shape == want.frames.shape
    assert got.descriptors.shape == want.descriptors.shape
    assert (got.affine is None) == (want.affine is None)
    share, cos, total = match_keypoints(want, got)
    assert total >= 48
    assert share >= 0.98, share
    assert cos >= 0.999, cos
    assert abs(int(got.n_valid.sum()) - int(np.asarray(want.n_valid).sum())) \
        <= 0.02 * total
    if got.affine is not None:
        v = got.valid.numpy()
        np.testing.assert_allclose(np.abs(np.linalg.det(
            got.affine.numpy()[v])), 1.0, rtol=1e-3)


def test_extract_sift_2d_input_and_unknown_detector(images):
    one = tcov.extract_sift(images[0], max_features=16, device="cpu")
    both = tcov.extract_sift(images, max_features=16, device="cpu")
    assert one.frames.shape == (1, 16, 4)
    # one image alone against the same in a batch of two: the batched
    # convolutions may sum in another order
    first = tcov.SiftFeatures(*(a[:1] for a in (
        both.frames, both.descriptors, both.response, both.valid)))
    share, cos, _ = match_keypoints(first, one)
    assert share >= 0.98 and cos >= 0.999, (share, cos)
    with pytest.raises(ValueError, match="unknown detector"):
        tcov.extract_sift(images, detector="harris", device="cpu")


def test_pipeline_rows_equal_extract_sift(images, tmp_path):
    """FeatureExtractionPipeline over ndarray sources (one reader, so the
    batches are [im0, im1] and [im2], the last partial) writes the valid
    rows of extract_sift over the same batches; a second run skips all."""
    imgs = np.concatenate([images, images[:1] * 0.5])
    with FeatureDatabase(str(tmp_path / "f.sqlite")) as db:
        pipe = FeatureExtractionPipeline(db, batch_size=2, max_features=32,
                                         n_reader_threads=1, device="cpu")
        stats = pipe.run([(f"im{i}", imgs[i]) for i in range(3)])
        assert (stats.n_images, stats.n_skipped, stats.n_failed) == (3, 0, 0)
        again = pipe.run([(f"im{i}", imgs[i]) for i in range(3)])
        assert again.n_skipped == 3
        feats = [tcov.extract_sift(imgs[s], max_features=32, device="cpu")
                 for s in (slice(0, 2), slice(2, 3))]
        for i, (f, b) in enumerate([(feats[0], 0), (feats[0], 1),
                                    (feats[1], 0)]):
            v = f.valid[b].numpy()
            iid = db.image_id(f"im{i}")
            np.testing.assert_array_equal(db.read_keypoints(iid),
                                          f.frames[b].numpy()[v])
            np.testing.assert_array_equal(db.read_descriptors(iid),
                                          f.descriptors[b].numpy()[v])
