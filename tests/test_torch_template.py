"""The port's template / logo / video object matching and video reader
(`cvt_tpu_torch.apps.template_match`, `apps.video_match`, `io.video`)
held to `cvt_tpu` on the same seeded inputs, on the CPU.

Tolerances: octave_validate masks bitwise; HOG 1e-5; the affine patch
warp 1e-5; match_features with use_ransac=False on `cvt_tpu`'s own
features carried across: inlier counts and hits equal (matching, SVF
and the octave check are deterministic); with RANSAC (whose samples come
from a torch.Generator and cannot equal jax.random's) and with the
port's own extraction: the same hits on tests/test_apps2.py's and
tests/test_apps3.py's scenes. The logo pack loads in the other package
and detects the same logos. Decoded frames equal `cvt_tpu`'s reader's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from cvt_tpu.apps import template_match as jt
from cvt_tpu.apps import video_match as jv
from cvt_tpu.io import video as jvid
from cvt_tpu_torch.apps import template_match as tt
from cvt_tpu_torch.apps import video_match as tv
from cvt_tpu_torch.features.covdet import SiftFeatures
from cvt_tpu_torch.io import video as tvid


def _have_cv2():
    try:
        import cv2  # noqa: F401
        return True
    except Exception:
        return False


def t(a):
    return torch.from_numpy(np.array(a))


def _bandlimited(rng, shape, sigma):
    x = gaussian_filter(rng.random(shape).astype(np.float32), sigma)
    x -= x.min()
    return x / max(float(x.max()), 1e-6)


def _scene(seed):
    """tests/test_apps2.py's template scene: frame 0 holds the template,
    frame 1 is unrelated."""
    rng = np.random.default_rng(seed)
    tmpl = _bandlimited(rng, (64, 64), 2.0)
    f0 = _bandlimited(rng, (128, 128), 2.0) * 0.2
    f0[32:96, 32:96] = tmpl
    f1 = _bandlimited(np.random.default_rng(seed + 99), (128, 128), 2.0)
    return tmpl, np.stack([f0, f1])


def _carry(f) -> SiftFeatures:
    return SiftFeatures(*(t(np.asarray(a)) for a in (
        f.frames, f.descriptors, f.response, f.valid)))


def test_octave_validate_matches():
    rng = np.random.default_rng(0)
    s1 = rng.uniform(1, 4, (6, 40)).astype(np.float32)
    s2 = (s1 * 2.0 ** rng.integers(-1, 2, (6, 40))
          * rng.uniform(0.9, 1.1, (6, 40))).astype(np.float32)
    s2[2, :30] = s1[2, :30] * 4.0
    valid = rng.random((6, 40)) < 0.8
    got = tt.octave_validate(t(s1), t(s2), t(valid)).numpy()
    for i in range(6):
        np.testing.assert_array_equal(got[i], np.asarray(jt.octave_validate(
            jnp.asarray(s1[i]), jnp.asarray(s2[i]), jnp.asarray(valid[i]))))
    # the reference test
    keep = tt.octave_validate(torch.ones(20) * 2.0, torch.cat(
        [torch.ones(15) * 4.0, torch.ones(5) * 0.5]),
        torch.ones(20, dtype=torch.bool)).numpy()
    assert keep[:15].all() and not keep[15:].any()


def test_hog_and_warp_match():
    rng = np.random.default_rng(1)
    imgs = rng.random((3, 70, 90)).astype(np.float32)
    np.testing.assert_allclose(
        tt.hog_descriptor(t(imgs)).numpy(),
        np.asarray(jt.hog_descriptor(jnp.asarray(imgs))), rtol=0, atol=1e-5)
    models = np.array([[[1.0, 0.1, 5.5], [-0.05, 0.9, 3.25]],
                       [[0.8, 0.0, -4.0], [0.0, 0.8, 60.0]],
                       [[1.2, -0.3, 10.0], [0.3, 1.2, 2.0]]], np.float32)
    got = tt._warp_affine_patch(t(imgs), t(models), 24, 32).numpy()
    for i in range(3):
        np.testing.assert_allclose(got[i], np.asarray(jt._warp_affine_patch(
            jnp.asarray(imgs[i]), jnp.asarray(models[i]), 24, 32)),
            rtol=0, atol=1e-5)


@pytest.mark.parametrize("octave", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_match_features_counts_without_ransac(seed, octave):
    """`cvt_tpu`'s template and frame features carried across: matching,
    SVF and the octave check give the same inlier counts."""
    tmpl, frames = _scene(seed)
    jm = jt.TemplateMatcher(tmpl, min_matches=8, use_ransac=False,
                            use_octave_check=octave)
    jf = jt.extract_sift(jnp.asarray(frames), max_features=256,
                         rootsift=True)
    want = jm.match_features(jf)
    tm = tt.TemplateMatcher(features=_carry(jm.tmpl), template_shape=(64, 64),
                            min_matches=8, use_ransac=False,
                            use_octave_check=octave)
    got = tm.match_features(_carry(jf))
    np.testing.assert_array_equal(got.n_inliers, want.n_inliers)
    np.testing.assert_array_equal(got.hits, want.hits)
    assert got.hits[0] and not got.hits[1]


@pytest.mark.parametrize("seed", [0, 1])
def test_match_frames_hits_with_ransac(seed):
    tmpl, frames = _scene(seed)
    want = jt.TemplateMatcher(tmpl, min_matches=8, use_octave_check=False
                              ).match_frames(frames)
    got = tt.TemplateMatcher(tmpl, min_matches=8, use_octave_check=False,
                             device="cpu").match_frames(frames)
    np.testing.assert_array_equal(got.hits, want.hits)
    assert got.hits[0] and got.n_inliers[0] > got.n_inliers[1]
    # the affine model maps the template's corner near (32, 32)
    np.testing.assert_allclose(got.models[0] @ [0, 0, 1], [32, 32], atol=2.0)


def test_hog_secondary_decision():
    """tests/test_apps2.py: with the SIFT bar out of reach, the HOG
    distance of the affine-matched subwindow decides."""
    tmpl, frames = _scene(0)
    strict = tt.TemplateMatcher(tmpl, min_matches=10_000,
                                use_octave_check=False, device="cpu")
    assert not strict.match_frames(frames).hits.any()
    got = tt.TemplateMatcher(tmpl, min_matches=10_000, use_octave_check=False,
                             hog_threshold=0.8, device="cpu"
                             ).match_frames(frames)
    want = jt.TemplateMatcher(tmpl, min_matches=10_000,
                              use_octave_check=False, hog_threshold=0.8
                              ).match_frames(frames)
    np.testing.assert_array_equal(got.hits, want.hits)
    assert got.hog_dist[0] < got.hog_dist[1]
    assert got.hits[0] and not got.hits[1]
    np.testing.assert_allclose(got.hog_dist[1], want.hog_dist[1], atol=0.05)


def _logo_frames():
    tmpl, frames = _scene(2)
    rng = np.random.default_rng(7)
    f0 = _bandlimited(rng, (128, 128), 2.0) * 0.2
    f0[16:80, 40:104] = tmpl
    return tmpl, np.stack([f0, frames[1]])


def test_logo_pack_both_ways(tmp_path):
    tmpl, frames = _logo_frames()
    other = _bandlimited(np.random.default_rng(8), (64, 64), 2.0)
    kw = dict(min_matches=8, use_octave_check=False)
    jdet = jt.LogoDetector({"acme": [tmpl], "other": [other]}, **kw)
    want = jdet.detect(frames)
    assert "acme" in want[0] and "acme" not in want[1]
    jpath = str(tmp_path / "jax_pack.npz")
    jdet.save(jpath)
    loaded = tt.LogoDetector.load(jpath, device="cpu")
    assert [m.template_shape for m in loaded.matchers["acme"]] == [(64, 64)]
    got = loaded.detect(frames)
    assert [set(d) for d in got] == [set(d) for d in want]

    tdet = tt.LogoDetector({"acme": [tmpl], "other": [other]},
                           device="cpu", **kw)
    tpath = str(tmp_path / "torch_pack.npz")
    tdet.save(tpath)
    own = tdet.detect(frames)
    z_t, z_j = np.load(tpath), np.load(jpath)
    assert sorted(z_t.files) == sorted(z_j.files)
    np.testing.assert_array_equal(z_t["t0_thr"], z_j["t0_thr"])
    back = jt.LogoDetector.load(tpath)
    assert [set(d) for d in back.detect(frames)] == [set(d) for d in own]
    assert [set(d) for d in own] == [set(d) for d in want]
    again = tt.LogoDetector.load(tpath, device="cpu").detect(frames)
    assert again == own


@pytest.mark.skipif(not _have_cv2(), reason="cv2 unavailable")
def test_video_reader_matches_reference(tmp_path):
    frames = np.random.default_rng(3).random((8, 48, 64)).astype(np.float32)
    p = str(tmp_path / "clip.mp4")
    jvid.write_video(p, frames, fps=10.0)
    buf = open(p, "rb").read()
    for src, kw in ((p, {}), (buf, dict(frame_stride=2)),
                    (p, dict(gray=False)), (p, dict(target_size=(24, 32)))):
        want = list(jvid.VideoReader(src, **kw))
        got = list(tvid.VideoReader(src, **kw))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    r = tvid.VideoReader(p)
    assert [n for _, n in r.batches(3)] == [3, 3, 2]
    r.release()
    tvid.write_video(str(tmp_path / "own.mp4"), frames, fps=10.0)
    assert len(list(jvid.VideoReader(str(tmp_path / "own.mp4")))) == 8


def test_native_decoder_or_clear_error(tmp_path):
    """The native in-memory decoder is built by path into the port's
    _build/; where libav is missing the helper raises NativeBuildError
    (and VideoReader goes on to cv2)."""
    from cvt_tpu_torch.native import NativeBuildError, available, build
    if not available("ffdecode"):
        with pytest.raises(NativeBuildError):
            build("ffdecode")
        pytest.skip("libav* not available on this machine")
    if not _have_cv2():
        pytest.skip("cv2 unavailable to write the clip")
    frames = np.random.default_rng(4).random((6, 48, 64)).astype(np.float32)
    p = str(tmp_path / "clip.mp4")
    jvid.write_video(p, frames, fps=10.0)
    r = tvid.VideoReader(open(p, "rb").read())
    assert r._native is not None and r._tmp is None      # no temp file
    assert r.fps == 0.0 and r.frame_count == 0
    mem = list(r)
    r.release()
    want = list(jvid.VideoReader(p))
    assert len(mem) == len(want) == 6
    for a, b in zip(mem, want):
        np.testing.assert_array_equal(a, b)


def test_build_helper_rebuilds_and_reports(tmp_path, monkeypatch):
    from cvt_tpu_torch import native
    with pytest.raises(native.NativeBuildError, match="no native source"):
        native.build("no_such_component")
    monkeypatch.setenv("CXX", "no-such-compiler-x")
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    (tmp_path / "tiny.cc").write_text('extern "C" int tiny() { return 7; }\n')
    with pytest.raises(native.NativeBuildError, match="not found"):
        native.build("tiny")
    monkeypatch.setenv("CXX", "g++")
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    path = native.build("tiny")
    first = __import__("os").path.getmtime(path)
    assert native.build("tiny") == path
    assert __import__("os").path.getmtime(path) == first   # not rebuilt


def _textured_frames(rng, t_=6, h=64, w=80):
    frames = np.stack([_bandlimited(rng, (h, w), 3.0) * 0.3
                       for _ in range(t_)])
    patch = _bandlimited(rng, (32, 32), 1.5)
    for i in (2, 4):
        frames[i, 16:48, 24:56] = patch
    return frames, patch


def test_video_object_matcher_matches_reference(tmp_path):
    frames, patch = _textured_frames(np.random.default_rng(0))
    want = jv.VideoObjectMatcher(patch, min_inliers=8, max_features=128
                                 ).match_frames(frames,
                                                key=jax.random.PRNGKey(0))
    m = tv.VideoObjectMatcher(patch, min_inliers=8, max_features=128,
                              device="cpu")
    got = m.match_frames(frames)
    assert got.n_frames == want.n_frames == 6
    np.testing.assert_array_equal(got.frame_ids, want.frame_ids)
    assert {2, 4} <= set(got.frame_ids.tolist())
    if not _have_cv2():
        pytest.skip("cv2 unavailable to write the clip")
    p = str(tmp_path / "clip.mp4")
    jvid.write_video(p, frames, fps=25.0)
    # cvt_tpu's match_video reads `fps` from a capture its native path
    # never opens; its frames through its own reader stand in
    decoded = np.stack(list(jvid.VideoReader(p)))
    want_v = jv.VideoObjectMatcher(patch, min_inliers=8, max_features=128
                                   ).match_frames(decoded)
    for src in (p, open(p, "rb").read()):
        got_v = m.match_video(src)
        assert got_v.n_frames == 6
        np.testing.assert_array_equal(got_v.frame_ids, want_v.frame_ids)
        assert len(got_v.models) == len(got_v.frame_ids)
