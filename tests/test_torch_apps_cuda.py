"""The features / apps slice on the card against the same code on the
CPU (`features.{lines,embedding,text}`, `apps.{phash,detect,motion_area,
pupil,template_match,video_match}`).

Marked `cuda`: every test takes the `card` fixture, which skips when
torch.cuda.is_available() is false (decided in the fixture, never at
import). Needs no JAX:
    python -m pytest tests/test_torch_apps_cuda.py --noconftest -m cuda

Tolerances (TF32 off for products and convolutions): phash bitwise but
for bits within 1e-5 of their block's mean (counted), resize 1e-5;
decode 1e-6 and NMS keep masks bitwise; the motion mask within 8 ulp of
the largest cumulative sum, the box bitwise; pupil centres 1e-4 px with
equal inlier counts on the same picks; line labels bitwise on the same
angles, rectangles within tests/_lines_tolerance.py's bounds but for at
most 2 segments per component that an ulp of arctan2 joins otherwise;
CNN embeddings 1e-4 relative; text embeddings 1e-6; template matching
the same hits and, without RANSAC, the same inlier counts.
"""

import numpy as np
import pytest
import torch

from cvt_tpu_torch.apps import detect, motion_area, pupil, template_match
from cvt_tpu_torch.apps import video_match
from cvt_tpu_torch.features import embedding, lines, text
from cvt_tpu_torch.features.covdet import extract_sift
from cvt_tpu_torch.io.datasets import procedural_images

pytestmark = pytest.mark.cuda
EPS = float(np.finfo(np.float32).eps)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def both(fn, x):
    """fn on the CPU tensor and on its copy on the card -> (cpu, card)."""
    c = torch.from_numpy(np.ascontiguousarray(x))
    return fn(c), fn(c.cuda())


def test_phash_card_vs_cpu(card):
    import importlib
    ph = importlib.import_module("cvt_tpu_torch.apps.phash")
    x = procedural_images(64, 96, 128, seed=1)
    cpu, gpu = both(lambda a: ph.resize_gray_32(a), x)
    np.testing.assert_allclose(gpu.cpu().numpy(), cpu.numpy(), atol=1e-5)
    coef = ph.dct_block(cpu).numpy()
    near = np.abs(coef - coef.mean(-1, keepdims=True)) < 1e-5
    h_cpu, h_gpu = ph.phash(cpu), ph.phash(cpu.cuda())
    diff = (h_cpu ^ h_gpu.cpu()).numpy().view(np.uint64)
    bits = np.unpackbits(diff.view(np.uint8), bitorder="little").reshape(
        near.shape).astype(bool)
    assert not np.any(bits & ~near)
    d = ph.hamming_distance(h_gpu, h_gpu[:8])
    assert d.device.type == "cuda" and int(torch.diagonal(d).max()) == 0
    pure = np.concatenate([np.full((4, 48, 64), 90.0, np.float32),
                           x[:4, :48, :64] * 255])
    np.testing.assert_array_equal(
        ph.is_pure_image(pure, device="cuda").cpu().numpy(),
        ph.is_pure_image(pure, device="cpu").numpy())


def test_detect_card_vs_cpu(card):
    rng = np.random.default_rng(0)
    head = (rng.normal(size=(32, 22, 22, 85)) * 2).astype(np.float32)
    head[..., 0] -= 1
    head[:, 5:8, 5:7, 0] = 6.0
    head[:, 5:8, 5:7, 9] = 9.0
    c = detect.nms(detect.decode_fastestdet(head, device="cpu",
                                            score_threshold=0.5))
    g = detect.nms(detect.decode_fastestdet(head, device="cuda",
                                            score_threshold=0.5))
    np.testing.assert_allclose(g.scores.cpu().numpy(), c.scores.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(g.boxes.cpu().numpy(), c.boxes.numpy(),
                               atol=1e-6)
    np.testing.assert_array_equal(g.classes.cpu().numpy(), c.classes.numpy())
    np.testing.assert_array_equal(g.valid.cpu().numpy(), c.valid.numpy())


def test_motion_area_card_vs_cpu(card):
    rng = np.random.default_rng(1)
    frames = np.full((20, 120, 160), 0.5, np.float32)
    for i in range(20):
        frames[i, 30:80, 40:120] = rng.random((50, 80))
    c = motion_area.detect_motion_area(frames, device="cpu")
    g = motion_area.detect_motion_area(frames, device="cuda")
    np.testing.assert_allclose(g.motion_mask.cpu().numpy(),
                               c.motion_mask.numpy(), rtol=0,
                               atol=8 * EPS * (120 + 5))
    np.testing.assert_array_equal(g.box.cpu().numpy(), c.box.numpy())
    assert motion_area.find_topk_boxes(frames, 2, device="cuda")[0] == \
        motion_area.find_topk_boxes(frames, 2, device="cpu")[0]


def test_pupil_card_vs_cpu(card):
    rng = np.random.default_rng(2)
    eyes = np.stack([pupil.render_eye(
        cx=float(rng.uniform(45, 85)), cy=float(rng.uniform(38, 58)),
        a=float(rng.uniform(9, 14)), b=float(rng.uniform(7, 10)),
        angle=float(rng.uniform(-1, 1))) for _ in range(16)])
    eyes = np.clip(eyes + rng.normal(0, 0.01, eyes.shape), 0, 1).astype(
        np.float32)
    ec = pupil.pupil_edges(eyes, device="cpu")
    eg = pupil.pupil_edges(eyes, device="cuda")
    np.testing.assert_array_equal(eg.valid.cpu().numpy(), ec.valid.numpy())
    picks = pupil.sample_edge_picks(torch.Generator().manual_seed(0),
                                    ec.valid, 64)
    rc = pupil.fit_pupil(ec, picks)
    rg = pupil.fit_pupil(eg, picks.cuda())
    np.testing.assert_array_equal(rg.n_inliers.cpu().numpy(),
                                  rc.n_inliers.numpy())
    np.testing.assert_allclose(rg.center.cpu().numpy(), rc.center.numpy(),
                               atol=1e-4)


def test_lines_card_vs_cpu(card):
    import _lines_tolerance as tol
    x = procedural_images(2, 120, 160, seed=5)
    ang, mag = lines._level_lines(torch.from_numpy(x))
    tau = float(np.float32(np.deg2rad(22.5)))
    lab_c, steps_c = lines._components(ang, mag > 0.02, tau)
    lab_g, steps_g = lines._components(ang.cuda(), mag.cuda() > 0.02, tau)
    np.testing.assert_array_equal(lab_g.cpu().numpy(), lab_c.numpy())
    assert steps_g == steps_c
    # from the card's own angles (arctan2 an ulp apart), pixels of a pair
    # within an ulp of tau may join otherwise: count the components they
    # touch; at most 2 segments each may lack a partner
    ag, mg = lines._level_lines(torch.from_numpy(x).cuda())
    lab_own = lines._components(ag, mg > 0.02, tau)[0].cpu()
    differ = lab_own != lab_c
    touched = len(set(lab_c[differ].tolist())
                  | set(lab_own[differ].tolist()))
    c = lines.detect_line_segments(x, device="cpu", max_segments=256)
    g = lines.detect_line_segments(x, device="cuda", max_segments=256)
    unmatched = sum(tol.unmatched_segments(
        *(tol._numpy(type(s)(*(a[b] for a in s))) for s in (g, c)))
        for b in range(2))
    assert unmatched <= 2 * touched, (unmatched, touched)


def test_embeddings_card_vs_cpu(card):
    imgs = (np.random.default_rng(3).random((8, 240, 320, 3)) * 255).astype(
        np.uint8)
    params, head = embedding._init_simple_cnn(
        torch.Generator().manual_seed(0), 128)
    c = embedding.EmbeddingExtractor._from_weights(params, head,
                                                   device="cpu")
    g = embedding.EmbeddingExtractor._from_weights(params, head,
                                                   device="cuda")
    ec = c.compute(imgs, batch_size=4).numpy()
    eg = g.compute(imgs, batch_size=4).cpu().numpy()
    np.testing.assert_allclose(eg, ec, atol=1e-4 * np.abs(ec).max())
    words = [f"w{i}" for i in range(50)]
    tc = text.TextEmbedder.random(words, dim=64, n_buckets=1000,
                                  device="cpu")
    tg = text.TextEmbedder.random(words, dim=64, n_buckets=1000,
                                  device="cuda")
    sents = ["w1 w2 zz", "w3", "unknown words here w7"]
    np.testing.assert_allclose(tg.embed_sentences(sents).cpu().numpy(),
                               tc.embed_sentences(sents).numpy(), atol=1e-6)
    ids = np.random.default_rng(4).integers(0, 50, (16, 8))
    mask = np.ones((16, 8), np.float32)
    np.testing.assert_allclose(
        text.embed_ids(tg.vectors, ids, mask).cpu().numpy(),
        text.embed_ids(tc.vectors, ids, mask).numpy(), atol=1e-6)


def test_template_match_card_vs_cpu(card, tmp_path):
    x = procedural_images(5, 240, 320, seed=6)
    tmpl = x[0, 60:156, 100:196].copy()
    frames = x[1:] * 0.5 + 0.25          # a mark on a softer scene
    frames[0, 80:176, 40:136] = tmpl
    frames[2, 20:116, 200:296] = tmpl
    fc = extract_sift(frames, max_features=256, rootsift=True, device="cpu")
    mc = template_match.TemplateMatcher(tmpl, device="cpu",
                                        use_ransac=False)
    mg = template_match.TemplateMatcher(
        features=type(fc)(*(a.cuda() for a in (
            mc.tmpl.frames, mc.tmpl.descriptors, mc.tmpl.response,
            mc.tmpl.valid))), template_shape=(96, 96), use_ransac=False)
    want = mc.match_features(fc)
    got = mg.match_features(type(fc)(*(a.cuda() for a in (
        fc.frames, fc.descriptors, fc.response, fc.valid))))
    np.testing.assert_array_equal(got.n_inliers, want.n_inliers)
    det = template_match.LogoDetector({"t": [tmpl]}, device="cuda")
    path = str(tmp_path / "pack.npz")
    det.save(path)
    hits_g = det.detect(frames)
    hits_c = template_match.LogoDetector.load(path, device="cpu").detect(
        frames)
    assert [set(h) for h in hits_g] == [set(h) for h in hits_c]
    assert "t" in hits_g[0] and "t" in hits_g[2] and "t" not in hits_g[1]
    vm = video_match.VideoObjectMatcher(tmpl, device="cuda")
    assert set(vm.match_frames(frames).frame_ids.tolist()) >= {0, 2}
