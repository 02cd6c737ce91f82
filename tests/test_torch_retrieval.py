"""The port's SVF, RANSAC and image-retrieval app (cvt_tpu_torch/match/
svf.py, match/ransac.py, apps/retrieval.py) held against cvt_tpu on the
same numpy inputs, on the CPU.

Tolerances: SVF inlier masks equal (the greedy clique reads integer
degrees); RANSAC with the deterministic combination sampler: inliers and
n_inliers equal, model 1e-4 (float32 normal equations and SVDs in other
LAPACK calls). The random samplers cannot draw jax.random's bits, so they
are held to properties: they recover a planted model. ImageRetrievalIndex
on tests/test_apps.py's scenes: names and scores equal for rerank None
and "svf" (votes and inlier counts are integers; the final order is a
stable sort, ties by candidate order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.apps import ImageRetrievalIndex as JIndex
from cvt_tpu.features import extract_sift as j_extract
from cvt_tpu.match.svf import svf_inliers as j_svf
from cvt_tpu_torch.apps import ImageRetrievalIndex
from cvt_tpu_torch.features import extract_sift
from cvt_tpu_torch.match.svf import svf_inliers

# the modules: both packages' `match` export a function of the same name
jr = importlib.import_module("cvt_tpu.match.ransac")
tr = importlib.import_module("cvt_tpu_torch.match.ransac")
t = torch.from_numpy


def _planted(rng, n: int, n_in: int, th=0.4, s=1.3, extent=200.0):
    """n matches (x, y, angle): n_in follow one similarity (0.3 px
    noise), the rest are random points and angles."""
    p1 = rng.uniform(0, extent, (n, 2))
    a1 = rng.uniform(-np.pi, np.pi, n)
    rot = s * np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    p2 = p1 @ rot.T + np.array([15.0, -9.0]) + rng.normal(0, 0.3, (n, 2))
    a2 = a1 + th + rng.normal(0, 0.01, n)
    out = rng.permutation(n)[n_in:]
    p2[out] = rng.uniform(0, extent, (len(out), 2))
    a2[out] = rng.uniform(-np.pi, np.pi, len(out))
    f = lambda a: a.astype(np.float32)
    return f(p1), f(a1), f(p2), f(a2), out


@pytest.mark.parametrize("n,n_in,masked", [(64, 40, False), (64, 20, True),
                                           (40, 40, False), (48, 5, True),
                                           (1, 1, False)])
def test_svf_inliers_equal_cvt_tpu(rng, n, n_in, masked):
    p1, a1, p2, a2, out = _planted(rng, n, n_in)
    valid = rng.random(n) < 0.85 if masked else np.ones(n, bool)
    want = np.asarray(j_svf(p1, a1, p2, a2, jnp.asarray(valid)))
    got = svf_inliers(t(p1), t(a1), t(p2), t(a2), t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    if n_in >= 20:
        assert got.sum() >= 0.8 * valid[np.setdiff1d(np.arange(n),
                                                     out)].sum()


def test_svf_inliers_batched_equals_one_by_one(rng):
    """Leading dims (candidates) run the greedy loop for all at once."""
    cases = [_planted(rng, 48, k) for k in (40, 25, 10, 0)]
    stack = [np.stack([c[i] for c in cases]) for i in range(4)]
    valid = rng.random((4, 48)) < 0.9
    got = svf_inliers(*map(t, stack), t(valid)).numpy()
    for b, c in enumerate(cases):
        np.testing.assert_array_equal(
            got[b], np.asarray(j_svf(*c[:4], jnp.asarray(valid[b]))))
    # numpy input without a mask goes to the CPU only when asked: tensors
    assert svf_inliers(*(t(a) for a in cases[0][:4])).shape == (48,)


def _affine_pairs(rng, n, n_in, noise=0.2):
    src = rng.uniform(0, 100, (n, 2))
    a = np.array([[1.1, 0.2, 5.0], [-0.15, 0.9, -3.0]])
    dst = src @ a[:, :2].T + a[:, 2] + rng.normal(0, noise, (n, 2))
    out = rng.permutation(n)[n_in:]
    dst[out] = rng.uniform(0, 100, (len(out), 2))
    return src.astype(np.float32), dst.astype(np.float32), a, out


@pytest.mark.parametrize("model,n,n_in,n_hyp", [
    ("affine", 12, 9, 220), ("affine", 24, 16, 300),
    ("similarity", 16, 11, 120), ("translation", 10, 7, 10),
    ("homography", 9, 8, 126), ("affine", 2, 2, 4)])
def test_ransac_combination_equals_cvt_tpu(rng, model, n, n_in, n_hyp):
    """The combination sampler is deterministic: both packages fit the
    same minimal sets. The last case has fewer points than a minimal set:
    both degrade to repeated indices, and the model of that rank-deficient
    (regularised) solve depends on rounding in either package, so only
    its inliers and success are compared."""
    src, dst, _, _ = _affine_pairs(rng, n, n_in)
    valid = np.ones(n, bool)
    valid[-1] = n < 4
    kw = dict(model=model, threshold=1.5, n_hypotheses=n_hyp,
              sampler="combination", min_inliers=3)
    want = jr.ransac(jax.random.key(0), src, dst, jnp.asarray(valid), **kw)
    got = tr.ransac(None, t(src), t(dst), t(valid), **kw)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers)
    assert bool(got.success) == bool(want.success)
    if n >= 3:
        np.testing.assert_allclose(got.model.numpy(),
                                   np.asarray(want.model), rtol=1e-4,
                                   atol=1e-4)


def test_combination_samples_and_count():
    for n, mn, s in ((5, 2, 13), (4, 3, 4), (2, 3, 3)):
        np.testing.assert_array_equal(
            tr.combination_minimal_samples(s, mn, n).numpy(),
            np.asarray(jr.combination_minimal_samples(s, mn, n)))
        assert tr.n_combinations(n, mn) == jr.n_combinations(n, mn)


@pytest.mark.parametrize("sampler", ["uniform", "progressive", "preemptive"])
def test_random_samplers_recover_planted_affine(rng, sampler):
    """Uniform and PROSAC-style sampling (scores rank the inliers first)
    and preemptive RANSAC recover a planted affine under 40% outliers,
    batched over 3 problems; the same seed draws the same result."""
    cases = [_affine_pairs(rng, 60, 36) for _ in range(3)]
    src = np.stack([c[0] for c in cases])
    dst = np.stack([c[1] for c in cases])
    valid = np.ones((3, 60), bool)
    valid[:, :4] = False
    scores = None
    if sampler == "progressive":
        scores = np.stack([np.where(np.isin(np.arange(60), c[3]), 0.0,
                                    1.0) for c in cases]).astype(np.float32)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        if sampler == "preemptive":
            return tr.ransac_preemptive(g, t(src), t(dst), t(valid),
                                        threshold=1.5, n_hypotheses=256,
                                        n_survivors=32, n_probe=24)
        return tr.ransac(g, t(src), t(dst), t(valid), threshold=1.5,
                         n_hypotheses=128, scores=None if scores is None
                         else t(scores))
    res = run(3)
    assert res.model.shape == (3, 2, 3) and res.inliers.shape == (3, 60)
    for b, (_, _, a, out) in enumerate(cases):
        inl = np.setdiff1d(np.arange(4, 60), out)
        np.testing.assert_allclose(res.model[b].numpy(), a, atol=0.15)
        assert res.inliers[b].numpy()[inl].mean() >= 0.95
        assert not res.inliers[b].numpy()[out].any()
        assert not res.inliers[b].numpy()[:4].any()
        assert bool(res.success[b])
    again = run(3)
    assert torch.equal(again.inliers, res.inliers)


def test_progressive_samples_respect_rank_cutoff(rng):
    """Hypothesis 0 draws only from the 2*mn best-scored valid points; the
    last from every valid point; no draw picks an invalid point."""
    valid = rng.random(50) < 0.8
    scores = rng.random(50).astype(np.float32)
    picks = tr.progressive_minimal_samples(
        torch.Generator().manual_seed(1), 64, 3, t(valid),
        t(scores)).numpy()
    assert picks.shape == (64, 3)
    assert valid[picks].all()
    s = np.where(valid, scores, -np.inf)
    best6 = np.argsort(-s, kind="stable")[:6]
    assert np.isin(picks[0], best6).all()
    assert len(np.unique(picks)) > 20
    for row in picks:
        assert len(set(row.tolist())) == 3


def _scene(rng, seed_blobs):
    """tests/test_apps.py's scene generator."""
    img = np.zeros((96, 96), np.float32)
    yy, xx = np.mgrid[0:96, 0:96].astype(np.float32)
    for (cy, cx, s) in seed_blobs:
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img += 0.02 * rng.random((96, 96)).astype(np.float32)
    return np.clip(img, 0, 1)


SCENES = [[(30, 30, 4.0), (60, 70, 6.0), (70, 25, 3.0)],
          [(48, 48, 8.0), (20, 70, 3.5)],
          [(25, 50, 5.0), (70, 60, 4.0), (40, 20, 6.0)]]


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.default_rng(0)
    imgs = np.stack([_scene(rng, s) for s in SCENES])
    q = np.concatenate([_scene(np.random.default_rng(99 + i), SCENES[i])[None]
                        for i in range(3)])
    kw = dict(max_features=64, first_octave=0, rootsift=True)
    j = JIndex()
    port = ImageRetrievalIndex(device="cpu")
    feats = j_extract(imgs, **kw)
    for i in range(3):
        j.add_image(feats, name=f"scene{i}", batch_index=i)
        port.add_image(feats, name=f"scene{i}", batch_index=i)
    return j, port, j_extract(q, **kw), extract_sift(q, device="cpu", **kw)


@pytest.mark.parametrize("rerank", [None, "svf"])
@pytest.mark.parametrize("max_dist", [0.3, 0.1])
def test_image_retrieval_equals_cvt_tpu(scenes, rerank, max_dist):
    """Both indexes hold cvt_tpu's features of the scenes; each is queried
    with cvt_tpu's features of noisy re-renders: the same names and
    scores, and the source scene first."""
    j, port, qf, _ = scenes
    for b in range(3):
        kw = dict(topk=3, rerank=rerank, max_dist=max_dist, batch_index=b,
                  rerank_depth=3)
        names, scores = port.search(qf, **kw)
        want_names, want_scores = j.search(qf, **kw)
        assert names == want_names
        np.testing.assert_array_equal(scores, np.asarray(want_scores))
        if max_dist == 0.3:
            assert names[0] == f"scene{b}"


def test_image_retrieval_on_port_features(scenes):
    """The port's own features of the queries rank the source scene
    first with every rerank mode, and give cvt_tpu's names for rerank
    None and "svf" (the same extractor to 1e-5 and integer scores)."""
    j, port, qf, qt = scenes
    for b in range(3):
        for rerank in (None, "svf", "ransac"):
            names, scores = port.search(qt, topk=3, rerank=rerank,
                                        max_dist=0.3, batch_index=b,
                                        gen=torch.Generator().manual_seed(b))
            assert names[0] == f"scene{b}", (rerank, names, scores)
            assert np.isfinite(scores).all() and len(names) == 3
            if rerank != "ransac":
                want = j.search(qf, topk=3, rerank=rerank, max_dist=0.3,
                                batch_index=b)
                assert names == want[0]


def test_image_retrieval_empty_query_and_unknown_rerank(scenes):
    _, port, _, qt = scenes
    empty = type(qt)(qt.frames, qt.descriptors, qt.response,
                     torch.zeros_like(qt.valid))
    assert port.search(empty)[0] == []
    with pytest.raises(ValueError, match="unknown rerank"):
        port.search(qt, rerank="hough", max_dist=0.3)


def test_numpy_input_follows_device_rule(monkeypatch, rng):
    """numpy matches go to the card: without one SVF and RANSAC raise;
    CPU tensors stay on the CPU."""
    p1, a1, p2, a2, _ = _planted(rng, 16, 16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svf_inliers(p1, a1, p2, a2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.ransac(None, p1, p2)
    res = tr.ransac(None, t(p1), t(p2), model="similarity")
    assert res.inliers.device == torch.device("cpu")
    assert int(res.n_inliers) == 16
