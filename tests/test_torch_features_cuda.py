"""The feature layer, SVF, RANSAC and the image-retrieval app on the card
against the same code on the CPU.

Marked `cuda`: every test takes the `card` fixture, which skips when
torch.cuda.is_available() is false (decided in the fixture, never at
import). Needs no JAX:
    python -m pytest tests/test_torch_features_cuda.py --noconftest -m cuda

Tolerances: extract_sift as the CPU parity tests hold the port to
cvt_tpu (>= 98% of the CPU's valid keypoints matched within 0.01 px and
1e-3 rad, descriptors at cosine >= 0.999): cuDNN's convolutions and the
card's products sum in other orders. SVF and RANSAC with the
combination sampler: inlier masks equal; RANSAC's uniform sampler draws
on the CPU generator, so the card fits the same samples. Retrieval on
the CPU's features: names and scores equal.
"""

import numpy as np
import pytest
import torch

from cvt_tpu_torch.apps import ImageRetrievalIndex
from cvt_tpu_torch.features import extract_sift
from cvt_tpu_torch.io.datasets import procedural_images
from cvt_tpu_torch.match import ransac, svf_inliers

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def match_keypoints(want, got, px=0.01, rad=1e-3):
    """Share of `want`'s valid keypoints matched by a valid keypoint of
    `got` and the smallest descriptor cosine over the matches."""
    matched, total, cos = 0, 0, 1.0
    for b in range(want.valid.shape[0]):
        vw, vg = want.valid[b].cpu().numpy(), got.valid[b].cpu().numpy()
        fw = want.frames[b].cpu().numpy()[vw]
        fg = got.frames[b].cpu().numpy()[vg]
        dw = want.descriptors[b].cpu().numpy()[vw]
        dg = got.descriptors[b].cpu().numpy()[vg]
        for i in range(len(fw)):
            total += 1
            ok = ((np.abs(fg[:, :3] - fw[i, :3]).max(1) <= px)
                  & (np.abs(np.angle(np.exp(1j * (fg[:, 3] - fw[i, 3]))))
                     <= rad))
            if ok.any():
                matched += 1
                cos = min(cos, float(dw[i] @ dg[np.argmax(ok)]))
    return matched / max(total, 1), cos


@pytest.mark.parametrize("cfg", [
    dict(), dict(first_octave=0, detector="hessian"),
    dict(n_orientations=2, rootsift=True), dict(dsp_num_scales=3),
    dict(affine_shape=True, first_octave=0, n_orientations=2,
         max_per_octave=48)])
def test_extract_sift_card_matches_cpu(card, cfg):
    imgs = procedural_images(2, 120, 160, seed=5)
    cpu = extract_sift(imgs, max_features=256, device="cpu", **cfg)
    gpu = extract_sift(imgs, max_features=256, device=card, **cfg)
    assert gpu.frames.device.type == "cuda"
    share, cos = match_keypoints(cpu, gpu)
    assert share >= 0.98 and cos >= 0.999, (share, cos)
    assert abs(int(gpu.n_valid.sum()) - int(cpu.n_valid.sum())) <= \
        0.02 * int(cpu.n_valid.sum())


def _planted(rng, c: int, n: int):
    p1 = rng.uniform(0, 300, (c, n, 2))
    a1 = rng.uniform(-np.pi, np.pi, (c, n))
    p2 = 1.2 * p1 + 5.0 + rng.normal(0, 0.3, p1.shape)
    a2 = a1 + rng.normal(0, 0.01, a1.shape)
    out = rng.random((c, n)) < 0.4
    p2[out] = rng.uniform(0, 300, (int(out.sum()), 2))
    a2[out] = rng.uniform(-np.pi, np.pi, int(out.sum()))
    valid = rng.random((c, n)) < 0.9
    return [torch.from_numpy(a.astype(np.float32)) for a in (p1, a1, p2, a2)
            ] + [torch.from_numpy(valid)]


def test_svf_and_ransac_card_match_cpu(card):
    rng = np.random.default_rng(2)
    args = _planted(rng, 10, 64)
    want = svf_inliers(*args)
    got = svf_inliers(*(a.to(card) for a in args))
    assert torch.equal(got.cpu(), want)
    p1, _, p2, _, valid = args
    for kw in (dict(sampler="combination", n_hypotheses=300),
               dict(n_hypotheses=64)):
        r_cpu = ransac(torch.Generator().manual_seed(0), p1, p2, valid,
                       threshold=8.0, **kw)
        r_gpu = ransac(torch.Generator().manual_seed(0), p1.to(card),
                       p2.to(card), valid.to(card), threshold=8.0, **kw)
        assert torch.equal(r_gpu.inliers.cpu(), r_cpu.inliers)
        torch.testing.assert_close(r_gpu.model.cpu(), r_cpu.model,
                                   rtol=1e-3, atol=1e-3)


def test_image_retrieval_card_matches_cpu(card):
    """Both indexes hold the CPU's features of 12 images; queries are
    the CPU's features of noisy copies of 4 of them."""
    rng = np.random.default_rng(3)
    imgs = procedural_images(12, 96, 128, seed=9)
    q = np.clip(imgs[::3] + rng.normal(0, 0.01, imgs[::3].shape), 0, 1)
    kw = dict(max_features=256, rootsift=True, device="cpu")
    feats, qf = extract_sift(imgs, **kw), extract_sift(q, **kw)
    cpu, gpu = ImageRetrievalIndex(device="cpu"), ImageRetrievalIndex(
        device=card)
    for i in range(12):
        cpu.add_image(feats, name=f"im{i}", batch_index=i)
        gpu.add_image(feats, name=f"im{i}", batch_index=i)
    for b in range(4):
        for rerank in (None, "svf", "ransac"):
            want = cpu.search(qf, batch_index=b, rerank=rerank, topk=5)
            got = gpu.search(qf, batch_index=b, rerank=rerank, topk=5)
            assert got[0] == want[0], (rerank, got, want)
            np.testing.assert_array_equal(got[1], want[1])
            assert got[0][0] == f"im{3 * b}"
