"""The port's float32 convolutions and the ArcFace step on the card under
PyTorch's default flags, against the same code on the CPU.

cuDNN allows TF32 in float32 convolutions by default; the port runs every
`F.conv2d` under `ops.linalg.full_precision_conv()`, which sets full
float32 for the call and puts the caller's setting back. The `defaults`
fixture sets PyTorch's defaults (cuDNN convolutions TF32, float32 matrix
products full precision), as a caller that touches nothing has them, and
checks after each test that they are still set; it then restores what
the process had (other card fixtures turn TF32 off for the process). It
reads and writes cuDNN's flags through the per-operator API only: after
another fixture's legacy `allow_tf32 = False`, reading the legacy flag
while conv is "tf32" raises.

Inputs where TF32 would show: 64 input channels at unit scale (TF32's
10-bit mantissa puts ~1e-3 relative error on such a sum). Tolerances are
the existing card-against-CPU ones: the convolution itself 1e-5 of its
largest value (float32 sums in another order), CNN embeddings 1e-4
relative, remove_specular 1e-6 on [0, 1] images, pupil centres 1e-4 px
with equal inlier counts on the same picks; ArcFace gradients
max|diff| <= 1e-4 max|g|.

Marked `cuda`; the fixture skips without a card (decided in the fixture,
never at import). Needs no JAX:
    python -m pytest tests/test_torch_tf32_cuda.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from cvt_tpu_torch.apps import pupil
from cvt_tpu_torch.features import embedding
from cvt_tpu_torch.train import (arcface_loss, create_state, parameters,
                                 state_from_params)

pytestmark = pytest.mark.cuda


def _flags():
    return (torch.backends.cudnn.conv.fp32_precision,
            torch.backends.cudnn.rnn.fp32_precision,
            torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())


@pytest.fixture
def defaults():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = _flags()
    torch.backends.cudnn.conv.fp32_precision = "tf32"
    torch.backends.cudnn.rnn.fp32_precision = "tf32"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    want = _flags()
    try:
        yield
        assert _flags() == want, "a call left the TF32 flags changed"
    finally:
        conv, rnn, mm, prec = saved
        torch.backends.cudnn.conv.fp32_precision = conv
        torch.backends.cudnn.rnn.fp32_precision = rnn
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.set_float32_matmul_precision(prec)


def test_conv_64_channels_full_precision(defaults):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4, 64, 40, 48)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(128, 64, 3, 3))
                          / 24.0).astype(np.float32))
    for stride in (1, 2):
        c = embedding._conv(x, w, stride)
        g = embedding._conv(x.cuda(), w.cuda(), stride).cpu()
        np.testing.assert_allclose(g.numpy(), c.numpy(),
                                   atol=1e-5 * float(c.abs().max()))


def test_embedding_extractor_full_precision(defaults):
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


def test_remove_specular_and_find_pupil_full_precision(defaults):
    rng = np.random.default_rng(2)
    x = rng.random((8, 96, 128)).astype(np.float32)
    np.testing.assert_allclose(
        pupil.remove_specular(x, device="cuda").cpu().numpy(),
        pupil.remove_specular(x, device="cpu").numpy(), atol=1e-6)
    eyes = np.stack([pupil.render_eye(
        cx=float(rng.uniform(45, 85)), cy=float(rng.uniform(38, 58)),
        a=float(rng.uniform(9, 14)), b=float(rng.uniform(7, 10)),
        angle=float(rng.uniform(-1, 1))) for _ in range(16)])
    eyes = np.clip(eyes + rng.normal(0, 0.01, eyes.shape), 0, 1).astype(
        np.float32)
    rc = pupil.find_pupil(torch.Generator().manual_seed(0), eyes,
                          device="cpu")
    rg = pupil.find_pupil(torch.Generator().manual_seed(0), eyes,
                          device="cuda")
    np.testing.assert_array_equal(rg.n_inliers.cpu().numpy(),
                                  rc.n_inliers.numpy())
    np.testing.assert_allclose(rg.center.cpu().numpy(), rc.center.numpy(),
                               atol=1e-4)


def test_arcface_step_gradients_card_vs_cpu(defaults):
    """One step's loss and gradients from the same parameters, at 512 ->
    128 over 1,000 classes, batch 64, s 64, m 0.5."""
    state, _ = create_state(0, dim_in=512, num_classes=1000, dim_emb=128,
                            device="cpu")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 512)).astype(np.float32)
    y = rng.integers(0, 1000, size=64)
    grads, losses = [], []
    for dev in ("cpu", "cuda"):
        s, _ = state_from_params(
            {"layers": [{k: v.detach().to(dev) for k, v in lyr.items()}
                        for lyr in state.params["layers"]],
             "head": state.params["head"].detach().to(dev)})
        loss = arcface_loss(s.params, x, y, scale=64.0, margin=0.5)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append([p.grad.cpu() for p in parameters(s.params)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    for c, g in zip(*grads):
        assert float((g - c).abs().max()) <= 1e-4 * float(c.abs().max())
