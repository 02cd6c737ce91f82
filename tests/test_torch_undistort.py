"""The port's undistortion and warps (`cvt_tpu_torch.apps.undistort`) held
to `cvt_tpu.apps.undistort` on the same seeded images, on the CPU.

One bilinear sampler serves all four warps; `cvt_tpu` samples through
`jax.scipy.ndimage.map_coordinates(order=1, mode="constant", cval=0)`.
Tolerance: 1e-5 on values in [0, 1] (float32 weight products rounded in
another order), the output camera of undistort_camera equal. The grids
reach outside the frame on every side, so the out-of-frame taps count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.apps import undistort as ju
from cvt_tpu.match.cameras import image_to_world as j_image_to_world
from cvt_tpu_torch.apps import undistort as tu

RNG = np.random.default_rng(0)
IMAGES = RNG.random((3, 40, 52, 3)).astype(np.float32)
CAMERAS = [
    ("simple_radial", [40., 25.5, 19.5, 0.15]),
    ("opencv", [40., 42., 25.5, 19.5, -0.2, 0.05, 1e-3, -2e-3]),
    ("full_opencv", [40., 42., 25.5, 19.5, -0.1, 0.02, 1e-3, -2e-3, 1e-3,
                     0.01, -2e-3, 5e-4]),
    ("opencv_fisheye", [40., 42., 25.5, 19.5, 0.03, -0.005, 1e-3, -5e-4]),
    ("pinhole", [40., 40., 25.5, 19.5]),
]


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("model,params", CAMERAS)
@pytest.mark.parametrize("blank", [0.0, 0.5, 1.0])
def test_undistort_camera_matches_reference(model, params, blank):
    p = np.float32(params)
    np.testing.assert_array_equal(
        tu.undistort_camera(model, p, 52, 40, blank_pixels=blank),
        ju.undistort_camera(model, p, 52, 40, blank_pixels=blank))


@pytest.mark.parametrize("model,params", CAMERAS)
@pytest.mark.parametrize("channels", [True, False])
def test_undistort_images_matches_reference(model, params, channels):
    imgs = IMAGES if channels else IMAGES[..., 0]
    p = np.float32(params)
    for blank, shape in ((0.0, None), (1.0, (30, 64))):
        oj, nj = ju.undistort_images(imgs, model, p, blank_pixels=blank,
                                     out_shape=shape)
        ot, nt = tu.undistort_images(t(imgs), model, p, blank_pixels=blank,
                                     out_shape=shape)
        np.testing.assert_array_equal(nt, nj)
        assert ot.shape == oj.shape and ot.dtype == torch.float32
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-5)


def test_undistort_roundtrip_psnr():
    """tests/test_apps3.py's distort -> undistort check in the port."""
    h = w = 96
    params = np.array([80.0, 47.5, 47.5, 0.15], np.float32)

    def scene(x, y):
        return (0.5 + 0.25 * np.sin(6.0 * x) * np.cos(5.0 * y)
                + 0.25 * np.sin(3.0 * (x + y)))

    vv, uu = np.mgrid[0:h, 0:w].astype(np.float32)
    uv = np.stack([uu.ravel(), vv.ravel()], -1)
    xy = np.asarray(j_image_to_world("simple_radial", params, uv))
    distorted = scene(xy[:, 0], xy[:, 1]).reshape(h, w).astype(np.float32)
    out, newp = tu.undistort_images(distorted[None], "simple_radial",
                                    params, device="cpu")
    fx, fy, ncx, ncy = newp
    expected = scene((uu - ncx) / fx, (vv - ncy) / fy).astype(np.float32)
    err = out[0].numpy()[12:-12, 12:-12] - expected[12:-12, 12:-12]
    assert 10 * np.log10(1.0 / max(np.mean(err * err), 1e-12)) > 32.0


@pytest.mark.parametrize("channels", [True, False])
def test_warp_image_homography_matches_reference(channels):
    img = IMAGES[0] if channels else IMAGES[0, ..., 1]
    for h in (np.array([[1.02, 0.05, -4.3], [-0.03, 0.98, 7.7],
                        [1e-4, -2e-4, 1]], np.float32),
              np.array([[1, 0, -4], [0, 1, -2], [0, 0, 1]], np.float32),
              np.array([[0.7, 0.2, 30.], [-0.1, 1.3, -12.], [0, 0, 1]],
                       np.float32)):
        want = ju.warp_image_homography(img, h, 50, 60)
        got = tu.warp_image_homography(t(img), h, 50, 60)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_warp_homography_translation():
    """tests/test_scene_utils.py's shift in the port: exact on whole
    pixels, zero where the source lies outside the frame."""
    img = np.zeros((32, 32), np.float32)
    img[8:12, 8:12] = 1.0
    h = np.array([[1, 0, -4], [0, 1, -2], [0, 0, 1]], np.float32)
    out = tu.warp_image_homography(t(img), h, 32, 32).numpy()
    assert out[12, 14] == 1.0 and out[10, 10] == 0.0
    assert (out[:2] == 0).all() and (out[:, :4] == 0).all()


@pytest.mark.parametrize("channels", [True, False])
@pytest.mark.parametrize("src,dst", [
    (("opencv", [40., 42., 25.5, 19.5, -0.2, 0.05, 1e-3, -2e-3]),
     ("simple_radial", [38., 26., 20., 0.1])),
    (("simple_pinhole", [30.0, 25.5, 19.5]),
     ("simple_pinhole", [30.0, 25.5, 19.5])),
    (("radial_fisheye", [30., 25.5, 19.5, 0.03, -0.008]),
     ("pinhole", [36., 36., 24.0, 21.0])),
])
def test_warp_between_cameras_matches_reference(channels, src, dst):
    img = IMAGES[1] if channels else IMAGES[1, ..., 2]
    want = ju.warp_between_cameras(img, src[0], np.float32(src[1]), dst[0],
                                   np.float32(dst[1]))
    got = tu.warp_between_cameras(t(img), src[0], np.float32(src[1]),
                                  dst[0], np.float32(dst[1]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if src == dst:
        np.testing.assert_allclose(got.numpy(), img, atol=1e-4)


def test_bilinear_taps_outside_the_frame():
    """Sample points past every edge: each tap outside counts 0, as
    map_coordinates' constant mode."""
    img = RNG.random((6, 7)).astype(np.float32)
    sv = np.array([-1.5, -0.5, 0.0, 2.25, 5.0, 5.5, 6.2, 3.0, 3.0, 3.0],
                  np.float32)
    su = np.array([3.0, 3.0, -0.75, 6.5, 6.0, 0.5, 2.0, -1.0, 6.9, 7.0],
                  np.float32)
    import jax.scipy.ndimage as ndi
    want = ndi.map_coordinates(jnp.asarray(img), [jnp.asarray(sv),
                                                  jnp.asarray(su)],
                               order=1, mode="constant", cval=0.0)
    got = tu._sample(t(img), t(sv), t(su))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
