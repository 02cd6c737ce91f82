"""The port's LSD-style line detector (`cvt_tpu_torch.features.lines`)
held to `cvt_tpu.features.lines` on the CPU, on every scene of
`tests/test_lines.py` and on procedural images.

Tolerances: level-line magnitudes 1e-6, angles 4 ulp (arctan2 of two
libraries); component labels bitwise where no neighbour pair's angle
difference lies within 1e-6 of tau and no magnitude within 1e-6 of the
gradient threshold (such near-tie pixels are counted and may join in one
package only), with the same propagation step count; then the
rectangles within tests/_lines_tolerance.py's float32 bounds (segments
1e-3 px plus the moments' cancellation, which grows with the distance
from the origin; `valid` equal but where -log10(NFA) lies within 0.05 of
nfa_eps, counted, at most 1% of slots). The labels of `cvt_tpu` come
from a copy of its while_loop over its own helpers.

XLA on the CPU flushes subnormal floats to zero, and the soft edges of
`_edge_image` hold subnormal pixels far from the edge: there `cvt_tpu`'s
gradient is exactly 0 (angle pi) where torch's is ~1e-40 (angle pi/2).
The tests run torch with `torch.set_flush_denormal(True)`, as XLA does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.features import lines as jl
from cvt_tpu_torch.features import lines as tl
from cvt_tpu_torch.io.datasets import procedural_images
from _lines_tolerance import _numpy, assert_segments_close
from test_lines import _edge_image

NEAR = 1e-6


@pytest.fixture(autouse=True)
def flush_denormals():
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)



def _scenes():
    rng = np.random.default_rng(0)
    xx = np.linspace(0, 1, 128, dtype=np.float32)
    return {
        "edge_0": _edge_image(96, 128, 0.0)[None],
        "edge_90": _edge_image(96, 128, 90.0)[None],
        "edge_35": _edge_image(96, 128, 35.0)[None],
        "flat": np.full((1, 64, 64), 0.5, np.float32),
        "noise": rng.uniform(0, 1, (1, 96, 96)).astype(np.float32),
        "two": np.stack([_edge_image(96, 128, 0.0),
                         _edge_image(96, 128, 90.0)]),
        "ramp": np.broadcast_to(xx, (1, 96, 128)).copy(),
        "edge_40": _edge_image(96, 128, 40.0)[None],
        "tiny": _edge_image(8, 8, 0.0)[None],
        "procedural": procedural_images(2, 96, 128, seed=3),
        "procedural_wide": procedural_images(1, 120, 160, seed=5),
    }


SCENES = _scenes()
# test_lines.py's calls: (scene, keyword arguments)
CALLS = [("edge_0", dict(max_segments=8)), ("edge_90", dict(max_segments=8)),
         ("edge_35", dict(max_segments=8)), ("flat", dict(max_segments=8)),
         ("noise", dict(max_segments=16)), ("two", dict(max_segments=8)),
         ("ramp", dict(max_segments=8)),
         ("edge_40", dict(max_segments=8, tau_deg=30.0, grad_threshold=0.01,
                          min_pixels=20, nfa_eps=1.0)),
         ("tiny", dict(max_segments=128)), ("procedural", dict()),
         ("procedural_wide", dict(max_segments=256))]


def _jax_labels(images, grad_threshold=0.02, tau_deg=22.5):
    """`cvt_tpu`'s label propagation (lines.py:118-148) over its helpers."""
    images = jnp.asarray(images, jnp.float32)
    b, h, w = images.shape
    tau = jnp.float32(np.deg2rad(tau_deg))
    ang, mag = jl._level_lines(images)
    usable = mag > grad_threshold
    flat_idx = (jax.lax.broadcasted_iota(jnp.int32, (b, h, w), 1) * w
                + jax.lax.broadcasted_iota(jnp.int32, (b, h, w), 2))
    labels = jnp.where(usable, flat_idx, jl._NO_LABEL)
    neigh = ((0, 1), (0, -1), (1, 0), (-1, 0),
             (1, 1), (1, -1), (-1, 1), (-1, -1))

    def step(state):
        labels = state[0]
        new = labels
        for dy, dx in neigh:
            n_lab = jl._shift(labels, dy, dx, jl._NO_LABEL)
            n_ang = jl._shift(ang, dy, dx, jnp.float32(0))
            n_ok = jl._shift(usable, dy, dx, False)
            join = usable & n_ok & (jl._angle_diff(ang, n_ang) < tau)
            new = jnp.where(join, jnp.minimum(new, n_lab), new)
        hop = jnp.take_along_axis(
            new.reshape(b, -1),
            jnp.clip(new.reshape(b, -1), 0, h * w - 1), axis=1
        ).reshape(b, h, w)
        hop = jnp.where(new < jl._NO_LABEL, jnp.minimum(new, hop), new)
        return hop, jnp.any(hop != labels), state[2] + 1

    labels, _, steps = jax.lax.while_loop(
        lambda s: s[1], step, (labels, jnp.bool_(True), jnp.int32(0)))
    near = 0
    for dy, dx in neigh:
        d = jl._angle_diff(ang, jl._shift(ang, dy, dx, jnp.float32(0)))
        pair = usable & jl._shift(usable, dy, dx, False)
        near += int(jnp.sum(pair & (jnp.abs(d - tau) < NEAR)))
    near += int(jnp.sum(jnp.abs(mag - grad_threshold) < NEAR))
    return np.asarray(labels), int(steps), near


@pytest.mark.parametrize("name", sorted(SCENES))
def test_level_lines_match(name):
    x = SCENES[name]
    ja, jm = (np.asarray(a) for a in jl._level_lines(jnp.asarray(x)))
    ta, tm = (a.numpy() for a in tl._level_lines(torch.from_numpy(x)))
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ta, ja, rtol=0,
                               atol=4 * np.spacing(np.float32(np.pi)))


@pytest.mark.parametrize("name,kw", CALLS, ids=[c[0] for c in CALLS])
def test_labels_bitwise_up_to_near_ties(name, kw):
    x = SCENES[name]
    thr = kw.get("grad_threshold", 0.02)
    tau_deg = kw.get("tau_deg", 22.5)
    want, steps, near = _jax_labels(x, thr, tau_deg)
    ang, mag = tl._level_lines(torch.from_numpy(x))
    got, got_steps = tl._components(
        ang, mag > thr, float(np.float32(np.deg2rad(tau_deg))))
    if near == 0:
        np.testing.assert_array_equal(got.numpy(), want)
        assert got_steps == steps
    else:
        assert np.mean(got.numpy() != want) < 0.01, near


@pytest.mark.parametrize("name,kw", CALLS, ids=[c[0] for c in CALLS])
def test_segments_match_reference(name, kw):
    x = SCENES[name]
    want = jl.detect_line_segments(jnp.asarray(x), **kw)
    got = tl.detect_line_segments(torch.from_numpy(x), **kw)
    assert tl.last_propagation_steps == _jax_labels(
        x, kw.get("grad_threshold", 0.02), kw.get("tau_deg", 22.5))[1]
    assert got.segments.shape == want.segments.shape
    assert_segments_close(_numpy(got), _numpy(want), kw.get("nfa_eps", 0.0))


def test_near_tie_pair_is_counted():
    """Two pixels whose level-line angles differ by tau to within an ulp
    count as a near tie: the rule that excuses a label difference."""
    tau = np.float32(np.deg2rad(22.5))
    img = np.zeros((1, 16, 16), np.float32)
    img[0, :, 8:] = 1.0
    ang, mag = jl._level_lines(jnp.asarray(img))
    ang = np.asarray(ang).copy()
    ang[0, 3, 8] = ang[0, 4, 8] + tau           # the pair (3,8)-(4,8)
    d = np.asarray(jl._angle_diff(jnp.asarray(ang[0, 3, 8]),
                                  jnp.asarray(ang[0, 4, 8])))
    assert abs(float(d) - float(tau)) < NEAR
    td = tl._angle_diff(torch.tensor(ang[0, 3, 8]), torch.tensor(ang[0, 4, 8]))
    assert abs(float(td) - float(tau)) < NEAR
    assert float(td) == float(d)                # fmod: exact, both sides


def test_batch_and_single_agree():
    x = SCENES["two"]
    both = tl.detect_line_segments(torch.from_numpy(x), max_segments=8)
    for i in range(2):
        one = tl.detect_line_segments(torch.from_numpy(x[i]), max_segments=8)
        np.testing.assert_array_equal(one.valid.numpy()[0],
                                      both.valid.numpy()[i])
        np.testing.assert_allclose(one.segments.numpy()[0],
                                   both.segments.numpy()[i], atol=1e-4)


def test_numpy_input_follows_device_rule():
    out = tl.detect_line_segments(SCENES["edge_0"], max_segments=8,
                                  device="cpu")
    assert out.valid.device == torch.device("cpu")
