"""The rectangle tolerances of the line detector's parity tests
(tests/test_torch_lines.py against `cvt_tpu`, tests/test_torch_apps_cuda.py
the card against the CPU). Imports numpy only, so the card-only tests
run without JAX. Not collected (no test_ prefix).

The rectangles come from second moments about the centre,
m = s/w - c^2. `cvt_tpu` sums them in float32 about the image origin, a
cancellation whose rounding (tens of ulp of cx^2 + cy^2) grows with the
distance from the origin and shrinks with the length L; the port takes
them about each component's first pixel, in float64, so the difference
is `cvt_tpu`'s rounding and between the card and the CPU far less:
segments are held, as unordered endpoint pairs, to
1e-3 px + 64 eps (cx^2 + cy^2) / max(L, 1), angles (mod pi) to 1e-4 +
twice that over max(L, 1), widths to 1e-3 + 192 eps (cx^2 + cy^2), and
-log10(NFA), which follows the rectangle's area, to 0.05 + 2% relative.
A slot valid in one package only must have its -log10(NFA) within that
of 0 (of nfa_eps).
"""

import numpy as np

EPS = float(np.finfo(np.float32).eps)
NFA_RTOL, NFA_ATOL = 2e-2, 0.05


def _numpy(seg):
    """LineSegments of tensors (or jax arrays) -> of numpy arrays."""
    return type(seg)(*(np.asarray(a.cpu() if hasattr(a, "cpu") else a)
                       for a in seg))


def assert_segments_close(got, want, nfa_eps: float = 0.0) -> int:
    """The rectangle tolerances of the module docstring; got / want are
    LineSegments as numpy arrays. A slot valid in one package only must
    have its -log10(NFA) within 0.05 + NFA_RTOL of nfa_eps there (the
    rectangle's rounding decides it); such slots are counted, returned
    and left out of the other checks."""
    flip = got.valid != want.valid
    nfa_one = np.where(got.valid, got.nfa, want.nfa)
    assert np.all(np.abs(nfa_one - nfa_eps)[flip]
                  <= NFA_ATOL + NFA_RTOL * abs(nfa_eps)), nfa_one[flip]
    assert flip.mean() <= 0.01, flip.sum()
    both = ~flip
    got, want = (type(got)(*(a[both] for a in g)) for g in (got, want))
    sj, st = want.segments, got.segments
    cx = (sj[..., 0] + sj[..., 2]) / 2
    cy = (sj[..., 1] + sj[..., 3]) / 2
    length = np.maximum(np.hypot(sj[..., 2] - sj[..., 0],
                                 sj[..., 3] - sj[..., 1]), 1.0)
    r2 = cx * cx + cy * cy
    tol = 1e-3 + 64 * EPS * r2 / length
    same = np.abs(st - sj).max(-1)
    swapped = np.abs(st - sj[..., [2, 3, 0, 1]]).max(-1)
    assert np.all(np.minimum(same, swapped) <= tol), (
        np.minimum(same, swapped) / tol).max()
    da = np.abs(got.angle - want.angle) % np.pi
    da = np.minimum(da, np.pi - da)
    assert np.all(da <= 1e-4 + 2 * tol / length)
    assert np.all(np.abs(got.width - want.width) <= 1e-3 + 192 * EPS * r2)
    np.testing.assert_allclose(got.nfa, want.nfa, rtol=NFA_RTOL,
                               atol=NFA_ATOL)
    return int(flip.sum())


def segment_close_matrix(got, want):
    """[Lg, Lw] bool: got's slot i and want's slot j are both valid and
    the same rectangle within the bounds above (slots need not align: a
    component that differs by a pixel can move in the count ranking)."""
    sg, sw = got.segments[:, None], want.segments[None]
    cx = (sw[..., 0] + sw[..., 2]) / 2
    cy = (sw[..., 1] + sw[..., 3]) / 2
    length = np.maximum(np.hypot(sw[..., 2] - sw[..., 0],
                                 sw[..., 3] - sw[..., 1]), 1.0)
    r2 = cx * cx + cy * cy
    dev = np.minimum(np.abs(sg - sw).max(-1),
                     np.abs(sg - sw[..., [2, 3, 0, 1]]).max(-1))
    ok = dev <= 1e-3 + 64 * EPS * r2 / length
    ok &= (np.abs(got.width[:, None] - want.width[None])
           <= 1e-3 + 192 * EPS * r2)
    ok &= (np.abs(got.nfa[:, None] - want.nfa[None])
           <= NFA_ATOL + NFA_RTOL * np.abs(want.nfa[None]))
    return ok & got.valid[:, None] & want.valid[None]


def unmatched_segments(got, want) -> int:
    """Valid segments of either side (one image: LineSegments of [L]
    arrays) left without a partner after a greedy one-to-one matching
    under segment_close_matrix."""
    ok = segment_close_matrix(got, want)
    used_w = np.zeros(ok.shape[1], bool)
    matched = 0
    for i in np.flatnonzero(got.valid):
        free = np.flatnonzero(ok[i] & ~used_w)
        if free.size:
            used_w[free[0]] = True
            matched += 1
    return int(got.valid.sum() + want.valid.sum() - 2 * matched)
