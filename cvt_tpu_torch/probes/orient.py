"""The orientation pass split into its gathers and its histogram
(`_prof_orient.py` on the port).

    python -m cvt_tpu_torch.probes.orient [--device cpu] [--reps R]
        [--quick] [--batch 8] [--height 480] [--width 640] [--max-k 8192]

Input: `procedural_images(B, H, W, seed=0)`. Every stage starts from the
images with the base preparation, so the difference of a stage's time
and the first's is the stage's own part. One JSON line each:

  prep(base)            `build_pyramid(first_octave=-1)` with gradients,
                        `detect_octave` on the first octave (K max_k),
                        its interleaved (dx, dy) stack and the keypoints'
                        scales
  prep+gathers only     + the orientation window's bilinear gathers of
                        every keypoint, reduced to one sum of its samples
  prep+hist/peaks only  + the 36-bin histogram and its two peaks on
                        gradients made from each keypoint's x, y, sigma
                        (no gathers)
  prep+orient full      + `assign_orientations_multi_flat` on the octave,
                        two orientations

Which port function stands for which of the script's:

  `descriptor._Sampler` (descriptor.py, the class)  for
      `cvt_tpu`'s `_flat_sampler_pair` (one contiguous 4-element gather
      per bilinear row there; four row gathers of (dx, dy) pairs here);
  `descriptor._orientation_samples`  for the script's vmapped per-keypoint
      window (`u = sigma * 4.5 * grid`), in the pass's own chunks of rows;
  `descriptor._orientation_hist` + `_orientation_peaks`  for `cvt_tpu`'s
      `_orientation_peaks(g1, g2, wgt, ...)`, which builds the histogram
      inside;
  `descriptor.assign_orientations_multi_flat`  for its namesake.

The script's window grid (16 x 16 over [-1, 1]) and its stand-in weights
exp(-(u^2 + v^2)) are kept for the histogram-only stage; the octave's
height and width come from its gradient stack (the script writes 960 x
1280, the first octave of 480 x 640).
"""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.benches._common import Run
from cvt_tpu_torch.features import descriptor as DD
from cvt_tpu_torch.features.detect import detect_octave
from cvt_tpu_torch.features.scale_space import build_pyramid
from cvt_tpu_torch.probes._common import (image_parser, image_stack, images,
                                          timed)

PEAK, N_ORI, RATIO, P = 0.02 / 3, 2, 0.8, 16


def prep(im, max_k: int) -> dict:
    """`octave_prep` of the first octave of the images' pyramid."""
    return octave_prep(build_pyramid(im, first_octave=-1,
                                     with_gradients=True)[0], max_k)


def octave_prep(o0, max_k: int) -> dict:
    """An octave's interleaved gradient stack gf [B, 2F], its metadata
    (base 0, h, w) and its keypoints x, y, sig, lev, valid."""
    x, y, lf, lev, _, valid = detect_octave(
        o0.dog, max_k=min(max_k, o0.dog[0].numel()), peak_threshold=PEAK)
    return {"gf": DD._interleave(o0.grad_dx, o0.grad_dy),
            "meta": DD._one_octave(o0.grad_dx), "x": x, "y": y,
            "sig": 1.6 * 2.0 ** (lf / 3.0), "lev": lev, "valid": valid}


def gathers(p: dict) -> torch.Tensor:
    """The orientation window's samples of each keypoint, summed: [B, K]
    of sum(vx) + sum(vy)."""
    b, k = p["x"].shape
    out = DD._orientation_samples(
        DD._Sampler(p["gf"], *p["meta"]), p["x"], p["y"], p["sig"],
        p["lev"], torch.zeros_like(p["lev"]), None, P,
        lambda g1, g2, wgt: g1.sum(-1) + g2.sum(-1))
    return torch.cat(out).reshape(b, k)


def _script_grid(dev) -> torch.Tensor:
    lin = np.linspace(-1.0, 1.0, P, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    return torch.from_numpy(np.stack([gx.ravel(), gy.ravel()], 1)).to(dev)


def hist_peaks(p: dict):
    """Histogram and peaks alone, in the pass's chunks of rows, on the
    script's stand-in gradients g1 = x * u + sigma, g2 = y * v + sigma
    over the window grid (u, v) with weights exp(-(u^2 + v^2)) ->
    (angles, ok) [B, K, 2]."""
    b, k = p["x"].shape
    grid = _script_grid(p["x"].device)
    wgt = torch.exp(-(grid[:, 0] ** 2 + grid[:, 1] ** 2))
    xr, yr, sr = (DD._rows(p[key]) for key in ("x", "y", "sig"))
    angs, oks = [], []
    for c in DD._chunks(b * k, P * P * DD.N_ORI_BINS):
        g1 = xr[c, None] * grid[:, 0] + sr[c, None]
        g2 = yr[c, None] * grid[:, 1] + sr[c, None]
        a, ok = DD._orientation_peaks(DD._orientation_hist(g1, g2, wgt),
                                      N_ORI, RATIO)
        angs.append(a)
        oks.append(ok)
    return (torch.cat(angs).reshape(b, k, N_ORI),
            torch.cat(oks).reshape(b, k, N_ORI))


def orient_full(p: dict):
    """`assign_orientations_multi_flat` on the octave: (angles, ok)
    [B, K, 2]."""
    return DD.assign_orientations_multi_flat(
        p["gf"], *p["meta"], torch.zeros_like(p["lev"]), p["x"], p["y"],
        p["sig"], p["lev"], p["valid"], n_orientations=N_ORI,
        peak_ratio=RATIO)


def main(argv=None) -> dict:
    """Run every stage (the card unless `--device cpu`); returns the
    result line's fields."""
    ns = image_parser(__doc__).parse_args(argv)
    run = Run("probes.orient", ns.device)
    im = images(ns, run.dev)
    stack = image_stack(im, ns.reps)
    k = ns.max_k
    p0 = prep(im, k)
    shapes = {"images": list(im.shape), "gf": list(p0["gf"].shape),
              "keypoints": list(p0["x"].shape), "window": [P, P]}
    for name, fn in (("prep(base)", lambda x: prep(x, k)),
                     ("prep+gathers only", lambda x: gathers(prep(x, k))),
                     ("prep+hist/peaks only",
                      lambda x: hist_peaks(prep(x, k))),
                     ("prep+orient full", lambda x: orient_full(prep(x, k)))):
        timed(name, fn, stack, ns, shapes)
    return run.result(batch=ns.batch, height=ns.height, width=ns.width,
                      max_k=k, n_orientations=N_ORI)


if __name__ == "__main__":
    main()
