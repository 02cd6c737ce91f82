"""The fast extraction path split into stages (`_prof_feat.py` on the
port).

    python -m cvt_tpu_torch.probes.feat [--device cpu] [--reps R] [--quick]
        [--batch 8] [--height 480] [--width 640] [--max-k 8192]

Input: `procedural_images(B, H, W, seed=0)`. The stages follow
`features/covdet._extract_fast` at first octave -1, DoG, two
orientations, and each runs from the images, so the difference of two
stages' times is the part between them. One JSON line each:

  pyramid              `build_pyramid(first_octave=-1)` with gradients
  detect+select        + `detect_octave` on every octave (K = min(max_k,
                       L*H*W)), the global top max_k by |response|
                       (`ops.topk.top_k_largest`) and the gathers of the
                       selected keypoints
  +orient(K,O=2)       + the interleaved flat gradient stack and
                       `assign_orientations_multi_flat` (descriptor.py),
                       two orientations per keypoint
  +desc(2K)            + `sift_descriptors_flat` on the 2 * max_k
                       duplicated keypoints

The script passes the gradient fields to `assign_orientations_multi_flat`
and `sift_descriptors_flat` as two stacks, which `cvt_tpu`'s functions
no longer take; both packages now take one interleaved (dx, dy) stack,
and so does this probe.
"""

from __future__ import annotations

import torch

from cvt_tpu_torch.benches._common import Run
from cvt_tpu_torch.features import descriptor as DD
from cvt_tpu_torch.features.covdet import _take
from cvt_tpu_torch.features.detect import detect_octave
from cvt_tpu_torch.features.scale_space import build_pyramid
from cvt_tpu_torch.ops.topk import top_k_largest
from cvt_tpu_torch.probes._common import (image_parser, image_stack, images,
                                          timed)

PEAK, N_ORI = 0.02 / 3, 2
KEYS = ("x", "y", "lf", "lev", "resp", "valid", "oct")


def pyramid(im) -> list:
    return build_pyramid(im, first_octave=-1, with_gradients=True)


def select(pyr: list, max_k: int) -> dict:
    """Detection on every octave, then the global top max_k by |response|:
    the selected x, y, lf, lev, resp, valid, oct [B, max_k] and sig, the
    scale in octave pixels."""
    det = {k: [] for k in KEYS}
    for oi, o in enumerate(pyr):
        k_oct = min(max_k, o.dog[0].numel())
        for key, v in zip(KEYS, detect_octave(o.dog, max_k=k_oct,
                                              peak_threshold=PEAK)):
            det[key].append(v)
        det["oct"].append(torch.full_like(det["lev"][-1], oi))
    cat = {k: torch.cat(v, 1) for k, v in det.items()}
    score = torch.where(cat["valid"], cat["resp"].abs(), -1.0)
    _, sel = top_k_largest(score, min(max_k, score.shape[1]))
    out = {k: _take(v, sel) for k, v in cat.items()}
    out["sig"] = 1.6 * 2.0 ** (out["lf"] / 3.0)
    return out


def flat(pyr: list) -> tuple:
    """The interleaved (dx, dy) stack of every octave [B, 2F] and each
    octave's first pair, height and width."""
    gf = torch.cat([DD._interleave(o.grad_dx, o.grad_dy) for o in pyr], 1)
    base, off = [], 0
    for o in pyr:
        base.append(off)
        off += o.grad_dx[0].numel()
    meta = (base, [o.grad_dx.shape[2] for o in pyr],
            [o.grad_dx.shape[3] for o in pyr])
    return gf, tuple(torch.tensor(m, dtype=torch.int64, device=gf.device)
                     for m in meta)


def orient(gf, meta, s: dict):
    """(angles, ok) [B, max_k, 2] of the selected keypoints."""
    return DD.assign_orientations_multi_flat(
        gf, *meta, s["oct"], s["x"], s["y"], s["sig"], s["lev"],
        s["valid"], n_orientations=N_ORI)


def describe(gf, meta, s: dict, angs, aok):
    """Descriptors [B, 2 * max_k, 128] of each keypoint at each of its
    orientations."""
    b = angs.shape[0]

    def t(a):
        return a.repeat_interleave(N_ORI, 1)
    return DD.sift_descriptors_flat(
        gf, *meta, t(s["oct"]), t(s["x"]), t(s["y"]), t(s["sig"]),
        t(s["lev"]), angs.reshape(b, -1), aok.reshape(b, -1))


def upto(im, last: str, max_k: int):
    """The path from the images through stage `last`."""
    pyr = pyramid(im)
    if last == "pyramid":
        return pyr
    s = select(pyr, max_k)
    if last == "select":
        return s["x"], s["y"], s["resp"]
    gf, meta = flat(pyr)
    angs, aok = orient(gf, meta, s)
    if last == "orient":
        return angs
    return describe(gf, meta, s, angs, aok)


def main(argv=None) -> dict:
    """Run every stage (the card unless `--device cpu`); returns the
    result line's fields."""
    ns = image_parser(__doc__).parse_args(argv)
    run = Run("probes.feat", ns.device)
    im = images(ns, run.dev)
    stack = image_stack(im, ns.reps)
    k = ns.max_k
    shapes = {"images": list(im.shape), "keypoints": [ns.batch, k],
              "descriptors": [ns.batch, N_ORI * k, DD.DESC_DIM]}
    for name, last in (("pyramid", "pyramid"), ("detect+select", "select"),
                       (f"+orient({k},O={N_ORI})", "orient"),
                       (f"+desc({N_ORI * k})", "desc")):
        timed(name, lambda x, last=last: upto(x, last, k), stack, ns,
              shapes)
    return run.result(batch=ns.batch, height=ns.height, width=ns.width,
                      max_k=k, n_orientations=N_ORI)


if __name__ == "__main__":
    main()
