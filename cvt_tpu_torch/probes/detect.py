"""Detection split into stages (`_prof_detect.py` on the port).

    python -m cvt_tpu_torch.probes.detect [--device cpu] [--reps R]
        [--quick] [--batch 8] [--height 480] [--width 640] [--max-k 8192]

Input: `procedural_images(B, H, W, seed=0)`. Each stage runs from the
images, so the difference of two stages' times is the part between them.
One JSON line each:

  pyramid dog only     `build_pyramid(first_octave=-1,
                       with_gradients=False)`, the DoG stacks
  pyramid with grads   the same with the gradient fields
  pyr+stencil          + the 3x3x3 extremum masks of every octave
                       (`detect._window_max` / `_window_min`, the
                       0.02 / 3 peak threshold)
  pyr+topk(raw)        + `ops.topk.top_k_largest` of |DoG| over each
                       octave's [B, L*H*W], K = min(max_k, L*H*W)
  pyr+full detect      + `detect.detect_octave` at that K

The port's functions stand for the script's: `build_pyramid` for
`cvt_tpu`'s, `top_k_largest` for `jax.lax.top_k` (its tie order), the
max-pools for the reduce_windows.
"""

from __future__ import annotations

from cvt_tpu_torch.benches._common import Run
from cvt_tpu_torch.features import detect as D
from cvt_tpu_torch.features.scale_space import build_pyramid
from cvt_tpu_torch.ops.topk import top_k_largest
from cvt_tpu_torch.probes._common import (image_parser, image_stack, images,
                                          timed)

PEAK = 0.02 / 3


def dogs(im) -> list:
    """The DoG stack of every octave, [B, L, H, W] each."""
    return [o.dog for o in build_pyramid(im, first_octave=-1,
                                         with_gradients=False)]


def dogs_and_grads(im) -> list:
    return [(o.dog, o.grad_dx, o.grad_dy)
            for o in build_pyramid(im, first_octave=-1, with_gradients=True)]


def stencil(stacks: list) -> list:
    """The 3x3x3 extremum mask of each DoG stack (no edge or border test),
    as the script computes it."""
    return [((d >= D._window_max(d)) & (d > PEAK))
            | ((d <= D._window_min(d)) & (d < -PEAK)) for d in stacks]


def k_of(dog, max_k: int) -> int:
    return min(max_k, dog[0].numel())


def raw_topk(stacks: list, max_k: int) -> list:
    """The k largest |DoG| values of each image in each octave."""
    return [top_k_largest(d.abs().reshape(d.shape[0], -1),
                          k_of(d, max_k))[0] for d in stacks]


def detect(stacks: list, max_k: int) -> list:
    """`detect_octave` on each octave: (x, y, level_f, level, response,
    valid), [B, K] each."""
    return [D.detect_octave(d, max_k=k_of(d, max_k), peak_threshold=PEAK)
            for d in stacks]


def main(argv=None) -> dict:
    """Run every stage (the card unless `--device cpu`); returns the
    result line's fields."""
    ns = image_parser(__doc__).parse_args(argv)
    run = Run("probes.detect", ns.device)
    im = images(ns, run.dev)
    stack = image_stack(im, ns.reps)
    shapes = {"images": list(im.shape),
              "dog": [list(d.shape) for d in dogs(im)]}
    k = ns.max_k
    for name, fn in (
            ("pyramid dog only", dogs),
            ("pyramid with grads", dogs_and_grads),
            ("pyr+stencil", lambda x: stencil(dogs(x))),
            ("pyr+topk(raw)", lambda x: raw_topk(dogs(x), k)),
            ("pyr+full detect", lambda x: detect(dogs(x), k))):
        timed(name, fn, stack, ns, shapes, max_k=k)
    return run.result(batch=ns.batch, height=ns.height, width=ns.width,
                      max_k=k)


if __name__ == "__main__":
    main()
