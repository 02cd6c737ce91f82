"""What the four probes share: the command line, the timed stage and its
JSON line, and the seeded test images. The timers, the device and the
result line are the workload suites' (`benches/_common.py`)."""

from __future__ import annotations

import argparse
import json

import torch

from cvt_tpu_torch.benches import _common as bc
from cvt_tpu_torch.io.datasets import procedural_images


def parser(doc: str, reps: int) -> argparse.ArgumentParser:
    """`--device`, `--reps` (iterations per timed window, default `reps`)
    and `--quick` (one window per stage instead of benches' WINDOWS)."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: the card)")
    p.add_argument("--reps", type=int, default=reps,
                   help="iterations per timed window")
    p.add_argument("--quick", action="store_true",
                   help="one timed window per stage")
    return p


def image_parser(doc: str, reps: int = 3) -> argparse.ArgumentParser:
    """`parser` plus the image batch: `--batch`, `--height`, `--width`
    (8 x 480 x 640, the JAX probes' size) and `--max-k`, the keypoints
    kept (8,192)."""
    p = parser(doc, reps)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--max-k", type=int, default=8192)
    return p


def images(ns, dev: torch.device) -> torch.Tensor:
    """`procedural_images(batch, height, width, seed=0)` on `dev`."""
    return torch.from_numpy(procedural_images(
        ns.batch, ns.height, ns.width, seed=0)).to(dev)


def line(**fields) -> dict:
    """Print one JSON line of `fields` and return them."""
    print(json.dumps(fields), flush=True)
    return fields


def stage(name: str, ms: dict, shapes: dict, **extra) -> dict:
    """Print one stage's JSON line: its name, the median ms per iteration
    over the windows, the fastest and slowest window, the shapes and any
    extra fields; return the line's fields."""
    return line(stage=name, ms=ms["ms"], ms_min=ms["ms_spread"][0],
                ms_max=ms["ms_spread"][1], shapes=shapes, **extra)


def windowed(fn, stack, ns) -> dict:
    """ms of fn(stack[i]) per iteration over the stack, in one window
    (`--quick`) or benches' WINDOWS windows (`benches._common.
    timed_windows`: CUDA events on the card, one warm pass first)."""
    return bc.timed_windows(fn, stack, windows=1 if ns.quick else None)


def timed(name: str, fn, stack, ns, shapes: dict, **extra) -> dict:
    """`windowed`, then the stage's line."""
    return stage(name, windowed(fn, stack, ns), shapes, **extra)


def image_stack(x: torch.Tensor, reps: int) -> torch.Tensor:
    """`reps` iterations over the same batch (a view, no copy)."""
    return x[None].expand(reps, *x.shape)
