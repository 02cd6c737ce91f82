"""ADC phase 1 alone against the whole fast search (`_prof_adc.py` on the
port).

    python -m cvt_tpu_torch.probes.adc [--device cpu] [--reps R] [--quick]
        [--n N] [--dim D] [--batches 4096,8192,16384]
        [--tiles 1024,2048,4096]

Data, drawn from `np.random.default_rng(0)` in the script's order: N rows
(1M) of M 8 codes over K 256, padded to Npad, N rounded up to 16,384;
codebooks [M, K, D/M] and query stacks of N(0, 20^2) (D 128). The stacks
hold `--reps` batches (16) at the first B and half as many at the
others. Stages, one JSON line each:

  launch overhead               `utils.profile.measure_launch_overhead`
  phase1 tile=1024 B=<b0>       `_fold_queries` + `adc_segmin` at tile
                                1,024, seg 128 (the script's first line)
  phase1 (search's) B=<b>       for each B: phase 1 as `adc_search` runs
                                it (`_fold_for`, the tile of `fast_tile_n`)
  full fast k=10 B=<b>          `adc_search`, fast path, k 10
  phase1 tile=<t> B=<b0>        the tile sweep (the script's 2,048 and
                                4,096)

Each phase-1 line carries the kernel's bound (`utils.profile.adc_bound`).
Every `adc_segmin` call shape is held against the kernel's plain twin on
the call's own arguments (`ops.kernels.twin_check`), and a row that
differs stops the probe. A tile that the kernel refuses
(`adc_scan.check_segmin_launch`) gets a line with the refusal instead of
a time, and the probe raises once the sweep has ended. The last line is
the run's result: the device, the kernel launches and the twin checks.
"""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.benches._common import Run
from cvt_tpu_torch.ops.kernels import adc_scan as T
from cvt_tpu_torch.ops.kernels import recorded_args, twin_check
from cvt_tpu_torch.probes._common import line, parser, stage, windowed
from cvt_tpu_torch.utils.profile import adc_bound, measure_launch_overhead

N, M, KSUB, D = 1_000_000, 8, 256, 128
BATCHES, TILES = (4096, 8192, 16384), (1024, 2048, 4096)
K, REPS, PAD = 10, 16, 16384


def ints(s: str) -> tuple:
    return tuple(int(v) for v in s.split(","))


def data(n: int, d: int, batches: tuple, reps: int, dev) -> dict:
    """The script's draws: codes, codebooks, one unused query batch, the
    first B's stack of `reps`, then each larger B's of reps // 2."""
    rng = np.random.default_rng(0)
    npad = -(-n // PAD) * PAD
    codes = rng.integers(0, KSUB, size=(npad, M), dtype=np.uint8)
    cb = rng.normal(size=(M, KSUB, d // M)).astype(np.float32) * 20
    rng.normal(size=(batches[0], d))
    stacks = [rng.normal(size=(reps if i == 0 else max(1, reps // 2), b, d))
              .astype(np.float32) * 20 for i, b in enumerate(batches)]
    cb_t = torch.from_numpy(cb).to(dev)
    cb_q, srow = T._quantize_codebooks(cb_t)
    return {"npad": npad, "codes": torch.from_numpy(codes).to(dev),
            "cb": cb_t, "cb_q": cb_q, "srow": srow,
            "stacks": [torch.from_numpy(s).to(dev) for s in stacks]}


def phase1(x: dict, n: int, tile: int | None, fold):
    """Phase 1 of one query batch: fold, then the `adc_segmin` scan at
    `tile` (None: the search's own, `fast_tile_n`) and seg 128."""
    tile = T.fast_tile_n(x["npad"]) if tile is None else tile

    def fn(qb):
        q2s, qs = fold(qb, x["srow"])
        return T.adc_segmin(q2s, qs, x["codes"], x["cb_q"],
                            x["srow"] * x["srow"], n, tile, T.SEG)
    return fn, tile


def search_fold(qb, srow):
    """`adc_search`'s fold (`_fold_for`, with the analytic norm cap that
    the script's `_fold_queries` leaves out)."""
    return T._fold_for(qb, srow, qb.shape[1])


def refusal(x: dict, tile: int, fold, qb) -> str | None:
    """The kernel's refusal of phase 1 at `tile` on batch qb, or None."""
    q2s, qs = fold(qb, x["srow"])
    try:
        T.check_segmin_launch(q2s, qs, x["codes"], x["cb_q"],
                              x["srow"] * x["srow"], tile, T.SEG)
    except (ValueError, TypeError) as e:
        return str(e)
    return None


def held(name: str, args: tuple, twins: dict) -> dict:
    """`adc_segmin` against its twin on a call's own arguments; any
    difference raises."""
    c = twin_check("adc_segmin", args)
    if c["rows_differ"] or c["max_abs_err"]:
        raise RuntimeError(f"{name}: adc_segmin differs from its twin: {c}")
    twins[name] = c
    return c


def phase1_stage(name: str, fn, stack, ns, dev, twins: dict) -> dict:
    """Phase 1 timed over the stack beside its bound, then the kernel
    against its twin on the first batch's arguments."""
    args = recorded_args("adc_segmin", lambda: fn(stack[0]))
    b = adc_bound(args, cached=False)
    shapes = {"q2s": list(args[0].shape), "codes": list(args[2].shape),
              "tile": args[6], "seg": args[7]}
    t = windowed(fn, stack, ns)
    return stage(name, t, shapes, bound_ms=b["bound_ms"],
                 bound_by=b["bound_by"],
                 bound_share=(b["bound_ms"] / t["ms"] if dev.type == "cuda"
                              else None),
                 twin=held(name, args, twins))


def same_call(a: tuple, b: tuple) -> None:
    """The search's `adc_segmin` call is the phase-1 stage's: the same
    folded queries, scale, tile and segment (so one twin check holds
    both)."""
    if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            and a[5:] == b[5:]):
        raise RuntimeError("adc_search's phase 1 differs from the probe's")


def main(argv=None) -> dict:
    """Run every stage (the card unless `--device cpu`); returns the
    result line's fields. Raises after the sweep if a tile was refused."""
    p = parser(__doc__, REPS)
    p.add_argument("--n", type=int, default=N)
    p.add_argument("--dim", type=int, default=D)
    p.add_argument("--batches", type=ints, default=BATCHES,
                   help="comma list; the first is phase 1's B")
    p.add_argument("--tiles", type=ints, default=TILES[1:],
                   help="comma list of phase-1 tiles to sweep")
    ns = p.parse_args(argv)
    run = Run("probes.adc", ns.device)
    n, b0, dev = ns.n, ns.batches[0], run.dev
    x = data(n, ns.dim, ns.batches, ns.reps, dev)
    twins, refused = {}, {}
    line(stage="launch overhead",
         ms=1e3 * measure_launch_overhead(dev), shapes={})

    def sweep_tile(tile: int) -> None:
        name = f"phase1 tile={tile} B={b0}"
        why = refusal(x, tile, T._fold_queries, x["stacks"][0][0])
        if why is None:
            fn, _ = phase1(x, n, tile, T._fold_queries)
            phase1_stage(name, fn, x["stacks"][0], ns, dev, twins)
        else:
            refused[name] = line(stage=name, refused=why,
                                 shapes={"tile": tile})["refused"]

    sweep_tile(TILES[0])
    for b, stack in zip(ns.batches, x["stacks"]):
        fn, tile = phase1(x, n, None, search_fold)
        p1 = phase1_stage(f"phase1 (search's) B={b}", fn, stack, ns, dev,
                          twins)

        def full(qb):
            return T.adc_search(qb, None, x["codes"], None, x["cb"], K, n,
                                cb_q=x["cb_q"], srow=x["srow"])
        same_call(recorded_args("adc_segmin", lambda: full(stack[0])),
                  recorded_args("adc_segmin", lambda: fn(stack[0])))
        t = windowed(full, stack, ns)
        stage(f"full fast k={K} B={b}", t,
              {"queries": list(stack.shape[1:]),
               "codes": list(x["codes"].shape), "tile": tile},
              phase1_share=p1["ms"] / t["ms"])
    for tile in ns.tiles:
        sweep_tile(tile)
    r = run.result(n=n, npad=x["npad"], m=M, ksub=KSUB, d=ns.dim, k=K,
                   batches=list(ns.batches), twins=twins, refused=refused)
    if refused:
        raise RuntimeError(f"tiles refused by the kernel: {refused}")
    return r


if __name__ == "__main__":
    main()
