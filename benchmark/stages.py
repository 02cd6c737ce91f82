"""Time per stage of the port's search, from one traced run of a cell and
the port's spans (benchmark/spans.py): for each span, the device ms per
batch of the operations launched inside it (innermost span), and the host
ms per batch inside it, whole and by itself (less the spans it holds);
"(caller)" holds the device work launched outside every span. The
outermost search span and "(caller)" also give their device idle time as
a share of the slice, both on the host clock (benchmark/spans.py).

    python3 benchmark/stages.py --workload <cell> --seed <n> [--seconds 10]

From the root of a checkout, on the card. Prints one JSON object: the
run's `correct` and per-layer metrics, the traced batches, and `stages`
(null for a program without spans).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import argparse  # noqa: E402
import json  # noqa: E402
from types import SimpleNamespace  # noqa: E402

from benchmark import harness, spans, trace  # noqa: E402


def traced_run(cell: str, seed: int, seconds: float, *, device="cuda",
               overrides=None):
    """Run a cell once with --trace 1; returns (result, the run's tracer,
    which holds the profile). `harness.run_cell` returns no events, so
    the run's Tracer is swapped for one that is kept, for the run."""
    kept = []

    class Kept(trace.Tracer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            kept.append(self)

    plain, harness.Tracer = harness.Tracer, Kept
    try:
        result, _ = harness.run_cell(cell, seed, seconds, True,
                                     device=device, overrides=overrides)
    finally:
        harness.Tracer = plain
    return result, kept[0]


def table(events, bounds, calls: int) -> dict | None:
    """{span: {device_ms, host_ms, self_ms}} per batch, the outermost
    search span with its `idle_pct` of the slice and "(caller)" with its
    device ms and idle share; None where `spans.read` finds nothing to
    read."""
    got = spans.read(SimpleNamespace(events=events, slice=bounds,
                                     traced_calls=calls))
    if got is None:
        return None
    per = 1e3 / got.batches
    rows = {name: {"device_ms": per * got.device_s.get(name, 0.0),
                   "host_ms": per * whole, "self_ms": per * own}
            for name, (whole, own) in sorted(got.host.items())}
    for name in spans.SEARCH:
        if name in rows:
            rows[name]["idle_pct"] = 100.0 * got.idle_s / got.window_s
    rows["(caller)"] = {"device_ms": per * got.device_s.get(None, 0.0),
                        "idle_pct": 100.0 * got.caller_idle_s / got.window_s}
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    result, tracer = traced_run(args.workload, args.seed, args.seconds)
    events = tracer.events()
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "correct": result["correct"], "batches": tracer.calls,
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "stages": table(events, trace.window(events), tracer.calls)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
