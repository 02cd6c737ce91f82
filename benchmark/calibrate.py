"""Readings that the limits of `correct` are set from: the program's, and
its control's, cell by cell on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3
                                   [--seconds 3] [--control]

For each seed, one run of the cell with a short window at the cell's own
load (the window's whole traffic, its answers sampled as a full run
samples them), then, with --control, the control of the configuration's
kind (`control` in benchmark/kinds/<kind>.py) put in the program's place
on the same sampled queries. One JSON line per seed with both sets of
numbers, then a summary: the largest of the program's readings (the lower
reading) and the smallest of the control's (the upper reading); a
control's reading named "program_..." is of the program, beside it, and
is summed up by its largest. The benchmark's own runs never run the
control.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from benchmark import harness

    reg = harness.Registry(ROOT)
    cell = reg.cell(args.workload)
    cfg = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    kind = reg.kind(harness.kind_name(cfg))
    after = None
    if args.control:
        def after(ref, pool, win, dev):
            return kind.control(ref, cfg, traffic, pool, win, dev)
    program, ctrl = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        result, info = harness.run_cell(args.workload, seed, args.seconds,
                                        False, device=args.device,
                                        after=after)
        line = {"seed": seed, "program": info["numbers"],
                "control": info.get("after"),
                "correct": result["correct"],
                "metrics": {k: v["value"]
                            for k, v in result["metrics"].items()},
                "setup_s": info["setup_s"],
                "reference_s": info["reference_s"]}
        print(json.dumps(line), flush=True)
        program.append(info["numbers"])
        if info.get("after"):
            ctrl.append(info["after"])
    summary = {"lower": {k: max(p[k] for p in program) for k in program[0]}}
    if ctrl:
        summary["upper"] = {k: min(c[k] for c in ctrl) for k in ctrl[0]
                            if not k.startswith("program_")}
        summary.update({k: max(c[k] for c in ctrl) for k in ctrl[0]
                        if k.startswith("program_")})
    print(json.dumps({"workload": args.workload, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
