"""Readings that the limits of `correct` are set from: the program's, and
its control's, cell by cell on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3
                                   [--seconds 3] [--control]

For each seed, one run of the cell with a short window at the cell's own
load (the window's whole traffic, its answers sampled as a full run
samples them), then, with --control, the control of
`benchmark/reference/control.py` put in the program's place on the same
sampled queries. One JSON line per seed with both sets of numbers, then a
summary: the largest of the program's readings (the lower reading) and
the smallest of the control's (the upper reading). The benchmark's own
runs never run the control.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402


def control_numbers(cfg: dict, traffic: dict):
    """The control's numbers on the sampled queries, and beside them the
    program's rank_gap against the plain top k, with no selection (a
    reading for PERF.md, never a limit)."""
    import copy

    from benchmark.reference import compare, control

    def after(ref, q, ids, dists):
        if cfg["quantizer"]["kind"] == "opq":
            d, i = control.flat_int4(ref, q, traffic["k"])
        else:
            d, i = control.ivf_int8(ref, q, traffic["k"], traffic["nprobe"])
        out = compare.numbers(ref, q, i, d, traffic.get("nprobe"))
        plain = copy.copy(ref)
        plain.sel = None
        out["program_rank_gap_plain"] = compare.numbers(
            plain, q, ids, dists, traffic.get("nprobe"))["rank_gap"]
        return out
    return after


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
    after = control_numbers(cfg, traffic) if args.control else None
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
                            if k != "program_rank_gap_plain"}
        summary["program_rank_gap_plain"] = max(
            c["program_rank_gap_plain"] for c in ctrl)
    print(json.dumps({"workload": args.workload, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
