"""Run one cell of the port's benchmark once, on the card, and print its
result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout. It makes its inputs from the seed, builds
and warms up the port's index, measures for --seconds, checks a sample of
the answers against the plain reference (benchmark/reference), and prints
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), `device`,
with --trace 1 `breakdown`, and last `checks`, each number compared beside
its limit (also the last lines of standard error).

Exits with a code other than 0, and prints no result, without a card or
with fewer cards than the cell asks for, when the port is missing, or
when JAX, Flax or the JAX package was loaded.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")
# every compile cache inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host's cores are shared
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "2"
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi gave nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    reg = harness.Registry(ROOT)
    chips = reg.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    import cvt_tpu_torch  # noqa: F401  (fails here when the port is absent)

    print("card:", _card_line(), file=sys.stderr)
    result, info = harness.run_cell(args.workload, args.seed, args.seconds,
                                    bool(args.trace), device="cuda")
    found = harness.forbidden_modules()
    if found:
        print("loaded in this process, and forbidden here: "
              + ", ".join(found), file=sys.stderr)
        return 3
    print(json.dumps({"info": info}))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
