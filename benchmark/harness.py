"""One run of one cell: set-up, the measured window, the correctness check
and the metrics, driven by data.

Everything that belongs to one cell, configuration, traffic mix, system
or metric is a file of its own, found by the name that `BENCHMARK.json`
gives it:

  * BENCHMARK.json `workloads[name]` -> its `config` and `traffic`;
  * BENCHMARK.json `configs[config].file` -> the deployment's sizes;
  * benchmark/kinds/<kind>.py -> the configuration's kind (its "kind",
    else "adc"): what the deployment loads, its query pool, its plain
    reference and the numbers that decide `correct`, as five functions:
      inputs(cfg, seed, dev) -> (inputs, info), made from the seed by
        plain code, with the seconds each part took;
      query_pool(cfg, traffic, seed, dev), which the traffic's loop
        slices (it needs `shape[0]` and slicing);
      reference(cfg, inputs), with nothing of the port;
      numbers(ref, cfg, traffic, pool, win, dev) -> dict, keyed as the
        cell's limits, the window's own counts among them;
      informative(ref, inputs, pool, win, dev) -> dict, printed, never
        compared;
  * benchmark/traffic/<traffic>.json -> the mix, read by `generator`;
  * benchmark/systems/<system>.py -> how the port is built and called
    (the mix's "system", else the configuration's "index");
  * benchmark/workloads/<name>.json -> the limits of the numbers that
    decide `correct`;
  * benchmark/metrics/<metric>.py -> one reader per metric, `read(ctx)`,
    which returns a number or None when it finds nothing to read;
  * benchmark/roofline/<kernel>.py -> a kernel's operations and bytes.
"""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import data, generator
from benchmark.trace import Tracer, busy_seconds, idle_gaps, op_seconds, top
from benchmark.trace import window as trace_window

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "cvt_tpu")
_IMPORTED = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started (Linux's /proc; elsewhere since
    the harness was imported)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole (`cvt_tpu_torch` is not `cvt_tpu`)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _merge(base: dict, over: dict | None) -> dict:
    out = copy.deepcopy(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


class Registry:
    """The benchmark's files, found by name under a checkout's root."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.dir = os.path.join(root, "benchmark")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def _json(self, *parts) -> dict:
        with open(os.path.join(self.dir, *parts)) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise ValueError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name + ".json")

    def limits(self, cell: str) -> dict:
        return self._json("workloads", cell + ".json")["limits"]

    def kind(self, name: str):
        return _load_file(os.path.join(self.dir, "kinds", name + ".py"),
                          f"benchmark_kind_{name}")

    def system(self, name: str):
        return _load_file(os.path.join(self.dir, "systems", name + ".py"),
                          f"benchmark_system_{name}")

    def roofline(self, kernel: str):
        return _load_file(os.path.join(self.dir, "roofline", kernel + ".py"),
                          f"benchmark_roofline_{kernel}")

    def peaks(self) -> dict:
        return self._json("peaks.json")

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The `end_to_end` or `per_layer` metrics that this cell reports."""
        return [m for m in self.bench[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        return _load_file(os.path.join(self.dir, "metrics", metric + ".py"),
                          "benchmark_metric_" + metric.replace(".", "_"))


def kind_name(cfg: dict) -> str:
    return cfg.get("kind", "adc")


def make_inputs(cfg: dict, seed: int, dev) -> tuple[dict, dict]:
    return Registry().kind(kind_name(cfg)).inputs(cfg, seed, dev)


def reference(cfg: dict, inputs: dict):
    return Registry().kind(kind_name(cfg)).reference(cfg, inputs)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", root: str = ROOT, overrides: dict | None = None,
             fault=None, after=None) -> tuple[dict, dict]:
    """Run one cell once. Returns (the result line's object, information
    for the earlier lines). `overrides` ({"config": ..., "traffic": ...})
    shrink a cell for a test on the CPU; `fault(system)`, when given,
    breaks the system under test after its set-up (the tests' faults);
    `after(ref, pool, win, dev)`, when given, is called with the
    reference, the query pool and the window, and what it returns goes to
    the information under "after" (the controls' readings,
    benchmark/calibrate.py)."""
    overrides = overrides or {}
    started = process_age()
    reg = Registry(root)
    cell = reg.cell(name)
    cfg = _merge(reg.config(cell["config"]), overrides.get("config"))
    traffic = _merge(reg.traffic(cell["traffic"]), overrides.get("traffic"))
    limits = reg.limits(name)
    kind = reg.kind(kind_name(cfg))
    sysmod = reg.system(traffic.get("system", cfg["index"]))
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = int(seed) % 2 ** 63

    inputs, info = kind.inputs(cfg, seed, dev)
    info["start_s"] = started
    pool = kind.query_pool(cfg, traffic, seed, dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    system = sysmod.System(cfg, inputs, traffic, dev)
    data.sync(dev)
    info["build_s"] = time.perf_counter() - t
    del inputs
    t = time.perf_counter()
    warm, loop = generator.LOOPS[traffic["loop"]]
    warm(system, pool, traffic)
    tracer = Tracer(trace, seconds)
    tracer.warm()
    data.sync(dev)
    info["warm_s"] = time.perf_counter() - t
    if fault is not None:
        fault(system)
    # what set-up left behind is kept out of the collector's sweeps, so
    # that no full collection over it stalls the window
    gc.collect()
    gc.freeze()
    setup_s = process_age()
    rng = np.random.default_rng(data.seed_for(seed, "traffic"))
    win = loop(system, pool, traffic, seconds, rng, tracer)
    gc.unfreeze()

    events = tracer.events()
    memory = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference works the inputs out again from the seed
    t = time.perf_counter()
    inputs, _ = kind.inputs(cfg, seed, dev)
    ref = kind.reference(cfg, inputs)
    numbers = kind.numbers(ref, cfg, traffic, pool, win, dev)
    info["reference_s"] = time.perf_counter() - t
    info.update(kind.informative(ref, inputs, pool, win, dev))
    if after is not None and win.sample_rows is not None:
        info["after"] = after(ref, pool, win, dev)
    del inputs
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items()}
    correct = win.sample_rows is not None and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())

    ctx = SimpleNamespace(
        cell=name, config=cfg, traffic=traffic, window=win, seed=seed,
        setup_s=setup_s, events=events, slice=trace_window(events),
        traced_calls=tracer.calls,
        pool=pool, ref=ref, registry=reg, device=dev,
        kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
        scan_kernel=sysmod.SCAN_KERNEL)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in reg.metrics(name, kind):
        value = reg.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu", "kind": ctx.kind,
                "count": 1, "memory_peak_bytes": memory}
    result = {"correct": bool(correct), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": dev_info}
    if trace and ctx.slice is not None:
        w0, w1 = ctx.slice
        dev_info["busy_s"] = busy_seconds(events, w0, w1)
        dev_info["window_s"] = w1 - w0
        result["breakdown"] = {
            "device_ops": top(op_seconds(events, w0, w1)),
            "idle_gaps": top(idle_gaps(events, w0, w1))}
    result["checks"] = checks
    info.update(setup_s=setup_s, window_s=win.seconds,
                queries=win.queries, **win.extra)
    info["numbers"] = numbers
    return result, info
