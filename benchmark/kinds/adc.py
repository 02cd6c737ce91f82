"""The ADC kind: SIFT-like base vectors and a trained OPQ (flat) or IVF
quantizer as the deployment's inputs, fresh queries from the same mixture
as its pool, the plain float64 ADC index as its reference
(benchmark/reference/adc.py), and `compare.numbers` on the window's sample
as the numbers that decide `correct`.

A configuration without a "kind" key is of this kind. Beside the five
functions of every kind (benchmark/harness.py), it gives benchmark/
calibrate.py its control: the reference one precision below the
configuration's, on the window's sample.
"""

from __future__ import annotations

import copy
import time

import torch

from benchmark import data
from benchmark.reference import adc, compare, control as controls


def inputs(cfg: dict, seed: int, dev) -> tuple[dict, dict]:
    """The base vectors and the trained quantizer, and the seconds each
    took."""
    t = time.perf_counter()
    base = data.base_vectors(seed, cfg["n"], cfg["dim"], dev)
    data.sync(dev)
    t_data = time.perf_counter() - t
    q = cfg["quantizer"]
    if q["kind"] == "opq":
        rot, cb = data.flat_quantizer(seed, base, q)
        out = {"base": base, "rotation": rot, "codebooks": cb}
    else:
        cent, cb = data.ivf_quantizer(seed, base, q)
        out = {"base": base, "centroids": cent, "codebooks": cb}
    data.sync(dev)
    return out, {"data_s": t_data,
                 "quantizer_s": time.perf_counter() - t - t_data}


def query_pool(cfg: dict, traffic: dict, seed: int, dev):
    return data.query_pool(seed, cfg["n"], cfg["dim"], traffic["pool"], dev)


def reference(cfg: dict, inputs: dict):
    if cfg["quantizer"]["kind"] == "opq":
        return adc.FlatADC(inputs["base"], inputs["rotation"],
                           inputs["codebooks"], cfg.get("selection"))
    return adc.IVFADC(inputs["base"], inputs["centroids"],
                      inputs["codebooks"])


def _sample(pool, win, dev):
    """The sampled queries, and the program's ids and distances for them."""
    q = torch.as_tensor(pool[win.sample_rows], device=dev)
    ids = torch.as_tensor(win.sample_ids, device=dev).long()
    dists = torch.as_tensor(win.sample_dists, device=dev)
    return q, ids, dists


def numbers(ref, cfg: dict, traffic: dict, pool, win, dev) -> dict:
    """The numbers of `compare.numbers` on the window's sample, and the
    window's own counts of what never came or was cut."""
    out = {"unanswered": win.failed, "dropped_pages": win.dropped_pages}
    if win.sample_rows is None:
        return out
    out.update(compare.numbers(ref, *_sample(pool, win, dev),
                               traffic.get("nprobe")))
    return out


def informative(ref, inputs: dict, pool, win, dev) -> dict:
    """recall@1 and @k against the exact L2 nearest row of the raw base."""
    if win.sample_rows is None:
        return {}
    q, ids, _ = _sample(pool, win, dev)
    return compare.exact_recall(inputs["base"], q, ids)


def control(ref, cfg: dict, traffic: dict, pool, win, dev) -> dict:
    """The control's numbers on the window's sample (flat: int4; IVF:
    int8, benchmark/reference/control.py), and beside them the program's
    rank_gap against the plain top k, with no selection (a reading for
    PERF.md, never a limit)."""
    q, ids, dists = _sample(pool, win, dev)
    nprobe = traffic.get("nprobe")
    if cfg["quantizer"]["kind"] == "opq":
        d, i = controls.flat_int4(ref, q, traffic["k"])
    else:
        d, i = controls.ivf_int8(ref, q, traffic["k"], nprobe)
    out = compare.numbers(ref, q, i, d, nprobe)
    plain = copy.copy(ref)
    plain.sel = None
    out["program_rank_gap_plain"] = compare.numbers(
        plain, q, ids, dists, nprobe)["rank_gap"]
    return out
