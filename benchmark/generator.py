"""The one traffic generator. It reads a traffic mix
(`benchmark/traffic/<name>.json`) and drives the system under test with it
for the window:

  * "loop": "closed" -- one caller sends a batch of `batch` queries, takes
    its ids and distances to the host, and sends the next; the batches
    are consecutive slices of a pool of `pool` fresh queries held in host
    memory, from a start drawn from the seed.

It keeps, for the correctness check, the answers of a sample of the
queries drawn from the seed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Window:
    """What a window did, for the metrics and the correctness check."""
    attempted: int = 0            # queries sent
    failed: int = 0
    queries: int = 0              # query rows answered
    seconds: float = 0.0          # the window's whole time
    dropped_pages: int = 0
    sample_rows: np.ndarray | None = None    # pool rows of the sample
    sample_ids: np.ndarray | None = None
    sample_dists: np.ndarray | None = None
    traced_offsets: list = field(default_factory=list)
    extra: dict = field(default_factory=dict)


def warm_closed(system, pool: np.ndarray, traffic: dict, calls: int = 3):
    b = traffic["batch"]
    for j in range(calls):
        system.search(pool[j * b:(j + 1) * b])


def closed(system, pool: np.ndarray, traffic: dict, seconds: float,
           rng: np.random.Generator, tracer) -> Window:
    b = traffic["batch"]
    per_pool = pool.shape[0] // b
    keep = traffic["keep_per_batch"]
    first = int(rng.integers(0, per_pool))
    rows, ids, dists = [], [], []
    w = Window()
    j = 0
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        tracer.tick(now - t0)
        off = ((first + j) % per_pool) * b
        if tracer.active:
            w.traced_offsets.append(off)
        d, i, dropped = system.search(pool[off:off + b])
        pos = rng.integers(0, b, size=keep)
        rows.append(off + pos)
        ids.append(i[pos])
        dists.append(d[pos])
        w.dropped_pages += dropped
        j += 1
    w.seconds = time.perf_counter() - t0
    tracer.stop()
    w.attempted = w.queries = j * b
    w.extra["batches"] = j
    pick = rng.choice(len(rows) * keep, size=min(traffic["sample"],
                                                 len(rows) * keep),
                      replace=False)
    w.sample_rows = np.concatenate(rows)[pick]
    w.sample_ids = np.concatenate(ids)[pick]
    w.sample_dists = np.concatenate(dists)[pick]
    return w


LOOPS = {"closed": (warm_closed, closed)}
