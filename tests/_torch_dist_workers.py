"""Rank bodies for tests/test_torch_train.py and tests/test_torch_dryrun.py
(not collected: no test_ prefix). The spawned ranks import this module,
which imports neither jax nor cvt_tpu, so each child starts with torch
alone.

spawn() starts WORLD gloo ranks once (torch.multiprocessing.spawn, a
FileStore in the caller's temporary directory) with a join limit, so a
hang fails one test instead of the run. Each rank runs one of the jobs
below on the fixture's data and writes its results to rank<r>.npz; the
parent compares them with cvt_tpu."""

from __future__ import annotations

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 240


def sharded_arcface(z: dict, rank: int, world: int) -> dict:
    """make_sharded_train_step over a 'dp' mesh of every rank, SGD 1e-2,
    from the carried parameters: three steps, each rank on its quarter of
    the batch (tests/test_train.py:72's scenario)."""
    from cvt_tpu_torch.convert import arcface_from_numpy
    from cvt_tpu_torch.parallel import cpu_mesh
    from cvt_tpu_torch.train import (make_sharded_train_step, parameters,
                                     state_from_params)
    params = {"layers": [{"w": z["w0"], "b": z["b0"]}], "head": z["head"]}
    state, opt = state_from_params(
        arcface_from_numpy(params, device="cpu"),
        lambda p: torch.optim.SGD(p, lr=1e-2))
    step = make_sharded_train_step(cpu_mesh({"dp": world}), opt)
    x, y = z["x"], z["y"]
    per = x.shape[0] // world
    losses = []
    for _ in range(3):
        state, loss = step(state, x[rank * per:(rank + 1) * per],
                           y[rank * per:(rank + 1) * per])
        losses.append(float(loss))
    out = {f"p{j}": p.detach() for j, p in enumerate(parameters(
        state.params))}
    out["losses"] = np.array(losses)
    out["step"] = np.array([state.step])
    return out


def dryrun(z: dict, rank: int, world: int) -> dict:
    """The port's dry run over every rank (its own assertions)."""
    from cvt_tpu_torch.parallel.dryrun import dryrun_multichip
    res = dryrun_multichip(world, verbose=False)
    return {k: np.array([v]) for k, v in res.items()}


JOBS = {"sharded_arcface": sharded_arcface, "dryrun": dryrun}


def run(rank: int, world: int, store_dir: str, job: str, fixture: str,
        out_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        z = dict(np.load(fixture)) if fixture else {}
        out = JOBS[job](z, rank, world)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})
    finally:
        dist.destroy_process_group()


def spawn(tmp_path, job: str, world: int, fixture: dict | None = None):
    """Run `job` on `world` gloo ranks; raise on a rank's failure or when
    the ranks outlive the join limit. Returns each rank's results."""
    out = tmp_path / "out"
    out.mkdir()
    fx = ""
    if fixture is not None:
        fx = str(tmp_path / "fixture.npz")
        np.savez(fx, **fixture)
    ctx = mp.spawn(run, args=(world, str(tmp_path), job, fx, str(out)),
                   nprocs=world, join=False)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after "
                               f"{JOIN_TIMEOUT_S} s")
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
