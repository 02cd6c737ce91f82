"""cvt_tpu_torch.parallel.dryrun: the multi-device dry run
(`__graft_entry__.py`'s dryrun_multichip + _dryrun_config5) on gloo
ranks, spawned with a join limit (tests/_torch_dist_workers.py).

The port's function asserts what the JAX dry run asserts: centroid and
result shapes, finite distances, the n-shard server's distances bitwise
equal to a 1-shard server's (ids where the distance is unique), top-1
agreement >= 0.8 with the reference engine, pipelined and 2-D serving,
the batcher. Its k-means data are cvt_tpu's numpy draws, so at dp 2 the
objective equals MULTICHIP_r05.json's (dp 2 x db 4) to its printed
precision, and equals numpy's on the same draws (rtol 1e-5)."""

import json
import os

import numpy as np
import pytest

import _torch_dist_workers as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _numpy_objective(dp: int) -> float:
    """The mean squared distance to the nearest of the 8 first rows, over
    the dry run's 32 * dp training rows."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32 * dp, 128)).astype(np.float32).astype(np.float64)
    d = ((x[:, None] - x[None, :8]) ** 2).sum(-1)
    return float(d.min(1).mean())


@pytest.mark.parametrize("world,dp,db", [(4, 2, 2), (1, 1, 1)])
def test_dryrun_on_gloo_ranks(tmp_path, world, dp, db):
    ranks = W.spawn(tmp_path, "dryrun", world)
    for out in ranks:
        assert (int(out["dp"][0]), int(out["db"][0])) == (dp, db)
        for key in ("objective", "agree", "agree_pipelined"):
            assert float(out[key][0]) == float(ranks[0][key][0])
        assert float(out["agree"][0]) >= 0.8
        np.testing.assert_allclose(float(out["objective"][0]),
                                   _numpy_objective(dp), rtol=1e-5)
        assert ("agree_2d" in out) == (world % 2 == 0)
    if dp == 2:
        with open(os.path.join(ROOT, "MULTICHIP_r05.json")) as f:
            tail = json.load(f)["tail"]
        ref = float(tail.split("objective=")[1].split()[0])
        assert round(float(ranks[0]["objective"][0]), 3) == ref
