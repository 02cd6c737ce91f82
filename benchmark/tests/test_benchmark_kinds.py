"""A configuration's kind (benchmark/kinds/<kind>.py): its inputs, query
pool, reference and the numbers that decide `correct`. A kind of another
shape runs from new files alone, and the ADC kind reads, bit for bit, what
the harness read before kinds were files of their own."""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY
from benchmark import generator, harness

SEED = 2 ** 31 + 99
CELLS = ["sift1m-opq8.b256", "sift1m-ivf8192-pq16.b4096-np16"]

# sha256 of what the harness of the commit before kinds were files made
# for each committed configuration at the CPU test size (TINY) and SEED,
# taken by `adc_digests` with the harness's own functions of that commit
# (make_inputs, data.query_pool, reference, check_numbers and
# compare.exact_recall)
PARENT = {
    "sift1m-opq8.b256": {
        "inputs.base":
            "b3cf5cc7f95d946f13c3066988b3b8cc51471094c3b594a174773f458ba3e39c",
        "inputs.codebooks":
            "424610fb3517d4b18a18902132a89a0f4b1e1d38b438904bd5cb3405a5a8c282",
        "inputs.rotation":
            "de78f426756349704fb23ac0031ed5e805c1639271e4074eac3c466873ceda1d",
        "pool":
            "2847e915723098257abd2e265aa730138f16c7e35fd822bd3bb095260e3037a3",
        "best.dists":
            "7bc08829ea6516c7bef15f98c6a88dfd20b98230ce32815598a82903bbf610a0",
        "best.ids":
            "0eca5e1e376c9a7fb255ea5c0ca06e3c7945dc08f3a3d8a1f1c930b37c051324",
        "numbers":
            "b3f5980c8eb9b253eb6e5522feb9dc768805e4d97ae2fa9f3af117517b7d098a",
        "informative":
            "8a9efd26d72c8557d394de5d0e4a8fed47f6815aff42da09bded36d3bb911033",
    },
    "sift1m-ivf8192-pq16.b4096-np16": {
        "inputs.base":
            "b3cf5cc7f95d946f13c3066988b3b8cc51471094c3b594a174773f458ba3e39c",
        "inputs.centroids":
            "b7b9c91204a916378ccb7c197d6b5f337d41229a81b9e84d5b67de96d52e4d3f",
        "inputs.codebooks":
            "2a6413b57b4b9f4ed29748524fd7ed54a16a8ac8c16d6a7a4e5aeff38e093e8d",
        "pool":
            "2847e915723098257abd2e265aa730138f16c7e35fd822bd3bb095260e3037a3",
        "best.dists":
            "b4044ae3bbb1f50c03e9f6557ba1b3905496625fe703e89398b197d928db2fdf",
        "best.ids":
            "92db0777711d19e69ce19cfde8f60eebaa66f3194cd5565d6263d2ff25ddfd54",
        "numbers":
            "727f60e410a833f18ac2bf4c414331675c460c4056faf730f01c0866f8480200",
        "informative":
            "640ac76ad2ecc56c2fc52b9d5122ff088b02b9eff8b227c4dbbea1dcaa6a18ed",
    },
}


def _sha(x) -> str:
    a = x.detach().cpu().contiguous().numpy() if torch.is_tensor(x) \
        else np.ascontiguousarray(x)
    h = hashlib.sha256(f"{a.dtype}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _sha_dict(d: dict) -> str:
    return hashlib.sha256(json.dumps(d, sort_keys=True).encode()).hexdigest()


def _cell(cell):
    reg = harness.Registry(ROOT)
    w = reg.cell(cell)
    cfg = harness._merge(reg.config(w["config"]), TINY["config"])
    traffic = harness._merge(reg.traffic(w["traffic"]), TINY["traffic"])
    return cfg, traffic


def fake_window(d_best, i_best, n: int):
    """A window whose sample is the pool's first rows, answered by the
    reference's best with each distance a little off and every fourth
    query's last id moved half the index away."""
    ids = i_best.numpy().copy()
    ids[::4, -1] = (ids[::4, -1] + n // 2) % n
    scale = 1.0 + 1e-4 * np.arange(ids.shape[1])
    dists = (d_best.numpy() * scale).astype(np.float32)
    return generator.Window(sample_rows=np.arange(ids.shape[0]),
                            sample_ids=ids, sample_dists=dists)


def adc_digests(cell, inputs, query_pool, reference, numbers, informative,
                queries: int = 64) -> dict:
    """Digests of one cell's inputs, pool, the reference's best of the
    pool's first `queries` rows, and the numbers and informative readings
    of a fixed fake window, from the five functions given."""
    cfg, traffic = _cell(cell)
    dev = torch.device("cpu")
    inp, _ = inputs(cfg, SEED, dev)
    out = {"inputs." + k: _sha(v) for k, v in sorted(inp.items())}
    pool = query_pool(cfg, traffic, SEED, dev)
    out["pool"] = _sha(pool)
    ref = reference(cfg, inp)
    q = torch.as_tensor(pool[:queries])
    extra = (traffic["nprobe"],) if "nprobe" in traffic else ()
    d, i = ref.best(q, traffic["k"], *extra)
    out["best.dists"], out["best.ids"] = _sha(d), _sha(i)
    win = fake_window(d, i, ref.n)
    out["numbers"] = _sha_dict(numbers(ref, cfg, traffic, pool, win, dev))
    out["informative"] = _sha_dict(informative(ref, inp, pool, win, dev))
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_the_adc_kind_reads_what_the_harness_read_before(cell):
    cfg, _ = _cell(cell)
    assert "kind" not in cfg
    kind = harness.Registry(ROOT).kind("adc")
    got = adc_digests(cell, kind.inputs, kind.query_pool, kind.reference,
                      kind.numbers, kind.informative)
    assert got == PARENT[cell]
    # the harness's delegations give the same
    inp, _ = harness.make_inputs(cfg, SEED, torch.device("cpu"))
    assert {"inputs." + k: _sha(v) for k, v in inp.items()} == {
        k: v for k, v in PARENT[cell].items() if k.startswith("inputs.")}


# ------------------------------------------------ a kind added as files

TOY_KIND = '''"""Raw float vectors searched exactly by L2: the reference is a plain
float64 top k over every row."""

import torch

from benchmark import data


def inputs(cfg, seed, dev):
    return {"base": data.base_vectors(seed, cfg["n"], cfg["dim"], dev)}, {}


def query_pool(cfg, traffic, seed, dev):
    return data.query_pool(seed, cfg["n"], cfg["dim"], traffic["pool"], dev)


class ExactL2:
    def __init__(self, base):
        self.base = base.double()
        self.n = base.shape[0]

    def dists(self, q, ids):
        ok = (ids >= 0) & (ids < self.n)
        x = self.base[torch.where(ok, ids, 0)]
        d = torch.sum((q.double()[:, None] - x) ** 2, -1)
        return torch.where(ok, d, float("inf"))

    def best(self, q, k):
        qd = q.double()
        d = (torch.sum(qd * qd, 1)[:, None] - 2.0 * qd @ self.base.T
             + torch.sum(self.base * self.base, 1)[None])
        return torch.topk(d, k, dim=1, largest=False)


def reference(cfg, inputs):
    return ExactL2(inputs["base"])


def numbers(ref, cfg, traffic, pool, win, dev):
    out = {"unanswered": win.failed}
    if win.sample_rows is None:
        return out
    q = torch.as_tensor(pool[win.sample_rows])
    ids = torch.as_tensor(win.sample_ids).long()
    d_ref = ref.dists(q, ids)
    d_best = ref.best(q, ids.shape[1]).values
    gap = (torch.sort(d_ref, 1).values - d_best) / d_best.clamp_min(1.0)
    out["rank_gap"] = float(gap.max())
    return out


def informative(ref, inputs, pool, win, dev):
    return {}
'''

TOY_SYSTEM = '''"""The port's exact flat index, `FlatIndex.search(q_host, k)`."""

SCAN_KERNEL = "chunked_topk_scan"


class System:
    def __init__(self, cfg, inputs, traffic, device):
        from cvt_tpu_torch.index.flat import FlatIndex

        self.index = FlatIndex(cfg["dim"], device=device)
        self.index.add(inputs["base"])
        self.k = traffic["k"]

    def search(self, q):
        d, i = self.index.search(q, self.k)
        return d.cpu().numpy(), i.cpu().numpy(), 0
'''

TOY_CELL = "toy-exactl2.b64"


def _files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


@pytest.fixture
def toy_root(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _files(tmp_path)
    old = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    (b / "kinds" / "exactl2.py").write_text(TOY_KIND)
    (b / "systems" / "exactl2.py").write_text(TOY_SYSTEM)
    (b / "configs" / "toy-exactl2.json").write_text(json.dumps(
        {"name": "toy-exactl2", "kind": "exactl2", "index": "exactl2",
         "n": 4096, "dim": 32, "reduced": []}))
    (b / "traffic" / "b64.json").write_text(json.dumps(
        {"loop": "closed", "batch": 64, "k": 10, "pool": 1024,
         "keep_per_batch": 4, "sample": 128}))
    (b / "workloads" / (TOY_CELL + ".json")).write_text(json.dumps(
        {"limits": {"unanswered": 0, "rank_gap": 1e-6}}))
    bench = json.loads(json.dumps(old))
    bench["configs"].append({"name": "toy-exactl2", "source": "a test's",
                             "file": "benchmark/configs/toy-exactl2.json",
                             "reduced": [], "why": "a test's"})
    bench["workloads"].append({"name": TOY_CELL, "config": "toy-exactl2",
                               "traffic": "b64", "chips": 1,
                               "why": "a test's"})
    next(m for m in bench["end_to_end"] if m["name"] == "qps")[
        "workloads"].append(TOY_CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    yield tmp_path
    # every file of the copy but BENCHMARK.json is as it was, and
    # BENCHMARK.json is as it was but for the entries added above
    after = _files(tmp_path)
    before.pop("BENCHMARK.json")
    assert {k: v for k, v in after.items() if k in before} == before
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].pop()
    bench["workloads"].pop()
    next(m for m in bench["end_to_end"] if m["name"] == "qps")[
        "workloads"].remove(TOY_CELL)
    assert bench == old


def _shift_ids(system):
    search = system.search

    def broken(q):
        d, i, dropped = search(q)
        return d, i + 1, dropped
    system.search = broken


@pytest.mark.parametrize("fault", [None, _shift_ids], ids=["sound",
                                                           "ids shifted"])
def test_a_kind_added_as_files_alone(toy_root, fault):
    result, _ = harness.run_cell(TOY_CELL, SEED, 0.5, False,
                                 device="cpu", root=str(toy_root),
                                 fault=fault)
    checks = result["checks"]
    assert set(checks) == {"unanswered", "rank_gap"}
    assert result["attempted"] > 0
    assert result["correct"] == (fault is None), checks
    assert set(result["metrics"]) == {"qps", "setup_s"}
