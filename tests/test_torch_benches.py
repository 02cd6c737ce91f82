"""The seven workload suites of `cvt_tpu_torch.benches` on the CPU at tiny
sizes, against `cvt_tpu` and the top-level `_bench_*.py` scripts on the
same numpy inputs; their kernels run their plain twins here.

(a) Each suite's `main(device="cpu")` prints only JSON lines, one per
    lane, and a last line with the suite, the device ("cpu"), the kernel
    launches (0 here) and the kernel figures; without a card and without
    the CPU asked for, each raises.
(b) vocab5: the patch bank, the mosaics and `random_h` bitwise equal the
    script's (its nested `make_images` is rebuilt from its code object);
    a warped, jittered query image within 1e-4 of the script's sequence
    over `cvt_tpu`'s warp (bilinear float32 sums in another order).
(c) dogfood: the uint8 export rule bitwise equals the script's own line
    on the same float descriptors; `config2` handed a `cvt_tpu` OPQ index
    carried across gives `cvt_tpu`'s fast and exact recall exactly, and
    the reference engine's within its top-1 near-ties.
(d) ivf: the chunked `merge_topk` ground truth equals `cvt_tpu`'s exact
    FlatIndex top-10 (ids equal, a swap only between distances within
    1e-5 relative; distances rtol 1e-5); the lanes handed a `cvt_tpu`
    IVF index carried across give `cvt_tpu`'s `search_fast` ids at the
    suite's page budget (Pallas in interpret mode) and its `search_fast`
    / `search()` recall (ids as tests/test_torch_ivf_scan.assert_ids_match
    holds them).
(f) `ops.kernels.recorded_args` returns a call's own wrapper arguments
    and leaves the wrapper as it was; `twin_check` leaves the launch
    count as it was.
(e) hnsw: the corpus and the ground truth bitwise equal the script's;
    single-threaded builds and sweeps give `cvt_tpu` HnswIndex's labels.
Card only (marker `cuda`, skipped here; the file imports no JAX at its
top, so they run with --noconftest where JAX is not installed):
`adc_segmin` at m 16 with 8-d subvectors (D 128), B 256, Npad 65,536
and `ivf_page` over the IVF suite's own pages at nprobe 16 (more pages
than any other test), each bitwise against its twin on the arguments
the suite's indexes hand it.
"""

import inspect
import json
import textwrap
import types

import numpy as np
import pytest
import torch

from cvt_tpu_torch.benches import (dogfood, features, hnsw, ivf, serve,
                                   vocab, vocab5)
from cvt_tpu_torch.benches._common import parse_args
from cvt_tpu_torch.convert import flat_adc_from_numpy, ivf_adc_from_numpy
from cvt_tpu_torch.index import IVFADCIndex
from cvt_tpu_torch.io.datasets import procedural_images
from cvt_tpu_torch.ops.kernels import adc_scan as T
from cvt_tpu_torch.ops.kernels import ivf_scan as V
from cvt_tpu_torch.ops.kernels import recorded_args, wrappers

# jax, cvt_tpu and the scripts are imported inside the CPU tests, so that
# the card-only cases run where JAX is not installed (--noconftest -m cuda)

CPU = torch.device("cpu")
SUITES = ("ivf", "serve", "dogfood", "vocab5", "vocab", "features", "hnsw")
RESULT_KEYS = {"suite", "device", "kernel_launches", "kernels", "seconds"}


@pytest.fixture(autouse=True)
def one_window(monkeypatch):
    """One timed window per figure and two torch threads: the workers of
    a parallel test run share the cores, and torch's default of a thread
    per core then slows the suites' many small CPU operations tenfold."""
    from cvt_tpu_torch import bench
    from cvt_tpu_torch.benches import _common
    monkeypatch.setattr(_common, "WINDOWS", 1)
    monkeypatch.setattr(bench, "WINDOWS", 1)
    monkeypatch.setattr(features, "EXTRACT_WINDOWS", 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _tiny(name: str, tmp_path, monkeypatch):
    """The suite's main at a tiny size on the CPU."""
    if name == "ivf":
        return ivf.main("cpu", n_list=(8192,), chunk=4096, batch=32,
                        n_gt=64, n_queries=256, n_clusters=256,
                        coarse_k=64, iters=3, stack_n=2)
    if name == "serve":
        return serve.main("cpu", n=8192, batch=256, n_train=1024, n_rec=128,
                          stack_n=2)
    if name == "dogfood":
        return dogfood.main("cpu", "all", data_dir=str(tmp_path), n_rec=64,
                            iters=2, n_base=2048, n_query=128, k=128,
                            batch=2, h=96, w=128)
    if name == "vocab5":
        # part B finds no corpus in tmp_path and extracts one at these sizes
        for key, v in dict(N_BASE=2048, N_QUERY=64, K_PER_IMAGE=128,
                           BATCH=2, H=96, W=128).items():
            monkeypatch.setattr(dogfood, key, v)
        return vocab5.main(
            "cpu", "AB",
            part_a_sizes=dict(n_db=4, n_q=2, bb=4, n_words=64, iters=3),
            part_b_sizes=dict(data_dir=str(tmp_path), n_words=256,
                              n_train=2048, n_images=4, per=64, n_q=2,
                              q_start=1024, iters=3))
    if name == "vocab":
        return vocab.main("cpu", small=True, w=256, n_train=4096,
                          n_images=4, k_feat=32, n_queries=2,
                          n_clusters=256)
    if name == "features":
        return features.main("cpu", sweep=((1, 256), (2, 128)), h=96, w=128,
                             iters=2, match_k=256, match_iters=2, n_verify=2)
    return hnsw.main("cpu", n=2000, n_queries=50, efs=(10, 80))


def _gate_keys(name: str, r: dict) -> list:
    """The numbers chip_smoke.py's step 28 holds each suite's line to."""
    if name == "ivf":
        row = r["rows"][0]
        return [row["ivf_nprobe16"]["r10"], row["search"]["r10"],
                row["ivf_nprobe16"]["dropped"], row["flat"]["r10"],
                r["kernels"]["ivf_page"]["8192"]["16"]["bound_ms"]]
    if name == "serve":
        return [r["top1_agreement"], r["parity_pt"],
                r["rows"]["serving_tax"], r["kernels"]["adc_segmin"]["ms"]]
    if name == "dogfood":
        c2 = r["config2_opq64"]
        return [c2["parity_pt"], c2["recall_at_1_exact"],
                c2["recall_at_1_fast"], r["config1_sq_d128"]["recall_at_1"],
                r["kernels"]["adc_segmin_cached"]["bound_ms"]]
    if name == "vocab5":
        sw = r["A"]["sweep"]
        return [sw["probes=8"]["recall_at_1"],
                sw["probes=8+verify10"]["recall_at_1"],
                r["B"]["queries"]["probes=16"]["img_per_s_steady"]]
    if name == "vocab":
        mp = r["multiprobe"]
        return [mp["agree8"], mp["agree16"], r["exact_assign"]["seconds"]]
    if name == "features":
        return [r["extract"]["b2_k128"]["keypoints_mean"],
                r["match_k256"]["pairs_per_s"],
                r["verify_two_view"]["pairs_per_s"]]
    return [next(s["recall"] for s in r["sweep"] if s["ef"] == 80)]


@pytest.mark.parametrize("name", SUITES)
def test_suite_main_on_cpu(name, tmp_path, monkeypatch, capsys):
    r = _tiny(name, tmp_path, monkeypatch)
    lines = capsys.readouterr().out.strip().splitlines()
    said = [ln for ln in lines if not ln.startswith("{")]
    if name == "vocab5":           # B found no corpus in tmp_path
        assert len(said) == 1 and "running dogfood extract first" in said[0]
    else:
        assert not said, said
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    *lanes, last = rows
    assert lanes and all("lane" in ln for ln in lanes)
    assert last == json.loads(json.dumps(r))
    assert RESULT_KEYS <= set(r) and r["suite"] == name
    assert r["device"] == "cpu"
    assert r["kernel_launches"] == {name: 0 for name in wrappers()}
    for x in _gate_keys(name, r):
        assert np.isfinite(x), (name, x)


@pytest.mark.parametrize("name", SUITES)
def test_suite_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        globals()[name].main()


def test_parse_args():
    assert parse_args(["AB", "--device", "cpu"]) == (["AB"], "cpu")
    assert parse_args([]) == ([], None)


# ------------------------------------------------------------- vocab5
def _script_make_images(bank: np.ndarray):
    """The script's `make_images`, nested in build_part_a over BANK."""
    import _bench_vocab5
    code = next(c for c in _bench_vocab5.build_part_a.__code__.co_consts
                if getattr(c, "co_name", None) == "make_images")
    assert code.co_freevars == ("BANK",)
    return types.FunctionType(code, vars(_bench_vocab5), "make_images",
                              None, (types.CellType(bank),))


def test_vocab5_mosaics_and_homographies_equal_the_script():
    import _bench_vocab5
    bank = vocab5.patch_bank()
    np.testing.assert_array_equal(
        bank, _bench_vocab5.procedural_images(16, 160, 160, seed=777))
    script = _script_make_images(bank)
    for lo in (0, 16):
        seed = vocab5.DB_SEED0 + lo // vocab5.BB
        got = vocab5.make_images(bank, 4, seed)
        assert got.dtype == np.float32 and got.shape == (4, 480, 640)
        np.testing.assert_array_equal(got, script(lo, 4, seed))
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(8):
        np.testing.assert_array_equal(vocab5.random_h(a),
                                      _bench_vocab5._random_h(b))


def test_vocab5_query_image_matches_the_script():
    """The script's sequence: _random_h, cvt_tpu's warp, then its
    photometric jitter line (copied from build_part_a)."""
    import _bench_vocab5
    im = vocab5.make_images(vocab5.patch_bank(), 1, 7)[0]
    got = vocab5.query_image(im, np.random.default_rng(3), CPU)
    rng = np.random.default_rng(3)
    hm = _bench_vocab5._random_h(rng)
    wi = np.asarray(_bench_vocab5.warp_image_homography(im, hm, 480, 640))
    wi = np.clip(wi ** rng.uniform(0.7, 1.4)      # gamma
                 * rng.uniform(0.6, 1.3)
                 + rng.uniform(-0.1, 0.1)
                 + rng.normal(0, 0.05, wi.shape), 0, 1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, wi.astype(np.float32), rtol=0,
                               atol=1e-4)


# ------------------------------------------------------------ dogfood
def test_dogfood_export_rule_equals_the_script():
    """On cvt_tpu's own float descriptors and on values at the rule's
    edges (ties at half-integers, negatives, past 255)."""
    import _bench_dogfood
    from cvt_tpu.features.covdet import extract_sift as jextract_sift
    imgs = procedural_images(2, 96, 128, seed=0)
    out = jextract_sift(imgs, max_features=128, first_octave=-1,
                        n_orientations=2, rootsift=True)
    desc = np.asarray(out.descriptors)[np.asarray(out.valid)]
    edges = (np.arange(-8, 520, dtype=np.float32) / 2 / 512.0)
    src = inspect.getsource(_bench_dogfood.extract_corpus)
    rule = next(ln.strip() for ln in src.splitlines() if "512.0" in ln)
    assert rule.startswith("d = ")
    for d in (desc, edges.reshape(-1, 1)):
        ns = {"np": np, "d": d}
        exec(rule, ns)
        got = dogfood.to_uint8(d)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ns["d"])


@pytest.fixture(scope="module")
def opq_carried(sift_like):
    """A cvt_tpu OPQ index (M 8, K 256) and the port's index over its
    codes (tests/test_torch_bench.py's `carried`), exact top-1."""
    import jax
    from cvt_tpu.index import FlatADCIndex as JFlatADCIndex
    from cvt_tpu.quant import OPQ as JOPQ
    base, queries = sift_like
    jopq = JOPQ.train(jax.random.key(0), base, m=8, k=256, opq_iters=2,
                      kmeans_iters=3, final_kmeans_iters=3)
    jidx = JFlatADCIndex(jopq, impl="pallas")
    jidx.add(base)
    jidx._materialize()
    idx = flat_adc_from_numpy(np.asarray(jidx._codes),
                              np.asarray(jidx._dec_sq),
                              np.asarray(jopq.pq.codebooks),
                              np.asarray(jopq.rotation), device="cpu",
                              impl="kernel")
    gt1 = dogfood.bench.ground_truth(base, queries, len(queries), CPU)
    return jopq, jidx, idx, queries, gt1


def test_dogfood_config2_gives_reference_recall(opq_carried):
    import jax
    from cvt_tpu.index import flat_adc as jflat_adc
    from cvt_tpu.utils import recall_at_k as jrecall_at_k
    jopq, jidx, idx, queries, gt1 = opq_carried
    got = dogfood.config2(idx, queries, gt1)
    _, ji = jidx.search(queries, 10)
    _, jx = jidx.search(queries, 10, exact=True)
    assert got["recall_at_1_fast"] == jrecall_at_k(np.asarray(ji), gt1, k=1)
    assert got["recall_at_10_fast"] == jrecall_at_k(np.asarray(ji), gt1,
                                                    k=10)
    assert got["recall_at_1_exact"] == jrecall_at_k(np.asarray(jx), gt1,
                                                    k=1)
    # the f32 LUT engine: cvt_tpu's over the same codes, its top-1 equal
    # but where ADC distances tie (tests/test_torch_bench.py holds them)
    n = jidx.ntotal
    npad = -(-n // 16_384) * 16_384
    codes = np.zeros((npad, 8), np.uint8)
    codes[:n] = np.asarray(jidx._codes)
    dsq = np.zeros(npad, np.float32)
    dsq[:n] = np.asarray(jidx._dec_sq)
    qr = jopq.rotate(queries)
    _, jr = jflat_adc._adc_scan(qr, jax.numpy.sum(qr * qr, -1), codes, dsq,
                                jopq.pq.codebooks, 10, 16_384, n)
    ref = dogfood.bench.reference_ids(idx, queries).numpy()
    ties = np.mean(ref[:, 0] != np.asarray(jr)[:, 0])
    assert abs(got["recall_at_1_ref_f32_adc"]
               - jrecall_at_k(np.asarray(jr), gt1, k=1)) <= ties
    assert got["parity_pt"] == pytest.approx(
        100 * (got["recall_at_1_ref_f32_adc"] - got["recall_at_1_fast"]))


# ---------------------------------------------------------------- ivf
def test_ivf_chunked_ground_truth_equals_exact_top10():
    from cvt_tpu.index import FlatIndex as JFlatIndex
    cent = torch.from_numpy(ivf.centers(256))
    queries = ivf.draw_chunk(cent, 999, 48)
    gt_d, gt_i = ivf.gt_init(48, CPU)
    chunks = []
    for i in range(4):
        xc = ivf.draw_chunk(cent, i, 1000)
        chunks.append(xc.numpy())
        gt_d, gt_i = ivf.gt_step(queries, xc, i * 1000, gt_d, gt_i)
    exact = JFlatIndex(128, "l2")
    exact.add(np.concatenate(chunks))
    jd, ji = map(np.asarray, exact.search(queries.numpy(), 10))
    np.testing.assert_allclose(gt_d.numpy(), jd, rtol=1e-5)
    for r, c in zip(*np.nonzero(gt_i.numpy() != ji)):
        gap = np.abs(np.delete(jd[r], c) - jd[r, c])
        assert gap.min() <= 1e-5 * jd[r, c], (r, c)


@pytest.fixture(scope="module")
def ivf_carried():
    """A cvt_tpu IVF index (m 16 over 8-d subvectors) on the suite's own
    data, carried across with the same codes; the suite's ground truth."""
    import jax
    from cvt_tpu.index import IVFADCIndex as JIVFADCIndex
    cent = torch.from_numpy(ivf.centers(512))
    base = torch.cat([ivf.draw_chunk(cent, i, 2048) for i in range(3)])
    queries = ivf.draw_chunk(cent, 999, 64)
    jidx = JIVFADCIndex(coarse_k=32, m=ivf.M, k=32)
    jidx.train(jax.random.key(0), base.numpy()[:4096], coarse_iters=4,
               pq_iters=4)
    a, c, dq = map(np.array, jidx.encode_chunk(base.numpy()))
    jidx.build_from_codes(a, c, dq)
    idx = ivf_adc_from_numpy(np.asarray(jidx.centroids),
                             np.asarray(jidx.pq.codebooks), device="cpu")
    idx.build_from_codes(a, c, dq)
    gt_d, gt_i = ivf.gt_init(len(queries), CPU)
    gt_d, gt_i = ivf.gt_step(queries, base, 0, gt_d, gt_i)
    return jidx, idx, queries, gt_i.numpy()


@pytest.mark.parametrize("nprobe", (2, 8))
def test_ivf_lanes_give_reference_ids(ivf_carried, nprobe):
    from test_torch_ivf_scan import assert_ids_match
    jidx, idx, queries, gt_ids = ivf_carried
    budget = ivf.page_budget(idx, nprobe, 32)
    d, i, drop = idx.search_fast(queries[:32], ivf.K, nprobe=nprobe,
                                 max_pages=budget)
    jd, ji, jdrop = jidx.search_fast(queries[:32].numpy(), ivf.K,
                                     nprobe=nprobe, max_pages=budget,
                                     interpret=True)
    assert int(drop) == int(jdrop) == 0
    assert_ids_match(d.numpy(), i.numpy(), jd, ji)
    stack = torch.stack([queries[:32], queries[32:]])
    lane = ivf.ivf_lane(idx, nprobe, stack, queries, gt_ids)
    _, jf, jfdrop = jidx.search_fast(
        queries.numpy(), ivf.K, nprobe=nprobe,
        max_pages=ivf.page_budget(idx, nprobe, len(queries)), interpret=True)
    assert lane["twin"]["max_abs_err"] == 0
    assert lane["dropped"] == int(jfdrop) == 0 and lane["ids_in_range"]
    assert lane["dropped_timed"] == 0
    assert lane["r10"] == ivf.recall10(np.asarray(jf), gt_ids)
    assert lane["live_slots"] == min(lane["probed_pages"], lane["slots"])
    ref = ivf.search_lane(idx, queries, gt_ids, 32)
    _, js = jidx.search(queries.numpy(), ivf.K, nprobe=ivf.REF_NPROBE)
    assert ref["r10"] == ivf.recall10(np.asarray(js), gt_ids)


def test_ivf_page_budget_holds_cells_longer_than_a_page():
    """With cells of ~4 pages (N 8,192 over 4 cells), the script's budget
    of 2 pages per (query, probe) drops pages; the suite's does not."""
    cent = torch.from_numpy(ivf.centers(64))
    base = ivf.draw_chunk(cent, 0, 8192)
    idx = IVFADCIndex(coarse_k=4, m=ivf.M, k=16, device="cpu")
    idx.train(torch.Generator().manual_seed(0), base, coarse_iters=3,
              pq_iters=3)
    idx.build_from_codes(*(t.numpy() for t in idx.encode_chunk(base)))
    assert idx.cell_pages() >= 3
    q = ivf.draw_chunk(cent, 999, 2)
    max_pages = ivf.page_budget(idx, 2, 2)
    *_, dropped = idx.search_fast(q, ivf.K, nprobe=2, max_pages=max_pages)
    assert int(dropped) == 0 and max_pages > 2 * 2 * 2
    *_, dropped = idx.search_fast(q, ivf.K, nprobe=2, max_pages=2 * 2 * 2)
    assert int(dropped) > 0


# ----------------------------------------------------- recorder, twins
def test_recorded_args_are_the_calls_own(ivf_carried):
    _, idx, queries, _ = ivf_carried
    budget = ivf.page_budget(idx, 8, 32)
    args = recorded_args("ivf_page", lambda: idx.search_fast(
        queries[:32], ivf.K, nprobe=8, max_pages=budget))
    assert V.ivf_pages_segmin.recorded is None
    assert args[0].shape == (128, 128) and args[7:9] == (idx._pg_lp,
                                                         idx._pg_seg)
    torch.testing.assert_close(V.ivf_pages_segmin(*args),
                               V.ivf_pages_segmin_plain(*args), rtol=0,
                               atol=0)
    with pytest.raises(RuntimeError, match="never reached the adc_segmin"):
        recorded_args("adc_segmin", lambda: idx.search_fast(
            queries[:32], ivf.K, nprobe=8))
    assert T.adc_segmin.recorded is None


def test_twin_check_leaves_the_launch_count(monkeypatch):
    from cvt_tpu_torch.ops.kernels import twin_check
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 16, (1024, 16), np.uint8))
    cb_q = torch.from_numpy(rng.integers(-127, 128, (16, 16, 8), np.int8))
    q2s = torch.from_numpy(rng.integers(-127, 128, (128, 128), np.int8))
    args = (q2s, torch.ones(1), codes, cb_q, torch.ones(128), 1000, 1024, 128)
    monkeypatch.setattr(T.adc_segmin, "launches", 7)
    out = twin_check("adc_segmin", args)
    assert out["max_abs_err"] == 0 and T.adc_segmin.launches == 7


# --------------------------------------------------------------- hnsw
def _script_ground_truth(base, queries):
    """The script's ground-truth block, cut from its main()."""
    import _bench_hnsw
    lines = textwrap.dedent(inspect.getsource(_bench_hnsw.main)).splitlines()
    i = next(j for j, ln in enumerate(lines) if "gt = np.empty" in ln)
    j = next(j for j, ln in enumerate(lines) if "= ordered.T" in ln)
    ns = {"np": np, "base": base, "queries": queries, "K": _bench_hnsw.K}
    exec(textwrap.dedent("\n".join(lines[i:j + 1])), ns)
    return ns["gt"]


def test_hnsw_corpus_ground_truth_and_labels_equal_reference(monkeypatch):
    import _bench_hnsw
    from cvt_tpu.index.hnsw import HnswIndex as JHnsw
    monkeypatch.setattr(_bench_hnsw, "N", 1500)
    monkeypatch.setattr(_bench_hnsw, "N_QUERIES", 200)
    monkeypatch.setattr("sys.argv", ["_bench_hnsw.py"])
    jb, jq, jsrc = _bench_hnsw.load_corpus()
    base, queries, src = hnsw.load_corpus(None, 1500, 200)
    assert src == jsrc
    np.testing.assert_array_equal(base, jb)
    np.testing.assert_array_equal(queries, jq)
    gt = hnsw.ground_truth(base, queries)
    np.testing.assert_array_equal(gt, _script_ground_truth(jb, jq))
    idx, _ = hnsw.build(base, num_threads=1)
    ref = JHnsw(hnsw.D, metric="ip", capacity=len(base), m=hnsw.M,
                ef_construction=hnsw.EF_C)
    ref.add(jb, num_threads=1)
    for row in hnsw.sweep(idx, queries, gt, efs=(10, 80)):
        _, labels = ref.search(jq, k=hnsw.K, ef=row["ef"], num_threads=1)
        np.testing.assert_array_equal(row["_labels"], labels)
        assert row["recall"] == np.mean([len(set(labels[i]) & set(gt[i]))
                                         / hnsw.K for i in range(200)])


# ---------------------------------------------------------- card only
@pytest.fixture(scope="module")
def card_ivf():
    """The IVF suite's build on the card at N 65,536 (coarseK 256, m 16,
    K 256), its 256-query batch and its index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cent = torch.from_numpy(ivf.centers()).to(dev)
    queries = ivf.draw_chunk(cent, 999, 1024)
    b = ivf.build(65_536, cent, queries, chunk=16_384, n_gt=256,
                  coarse_k=256, iters=4)
    return b, queries[:256]


@pytest.mark.cuda
def test_adc_segmin_m16_at_the_ivf_suite_shape(card_ivf):
    b, q = card_ivf
    flat = b["flat"]
    args = recorded_args("adc_segmin", lambda: flat.search(q, ivf.K))
    assert args[2].shape == (65_536, 16) and args[3].shape[2] == 8
    assert args[0].shape == (256, 128)
    got, want = T.adc_segmin(*args), T.adc_segmin_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_ivf_page_at_the_ivf_suite_shape(card_ivf):
    b, q = card_ivf
    budget = ivf.page_budget(b["ivf"], 16, 256)
    args = recorded_args("ivf_page", lambda: b["ivf"].search_fast(
        q, ivf.K, nprobe=16, max_pages=budget))
    assert args[6].shape[0] >= 128, args[6].shape     # page slots
    assert 0 < int(args[9]) <= args[6].shape[0]
    got = V.ivf_pages_segmin(*args)
    want = V.ivf_pages_segmin_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
