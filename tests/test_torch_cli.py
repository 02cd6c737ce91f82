"""`python -m cvt_tpu_torch.cli serve` held against cvt_tpu's
MultiHostADCServer on a 1-device mesh, on a pack that cvt_tpu's
FlatADCIndex.save wrote; every other ported command held against the
same `cvt_tpu.cli` command on files cvt_tpu wrote; and every new port
module importable with jax and cvt_tpu blocked.

The command runs in a subprocess whose `jax` and `cvt_tpu` imports are
blocked (sys.modules entries set to None), as on a machine without JAX;
it starts a 1-rank gloo group through a FileStore. Tolerance: ids
bitwise. The PQ codebooks are snapped to a power-of-two grid so that
the in-kernel norm is exact in any summation order (see
tests/_torch_parallel_workers.py). The other commands run in-process
(`main(argv)`) with `--device cpu`; printed lines equal, apart from
pq_train's error (another generator trains other codebooks) and
vocab_tree_retriever's scores (rtol 1e-5, float32 sums in another
order). The matcher and database commands run in-process on copies of
one FeatureDatabase (tests/test_torch_pipelines.py's scene): the same
JSON lines and the same tables, under that file's rules (matches up to
counted near-ties, configurations and inlier rows equal; the RANSAC
draws differ, so the stored models are compared by kind). image_deleter
and image_filterer (no --device) run on a reconstruction cvt_tpu saved
and on a database copy: the same lines, and the saved scenes equal;
image_undistorter with --device cpu: the same line, images 1e-5."""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvt_tpu import cli as jcli
from cvt_tpu.index import FlatADCIndex
from cvt_tpu.io.database import FeatureDatabase
from cvt_tpu.io.vecs import read_ivecs, write_fvecs
from cvt_tpu.parallel import MultiHostADCServer, serving_mesh
from cvt_tpu.quant import ProductQuantizer
from cvt_tpu.quant import OPQ
from cvt_tpu_torch import cli as tcli
from _torch_parallel_workers import snap_codebooks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = "import sys; sys.modules['jax'] = None; sys.modules['cvt_tpu'] = None"
MODULES = ["cvt_tpu_torch.quant.sq", "cvt_tpu_torch.quant.pca",
           "cvt_tpu_torch.index.flat_sq", "cvt_tpu_torch.parallel",
           "cvt_tpu_torch.parallel.mesh", "cvt_tpu_torch.parallel.serving",
           "cvt_tpu_torch.parallel.sharded_search",
           "cvt_tpu_torch.parallel.distributed_kmeans",
           "cvt_tpu_torch.cli", "cvt_tpu_torch.convert",
           "cvt_tpu_torch.ops.topk", "cvt_tpu_torch.ops.kmeans",
           "cvt_tpu_torch.match", "cvt_tpu_torch.match.solvers",
           "cvt_tpu_torch.match.vote_verify",
           "cvt_tpu_torch.index.vocab_he", "cvt_tpu_torch.io.database",
           "cvt_tpu_torch.io.datasets", "cvt_tpu_torch.features",
           "cvt_tpu_torch.features.scale_space",
           "cvt_tpu_torch.features.detect",
           "cvt_tpu_torch.features.descriptor",
           "cvt_tpu_torch.features.affine", "cvt_tpu_torch.features.covdet",
           "cvt_tpu_torch.features.pipeline", "cvt_tpu_torch.match.svf",
           "cvt_tpu_torch.match.ransac", "cvt_tpu_torch.apps",
           "cvt_tpu_torch.apps.retrieval", "cvt_tpu_torch.utils.log",
           "cvt_tpu_torch.match.nn", "cvt_tpu_torch.match.epipolar",
           "cvt_tpu_torch.match.pose", "cvt_tpu_torch.match.two_view",
           "cvt_tpu_torch.match.guided", "cvt_tpu_torch.match.pipelines",
           "cvt_tpu_torch.match.gps", "cvt_tpu_torch.match.cameras",
           "cvt_tpu_torch.match.bundle", "cvt_tpu_torch.match.lad",
           "cvt_tpu_torch.match.reconstruction",
           "cvt_tpu_torch.match.scene_graph_utils",
           "cvt_tpu_torch.apps.undistort", "cvt_tpu_torch.features.lines",
           "cvt_tpu_torch.features.embedding", "cvt_tpu_torch.features.text",
           "cvt_tpu_torch.apps.phash", "cvt_tpu_torch.apps.detect",
           "cvt_tpu_torch.apps.motion_area", "cvt_tpu_torch.apps.pupil",
           "cvt_tpu_torch.apps.template_match",
           "cvt_tpu_torch.apps.video_match", "cvt_tpu_torch.io.video",
           "cvt_tpu_torch.native", "cvt_tpu_torch.ops.bits",
           "cvt_tpu_torch.ops.resize"]


def _python(code: str, *args, stdin: str | None = None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-c", code, *args], input=stdin,
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=120)


def _serve(*args, stdin=None):
    code = (BLOCK + "; import runpy; sys.argv = ['cli'] + sys.argv[1:]; "
            "runpy.run_module('cvt_tpu_torch.cli', run_name='__main__')")
    r = _python(code, "serve", *args, stdin=stdin)
    assert r.returncode == 0, r.stderr[-3000:]
    return np.array([json.loads(line)["ids"]
                     for line in r.stdout.splitlines() if line.strip()])


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(4)
    base = (rng.normal(size=(3000, 64)) * 20).astype(np.float32)
    q = (rng.normal(size=(40, 64)) * 20).astype(np.float32)
    pq = ProductQuantizer(jnp.asarray(snap_codebooks(np.asarray(
        ProductQuantizer.train(jax.random.key(0), base[:2048], m=8, k=64,
                               iters=4).codebooks))))
    idx = FlatADCIndex(pq)
    idx.add(base)
    idx.save(str(tmp / "pack.npz"))
    write_fvecs(str(tmp / "q.fvecs"), q)
    srv = MultiHostADCServer(pq, serving_mesh(jax.devices("cpu")[:1]))
    srv.load(codes=np.asarray(pq.encode(base)))
    return tmp, q, srv


def test_serve_batch_mode_matches_reference(pack):
    tmp, q, srv = pack
    ids = _serve("--index", str(tmp / "pack.npz"), "--queries",
                 str(tmp / "q.fvecs"), "--k", "10", "--batch", "16",
                 "--device", "cpu")
    want = np.concatenate([np.asarray(srv.serve(q[s:s + 16], 10)[1])
                           for s in range(0, 40, 16)])
    np.testing.assert_array_equal(ids, want)


def test_serve_stdin_mode_matches_reference(pack):
    """One query per line through the QueryBatcher: each is served in a
    batch of its own plus zero rows, which change no query's fold."""
    tmp, q, srv = pack
    lines = "\n".join(json.dumps(r.tolist()) for r in q[:3]) + "\n\n"
    ids = _serve("--index", str(tmp / "pack.npz"), "--stdin", "--k", "5",
                 "--batch", "8", "--merge", "ring", "--device", "cpu",
                 stdin=lines)
    want = np.concatenate([np.asarray(srv.serve(q[j:j + 1], 5)[1])
                           for j in range(3)])
    np.testing.assert_array_equal(ids, want)


def test_new_modules_import_without_jax():
    r = _python(BLOCK + "; import importlib\n"
                "for m in sys.argv[1:]: importlib.import_module(m)\n"
                "print('ok')", *MODULES)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "ok"


def _run(main, *argv) -> list[str]:
    """A CLI's main(argv) in this process -> its printed lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(list(argv))
    return out.getvalue().splitlines()


@pytest.fixture(scope="module")
def vec_files(tmp_path_factory):
    """cvt_tpu's gen_data, exact_search and OPQ pq_train outputs."""
    tmp = tmp_path_factory.mktemp("vecs")
    p = str(tmp / "j")
    _run(jcli.main, "gen_data", "--n", "3000", "--dim", "32", "--queries",
         "24", "--out", p)
    _run(jcli.main, "exact_search", "--base", p + "_base.fvecs",
         "--queries", p + "_query.fvecs", "--k", "10", "--out",
         p + "_gt.ivecs")
    _run(jcli.main, "pq_train", "--data", p + "_base.fvecs", "--m", "4",
         "--k", "16", "--opq", "--opq-iters", "2", "--out", p + "_opq.npz")
    return p


def test_gen_data_and_exact_search(vec_files, tmp_path):
    p, q = vec_files, str(tmp_path / "t")
    want = _run(jcli.main, "gen_data", "--n", "3000", "--dim", "32",
                "--queries", "24", "--out", str(tmp_path / "j"))
    assert _run(tcli.main, "gen_data", "--n", "3000", "--dim", "32",
                "--queries", "24", "--out", q) == want
    for part in ("_base.fvecs", "_query.fvecs"):
        with open(p + part, "rb") as a, open(q + part, "rb") as b:
            assert a.read() == b.read()
    lines = _run(tcli.main, "exact_search", "--base", p + "_base.fvecs",
                 "--queries", p + "_query.fvecs", "--k", "10", "--out",
                 q + "_gt.ivecs", "--device", "cpu")
    assert lines == ["wrote ground truth top-10 for 24 queries"]
    np.testing.assert_array_equal(read_ivecs(q + "_gt.ivecs"),
                                  read_ivecs(p + "_gt.ivecs"))


def test_sq_train_and_pq_train(vec_files, tmp_path):
    p, q = vec_files, str(tmp_path / "t")
    args = ("sq_train", "--data", p + "_base.fvecs")
    want = _run(jcli.main, *args, "--out", str(tmp_path / "j_sq.npz"))
    assert _run(tcli.main, *args, "--out", q + "_sq.npz",
                "--device", "cpu") == want
    with np.load(q + "_sq.npz") as a, np.load(str(tmp_path / "j_sq.npz")) \
            as b:
        for name in ("vmin", "vdiff"):     # L2 norms summed in another order
            np.testing.assert_allclose(a[name], b[name], rtol=1e-6,
                                       atol=1e-7)
    lines = _run(tcli.main, "pq_train", "--data", p + "_base.fvecs", "--m",
                 "4", "--k", "16", "--opq", "--opq-iters", "2", "--out",
                 q + "_opq.npz", "--device", "cpu")
    assert len(lines) == 1
    assert lines[0].startswith("trained OPQ m=4 k=16; reconstruction MSE ")
    # cvt_tpu reads the port's codebook file; the error is that of a
    # k-means of another seed
    from cvt_tpu.io.vecs import read_fvecs
    x = read_fvecs(p + "_base.fvecs")
    mse_t = float(OPQ.load(q + "_opq.npz").reconstruction_mse(x))
    mse_j = float(OPQ.load(p + "_opq.npz").reconstruction_mse(x))
    assert abs(mse_t - mse_j) <= 0.1 * mse_j


def test_build_adc_and_search_adc(vec_files, tmp_path):
    p, q = vec_files, str(tmp_path / "t")
    args = ("build_adc", "--base", p + "_base.fvecs", "--model",
            p + "_opq.npz", "--opq")
    want = _run(jcli.main, *args, "--out", str(tmp_path / "j_idx.npz"))
    assert _run(tcli.main, *args, "--out", q + "_idx.npz",
                "--device", "cpu") == want
    with np.load(q + "_idx.npz") as a, \
            np.load(str(tmp_path / "j_idx.npz")) as b:
        assert np.mean(a["codes"] == b["codes"]) >= 0.999  # near-ties
    args = ("search_adc", "--index", str(tmp_path / "j_idx.npz"),
            "--queries", p + "_query.fvecs", "--gt", p + "_gt.ivecs")
    assert _run(tcli.main, *args, "--device", "cpu") == \
        _run(jcli.main, *args)


@pytest.fixture(scope="module")
def feature_db(tmp_path_factory):
    """A FeatureDatabase that cvt_tpu's io.database wrote (10 images x 48
    SIFT-like descriptors with frames), a query list, and the vocabulary
    index cvt_tpu's vocab_tree_retriever trained and saved from it."""
    tmp = tmp_path_factory.mktemp("vocab_db")
    rng = np.random.default_rng(5)
    train = rng.gamma(1.5, 20.0, size=(2048, 128))
    db_path = str(tmp / "db.sqlite")
    with FeatureDatabase(db_path) as db:
        for i in range(10):
            iid = db.add_image(f"image_{i:03d}", width=640, height=480)
            d = np.clip(train[rng.integers(0, 2048, 48)]
                        + rng.normal(0, 2, (48, 128)), 0, 255)
            kp = np.stack([rng.uniform(0, 640, 48), rng.uniform(0, 480, 48),
                           rng.uniform(1.5, 8, 48), rng.uniform(-3, 3, 48)],
                          -1)
            db.write_descriptors(iid, d.astype(np.uint8))
            db.write_keypoints(iid, kp)
        db.commit()
    qlist = str(tmp / "queries.txt")
    with open(qlist, "w") as f:
        f.write("image_002\nimage_007\nmissing\nimage_009\n")
    index = str(tmp / "j_vocab.npz")
    _run(jcli.main, "vocab_tree_retriever", "--database", db_path,
         "--num_words", "64", "--output_index", index)
    return db_path, qlist, index


def _ranked(lines):
    """Printed retriever lines -> (text with scores cut, scores)."""
    text, scores = [], []
    for line in lines:
        if ", score=" in line:
            head, score = line.rsplit(", score=", 1)
            text.append(head)
            scores.append(float(score))
        else:
            text.append(line)
    return text, np.array(scores)


def test_vocab_tree_retriever_on_cvt_tpu_index(feature_db):
    """Both CLIs on cvt_tpu's saved index: the same lines and ranked
    names, scores within rtol 1e-5 (printed to 6 decimals)."""
    db_path, qlist, index = feature_db
    args = ("vocab_tree_retriever", "--database", db_path, "--vocab_index",
            index, "--query_image_list", qlist, "--topk", "4")
    want, want_s = _ranked(_run(jcli.main, *args))
    got, got_s = _ranked(_run(tcli.main, *args, "--device", "cpu"))
    assert got == want
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-6)
    assert "  image_name=image_002" in got
    assert any(line.startswith("WARNING: image 'missing'") for line in got)


def test_vocab_tree_retriever_trains_and_verifies(feature_db, tmp_path):
    """The port trains its own tree from the database, saves an index
    cvt_tpu loads, and ranks every query image first for itself, with
    and without spatial verification."""
    db_path, qlist, _ = feature_db
    out = str(tmp_path / "t_vocab.npz")
    for verify in ("0", "3"):
        lines = _run(tcli.main, "vocab_tree_retriever", "--database",
                     db_path, "--num_words", "64", "--query_image_list",
                     qlist, "--topk", "3", "--verify", verify,
                     "--output_index", out, "--device", "cpu")
        firsts = [lines[i + 1] for i, line in enumerate(lines)
                  if line.startswith("Querying for image")]
        assert [f.split(",")[0] for f in firsts] == [
            "  image_name=image_002", "  image_name=image_007",
            "  image_name=image_009"]
    from cvt_tpu.index import VocabHEIndex
    assert VocabHEIndex.load(out).n_images == 10


def test_vocab_tree_retriever_loaded_index_defect(feature_db, tmp_path):
    """Copied from cvt_tpu (its cli.py:316): a database image that a
    loaded index does not hold makes add_image raise, in both CLIs."""
    db_path, _, index = feature_db
    with FeatureDatabase(db_path) as db:
        extra = str(tmp_path / "extra.sqlite")
        with FeatureDatabase(extra) as out:
            FeatureDatabase.merge(db, FeatureDatabase(":memory:"), out)
            iid = out.add_image("image_new")
            out.write_descriptors(iid, db.read_descriptors(1))
            out.commit()
    args = ("vocab_tree_retriever", "--database", extra, "--vocab_index",
            index)
    for main, dev in ((jcli.main, ()), (tcli.main, ("--device", "cpu"))):
        with pytest.raises(ValueError, match="loaded VocabHEIndex"):
            _run(main, *args, *dev)


def test_vocab_tree_retriever_runs_without_jax(feature_db):
    db_path, qlist, index = feature_db
    code = (BLOCK + "; import runpy; sys.argv = ['cli'] + sys.argv[1:]; "
            "runpy.run_module('cvt_tpu_torch.cli', run_name='__main__')")
    r = _python(code, "vocab_tree_retriever", "--database", db_path,
                "--vocab_index", index, "--query_image_list", qlist,
                "--topk", "2", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "  image_name=image_007" in r.stdout


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """uint8 .npy files: 4 procedural database images and noisy copies of
    the first 2 as queries, and cvt_tpu's feature_extractor outputs."""
    from cvt_tpu.io.datasets import procedural_images
    tmp = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(6)
    imgs = procedural_images(4, 64, 96, seed=3)
    q = np.clip(imgs[:2] + rng.normal(0, 0.01, imgs[:2].shape), 0, 1)
    paths = {}
    for name, a in (("db", imgs), ("q", q)):
        paths[name] = str(tmp / f"{name}.npy")
        np.save(paths[name], (a * 255).round().astype(np.uint8))
    lines = {}
    for name in ("db", "q"):
        lines[name] = _run(jcli.main, "feature_extractor", "--images",
                           paths[name], "--out", str(tmp / f"j_{name}.npz"),
                           "--database", str(tmp / f"j_{name}.sqlite"))
    return tmp, paths, lines


def test_feature_extractor_matches_reference(image_files):
    """The port's command on the same .npy: the printed line, the .npz
    keys and shapes, keypoints and descriptors (within the extractor's
    tolerances, tests/test_torch_features.py) and the database rows."""
    from test_torch_features import match_keypoints
    import types
    tmp, paths, want_lines = image_files
    for name in ("db", "q"):
        out, db = str(tmp / f"t_{name}.npz"), str(tmp / f"t_{name}.sqlite")
        lines = _run(tcli.main, "feature_extractor", "--images",
                     paths[name], "--out", out, "--database", db,
                     "--device", "cpu")
        assert lines == want_lines[name]
        with np.load(out) as a, np.load(str(tmp / f"j_{name}.npz")) as b:
            assert sorted(a.files) == sorted(b.files) == [
                "descriptors", "frames", "valid"]
            got, want = (types.SimpleNamespace(**{k: z[k] for k in z.files})
                         for z in (a, b))
        share, cos, _ = match_keypoints(want, got)
        assert share >= 0.98 and cos >= 0.999, (share, cos)
        with FeatureDatabase(db) as t_db, \
                FeatureDatabase(str(tmp / f"j_{name}.sqlite")) as j_db:
            assert [n for _, n in t_db.iter_images()] == \
                [n for _, n in j_db.iter_images()]
            for iid, _ in j_db.iter_images():
                assert t_db.read_descriptors(iid).shape == \
                    j_db.read_descriptors(iid).shape


@pytest.mark.parametrize("rerank", ["svf", ""])
def test_retrieve_matches_reference(image_files, rerank):
    """Both `retrieve` commands on cvt_tpu's feature files print the same
    JSON lines; on its own files the port ranks the same names, each
    query's source image first."""
    tmp, _, _ = image_files
    args = ("retrieve", "--db", str(tmp / "j_db.npz"), "--query",
            str(tmp / "j_q.npz"), "--topk", "3", "--rerank", rerank)
    want = _run(jcli.main, *args)
    assert _run(tcli.main, *args, "--device", "cpu") == want
    if not (tmp / "t_db.npz").exists():
        _run(tcli.main, "feature_extractor", "--images", str(tmp / "db.npy"),
             "--out", str(tmp / "t_db.npz"), "--device", "cpu")
        _run(tcli.main, "feature_extractor", "--images", str(tmp / "q.npy"),
             "--out", str(tmp / "t_q.npz"), "--device", "cpu")
    own = _run(tcli.main, "retrieve", "--db", str(tmp / "t_db.npz"),
               "--query", str(tmp / "t_q.npz"), "--topk", "3", "--rerank",
               rerank, "--device", "cpu")
    rows = [json.loads(line) for line in own]
    assert [r["results"] for r in rows] == \
        [json.loads(line)["results"] for line in want]
    assert [r["results"][0] for r in rows] == ["img_0", "img_1"]


# ---------------------------------------------------------------------------
# the matcher and database commands
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def match_db(tmp_path_factory):
    from test_torch_pipelines import scene, write_scene
    tmp = tmp_path_factory.mktemp("match")
    images = scene(noise=0.0)        # as the guided runs there need
    write_scene(str(tmp / "scene.sqlite"), images)
    np.save(str(tmp / "pos.npy"), np.array(
        [[0, 0], [1, 0], [50, 0], [51, 0], [52, 0]], np.float32))
    (tmp / "pairs.txt").write_text("im0.jpg im1.jpg\nim3.jpg im4.jpg\n"
                                   "im2.jpg missing.jpg\n2 3\n")
    from test_torch_pipelines import _match_list
    _match_list(str(tmp / "matches.txt"), images)
    return tmp, images


def _both(tmp, name, *args, path_args=()):
    """Run a command of each CLI on its own copy of the scene database;
    -> (cvt_tpu's lines, the port's lines, the two database paths)."""
    import shutil
    out = []
    for tag, main, dev in (("j", jcli.main, ()),
                           ("t", tcli.main, ("--device", "cpu"))):
        db = str(tmp / f"{name}_{tag}.sqlite")
        shutil.copy(str(tmp / "scene.sqlite"), db)
        extra = [a.replace("{tmp}", str(tmp)) for a in args]
        out.append((_run(main, name, "--database", db, *extra, *dev), db))
    return out[0][0], out[1][0], out[0][1], out[1][1]


@pytest.mark.parametrize("name,args", [
    ("exhaustive_matcher", ("--block-size", "2")),
    ("exhaustive_matcher", ("--no-verify", "--ratio", "0.7")),
    ("sequential_matcher", ("--overlap", "2", "--guided")),
    ("sequential_matcher", ("--overlap", "2", "--quadratic")),
    ("spatial_matcher", ("--positions", "{tmp}/pos.npy", "--max-neighbors",
                         "1", "--max-distance", "5")),
    ("vocab_tree_matcher", ("--num-words", "64", "--num-images", "20",
                            "--transitive")),
    ("image_pairs_matcher", ("--pair-list", "{tmp}/pairs.txt",
                             "--min-matches", "30")),
    ("matches_importer", ("--match-list", "{tmp}/matches.txt")),
    ("matches_importer", ("--match-list", "{tmp}/matches.txt",
                          "--no-verify"))])
def test_matcher_commands_match_reference(match_db, name, args):
    """The same JSON line and tables as cvt_tpu.cli's command. The
    vocabulary trained on the fly differs (another generator), but with
    --num-images above the image count both retrieve every pair."""
    from test_torch_pipelines import assert_tables_equal
    tmp, images = match_db
    want, got, jdb, tdb = _both(tmp, name, *args)
    assert got == want
    stats = json.loads(got[-1])
    assert stats["n_pairs"] >= 2
    pairs = [(a, b) for a in range(1, 6) for b in range(a + 1, 6)]
    ratio = 0.7 if "0.7" in args else 0.8
    assert_tables_equal(jdb, tdb, pairs, images, ratio=ratio,
                        guided="--guided" in args)


def test_database_commands_match_reference(match_db):
    tmp, _ = match_db
    for tag, main in (("j", jcli.main), ("t", tcli.main)):
        new = str(tmp / f"new_{tag}.sqlite")
        assert _run(main, "database_creator", "--database", new) == [
            json.dumps({"created": new})]
        with FeatureDatabase(new) as db:
            assert db.num_images() == 0
    want, got, jdb, tdb = _both(tmp, "exhaustive_matcher")
    for typ in ("matches", "features", "images"):
        lines = [_run(main, "database_cleaner", "--database", db, "--type",
                      typ) for main, db in ((jcli.main, jdb), (tcli.main, tdb))]
        assert lines[0] == lines[1] == [json.dumps({"cleared": typ})]
        with FeatureDatabase(jdb) as a, FeatureDatabase(tdb) as b:
            assert a.num_images() == b.num_images()
            assert [a.has_matches(1, 2), a.read_keypoints(1) is None] == \
                [b.has_matches(1, 2), b.read_keypoints(1) is None]
    merged = {}
    for tag, main in (("j", jcli.main), ("t", tcli.main)):
        out = str(tmp / f"merged_{tag}.sqlite")
        line = _run(main, "database_merger", "--database1",
                    str(tmp / "scene.sqlite"), "--database2",
                    str(tmp / "new_j.sqlite"), "--merged_database", out)
        assert line == [json.dumps({"merged": out, "n_images": 5})]
        with FeatureDatabase(out) as db:
            merged[tag] = [(n, db.read_descriptors(i).shape)
                           for i, n in db.iter_images()]
        with pytest.raises(SystemExit, match="must not exist"):
            main(["database_merger", "--database1", out, "--database2", out,
                  "--merged_database", out])
    assert merged["t"] == merged["j"]


@pytest.fixture(scope="module")
def recon_files(tmp_path_factory):
    """A reconstruction cvt_tpu saved (tests/test_cli_admin.py's toy
    scene), name and id files, and a feature database."""
    from test_cli_admin import _make_db, _toy_reconstruction
    tmp = tmp_path_factory.mktemp("recon")
    rng = np.random.default_rng(7)
    _toy_reconstruction(rng).save(str(tmp / "rec.npz"))
    (tmp / "names.txt").write_text("im1.jpg\nmissing.jpg\nim3.jpg\n")
    (tmp / "ids.txt").write_text("4\n17\n")
    ids, _ = _make_db(str(tmp / "feat.db"), rng, n_images=4)
    with FeatureDatabase(str(tmp / "feat.db")) as db:
        db.write_matches(ids[0], ids[1], np.stack([np.arange(5)] * 2, 1))
        db.commit()
    return tmp


def _same_npz(a: str, b: str) -> None:
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


@pytest.mark.parametrize("args", [("--image_names_path", "names.txt"),
                                  ("--image_ids_path", "ids.txt")])
def test_image_deleter_matches_reference(recon_files, args):
    tmp = recon_files
    lines, outs = [], []
    for tag, main in (("j", jcli.main), ("t", tcli.main)):
        out = str(tmp / f"del_{tag}_{args[1]}.npz")
        lines.append(_run(main, "image_deleter", "--input_path",
                          str(tmp / "rec.npz"), "--output_path", out,
                          args[0], str(tmp / args[1])))
        outs.append(out)
    assert lines[0] == lines[1]
    assert json.loads(lines[1][-1])["deleted"] >= 1
    _same_npz(*outs)


def test_image_deleter_database_matches_reference(recon_files):
    import shutil
    tmp = recon_files
    lines, dbs = [], []
    for tag, main in (("j", jcli.main), ("t", tcli.main)):
        db = str(tmp / f"feat_{tag}.db")
        shutil.copy(str(tmp / "feat.db"), db)
        lines.append(_run(main, "image_deleter", "--database", db,
                          "--image_names_path", str(tmp / "names.txt")))
        dbs.append(db)
    assert lines[0] == lines[1]
    assert json.loads(lines[1][-1]) == {"deleted": 2}
    with FeatureDatabase(dbs[0]) as a, FeatureDatabase(dbs[1]) as b:
        assert list(a.iter_images()) == list(b.iter_images())
        assert a.has_matches(1, 2) == b.has_matches(1, 2)


@pytest.mark.parametrize("min_obs", ["2", "3", "10"])
def test_image_filterer_matches_reference(recon_files, min_obs):
    tmp = recon_files
    lines, outs = [], []
    for tag, main in (("j", jcli.main), ("t", tcli.main)):
        out = str(tmp / f"filt_{tag}_{min_obs}.npz")
        lines.append(_run(main, "image_filterer", "--input_path",
                          str(tmp / "rec.npz"), "--output_path", out,
                          "--min_num_observations", min_obs))
        outs.append(out)
    assert lines[0] == lines[1]
    assert lines[1][-1].startswith("Filtered ")
    _same_npz(*outs)


@pytest.mark.parametrize("model,params,blank", [
    ("simple_radial", "40,31.5,23.5,0.12", "0.0"),
    ("opencv", "40,42,31.5,23.5,-0.2,0.05,0.001,-0.002", "0.5")])
def test_image_undistorter_matches_reference(tmp_path, model, params,
                                             blank):
    rng = np.random.default_rng(8)
    imgs = (rng.random((2, 48, 64, 3)) * 255).astype(np.uint8)
    np.save(str(tmp_path / "imgs.npy"), imgs)
    lines, outs = [], []
    for tag, main, dev in (("j", jcli.main, ()),
                           ("t", tcli.main, ("--device", "cpu"))):
        out = str(tmp_path / f"und_{tag}.npy")
        lines.append(_run(main, "image_undistorter", "--images",
                          str(tmp_path / "imgs.npy"), "--model", model,
                          "--params", params, "--blank-pixels", blank,
                          "--out", out, *dev))
        outs.append(np.load(out))
    assert lines[0] == lines[1]
    assert outs[1].shape == outs[0].shape == (2, 48, 64, 3)
    assert outs[1].dtype == outs[0].dtype == np.float32
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5)
