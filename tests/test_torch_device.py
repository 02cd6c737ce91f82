"""The device rule of the port's entry points (`utils.device`): the card
unless the caller asks for the CPU, by `device="cpu"`, by CPU tensors or
by `--device cpu`. Without a card and without that request they raise.

`torch.cuda.is_available` is patched to return False, so every test
sees a machine without a card, whatever machine it runs on."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cvt_tpu_torch import convert
from cvt_tpu_torch.apps import ImageRetrievalIndex
from cvt_tpu_torch.features import build_pyramid, extract_sift
from cvt_tpu_torch.features.pipeline import FeatureExtractionPipeline
from cvt_tpu_torch.index import FlatADCIndex, FlatIndex, IVFADCIndex
from cvt_tpu_torch.ops.kmeans import kmeans
from cvt_tpu_torch.parallel import init_distributed
from cvt_tpu_torch.quant import OPQ, PCA, ProductQuantizer, ScalarQuantizer
from cvt_tpu_torch.train import (create_state, make_sharded_train_step,
                                 state_from_params)
from cvt_tpu_torch.utils import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(5)
CB = RNG.normal(size=(4, 16, 8)).astype(np.float32)     # M 4, K 16, D 32
ROT = np.linalg.qr(RNG.normal(size=(32, 32)))[0].astype(np.float32)
X = RNG.normal(size=(64, 32)).astype(np.float32)
IMG = RNG.random((1, 40, 48)).astype(np.float32)
ARC = {"layers": [{"w": X[:32, :4], "b": np.zeros(4, np.float32)}],
       "head": X[:4, :3]}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    """A saved FlatADCIndex (OPQ) built on the CPU."""
    path = str(tmp_path_factory.mktemp("dev") / "pack.npz")
    idx = FlatADCIndex(convert.opq_from_numpy(ROT, CB, device="cpu"))
    idx.add(X)
    idx.save(path)
    return path


# each entry point called with numpy (or a path) and `device`
ENTRY_POINTS = {
    "FlatIndex": lambda p, dev: FlatIndex(32, device=dev),
    "ProductQuantizer": lambda p, dev: ProductQuantizer(CB, device=dev),
    "FlatADCIndex.load": lambda p, dev: FlatADCIndex.load(p, device=dev),
    "opq_from_numpy": lambda p, dev: convert.opq_from_numpy(ROT, CB,
                                                            device=dev),
    "ScalarQuantizer.train": lambda p, dev: ScalarQuantizer.train(
        X, device=dev),
    "PCA.train": lambda p, dev: PCA.train(X, 4, device=dev),
    "IVFADCIndex": lambda p, dev: IVFADCIndex(coarse_k=4, m=4, k=16,
                                              device=dev),
    "kmeans": lambda p, dev: kmeans(torch.Generator().manual_seed(0), X, 4,
                                    iters=1, device=dev),
    "build_pyramid": lambda p, dev: build_pyramid(IMG, device=dev)[0],
    "extract_sift": lambda p, dev: extract_sift(IMG, max_features=8,
                                                device=dev),
    "ImageRetrievalIndex": lambda p, dev: ImageRetrievalIndex(device=dev),
    "FeatureExtractionPipeline": lambda p, dev: FeatureExtractionPipeline(
        None, device=dev).extract_fn(IMG),
    "create_state": lambda p, dev: create_state(
        0, dim_in=32, num_classes=3, dim_emb=4, device=dev)[0].params["head"],
    "arcface_from_numpy": lambda p, dev: convert.arcface_from_numpy(
        ARC, device=dev)["head"],
}


def _device_of(obj) -> torch.device:
    """Where an entry point's result lives: its `device`, else the device
    of its first tensor (k-means centroids, features, pyramid levels)."""
    dev = getattr(obj, "device", None)
    if dev is not None:
        return dev
    for name in ("centroids", "frames", "gauss"):
        if hasattr(obj, name):
            return getattr(obj, name).device
    raise AssertionError(f"no device on {type(obj).__name__}")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_card_raises(no_card, pack, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](pack, None)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_with_device_cpu_works(no_card, pack, name):
    obj = ENTRY_POINTS[name](pack, "cpu")
    assert _device_of(obj) == torch.device("cpu")


def test_cpu_tensors_keep_their_device(no_card):
    x = torch.from_numpy(X)
    assert resolve_device(like=x) == torch.device("cpu")
    pq = ProductQuantizer(torch.from_numpy(CB))
    assert pq.device == torch.device("cpu")
    opq = OPQ(torch.from_numpy(ROT), pq)
    assert opq.device == torch.device("cpu")
    assert FlatADCIndex(opq).device == torch.device("cpu")
    assert ScalarQuantizer.train(x).device == torch.device("cpu")
    assert kmeans(torch.Generator().manual_seed(0), x, 4,
                  iters=1).centroids.device == torch.device("cpu")
    feats = extract_sift(torch.from_numpy(IMG), max_features=8)
    assert feats.frames.device == torch.device("cpu")
    # an explicit device wins over the tensor's
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ProductQuantizer(torch.from_numpy(CB), device="cuda")


def test_loaded_index_searches_where_asked(no_card, pack):
    idx = FlatADCIndex.load(pack, device="cpu")
    assert idx._resolve_impl() == "scan"
    d, i = idx.search(X[:3], 5)
    assert i.device == torch.device("cpu") and i.shape == (3, 5)
    assert int(i[:, 0].min()) >= 0


def test_init_distributed_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_distributed()


def test_sharded_train_step_follows_device_rule(no_card):
    """Without a mesh, make_sharded_train_step starts a 1-rank group: NCCL
    on the card (raises here), gloo with device="cpu"."""
    import torch.distributed as dist
    state, opt = state_from_params(convert.arcface_from_numpy(
        ARC, device="cpu"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_sharded_train_step(None, opt)
    assert not dist.is_initialized()
    try:
        step = make_sharded_train_step(None, opt, device="cpu")
        assert dist.get_backend() == "gloo"
        state, loss = step(state, X[:8], np.arange(8) % 3)
        assert loss.device == torch.device("cpu") and state.step == 1
    finally:
        dist.destroy_process_group()


def test_cli_serve_without_device_cpu_fails(pack, tmp_path):
    """`serve` defaults to the card: on a machine without one (patched in
    the subprocess) it exits non-zero and names --device's way out."""
    from cvt_tpu_torch.io.vecs import write_fvecs
    qf = str(tmp_path / "q.fvecs")
    write_fvecs(qf, X[:4])
    code = ("import sys, runpy, torch; torch.cuda.is_available = "
            "lambda: False; sys.argv = ['cli'] + sys.argv[1:]; "
            "runpy.run_module('cvt_tpu_torch.cli', run_name='__main__')")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code, "serve", "--index",
                        pack, "--queries", qf], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode != 0
    assert 'device="cpu"' in r.stderr
    assert r.stdout.strip() == ""


@pytest.fixture
def small_db(tmp_path):
    """A FeatureDatabase of two images that share 40 descriptors under a
    shift, and a match list of their true pairs."""
    from cvt_tpu_torch.io.database import FeatureDatabase
    rng = np.random.default_rng(2)
    d = np.abs(rng.normal(size=(40, 16))).astype(np.float32)
    xy = rng.uniform(0, 200, (40, 2)).astype(np.float32)
    path = str(tmp_path / "db.sqlite")
    with FeatureDatabase(path) as db:
        for i in range(2):
            iid = db.add_image(f"im{i}.jpg", 200, 200)
            db.write_keypoints(iid, np.c_[xy + 3.0 * i, np.zeros((40, 2))])
            db.write_descriptors(iid, d)
        db.commit()
    lst = tmp_path / "matches.txt"
    lst.write_text("im0.jpg im1.jpg\n" + "\n".join(f"{i} {i}"
                                                   for i in range(40)))
    return path, str(lst)


def test_match_pipelines_without_card_raise(no_card, small_db):
    """match_pairs, import_feature_matches and spatial_pairs run on the
    card unless asked for the CPU; numpy handed to the matcher or the
    two-view estimator goes to the card too, CPU tensors stay."""
    from cvt_tpu_torch.io.database import FeatureDatabase
    from cvt_tpu_torch.match import (estimate_two_view_geometry,
                                     match_descriptors)
    from cvt_tpu_torch.match import pipelines as pl
    path, lst = small_db
    pos = np.zeros((2, 2), np.float32)
    with FeatureDatabase(path) as db:
        for call in (lambda dev: pl.match_pairs(db, [(1, 2)], device=dev),
                     lambda dev: pl.import_feature_matches(db, lst,
                                                           device=dev),
                     lambda dev: pl.spatial_pairs([1, 2], pos, device=dev)):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call(None)
        assert pl.match_pairs(db, [(1, 2)], device="cpu").n_verified == 1
        assert pl.import_feature_matches(db, lst, device="cpu").n_pairs == 1
        assert pl.spatial_pairs([1, 2], pos, device="cpu") == [(1, 2)]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        match_descriptors(X[:8], X[8:16])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        estimate_two_view_geometry(None, X[:20, :2], X[20:40, :2])
    res = match_descriptors(torch.from_numpy(X[:8]), torch.from_numpy(X))
    assert res.idx2.device == torch.device("cpu")
    np.testing.assert_array_equal(res.idx2.numpy(), np.arange(8))


def test_cli_matcher_without_device_cpu_fails(small_db):
    """exhaustive_matcher defaults to the card: without one (patched in
    the subprocess) it exits non-zero before matching, and with --device
    cpu it matches and verifies the pair."""
    path, _ = small_db
    code = ("import sys, runpy, torch; torch.cuda.is_available = "
            "lambda: False; sys.argv = ['cli'] + sys.argv[1:]; "
            "runpy.run_module('cvt_tpu_torch.cli', run_name='__main__')")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT
    runs = [subprocess.run([sys.executable, "-c", code, "exhaustive_matcher",
                            "--database", path, *dev], capture_output=True,
                           text=True, env=env, cwd=ROOT, timeout=120)
            for dev in ((), ("--device", "cpu"))]
    assert runs[0].returncode != 0 and runs[0].stdout.strip() == ""
    assert 'device="cpu"' in runs[0].stderr
    assert runs[1].returncode == 0, runs[1].stderr[-2000:]
    assert '"n_verified": 1' in runs[1].stdout


def test_database_commands_need_no_card(no_card, small_db, tmp_path,
                                        capsys):
    """The database commands touch no device: they run without a card and,
    like cvt_tpu's, take no --device."""
    import json
    from cvt_tpu_torch.cli import main
    path, _ = small_db
    new, merged = str(tmp_path / "new.sqlite"), str(tmp_path / "m.sqlite")
    main(["database_creator", "--database", new])
    main(["database_merger", "--database1", path, "--database2", new,
          "--merged_database", merged])
    main(["database_cleaner", "--database", path, "--type", "matches"])
    assert [json.loads(x) for x in capsys.readouterr().out.splitlines()] == [
        {"created": new}, {"merged": merged, "n_images": 2},
        {"cleared": "matches"}]
    with pytest.raises(SystemExit):
        main(["database_creator", "--database", new, "--device", "cpu"])


def _toy_scene(device=None):
    """Three images seeing four points (tests/test_cli_admin.py's layout:
    images 0-2 share three points, images 3-4 one)."""
    from cvt_tpu_torch.match import Point3D, Reconstruction
    rng = np.random.default_rng(3)
    rec = Reconstruction(device=device)
    for i in range(5):
        rec.register_image(i, f"im{i}.jpg", rng.normal(size=3) * 0.05,
                           rng.normal(size=3), rng.normal(size=(12, 2)))
    for j, xyz in enumerate(([0., 0., 4.], [1., 0., 4.], [0., 1., 4.])):
        rec.points3d[j] = Point3D(np.array(xyz),
                                  np.array([[0, j], [1, j], [2, j]]))
    rec.points3d[3] = Point3D(np.array([1., 1., 4.]),
                              np.array([[3, 0], [4, 0]]))
    rec._next_pt = 4
    return rec


def test_image_commands_need_no_card(no_card, small_db, tmp_path, capsys):
    """image_deleter and image_filterer touch no device: they run without
    a card and, like cvt_tpu's, take no --device."""
    import json
    from cvt_tpu_torch.cli import main
    from cvt_tpu_torch.match import Reconstruction
    inp, out = str(tmp_path / "rec.npz"), str(tmp_path / "out.npz")
    _toy_scene().save(inp)
    ids = tmp_path / "ids.txt"
    ids.write_text("4\n")
    main(["image_deleter", "--input_path", inp, "--output_path", out,
          "--image_ids_path", str(ids)])
    main(["image_filterer", "--input_path", out, "--output_path", out,
          "--min_num_observations", "2"])
    names = tmp_path / "names.txt"
    names.write_text("im1.jpg\n")
    path, _ = small_db
    main(["image_deleter", "--database", path, "--image_names_path",
          str(names)])
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[0]) == {"deleted": 1, "n_images": 4}
    assert lines[1] == "Filtered 1 images from a total of 4 images"
    assert json.loads(lines[2]) == {"deleted": 1}
    assert sorted(Reconstruction.load(out).images) == [0, 1, 2]
    for cmd in ("image_deleter", "image_filterer"):
        with pytest.raises(SystemExit):
            main([cmd, "--input_path", inp, "--output_path", out,
                  "--device", "cpu"])


def test_image_undistorter_without_device_cpu_fails(no_card, tmp_path,
                                                    capsys):
    from cvt_tpu_torch.cli import main
    np.save(str(tmp_path / "im.npy"), IMG)
    args = ["image_undistorter", "--images", str(tmp_path / "im.npy"),
            "--params", "40,24,20,0.1", "--out", str(tmp_path / "o.npy")]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main(args)
    assert capsys.readouterr().out == ""
    main(args + ["--device", "cpu"])
    assert np.load(str(tmp_path / "o.npy")).shape == IMG.shape


def test_reconstruction_follows_device_rule(no_card, tmp_path):
    """Loading, editing and saving a scene need no card; the computing
    methods run on the card unless the scene was asked for the CPU."""
    from cvt_tpu_torch.match import Reconstruction
    rec = _toy_scene()
    path = str(tmp_path / "rec.npz")
    rec.save(path)
    loaded = Reconstruction.load(path)
    assert loaded.deregister_image(4) and loaded.filter_images(2) == 1
    loaded.save(path)
    tracks = [p.track for p in rec.points3d.values()]
    for call in (lambda r: r.triangulate(tracks),
                 lambda r: r.bundle_adjust(iters=1),
                 lambda r: r.filter_points(1.0),
                 lambda r: r.to_ba_problem()):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call(_toy_scene())
        call(_toy_scene(device="cpu"))
    prob = Reconstruction.load(path, device="cpu").to_ba_problem()[0]
    assert prob.poses.device == torch.device("cpu")


def test_undistort_and_ba_follow_device_rule(no_card):
    from cvt_tpu_torch.apps import undistort_images, warp_image_homography
    with pytest.raises(RuntimeError, match='device="cpu"'):
        undistort_images(IMG, "simple_radial", [40., 24., 20., 0.1])
    out, _ = undistort_images(IMG, "simple_radial", [40., 24., 20., 0.1],
                              device="cpu")
    assert out.device == torch.device("cpu")
    out, _ = undistort_images(torch.from_numpy(IMG), "simple_radial",
                              [40., 24., 20., 0.1])
    assert out.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        warp_image_homography(IMG[0], np.eye(3), 8, 8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        convert.ba_problem_from_numpy(np.zeros((1, 6)), np.zeros((1, 3)),
                                      [0], [0], np.zeros((1, 2)), [1.0])
    prob = convert.ba_problem_from_numpy(np.zeros((1, 6)), np.zeros((1, 3)),
                                         [0], [0], np.zeros((1, 2)), [1.0],
                                         device="cpu")
    assert prob.cam_idx.dtype == torch.int64


# the entry points of the features / apps slice: numpy in, the card unless
# asked for the CPU
_EYE = np.full((1, 48, 64), 0.8, np.float32)
_HEAD = RNG.normal(size=(1, 4, 4, 7)).astype(np.float32)


def _slice_entry_points():
    import importlib
    from cvt_tpu_torch.apps import detect, motion_area, pupil, template_match
    from cvt_tpu_torch.apps import video_match
    from cvt_tpu_torch.features import embedding, text
    from cvt_tpu_torch.features import lines
    phash = importlib.import_module("cvt_tpu_torch.apps.phash")
    tmpl = RNG.random((40, 40)).astype(np.float32)
    return {
        "EmbeddingExtractor.simple_cnn":
            lambda dev: embedding.EmbeddingExtractor.simple_cnn(
                dim=8, input_size=32, device=dev).compute(
                    np.zeros((1, 40, 48, 3), np.uint8)),
        "TextEmbedder": lambda dev: text.TextEmbedder(
            {"a": 0}, X[:1], X[:4], device=dev).vectors,
        "TextEmbedder.random": lambda dev: text.TextEmbedder.random(
            ["a"], dim=4, n_buckets=8, device=dev).ngrams,
        "TextEmbedding": lambda dev: embedding.TextEmbedding(
            {"a": 0}, X[:1], device=dev).table,
        "embed_ids": lambda dev: text.embed_ids(X[:4], [[0, 1]], [[1, 1]],
                                                device=dev),
        "embedding_from_numpy": lambda dev: convert.embedding_from_numpy(
            [np.zeros((3, 3, 3, 4), np.float32)], np.zeros((4, 2),
                                                           np.float32),
            device=dev).compute(np.zeros((1, 8, 8, 3), np.uint8)),
        "phash": lambda dev: phash.phash(IMG[:, :32, :32], device=dev),
        "resize_gray_32": lambda dev: phash.resize_gray_32(IMG, device=dev),
        "is_pure_image": lambda dev: phash.is_pure_image(IMG, device=dev),
        "hamming_distance": lambda dev: phash.hamming_distance(
            np.zeros(2, np.int64), np.ones(3, np.int64), device=dev),
        "decode_fastestdet": lambda dev: detect.decode_fastestdet(
            _HEAD, max_dets=4, device=dev).scores,
        "detect_motion_area": lambda dev: motion_area.detect_motion_area(
            np.repeat(IMG, 3, 0), device=dev).motion_mask,
        "find_topk_boxes": lambda dev: torch.tensor(
            motion_area.find_topk_boxes(np.repeat(IMG, 3, 0), 1,
                                        device=dev)[1]),
        "find_pupil": lambda dev: pupil.find_pupil(None, _EYE, n_trials=4,
                                                   device=dev).center,
        "coarse_pupil_center": lambda dev: pupil.coarse_pupil_center(
            _EYE, device=dev)[0],
        "remove_specular": lambda dev: pupil.remove_specular(_EYE,
                                                             device=dev),
        "detect_line_segments": lambda dev: lines.detect_line_segments(
            IMG, max_segments=4, device=dev).nfa,
        "TemplateMatcher": lambda dev: template_match.TemplateMatcher(
            tmpl, max_features=16, device=dev).tmpl.frames,
        "LogoDetector": lambda dev: template_match.LogoDetector(
            {"a": [tmpl]}, max_features=16, device=dev).matchers["a"][
                0].tmpl.frames,
        "VideoObjectMatcher": lambda dev: video_match.VideoObjectMatcher(
            tmpl, max_features=16, device=dev).matcher.tmpl.frames,
    }


SLICE_ENTRY_POINTS = sorted(_slice_entry_points())


@pytest.mark.parametrize("name", SLICE_ENTRY_POINTS)
def test_slice_entry_point_without_card_raises(no_card, name):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _slice_entry_points()[name](None)


@pytest.mark.parametrize("name", SLICE_ENTRY_POINTS)
def test_slice_entry_point_with_device_cpu_works(no_card, name):
    out = _slice_entry_points()[name]("cpu")
    assert out.device == torch.device("cpu")


def test_logo_pack_loads_where_asked(no_card, tmp_path):
    from cvt_tpu_torch.apps.template_match import LogoDetector
    tmpl = RNG.random((40, 40)).astype(np.float32)
    path = str(tmp_path / "pack.npz")
    LogoDetector({"a": [tmpl]}, max_features=16, device="cpu").save(path)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        LogoDetector.load(path)
    det = LogoDetector.load(path, device="cpu")
    assert det.matchers["a"][0].tmpl.frames.device == torch.device("cpu")
    # CPU tensors keep their device through the functions handed tensors
    from cvt_tpu_torch.apps.detect import decode_fastestdet
    assert decode_fastestdet(torch.from_numpy(_HEAD), max_dets=4
                             ).scores.device == torch.device("cpu")


def test_bench_without_card_raises(no_card, capsys):
    """The benchmark runs on the card: without one, `cli bench` and
    `bench.main()` raise before any lane runs (no line printed)."""
    from cvt_tpu_torch import bench
    from cvt_tpu_torch.cli import main
    with pytest.raises(RuntimeError, match='device="cpu"'):
        main(["bench"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench.main()
    assert capsys.readouterr().out == ""
