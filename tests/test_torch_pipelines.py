"""The port's matching pipelines (cvt_tpu_torch/match/pipelines.py) and
LRU cache (utils/log.py) held against cvt_tpu on the same inputs, on the
CPU.

Pair generators: the same pair lists. match_pairs (plain and guided) and
import_feature_matches run on one database file copied for each package:
the matches tables equal up to counted near-tie rows (a descriptor's
top-2 gap, ratio margin or max-distance margin within 1e-5 relative: at
most 0.5% of the rows, as tests/test_torch_geometry.py counts them); the
two-view geometries' configurations and inlier rows equal, and each pair
stores a model of the same kind. The models themselves come from other
RANSAC draws (a torch.Generator cannot reproduce jax.random), so only
their kind is compared. A guided re-match gates its candidates with the
stored model, so it runs on the scene without keypoint noise, where
every all-inlier sample gives the true model; its rows are compared
where both stored models gate every candidate that decides the row
alike (the disputed rows are counted: at most 0.5%). The scene is a seeded multi-view set: 3D points
(a general volume and a plane) seen by cameras on an arc with 0.3 px of
noise (none for the guided runs), nonnegative unit descriptors with per-view noise, and random
distractor keypoints.
"""

import logging
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvt_tpu.index import VocabHEIndex as JVocab
from cvt_tpu.io.database import FeatureDatabase as JDatabase
from cvt_tpu.match import guided as jg
from cvt_tpu.match import pipelines as jpl
from cvt_tpu.match.two_view import PLANAR_OR_PANORAMIC
from cvt_tpu.utils import log as jlog
from cvt_tpu_torch import convert
from cvt_tpu_torch.io.database import FeatureDatabase as TDatabase
from cvt_tpu_torch.match import pipelines as tpl
from cvt_tpu_torch.utils import log as tlog
from test_torch_geometry import near_tie_rows

FOCAL, W, H = 500.0, 640, 480


def scene(n_general=260, n_planar=100, n_distract=60, dim=32, seed=0,
          noise=0.3):
    """Five views: four camera centres on an arc 13 degrees apart (wide
    enough for parallax: no homography explains a pair), the fifth at the
    fourth's centre, turned by 4 degrees (a pure rotation: a homography
    explains it all). Per image: keypoints [K, 4] (x, y, scale, angle),
    descriptors [K, dim] float32, and the scene point id of each keypoint
    (-1 for a distractor). `noise`: pixels of keypoint noise."""
    rng = np.random.default_rng(seed)
    general = rng.uniform([-2.5, -2, -3], [2.5, 2, 3], (n_general, 3))
    planar = np.c_[rng.uniform(-2.5, 2.5, (n_planar, 2)),
                   np.full(n_planar, -3.0)]
    pts = np.concatenate([general, planar])
    desc = np.abs(rng.normal(size=(len(pts), dim)))
    images = []
    for ang, turn in ((-20, 0), (-7, 0), (6, 0), (19, 0), (19, 4)):
        a = np.deg2rad(ang)
        c = 10.0 * np.array([np.sin(a), 0.0, np.cos(a)])
        a = np.deg2rad(ang + turn)
        fwd = -np.array([np.sin(a), 0.0, np.cos(a)])
        right = np.cross([0.0, 1.0, 0.0], fwd)
        rot = np.stack([right, np.cross(fwd, right), fwd])     # world->cam
        cam = (pts - c) @ rot.T
        uv = cam[:, :2] / cam[:, 2:3] * FOCAL + [W / 2, H / 2]
        seen = np.nonzero((cam[:, 2] > 0) & (uv[:, 0] >= 0) & (uv[:, 0] < W)
                          & (uv[:, 1] >= 0) & (uv[:, 1] < H)
                          & (rng.uniform(size=len(pts)) < 0.9))[0]
        xy = np.concatenate([uv[seen] + rng.normal(0, noise, (len(seen), 2)),
                             rng.uniform([0, 0], [W, H], (n_distract, 2))])
        d = np.concatenate([desc[seen] + 0.08 * rng.normal(
            size=(len(seen), dim)), np.abs(rng.normal(size=(n_distract,
                                                            dim)))])
        d = np.abs(d)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        ids = np.concatenate([seen, np.full(n_distract, -1)])
        order = rng.permutation(len(ids))
        kp = np.c_[xy, rng.uniform(1.5, 6, len(ids)),
                   rng.uniform(-3, 3, len(ids))][order]
        images.append((kp.astype(np.float32), d[order].astype(np.float32),
                       ids[order]))
    return images


def write_scene(path, images):
    """The scene as a FeatureDatabase file written by cvt_tpu's
    io.database."""
    with JDatabase(path) as db:
        for i, (kp, d, _) in enumerate(images):
            iid = db.add_image(f"im{i}.jpg", W, H)
            db.write_keypoints(iid, kp)
            db.write_descriptors(iid, d)
        db.commit()


@pytest.fixture(scope="module")
def scene_db(tmp_path_factory):
    """The scene's database file and the scene."""
    path = str(tmp_path_factory.mktemp("pipe") / "scene.sqlite")
    images = scene()
    write_scene(path, images)
    return path, images


@pytest.fixture(scope="module")
def exact_db(tmp_path_factory):
    """The scene without keypoint noise: every all-inlier sample fits the
    true model to float32 rounding, so both packages' guided re-matches
    gate their candidates with the same model whatever their draws."""
    path = str(tmp_path_factory.mktemp("pipe") / "exact.sqlite")
    images = scene(noise=0.0)
    write_scene(path, images)
    return path, images


def copies(path, tmp_path):
    a, b = str(tmp_path / "j.sqlite"), str(tmp_path / "t.sqlite")
    shutil.copy(path, a)
    shutil.copy(path, b)
    return a, b


def disputed_rows(images, a, b, model_j, model_t, config, err=4.0):
    """Rows of a guided re-match whose outcome the two stored models (from
    other RANSAC draws) may decide differently: a candidate of the row at
    most as far as its second-best, or a rival row of its best column at
    most as far, that one model gates in and the other out."""
    da, db_ = images[a - 1][1].astype(np.float64), images[b - 1][1]
    pa, pb = images[a - 1][0][:, :2], images[b - 1][0][:, :2]
    resid = (jg._homography_residual_matrix if config == PLANAR_OR_PANORAMIC
             else jg._epipolar_residual_matrix)
    gates = [np.asarray(resid(jnp.asarray(m.reshape(3, 3), jnp.float32),
                              jnp.asarray(pa), jnp.asarray(pb)))
             <= err * err for m in (model_j, model_t)]
    d = (np.sum(da ** 2, 1)[:, None] - 2.0 * da @ db_.T.astype(np.float64)
         + np.sum(db_.astype(np.float64) ** 2, 1)[None, :])
    dg = np.where(gates[0] | gates[1], d, np.inf)
    second = np.sort(dg, 1)[:, 1:2]
    dispute = gates[0] != gates[1]
    rows = np.any(dispute & (dg <= second), 1)
    best = np.argmin(dg, 1)
    rival = dispute[:, best] & (dg[:, best] <= dg[np.arange(len(d)), best])
    return rows | np.any(rival, 0)


def assert_tables_equal(jpath, tpath, pairs, images, ratio=0.8,
                        max_dist=0.7 ** 2 * 2.0, guided=False):
    """Matches equal up to counted near-tie rows; geometries' configs and
    inlier rows equal (guided: up to counted disputed rows), models of the
    same kind."""
    n_rows = n_ties = n_disputed = 0
    with JDatabase(jpath) as jdb, TDatabase(tpath) as tdb:
        for a, b in pairs:
            mj, mt = jdb.read_matches(a, b), tdb.read_matches(a, b)
            assert (mj is None) == (mt is None)
            if mj is None:
                continue
            da, db_ = images[a - 1][1], images[b - 1][1]
            v1, v2 = np.ones(len(da), bool), np.ones(len(db_), bool)
            tie = near_tie_rows(da, db_, v1, v2, ratio, max_dist)
            n_rows += len(da)
            n_ties += int(tie.sum())
            sj = {tuple(r) for r in mj if not tie[r[0]]}
            st = {tuple(r) for r in mt if not tie[r[0]]}
            assert sj == st, (a, b)
            gj, gt = (jdb.read_two_view_geometry(a, b),
                      tdb.read_two_view_geometry(a, b))
            assert (gj is None) == (gt is None)
            if gj is None:
                continue
            assert gt[1] == gj[1], (a, b, gt[1], gj[1])
            assert (gt[2] is None) == (gj[2] is None)
            if guided and gj[2] is not None:
                tie = tie | disputed_rows(images, a, b, gj[2], gt[2], gj[1])
                n_disputed += int(tie.sum())
            assert ({tuple(r) for r in gt[0] if not tie[r[0]]}
                    == {tuple(r) for r in gj[0] if not tie[r[0]]}), (a, b)
    assert n_ties <= 0.005 * max(n_rows, 1)
    assert n_disputed <= 0.005 * max(n_rows, 1)


def stats_dict(s):
    return (s.n_pairs, s.n_matched, s.n_verified, s.n_skipped, s.configs)


# ---------------------------------------------------------------------------
# pair generators
# ---------------------------------------------------------------------------

def test_exhaustive_and_sequential_pairs():
    ids = [10, 20, 30, 40, 50, 60, 70]
    for bs in (2, 3, 50):
        assert (tpl.exhaustive_pairs(ids, block_size=bs)
                == jpl.exhaustive_pairs(ids, block_size=bs))
    for overlap, quad in ((1, False), (2, False), (3, True), (10, False)):
        assert (tpl.sequential_pairs(ids, overlap=overlap, quadratic=quad)
                == jpl.sequential_pairs(ids, overlap=overlap,
                                        quadratic=quad))


@pytest.mark.parametrize("k,max_distance", [(1, 5.0), (3, 5.0), (50, 100.0),
                                            (2, 1.0)])
def test_spatial_pairs(k, max_distance):
    """Integer positions: distances are exact in float32, so ties (equal
    distances) break by index in both."""
    ids = [3, 5, 8, 9, 12, 13]
    pos = np.array([[0, 0], [1, 0], [50, 0], [51, 0], [0, 1], [2, 0]],
                   np.float32)
    got = tpl.spatial_pairs(ids, pos, max_num_neighbors=k,
                            max_distance=max_distance, device="cpu")
    assert got == jpl.spatial_pairs(ids, pos, max_num_neighbors=k,
                                    max_distance=max_distance)


def test_transitive_and_file_pairs(scene_db, tmp_path):
    path, _ = scene_db
    jp, tp = copies(path, tmp_path)
    lst = tmp_path / "pairs.txt"
    lst.write_text("im0.jpg im1.jpg\nim1.jpg   im3.jpg\nim2.jpg nope.jpg\n"
                   "4 5\nim2.jpg im2.jpg\nlonely\n\n3 im0.jpg\n")
    with JDatabase(jp) as jdb, TDatabase(tp) as tdb:
        for db in (jdb, tdb):
            for a, b in ((1, 2), (2, 3), (4, 5)):
                db.write_matches(a, b, np.zeros((3, 2), np.int32))
        assert tpl.transitive_pairs(tdb) == jpl.transitive_pairs(jdb) \
            == [(1, 3)]
        assert (tpl.transitive_pairs(tdb, [1, 2, 3])
                == jpl.transitive_pairs(jdb, [1, 2, 3]))
        assert tpl.pairs_from_file(tdb, str(lst)) == jpl.pairs_from_file(
            jdb, str(lst)) == [(1, 2), (2, 4), (4, 5), (1, 3)]


def test_vocab_tree_pairs_with_cvt_tpu_index(scene_db, tmp_path):
    """A vocabulary cvt_tpu trained, carried to the port by
    convert.vocab_he_from_numpy: the same retrieved pairs."""
    path, images = scene_db
    train = np.concatenate([d for _, d, _ in images])
    jp, tp = copies(path, tmp_path)
    for num_images in (1, 2, 10):
        jidx = JVocab(n_words=32, dim=train.shape[1])
        jidx.train(jax.random.key(0), train, iters=5)
        tidx = convert.vocab_he_from_numpy(
            {k: np.asarray(getattr(jidx, k))
             for k in ("words", "he_proj", "he_thresh")}, device="cpu")
        with JDatabase(jp) as jdb, TDatabase(tp) as tdb:
            want = jpl.vocab_tree_pairs(jdb, jidx, num_images=num_images)
            got = tpl.vocab_tree_pairs(tdb, tidx, num_images=num_images)
        assert got == want
        assert len(got) >= 3


# ---------------------------------------------------------------------------
# match_pairs / import_feature_matches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("guided", [False, True])
def test_match_pairs_tables_equal(scene_db, exact_db, tmp_path, guided):
    path, images = exact_db if guided else scene_db
    jp, tp = copies(path, tmp_path)
    pairs = jpl.exhaustive_pairs(list(range(1, len(images) + 1)))
    with JDatabase(jp) as jdb:
        js = jpl.match_pairs(jdb, pairs, guided=guided)
    with TDatabase(tp) as tdb:
        ts = tpl.match_pairs(tdb, pairs, guided=guided, device="cpu")
    assert stats_dict(ts) == stats_dict(js)
    assert ts.n_verified == len(pairs)
    assert set(ts.configs) == {"uncalibrated", "planar_or_panoramic"}
    assert_tables_equal(jp, tp, pairs, images, guided=guided)
    # resume: a second run skips every pair, in both
    with TDatabase(tp) as tdb:
        again = tpl.match_pairs(tdb, pairs, device="cpu")
    assert again.n_skipped == len(pairs) == again.n_pairs


def test_match_pairs_options(scene_db, tmp_path):
    """verify=False, a stricter ratio, min_num_matches, no cross-check,
    and a pair with an image that has no features."""
    path, images = scene_db
    jp, tp = copies(path, tmp_path)
    for p in (jp, tp):
        with JDatabase(p) as db:
            db.add_image("empty.jpg", W, H)
            db.commit()
    pairs = [(1, 2), (2, 3), (1, 6), (4, 5)]
    kw = dict(ratio=0.7, cross_check=False, min_num_matches=40)
    for verify in (False, True):
        with JDatabase(jp) as jdb:
            js = jpl.match_pairs(jdb, pairs, verify=verify,
                                 skip_existing=False, **kw)
        with TDatabase(tp) as tdb:
            ts = tpl.match_pairs(tdb, pairs, verify=verify,
                                 skip_existing=False, device="cpu", **kw)
        assert stats_dict(ts) == stats_dict(js)
    assert_tables_equal(jp, tp, [(1, 2), (2, 3), (4, 5)], images, ratio=0.7)
    with TDatabase(tp) as tdb:
        assert len(tdb.read_matches(1, 6)) == 0


def _match_list(path, images):
    """A FeaturePairsFeatureMatcher file: true correspondences of three
    pairs (one reversed, so rows are in name order), a short block, an
    unknown name."""
    blocks = []
    for a, b in ((0, 1), (3, 2), (1, 4)):
        ia, ib = images[a][2], images[b][2]
        rows = [(i, int(np.nonzero(ib == p)[0][0]))
                for i, p in enumerate(ia) if p >= 0 and (ib == p).any()]
        blocks.append(f"im{a}.jpg im{b}.jpg\n"
                      + "\n".join(f"{i} {j}" for i, j in rows[:120]))
    blocks.append("im0.jpg im4.jpg\n1 2\n3 4")
    blocks.append("im0.jpg missing.jpg\n1 2")
    with open(path, "w") as f:
        f.write("\n\n".join(blocks) + "\n")


@pytest.mark.parametrize("verify", [True, False])
def test_import_feature_matches(scene_db, tmp_path, verify):
    path, images = scene_db
    jp, tp = copies(path, tmp_path)
    lst = str(tmp_path / "matches.txt")
    _match_list(lst, images)
    with JDatabase(jp) as jdb:
        js = jpl.import_feature_matches(jdb, lst, verify=verify)
    with TDatabase(tp) as tdb:
        ts = tpl.import_feature_matches(tdb, lst, verify=verify,
                                        device="cpu")
        again = tpl.import_feature_matches(tdb, lst, device="cpu")
    assert stats_dict(ts) == stats_dict(js)
    assert ts.n_pairs == 4 and again.n_skipped == 4
    with JDatabase(jp) as jdb, TDatabase(tp) as tdb:
        for a, b in ((1, 2), (4, 3), (2, 5), (1, 5)):
            np.testing.assert_array_equal(tdb.read_matches(a, b),
                                          jdb.read_matches(a, b))
            gj, gt = (jdb.read_two_view_geometry(a, b),
                      tdb.read_two_view_geometry(a, b))
            assert (gj is None) == (gt is None)
            if gj is not None:
                np.testing.assert_array_equal(gt[0], gj[0])
                assert gt[1] == gj[1]


# ---------------------------------------------------------------------------
# LRUCache and the log helpers (tests/test_log_cache.py's cases, both
# packages)
# ---------------------------------------------------------------------------

@pytest.fixture(params=["cvt_tpu", "cvt_tpu_torch"])
def log(request):
    return {"cvt_tpu": jlog, "cvt_tpu_torch": tlog}[request.param]


def test_lru_cache_loader_and_eviction(log):
    loads = []

    def getter(k):
        loads.append(k)
        return k * 10

    c = log.LRUCache(2, getter)
    assert c.get(1) == 10
    assert c.get(2) == 20
    assert c.get(1) == 10            # hit, no reload
    assert loads == [1, 2]
    c.get(3)                         # evicts 2 (1 was touched later)
    assert 2 not in c
    assert 1 in c
    c.get(2)
    assert loads == [1, 2, 3, 2]
    assert c.hits == 1 and c.misses == 4
    assert len(c) == 2
    with pytest.raises(log.CheckError):
        log.LRUCache(0)


def test_lru_cache_no_loader(log):
    c = log.LRUCache(4)
    with pytest.raises(KeyError):
        c.get("missing")
    c.set("a", 1)
    assert c.get("a") == 1
    assert c.pop("a") == 1
    assert c.pop("a") is None
    c.set("b", 2)
    c.clear()
    assert len(c) == 0


def test_check_family_and_logging(log, caplog):
    log.check(True)
    log.check_eq(3, 3)
    log.check_le(2, 2)
    log.check_gt(5, 4)
    with pytest.raises(log.CheckError):
        log.check(False, "bad %d", 7)
    with pytest.raises(log.CheckError, match="4 vs 5"):
        log.check_eq(4, 5)
    with pytest.raises(log.CheckError):
        log.check_gt(1, 1)
    name = log.get_logger().name
    assert log.check_option(True, "x > 0")
    with caplog.at_level(logging.ERROR, logger=name):
        assert not log.check_option(False, "x > 0")
    assert "x > 0" in caplog.text
    lg = log.init_logging()
    n = len(lg.handlers)
    assert log.init_logging() is lg and len(lg.handlers) == n
