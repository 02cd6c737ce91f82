"""Matching front-ends: pair generation strategies + the match pipeline
(counterpart of `cvt_tpu.match.pipelines`).

Reference: vlindex/src/feature/matching.{h,cc} — the matcher zoo:
ExhaustiveFeatureMatcher (block-wise all pairs, matching.h:398),
SequentialFeatureMatcher (sliding overlap + vocab-tree loop closure,
matching.cc "RunSequentialMatching"), VocabTreeFeatureMatcher (index all
-> per-image retrieval -> match retrieved pairs, matching.cc:1106-1200),
SpatialFeatureMatcher (position knn), TransitiveFeatureMatcher (two-hop
closure), ImagePairsFeatureMatcher (explicit list), and the
match->verify pipeline that stores matches + two-view geometries in the
Database and skips pairs already matched (matching.cc:829-836).

Pair GENERATION is cheap host logic (spatial knn is one device matrix
product); pair MATCHING is the hot path, in `cvt_tpu`'s order: one pair
per call, descriptors padded to bucketed [K, D] shapes and kept with the
keypoints on the device in a bounded LRU cache, the one-product 2-NN
matcher (match.nn), the batched-hypothesis RANSACs (match.two_view),
the database written per pair and committed once. Reading the database
and writing results back are host work.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np
import torch

from cvt_tpu_torch.io.database import FeatureDatabase
from cvt_tpu_torch.match.guided import match_guided
from cvt_tpu_torch.match.nn import match_descriptors
from cvt_tpu_torch.match.two_view import (UNCALIBRATED,
                                          estimate_two_view_geometry)
from cvt_tpu_torch.ops.topk import top_k_smallest
from cvt_tpu_torch.utils.device import resolve_device
from cvt_tpu_torch.utils.log import LRUCache

# ---------------------------------------------------------------------------
# pair generation
# ---------------------------------------------------------------------------


def exhaustive_pairs(image_ids: Sequence[int],
                     block_size: int = 50) -> list[tuple[int, int]]:
    """All unordered pairs, emitted block-wise (cache-friendly order used
    by ExhaustiveFeatureMatcher's block loop)."""
    ids = list(image_ids)
    n = len(ids)
    pairs = []
    for bs in range(0, n, block_size):
        be = min(bs + block_size, n)
        for cs in range(0, be, block_size):
            ce = min(cs + block_size, n)
            for i in range(bs, be):
                for j in range(cs, min(ce, i)):
                    pairs.append((ids[j], ids[i]))
    return pairs


def sequential_pairs(image_ids: Sequence[int], *, overlap: int = 10,
                     quadratic: bool = False) -> list[tuple[int, int]]:
    """Consecutive-frame pairs: each image vs the next `overlap` frames
    (or 2^i strides when quadratic, SequentialMatchingOptions)."""
    ids = list(image_ids)
    pairs = []
    for i in range(len(ids)):
        if quadratic:
            steps = [2 ** p for p in range(overlap)]
        else:
            steps = range(1, overlap + 1)
        for s in steps:
            if i + s < len(ids):
                pairs.append((ids[i], ids[i + s]))
    return pairs


def spatial_pairs(image_ids: Sequence[int], positions, *,
                  max_num_neighbors: int = 50,
                  max_distance: float = 100.0,
                  device=None) -> list[tuple[int, int]]:
    """Nearest-neighbor pairs by camera position (GPS/xyz) — the knn is
    one batched device matrix product instead of FLANN (on `device`, the
    card unless asked for the CPU), neighbours in (distance, index)
    order."""
    ids = list(image_ids)
    pos = torch.as_tensor(np.asarray(positions, np.float32),
                          device=resolve_device(device))
    sq = torch.sum(pos * pos, -1)
    d2 = sq[:, None] - 2.0 * (pos @ pos.T) + sq[None, :]
    d2.fill_diagonal_(float("inf"))
    k = min(max_num_neighbors, len(ids) - 1)
    dist, idx = (a.cpu().numpy() for a in top_k_smallest(d2, k))
    pairs = set()
    for i in range(len(ids)):
        for j_pos in range(k):
            j = int(idx[i, j_pos])
            if dist[i, j_pos] <= max_distance ** 2:
                pairs.add((min(ids[i], ids[j]), max(ids[i], ids[j])))
    return sorted(pairs)


def vocab_tree_pairs(db: FeatureDatabase, index, *,
                     num_images: int = 20,
                     image_ids: Sequence[int] | None = None
                     ) -> list[tuple[int, int]]:
    """Retrieval-driven pairs: add every image's descriptors to the
    vocab-tree index, then pair each image with its top-`num_images`
    retrieved neighbors (VocabTreeFeatureMatcher, matching.cc:1106-1200).

    `index` is a trained cvt_tpu_torch.index.VocabHEIndex; `prepare()` is
    called here after all adds."""
    ids = list(image_ids) if image_ids is not None else [
        i for i, _ in db.iter_images()]
    indexed = []
    for iid in ids:
        desc = db.read_descriptors(iid)
        if desc is None or len(desc) == 0:
            continue
        index.add_image(np.asarray(desc, np.float32), name=str(iid))
        indexed.append(iid)
    index.prepare()
    pairs = set()
    for iid in indexed:
        desc = db.read_descriptors(iid)
        names, _scores = index.query(np.asarray(desc, np.float32),
                                     topk=num_images + 1)
        for name in names:
            other = int(name)
            if other != iid:
                pairs.add((min(iid, other), max(iid, other)))
    return sorted(pairs)


def transitive_pairs(db: FeatureDatabase,
                     image_ids: Sequence[int] | None = None
                     ) -> list[tuple[int, int]]:
    """Two-hop closure over existing matches: if (a,b) and (b,c) are
    matched but (a,c) is not, emit (a,c) (TransitiveFeatureMatcher)."""
    ids = list(image_ids) if image_ids is not None else [
        i for i, _ in db.iter_images()]
    adj: dict[int, set[int]] = {i: set() for i in ids}
    for a in ids:
        for b in ids:
            if a < b and db.has_matches(a, b):
                adj[a].add(b)
                adj[b].add(a)
    new_pairs = set()
    for b in ids:
        nbrs = sorted(adj[b])
        for i, a in enumerate(nbrs):
            for c in nbrs[i + 1:]:
                lo, hi = min(a, c), max(a, c)
                if hi not in adj[lo]:
                    new_pairs.add((lo, hi))
    return sorted(new_pairs)


def pairs_from_file(db: FeatureDatabase, path: str) -> list[tuple[int, int]]:
    """Explicit image-pair list (ImagePairsFeatureMatcher,
    matching.cc:1454-1466): one pair per line, two image names (or
    numeric ids) separated by whitespace; unknown names are skipped."""
    pairs: list[tuple[int, int]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            ids = []
            for token in parts[:2]:
                iid = db.image_id(token)
                if iid is None and token.isdigit():
                    iid = (int(token)
                           if db.image_name(int(token)) is not None else None)
                ids.append(iid)
            if ids[0] is None or ids[1] is None or ids[0] == ids[1]:
                continue
            pairs.append((min(ids), max(ids)))
    return pairs


def _write_geometry(db, stats, a, b, matches, geom, tv_matches=None):
    """Store a pair's two-view geometry (the winning model's inlier rows,
    or `tv_matches`) and count its configuration."""
    if tv_matches is None:
        tv_matches = matches[np.nonzero(geom.inliers)[0]]
    model = geom.h if geom.h is not None else geom.f
    db.write_two_view_geometry(
        a, b, tv_matches, config=geom.config,
        model=None if model is None else model.reshape(-1))
    stats.configs[geom.config_name] = stats.configs.get(geom.config_name,
                                                        0) + 1
    if geom.config_name != "degenerate":
        stats.n_verified += 1


def import_feature_matches(db: FeatureDatabase, path: str, *,
                           verify: bool = True, min_num_matches: int = 15,
                           max_error: float = 4.0, seed: int = 0,
                           device=None) -> MatchPipelineStats:
    """Import explicit per-pair feature matches
    (FeaturePairsFeatureMatcher, matching.cc:1569-1660). File format =
    the reference's: blocks of

        image_name1 image_name2
        idx1 idx2
        idx1 idx2
        <blank line>

    verify=True stores the rows as raw matches and estimates the
    two-view geometry from them on `device` (the card unless asked for
    the CPU; the reference's verify_matches path); verify=False trusts
    them as inliers and stores them directly as the pair's two-view
    matches. Pairs already matched are skipped. `seed` seeds one
    torch.Generator drawn from pair after pair; its draws cannot equal
    `cvt_tpu`'s jax.random bits.
    """
    dev = resolve_device(device)
    stats = MatchPipelineStats()
    gen = torch.Generator().manual_seed(seed)
    with open(path) as f:
        lines = [ln.strip() for ln in f] + [""]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        parts = lines[i].split()
        i += 1
        rows = []
        while i < len(lines) and lines[i]:
            r = lines[i].split()
            rows.append((int(r[0]), int(r[1])))
            i += 1
        if len(parts) < 2:
            continue
        # keep the file's (name1, name2) order: rows are
        # (idx-in-name1, idx-in-name2) and the database canonicalizes
        # the column order itself (matching.cc FeaturePairsFeatureMatcher
        # passes the original id order for the same reason)
        a, b = db.image_id(parts[0]), db.image_id(parts[1])
        if a is None or b is None:
            continue
        stats.n_pairs += 1
        if db.has_matches(a, b):
            stats.n_skipped += 1
            continue
        matches = (np.asarray(rows, np.int32).reshape(-1, 2)
                   if rows else np.zeros((0, 2), np.int32))
        db.write_matches(a, b, matches)
        if len(matches) >= min_num_matches:
            stats.n_matched += 1
        if not verify:
            # trusted-inlier import: the reference stores these as
            # UNCALIBRATED (no prior focal length) in this branch
            # (matching.cc FeaturePairsFeatureMatcher), never UNDEFINED
            db.write_two_view_geometry(a, b, matches,
                                       config=UNCALIBRATED, model=None)
            continue
        kpa, kpb = db.read_keypoints(a), db.read_keypoints(b)
        if kpa is None or kpb is None or len(matches) < min_num_matches:
            continue
        geom = estimate_two_view_geometry(
            gen, torch.as_tensor(kpa[matches[:, 0], :2], device=dev),
            torch.as_tensor(kpb[matches[:, 1], :2], device=dev),
            f_threshold=max_error, min_inliers=min_num_matches)
        _write_geometry(db, stats, a, b, matches, geom)
    db.commit()
    return stats


# ---------------------------------------------------------------------------
# match pipeline
# ---------------------------------------------------------------------------


def _bucket(k: int, buckets=(128, 256, 512, 1024, 2048, 4096, 8192)) -> int:
    for b in buckets:
        if k <= b:
            return b
    return -(-k // 8192) * 8192


@dataclass
class MatchPipelineStats:
    n_pairs: int = 0
    n_matched: int = 0          # pairs with >= min_num_matches
    n_verified: int = 0         # pairs with a non-degenerate geometry
    n_skipped: int = 0          # already in db
    configs: dict = field(default_factory=dict)


@dataclass
class _Image:
    """One image's padded features on the device: descriptors [Kb, D],
    their mask [Kb], keypoint locations [Kb, 2] (zero past the real
    ones), and the real keypoint count."""
    desc: torch.Tensor
    valid: torch.Tensor
    xy: torch.Tensor
    n_kp: int


def match_pairs(db: FeatureDatabase, pairs: Iterable[tuple[int, int]], *,
                ratio: float = 0.8, cross_check: bool = True,
                max_dist: float = 0.7 ** 2 * 2.0,
                min_num_matches: int = 15,
                verify: bool = True, guided: bool = False,
                guided_error: float = 4.0, seed: int = 0,
                skip_existing: bool = True,
                device=None) -> MatchPipelineStats:
    """Match descriptor sets for each pair, optionally verify two-view
    geometry, store both in the database. Pairs already matched are
    skipped (the reference's resume semantics).

    guided=True re-matches each verified pair with the estimated
    geometry as a candidate gate (SiftMatchingOptions.guided_matching,
    sift.cc:252-340): the Lowe ratio runs only among geometrically
    plausible candidates, recovering matches the plain ratio rejected.
    The guided match set replaces the stored two-view inlier matches
    when it is larger.

    Descriptors and keypoints go to `device` (the card unless asked for
    the CPU), padded per image to bucketed [K, D] shapes, and stay there
    in an LRU cache of 256 images. `seed` seeds one torch.Generator drawn
    from pair after pair (each pair's F, H and E samples in that order);
    the same seed draws the same samples on the CPU and the card, and its
    draws cannot equal `cvt_tpu`'s jax.random bits.
    """
    dev = resolve_device(device)
    stats = MatchPipelineStats()
    gen = torch.Generator().manual_seed(seed)

    def _load_image(iid):
        desc = db.read_descriptors(iid)
        kp = db.read_keypoints(iid)
        if desc is None or len(desc) == 0:
            return None
        d = np.asarray(desc, np.float32)
        if d.ndim != 2:
            d = d.reshape(len(d), -1)
        kb = _bucket(d.shape[0])
        pad = np.zeros((kb, d.shape[1]), np.float32)
        pad[:d.shape[0]] = d
        valid = np.zeros((kb,), bool)
        valid[:d.shape[0]] = True
        xy = np.zeros((kb, 2), np.float32)
        n_kp = -1 if kp is None else len(kp)
        if kp is not None:
            xy[:n_kp] = kp[:, :2]
        return _Image(*(torch.as_tensor(x, device=dev)
                        for x in (pad, valid, xy)), n_kp)

    # bounded device-side feature cache (FeatureMatcherCache's role,
    # matching.h:180-244): an unbounded dict would pin every image's
    # padded descriptors in device memory across a large corpus
    cache = LRUCache(256, _load_image)

    for a, b in pairs:
        stats.n_pairs += 1
        if skip_existing and db.has_matches(a, b):
            stats.n_skipped += 1
            continue
        ia, ib = cache.get(a), cache.get(b)
        if ia is None or ib is None:
            db.write_matches(a, b, np.zeros((0, 2), np.int32))
            continue
        res = match_descriptors(ia.desc, ib.desc, ia.valid, ib.valid,
                                ratio=ratio, cross_check=cross_check,
                                max_dist=max_dist)
        i1 = torch.nonzero(res.valid)[:, 0]
        i2 = res.idx2[i1]
        matches = torch.stack([i1, i2], -1).to(torch.int32).cpu().numpy()
        db.write_matches(a, b, matches)
        if len(matches) < min_num_matches:
            continue
        stats.n_matched += 1
        if not verify or ia.n_kp < 0 or ib.n_kp < 0:
            continue
        geom = estimate_two_view_geometry(
            gen, ia.xy[i1], ib.xy[i2], min_inliers=min_num_matches)
        tv_matches = None
        model = geom.h if geom.h is not None else geom.f
        if guided and model is not None and geom.config_name != "degenerate":
            gres = match_guided(
                ia.desc, ib.desc, ia.xy, ib.xy,
                torch.as_tensor(model, device=dev),
                model_type=("homography" if geom.h is not None
                            else "fundamental"),
                max_error=guided_error, ratio=ratio,
                cross_check=cross_check, max_dist=max_dist,
                valid1=ia.valid, valid2=ib.valid)
            g1 = torch.nonzero(gres.valid)[:, 0]
            if len(g1) > int(geom.inliers.sum()):
                tv_matches = torch.stack([g1, gres.idx2[g1]], -1).to(
                    torch.int32).cpu().numpy()
        _write_geometry(db, stats, a, b, matches, geom, tv_matches)
    db.commit()
    return stats
