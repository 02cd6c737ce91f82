"""Command-line interface of the port (counterpart of `cvt_tpu.cli`).

Usage:  python -m cvt_tpu_torch.cli <command> [args]
Commands:
  gen_data              write a synthetic SIFT-like fvecs dataset
  exact_search          brute-force ground truth (ivecs output)
  sq_train              train an int8 scalar quantizer
  pq_train              train a PQ/OPQ codebook
  build_adc             encode a database into a flat ADC index
  search_adc            query a flat ADC index, report recall if GT given
  feature_extractor     extract SIFT features from an image .npy
  retrieve              rank database images for query images (vote + rerank)
  vocab_tree_retriever  index + rank database images by vocab tree
  exhaustive_matcher / sequential_matcher / spatial_matcher /
  vocab_tree_matcher / image_pairs_matcher
                        generate pairs, match, verify two-view geometry,
                        store both in a FeatureDatabase
  matches_importer      import explicit feature matches (and verify them)
  database_creator / database_cleaner / database_merger
                        feature-database management
  image_undistorter     undistort an image stack through a camera model
  image_deleter / image_filterer
                        remove images from a saved reconstruction (or a
                        feature database) by name / id or by observations
  serve                 sharded query server over a saved flat ADC index
  bench                 the north-star benchmark (cvt_tpu_torch.bench):
                        flat ADC QPS at recall parity, encode rates, the
                        SQ lane and the parity sweep, a JSON line per lane
                        (sizes: bench.py's, or BENCH_N, BENCH_BATCH,
                        BENCH_ITERS, BENCH_NREC)

Flags, outputs and printed lines are `cvt_tpu.cli`'s, and the files each
command reads or writes are interchangeable with it. Every command but
gen_data, the three database commands, image_deleter and image_filterer
(which touch no device) runs on the card, and takes `--device`, the
port's one extra flag: `--device cpu` asks for the CPU; without a card
and without it the command fails.
Seeds give a torch.Generator where `cvt_tpu` makes a jax.random key, so
trained models and RANSAC samples differ between the two packages for
the same seed. `serve` runs one rank per process:
alone it is a 1-rank group; under torchrun every rank holds one shard:

    python -m cvt_tpu_torch.cli serve --index pack.npz --queries q.fvecs
    python -m cvt_tpu_torch.cli serve --index pack.npz --stdin < q.jsonl
    torchrun --nproc-per-node 4 -m cvt_tpu_torch.cli serve --index ...

serve's rank 0 prints one JSON line per query: {"ids": [...], "dists":
[...]}.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _cmd_gen_data(args):
    from cvt_tpu_torch.io.datasets import synthetic_sift
    from cvt_tpu_torch.io.vecs import write_fvecs
    base, queries = synthetic_sift(args.n, args.dim, n_queries=args.queries,
                                   seed=args.seed)
    write_fvecs(args.out + "_base.fvecs", base)
    write_fvecs(args.out + "_query.fvecs", queries)
    print(f"wrote {args.n}x{args.dim} base + {args.queries} queries")


def _cmd_exact_search(args):
    from cvt_tpu_torch.index import FlatIndex
    from cvt_tpu_torch.io.vecs import read_fvecs, write_ivecs
    base = read_fvecs(args.base)
    queries = read_fvecs(args.queries)
    idx = FlatIndex(base.shape[1], args.metric, device=args.device)
    idx.add(base)
    _, i = idx.search(queries, args.k)
    write_ivecs(args.out, i.cpu().numpy())
    print(f"wrote ground truth top-{args.k} for {queries.shape[0]} queries")


def _cmd_sq_train(args):
    from cvt_tpu_torch.io.vecs import read_fvecs
    from cvt_tpu_torch.quant import ScalarQuantizer
    x = read_fvecs(args.data)
    sq = ScalarQuantizer.train(x, l2norm=not args.no_l2norm,
                               device=args.device)
    l2, ip = sq.reconstruction_loss(x)
    sq.save(args.out)
    print(f"trained SQ d={sq.dim}; reconstruction L2 {float(l2):.5f}, "
          f"IP {float(ip):.5f}")


def _cmd_pq_train(args):
    import torch
    from cvt_tpu_torch.io.vecs import read_fvecs
    from cvt_tpu_torch.quant import OPQ, ProductQuantizer
    x = read_fvecs(args.data)
    gen = torch.Generator().manual_seed(args.seed)
    if args.opq:
        q = OPQ.train(gen, x, m=args.m, k=args.k, opq_iters=args.opq_iters,
                      device=args.device)
    else:
        q = ProductQuantizer.train(gen, x, m=args.m, k=args.k,
                                   device=args.device)
    mse = float(q.reconstruction_mse(x[:65536]))
    q.save(args.out)
    print(f"trained {'OPQ' if args.opq else 'PQ'} m={args.m} k={args.k}; "
          f"reconstruction MSE {mse:.2f}")


def _cmd_build_adc(args):
    from cvt_tpu_torch.index import FlatADCIndex
    from cvt_tpu_torch.io.vecs import read_fvecs
    from cvt_tpu_torch.quant import OPQ, ProductQuantizer
    base = read_fvecs(args.base)
    quant = (OPQ if args.opq else ProductQuantizer).load(args.model,
                                                         device=args.device)
    idx = FlatADCIndex(quant)
    for s in range(0, base.shape[0], 262144):
        idx.add(base[s:s + 262144])
    idx.save(args.out)
    print(f"indexed {idx.ntotal} codes")


def _cmd_search_adc(args):
    from cvt_tpu_torch.index import FlatADCIndex
    from cvt_tpu_torch.io.vecs import read_fvecs, read_ivecs
    from cvt_tpu_torch.utils import recall_at_k
    idx = FlatADCIndex.load(args.index, device=args.device)
    queries = read_fvecs(args.queries)
    _, i = idx.search(queries, args.k)
    out = {"n_queries": int(queries.shape[0]), "k": args.k}
    if args.gt:
        gt = read_ivecs(args.gt)
        out["recall@1"] = recall_at_k(i, gt[:, 0], k=1)
        out[f"recall@{args.k}"] = recall_at_k(i, gt[:, 0], k=args.k)
    print(json.dumps(out))


def _cmd_feature_extractor(args):
    from cvt_tpu_torch.features import extract_sift
    images = np.load(args.images)          # [B, H, W] float or uint8
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0
    feats = extract_sift(images, max_features=args.max_features,
                         rootsift=args.rootsift, device=args.device)
    frames = feats.frames.cpu().numpy()
    desc = feats.descriptors.cpu().numpy()
    valid = feats.valid.cpu().numpy()
    np.savez(args.out, frames=frames, descriptors=desc, valid=valid)
    if args.database:
        # colmap.cc feature_extractor semantics: features land in the
        # SQLite FeatureDatabase the matcher commands consume
        from cvt_tpu_torch.io.database import FeatureDatabase
        with FeatureDatabase(args.database) as db:
            for b in range(frames.shape[0]):
                iid = db.add_image(f"image_{b:06d}",
                                   width=images.shape[2],
                                   height=images.shape[1])
                v = valid[b]
                db.write_keypoints(iid, frames[b][v])
                db.write_descriptors(iid, desc[b][v])
            db.commit()
    n = valid.sum(-1)
    print(f"extracted features for {images.shape[0]} images "
          f"(keypoints/image: min {n.min()}, mean {n.mean():.1f}, "
          f"max {n.max()})")


def _cmd_retrieve(args):
    """Index every image of a feature_extractor .npz and rank them for
    each image of another (the hnsw_sifts_retrieval flow); one JSON line
    per query."""
    import types
    from cvt_tpu_torch.apps import ImageRetrievalIndex

    def load(path):
        z = np.load(path)
        return types.SimpleNamespace(frames=z["frames"],
                                     descriptors=z["descriptors"],
                                     valid=z["valid"])
    feats = load(args.db)
    idx = ImageRetrievalIndex(device=args.device)
    for b in range(feats.frames.shape[0]):
        idx.add_image(feats, batch_index=b)
    qfeats = load(args.query)
    for b in range(qfeats.frames.shape[0]):
        names, scores = idx.search(qfeats, batch_index=b, topk=args.topk,
                                   rerank=args.rerank or None)
        print(json.dumps({"query": b, "results": names,
                          "scores": [float(s) for s in scores]}))


def _cmd_vocab_tree_retriever(args):
    """Index database images into a VocabHEIndex and rank them for each
    query image (RunVocabTreeRetriever, exe/vocab_tree.cc:73-184):
    read-or-train tree -> add every database image -> prepare -> batched
    query -> print per-query ranked (image, score) lines.

    As in `cvt_tpu`, a loaded index takes no new image: names it already
    holds are skipped, and any other database image makes add_image
    raise."""
    import torch
    from cvt_tpu_torch.index import VocabHEIndex
    from cvt_tpu_torch.io.database import FeatureDatabase

    def read_list(path, db):
        if not path:
            return [i for i, _ in db.iter_images()]
        with open(path) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        ids = []
        for n in names:
            iid = db.image_id(n)
            if iid is None:
                print(f"WARNING: image {n!r} not in database, skipped")
            else:
                ids.append(iid)
        return ids

    with FeatureDatabase(args.database) as db:
        db_ids = read_list(args.database_image_list, db)
        q_ids = read_list(args.query_image_list, db) \
            if args.query_image_list else []
        desc_of = {}                 # read each image's blobs once
        if args.vocab_index:
            index = VocabHEIndex.load(args.vocab_index, device=args.device)
        else:
            for i in db_ids:
                d = db.read_descriptors(i)
                if d is not None and len(d):
                    desc_of[i] = d
            if not desc_of:
                raise SystemExit("vocab_tree_retriever: no descriptors "
                                 "in the database")
            train = np.concatenate(list(desc_of.values())).astype(
                np.float32)
            index = VocabHEIndex(
                n_words=min(args.num_words, max(len(train) // 4, 16)),
                dim=train.shape[1], probes=args.probes, device=args.device)
            index.train(torch.Generator().manual_seed(0), train, iters=10)
        indexed = set(index._names)
        for i, iid in enumerate(db_ids):
            name = db.image_name(iid)
            if name in indexed:
                print(f"Indexing image [{i + 1}/{len(db_ids)}] "
                      f"(already indexed)")
                continue
            d = desc_of.get(iid)
            if d is None:
                d = db.read_descriptors(iid)
            if d is None or not len(d):
                continue
            if args.max_features > 0:
                d = d[:args.max_features]
            kp = db.read_keypoints(iid)
            geom = (kp[:len(d), :4] if kp is not None
                    and kp.shape[1] >= 4 else None)
            index.add_image(d.astype(np.float32), name=name,
                            geometries=geom)
            print(f"Indexing image [{i + 1}/{len(db_ids)}]")
        index.prepare()
        if args.output_index:
            index.save(args.output_index)
        if not q_ids:
            return 0
        # pad query descriptor sets to one [Q, Kq, D] batch
        qs, gs, names = [], [], []
        kq = 0
        for iid in q_ids:
            d = db.read_descriptors(iid)
            d = np.zeros((0, index.dim), np.float32) if d is None else d
            if args.max_features > 0:
                d = d[:args.max_features]
            kq = max(kq, len(d), 1)
            qs.append(d.astype(np.float32))
            kp = db.read_keypoints(iid)
            gs.append(kp[:len(d), :4] if kp is not None
                      and kp.shape[1] >= 4
                      else np.zeros((len(d), 4), np.float32))
            names.append(db.image_name(iid))
        batch = np.zeros((len(qs), kq, index.dim), np.float32)
        valid = np.zeros((len(qs), kq), bool)
        geom = np.zeros((len(qs), kq, 4), np.float32)
        for i, (d, g) in enumerate(zip(qs, gs)):
            batch[i, :len(d)] = d
            valid[i, :len(d)] = True
            geom[i, :len(d)] = g
        ids, scores, slot_names = index.query_batch(
            batch, topk=args.topk, valid=valid,
            verify=args.verify, geometries=geom if args.verify else None)
        for qi, qname in enumerate(names):
            print(f"Querying for image {qname} [{qi + 1}/{len(names)}]")
            for j, s in zip(ids[qi], scores[qi]):
                print(f"  image_name={slot_names[int(j)]}, "
                      f"score={float(s):f}")
    return 0


def stats_line(mode: str, stats) -> str:
    """The JSON line a matcher command prints for its MatchPipelineStats."""
    return json.dumps({
        "mode": mode, "n_pairs": stats.n_pairs,
        "n_matched": stats.n_matched, "n_verified": stats.n_verified,
        "n_skipped": stats.n_skipped, "configs": stats.configs})


def _print_stats(mode: str, stats) -> None:
    print(stats_line(mode, stats))


def _cmd_matcher(args, mode: str):
    """The matcher commands (colmap.cc:93-139 dispatch: {exhaustive,
    sequential, spatial, vocab_tree, image_pairs}_matcher): generate
    pairs per strategy, run the match -> verify pipeline, store matches +
    two-view geometries in the database. vocab_tree_matcher without
    --vocab-index trains a vocabulary from the database's descriptors
    with a generator seeded 0."""
    import torch
    from cvt_tpu_torch.io.database import FeatureDatabase
    from cvt_tpu_torch.match import pipelines as pl

    with FeatureDatabase(args.database) as db:
        ids = [i for i, _ in db.iter_images()]
        if mode == "exhaustive":
            pairs = pl.exhaustive_pairs(ids, block_size=args.block_size)
        elif mode == "sequential":
            pairs = pl.sequential_pairs(ids, overlap=args.overlap,
                                        quadratic=args.quadratic)
        elif mode == "spatial":
            pairs = pl.spatial_pairs(
                ids, np.load(args.positions),
                max_num_neighbors=args.max_neighbors,
                max_distance=args.max_distance, device=args.device)
        elif mode == "image_pairs":
            pairs = pl.pairs_from_file(db, args.pair_list)
        else:
            from cvt_tpu_torch.index import VocabHEIndex
            if args.vocab_index:
                index = VocabHEIndex.load(args.vocab_index,
                                          device=args.device)
            else:
                # train a vocabulary from the database's own descriptors
                # (the reference ships a pretrained tree; zero-asset
                # fallback mirrors its Build() path)
                descs = [d for d in (db.read_descriptors(i) for i in ids)
                         if d is not None and len(d)]
                if not descs:
                    raise SystemExit(
                        "vocab_tree_matcher: no descriptors in the "
                        "database — run feature_extractor first")
                train = np.concatenate(descs)
                index = VocabHEIndex(n_words=min(args.num_words,
                                                 max(len(train) // 4, 16)),
                                     dim=train.shape[1], device=args.device)
                index.train(torch.Generator().manual_seed(0),
                            train.astype(np.float32), iters=10)
            pairs = pl.vocab_tree_pairs(db, index,
                                        num_images=args.num_images)
        if args.transitive:
            pairs = list(pairs) + pl.transitive_pairs(db, ids)
        stats = pl.match_pairs(
            db, pairs, ratio=args.ratio, min_num_matches=args.min_matches,
            verify=not args.no_verify, guided=args.guided,
            device=args.device)
    _print_stats(mode, stats)


def _cmd_matches_importer(args):
    """Import explicit feature matches (FeaturePairsFeatureMatcher,
    matching.cc:1569-1660)."""
    from cvt_tpu_torch.io.database import FeatureDatabase
    from cvt_tpu_torch.match import pipelines as pl

    with FeatureDatabase(args.database) as db:
        stats = pl.import_feature_matches(
            db, args.match_list, verify=not args.no_verify,
            min_num_matches=args.min_matches, device=args.device)
    _print_stats("feature_pairs", stats)


def _cmd_database_creator(args):
    """Create an empty feature database (RunDatabaseCreator)."""
    from cvt_tpu_torch.io.database import FeatureDatabase
    with FeatureDatabase(args.database):
        pass
    print(json.dumps({"created": args.database}))


def _cmd_database_cleaner(args):
    """Clear database tables (RunDatabaseCleaner, exe/database.cc:40)."""
    from cvt_tpu_torch.io.database import FeatureDatabase
    with FeatureDatabase(args.database) as db:
        db.clear(args.type)
    print(json.dumps({"cleared": args.type}))


def _cmd_database_merger(args):
    """Merge two databases (RunDatabaseMerger, exe/database.cc:91)."""
    import os
    from cvt_tpu_torch.io.database import FeatureDatabase
    if os.path.exists(args.merged_database):
        raise SystemExit("ERROR: merged database file must not exist")
    with FeatureDatabase(args.database1) as d1, \
            FeatureDatabase(args.database2) as d2, \
            FeatureDatabase(args.merged_database) as out:
        FeatureDatabase.merge(d1, d2, out)
        n = out.num_images()
    print(json.dumps({"merged": args.merged_database, "n_images": n}))


def _cmd_image_deleter(args):
    """Delete images from a saved reconstruction or a feature database
    (RunImageDeleter, exe/image.cc:77-154). Touches no device."""
    from cvt_tpu_torch.match.reconstruction import Reconstruction

    names = []
    if args.image_names_path:
        with open(args.image_names_path) as f:
            names = [ln.strip() for ln in f if ln.strip()]
    ids = []
    if args.image_ids_path:
        with open(args.image_ids_path) as f:
            ids = [int(ln) for ln in f if ln.strip()]

    if args.database:
        from cvt_tpu_torch.io.database import FeatureDatabase
        with FeatureDatabase(args.database) as db:
            for n in names:
                iid = db.image_id(n)
                if iid is not None:
                    ids.append(iid)
                else:
                    print(f"WARNING: skipping {n!r}: not in database")
            deleted = sum(bool(db.delete_image(i)) for i in set(ids))
        print(json.dumps({"deleted": deleted}))
        return 0

    rec = Reconstruction.load(args.input_path, device="cpu")
    for n in names:
        iid = rec.find_image_id(n)
        if iid is None:
            print(f"WARNING: skipping image_name={n}: not registered")
        else:
            ids.append(iid)
    deleted = 0
    for iid in set(ids):
        if rec.deregister_image(iid):
            deleted += 1
        else:
            print(f"WARNING: skipping image_id={iid}: not registered")
    rec.save(args.output_path)
    print(json.dumps({"deleted": deleted,
                      "n_images": len(rec.images)}))
    return 0


def _cmd_image_filterer(args):
    """Deregister under-observed images (RunImageFilterer,
    exe/image.cc:155-203). Touches no device."""
    from cvt_tpu_torch.match.reconstruction import Reconstruction
    rec = Reconstruction.load(args.input_path, device="cpu")
    before = len(rec.images)
    n = rec.filter_images(
        min_num_observations=args.min_num_observations)
    rec.save(args.output_path)
    print(f"Filtered {n} images from a total of {before} images")
    return 0


def _cmd_image_undistorter(args):
    """Undistort an image stack through a camera model — the
    exe/image.cc:77-407 image_undistorter."""
    from cvt_tpu_torch.apps.undistort import undistort_images
    images = np.load(args.images)
    if images.dtype == np.uint8:
        images = images.astype(np.float32) / 255.0
    params = np.asarray([float(p) for p in args.params.split(",")],
                        np.float32)
    out, newp = undistort_images(images, args.model, params,
                                 blank_pixels=args.blank_pixels,
                                 device=args.device)
    np.save(args.out, out.cpu().numpy())
    print(json.dumps({"n_images": int(images.shape[0]),
                      "model_out": "pinhole",
                      "params_out": [float(p) for p in newp]}))


def _print_rows(d, i) -> None:
    for row_d, row_i in zip(np.asarray(d), np.asarray(i)):
        print(json.dumps({"ids": row_i.tolist(),
                          "dists": [round(float(x), 3) for x in row_d]}),
              flush=True)


def _stdin_lines(rank: int, world: int):
    """Non-empty stdin lines, read by rank 0 and broadcast to every rank,
    so that all ranks serve the same queries in the same order."""
    import torch.distributed as dist
    while True:
        line = [None]
        if rank == 0:
            for raw in sys.stdin:
                if raw.strip():
                    line[0] = raw.strip()
                    break
        if world > 1:
            dist.broadcast_object_list(line, src=0)
        if line[0] is None:
            return
        yield line[0]


def _cmd_serve(args):
    """Load a FlatADCIndex pack and serve queries with the sharded
    MultiHostADCServer + continuous QueryBatcher (BASELINE config 5's
    front end). Queries arrive as an fvecs file (batch mode) or
    line-delimited JSON float arrays on stdin (--stdin streaming mode)."""
    import torch.distributed as dist
    from cvt_tpu_torch.index import FlatADCIndex
    from cvt_tpu_torch.io.vecs import read_fvecs
    from cvt_tpu_torch.parallel.serving import (MultiHostADCServer,
                                                QueryBatcher,
                                                init_distributed,
                                                serving_mesh)
    from cvt_tpu_torch.quant.opq import OPQ

    rank = init_distributed(device=args.device)
    world = dist.get_world_size()
    idx = FlatADCIndex.load(args.index, device=args.device)
    quant = (OPQ(idx.rotation, idx.pq) if idx.rotation is not None
             else idx.pq)
    srv = MultiHostADCServer(quant, serving_mesh(), merge=args.merge)
    idx._materialize()
    srv.load(codes=idx._codes)
    if args.stdin:
        batcher = QueryBatcher(srv.serve, batch_size=args.batch, k=args.k,
                               max_wait_ms=args.max_wait_ms)
        try:
            for line in _stdin_lines(rank, world):
                q = np.asarray(json.loads(line), np.float32).reshape(1, -1)
                d, i = batcher.submit(q).result()
                if rank == 0:
                    _print_rows(d, i)
        finally:
            batcher.close()
        return
    queries = read_fvecs(args.queries)
    for s in range(0, len(queries), args.batch):
        d, i = srv.serve(queries[s:s + args.batch], args.k)
        if rank == 0:
            _print_rows(d.cpu(), i.cpu())


def _cmd_bench(args):
    from cvt_tpu_torch.bench import main as bench_main
    bench_main(args.device)


def main(argv=None):
    p = argparse.ArgumentParser(prog="cvt_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    def parser(name, fn, on_device=True):
        g = sub.add_parser(name)
        if on_device:
            g.add_argument("--device", default="cuda",
                           choices=["cuda", "cpu"])
        g.set_defaults(fn=fn)
        return g

    g = parser("gen_data", _cmd_gen_data, on_device=False)
    g.add_argument("--n", type=int, default=100000)
    g.add_argument("--dim", type=int, default=128)
    g.add_argument("--queries", type=int, default=1000)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--out", required=True)

    g = parser("exact_search", _cmd_exact_search)
    g.add_argument("--base", required=True)
    g.add_argument("--queries", required=True)
    g.add_argument("--k", type=int, default=100)
    g.add_argument("--metric", default="l2", choices=["l2", "ip"])
    g.add_argument("--out", required=True)

    g = parser("sq_train", _cmd_sq_train)
    g.add_argument("--data", required=True)
    g.add_argument("--no-l2norm", action="store_true")
    g.add_argument("--out", required=True)

    g = parser("pq_train", _cmd_pq_train)
    g.add_argument("--data", required=True)
    g.add_argument("--m", type=int, default=8)
    g.add_argument("--k", type=int, default=256)
    g.add_argument("--opq", action="store_true")
    g.add_argument("--opq-iters", type=int, default=8)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--out", required=True)

    g = parser("build_adc", _cmd_build_adc)
    g.add_argument("--base", required=True)
    g.add_argument("--model", required=True)
    g.add_argument("--opq", action="store_true")
    g.add_argument("--out", required=True)

    g = parser("search_adc", _cmd_search_adc)
    g.add_argument("--index", required=True)
    g.add_argument("--queries", required=True)
    g.add_argument("--k", type=int, default=10)
    g.add_argument("--gt")

    g = parser("feature_extractor", _cmd_feature_extractor)
    g.add_argument("--images", required=True, help=".npy [B, H, W]")
    g.add_argument("--max-features", type=int, default=512)
    # as in cvt_tpu: store_true with default True, so always on
    g.add_argument("--rootsift", action="store_true", default=True)
    g.add_argument("--database", default=None,
                   help="also write features into this FeatureDatabase")
    g.add_argument("--out", required=True)

    g = parser("retrieve", _cmd_retrieve)
    g.add_argument("--db", required=True, help="features .npz from "
                   "feature_extractor")
    g.add_argument("--query", required=True)
    g.add_argument("--topk", type=int, default=10)
    g.add_argument("--rerank", default="svf")

    g = parser("vocab_tree_retriever", _cmd_vocab_tree_retriever)
    g.add_argument("--database", required=True)
    g.add_argument("--vocab_index", default="",
                   help="saved VocabHEIndex .npz (else train from db)")
    g.add_argument("--database_image_list", default="")
    g.add_argument("--query_image_list", default="")
    g.add_argument("--output_index", default="")
    g.add_argument("--num_words", type=int, default=65536)
    g.add_argument("--probes", type=int, default=8)
    g.add_argument("--max_features", type=int, default=-1)
    g.add_argument("--topk", type=int, default=10)
    g.add_argument("--verify", type=int, default=0,
                   help="spatially re-rank this many candidates")

    def matcher(name, mode):
        g = parser(name, lambda a: _cmd_matcher(a, mode))
        g.add_argument("--database", required=True)
        g.add_argument("--ratio", type=float, default=0.8)
        g.add_argument("--min-matches", type=int, default=15)
        g.add_argument("--no-verify", action="store_true")
        g.add_argument("--guided", action="store_true")
        g.add_argument("--transitive", action="store_true",
                       help="add two-hop closure pairs over existing "
                       "matches (TransitiveFeatureMatcher)")
        return g

    g = matcher("exhaustive_matcher", "exhaustive")
    g.add_argument("--block-size", type=int, default=50)

    g = matcher("sequential_matcher", "sequential")
    g.add_argument("--overlap", type=int, default=10)
    g.add_argument("--quadratic", action="store_true")

    g = matcher("spatial_matcher", "spatial")
    g.add_argument("--positions", required=True,
                   help=".npy [n_images, 2|3] camera positions")
    g.add_argument("--max-neighbors", type=int, default=50)
    g.add_argument("--max-distance", type=float, default=100.0)

    g = matcher("vocab_tree_matcher", "vocab_tree")
    g.add_argument("--vocab-index", default=None,
                   help="saved VocabHEIndex .npz (trained on the fly "
                   "from the database when omitted)")
    g.add_argument("--num-words", type=int, default=4096)
    g.add_argument("--num-images", type=int, default=20)

    g = matcher("image_pairs_matcher", "image_pairs")
    g.add_argument("--pair-list", required=True,
                   help="text file: one 'name1 name2' pair per line "
                   "(ImagePairsFeatureMatcher)")

    g = parser("matches_importer", _cmd_matches_importer)
    g.add_argument("--database", required=True)
    g.add_argument("--match-list", required=True,
                   help="blocks: 'name1 name2' header + 'idx1 idx2' rows "
                   "(FeaturePairsFeatureMatcher format)")
    g.add_argument("--no-verify", action="store_true",
                   help="trust the rows as inliers (skip geometric "
                   "verification)")
    g.add_argument("--min-matches", type=int, default=15)

    g = parser("database_creator", _cmd_database_creator, on_device=False)
    g.add_argument("--database", required=True)

    g = parser("database_cleaner", _cmd_database_cleaner, on_device=False)
    g.add_argument("--database", required=True)
    g.add_argument("--type", required=True,
                   choices=["all", "images", "features", "matches"])

    g = parser("database_merger", _cmd_database_merger, on_device=False)
    g.add_argument("--database1", required=True)
    g.add_argument("--database2", required=True)
    g.add_argument("--merged_database", required=True)

    g = parser("image_undistorter", _cmd_image_undistorter)
    g.add_argument("--images", required=True, help=".npy [B, H, W(, C)]")
    g.add_argument("--model", default="simple_radial")
    g.add_argument("--params", required=True,
                   help="comma-separated camera params")
    g.add_argument("--blank-pixels", type=float, default=0.0)
    g.add_argument("--out", required=True)

    g = parser("image_deleter", _cmd_image_deleter, on_device=False)
    g.add_argument("--input_path", default="",
                   help="saved Reconstruction .npz")
    g.add_argument("--output_path", default="")
    g.add_argument("--database", default="",
                   help="operate on a FeatureDatabase instead")
    g.add_argument("--image_ids_path", default="")
    g.add_argument("--image_names_path", default="")

    g = parser("image_filterer", _cmd_image_filterer, on_device=False)
    g.add_argument("--input_path", required=True)
    g.add_argument("--output_path", required=True)
    g.add_argument("--min_num_observations", type=int, default=10)

    g = parser("serve", _cmd_serve)
    g.add_argument("--index", required=True)
    g.add_argument("--queries", default=None)
    g.add_argument("--stdin", action="store_true")
    g.add_argument("--k", type=int, default=10)
    g.add_argument("--batch", type=int, default=1024)
    g.add_argument("--merge", default="allgather",
                   choices=["allgather", "ring"])
    g.add_argument("--max-wait-ms", type=float, default=5.0)

    parser("bench", _cmd_bench)

    args = p.parse_args(argv)
    import torch.distributed as dist
    if hasattr(args, "device"):
        from cvt_tpu_torch.utils import resolve_device
        resolve_device(args.device)      # no card: fail before any work
    try:
        return args.fn(args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
