"""The vocabulary tree on held-out warped queries and at a million words
(`_bench_vocab5.py` on the port).

    python -m cvt_tpu_torch.benches.vocab5 [A|B|AB] [--device cpu]

Part A (recall on queries whose descriptor sets differ from the
database's): N_DB mosaics, each a 3 x 4 grid of patches drawn from one
16-patch bank (`make_images`, so bag-of-words scores collide and only the
arrangement separates images), N_Q query images, each a random zoomed,
rotated, perspective crop (`random_h`) of a database image warped by
`apps.undistort.warp_image_homography`, with gamma, gain, offset and
noise jitter (`query_image`). SIFT at K 512 (first octave 0, one
orientation, RootSIFT, x512 into SIFT's uint8 range); W 65,536 trained on
up to 400,000 database descriptors (512 x 512 hold 262,144); the
strongest KQ_USE query features;
`query_batch` at probes 2 / 4 / 8 / 16 / exact, then probes 8 with
verify=10. The images are numpy over `procedural_images` and equal the
script's bit for bit; no descriptor cache is kept (the script's
`_data/vocab5_db_mosaic16.npz` holds `cvt_tpu`'s features).

Part B (speed at the Flickr100K tree's size, exe/vocab_tree.cc:74-78): W
1,048,576 (1024 x 1024) trained on the first 1M rows of the port's
dogfood corpus (`benches.dogfood`'s DATA_DIR and BASE_NAME; made first
by `dogfood extract` where absent), 256 images x 512 added,
`query_batch` of 64 x 512 descriptors from the corpus's middle at probes
8 and 16: first call and steady time, peak device memory.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from cvt_tpu_torch.apps.undistort import warp_image_homography
from cvt_tpu_torch.benches import dogfood
from cvt_tpu_torch.benches._common import (Run, emit, full_precision,
                                           parse_args, peak_mib, reset_peak,
                                           sync)
from cvt_tpu_torch.features.covdet import extract_sift
from cvt_tpu_torch.index.vocab_he import VocabHEIndex
from cvt_tpu_torch.io.datasets import procedural_images
from cvt_tpu_torch.io.vecs import read_bvecs

H, W = 480, 640
N_DB = 512
N_Q = 128
KQ = 512
KQ_USE = 128                    # strongest query features only
BB, QB = 16, 8                  # database / query extraction batches
BANK_N, BANK_SIZE, BANK_SEED, DB_SEED0, QUERY_RNG_SEED = 16, 160, 777, \
    20_000, 5
A_WORDS, A_TRAIN, A_PROBES, A_TOPK, A_VERIFY = 65_536, 400_000, \
    (2, 4, 8, 16, 0), 5, 10
B_WORDS, B_TRAIN, B_IMAGES, B_PER, B_Q, B_Q_START, B_PROBES = \
    1024 * 1024, 1_000_000, 256, 512, 64, 500_000, (8, 16)
ITERS = 10


def random_h(rng):
    """Random query-view homography: a ZOOMED CROP (only 25-60% of the
    source image area remains visible, at 1.3-2x magnification) with
    rotation +-30deg and perspective — hard enough that assignment
    quality shows (the first honest-eval attempt with mild whole-image
    warps saturated recall at 1.0 for every probe setting)."""
    th = rng.uniform(-0.52, 0.52)
    s = rng.uniform(0.5, 0.75)          # target->source: zoom 1.3-2x
    tx, ty = rng.uniform(-60, 60, 2)
    px, py = rng.uniform(-4e-4, 4e-4, 2)
    c, si = np.cos(th), np.sin(th)
    # target -> source convention (warp_image_homography)
    a = np.array([[s * c, -s * si, tx],
                  [s * si, s * c, ty],
                  [px, py, 1.0]], np.float32)
    # recenter so the frame stays mostly in view
    cx, cy = W / 2, H / 2
    t0 = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float32)
    t1 = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]], np.float32)
    return t1 @ a @ t0


def patch_bank() -> np.ndarray:
    return procedural_images(BANK_N, BANK_SIZE, BANK_SIZE, seed=BANK_SEED)


def make_images(bank: np.ndarray, n: int, seed: int) -> np.ndarray:
    """n mosaics [n, 480, 640]: 3 x 4 patches of the bank picked with
    replacement, plus N(0, 0.01) noise, clipped to [0, 1]."""
    r = np.random.default_rng(seed)
    pick = r.integers(0, len(bank), size=(n, 3, 4))
    rows = bank[pick]                       # [n, 3, 4, 160, 160]
    imgs = rows.transpose(0, 1, 3, 2, 4).reshape(n, 480, 640)
    imgs = np.clip(imgs + r.normal(0, 0.01, imgs.shape), 0, 1)
    return imgs.astype(np.float32)


def query_image(im: np.ndarray, rng, dev: torch.device) -> np.ndarray:
    """One warped, photometrically jittered re-render of `im`."""
    hm = random_h(rng)
    wi = warp_image_homography(torch.from_numpy(im).to(dev),
                               torch.from_numpy(hm), H, W).cpu().numpy()
    wi = np.clip(wi ** rng.uniform(0.7, 1.4)      # gamma
                 * rng.uniform(0.6, 1.3)
                 + rng.uniform(-0.1, 0.1)
                 + rng.normal(0, 0.05, wi.shape), 0, 1)
    return wi.astype(np.float32)


def extract(imgs: np.ndarray, dev: torch.device, k: int = KQ):
    """(descriptors x512 in SIFT's uint8 range as float32, frames,
    valid), numpy."""
    out = extract_sift(torch.from_numpy(imgs).to(dev), max_features=k,
                       first_octave=0, n_orientations=1, rootsift=True)
    d = out.descriptors.cpu().numpy() * 512.0
    return (np.clip(np.rint(d), 0, 255).astype(np.float32),
            out.frames.cpu().numpy(), out.valid.cpu().numpy())


def _extract_all(batches, dev: torch.device, k: int):
    parts = [extract(b, dev, k) for b in batches]
    return tuple(np.concatenate([p[j] for p in parts]) for j in range(3))


def build_part_a(dev: torch.device, *, n_db: int = N_DB, n_q: int = N_Q,
                 kq: int = KQ, bb: int = BB) -> tuple:
    """Database mosaics and warped queries, extracted -> (db_desc,
    db_geom, db_valid, q_desc, q_geom, q_valid, q_ids)."""
    rng = np.random.default_rng(QUERY_RNG_SEED)
    t0 = time.perf_counter()
    bank = patch_bank()
    imgs = {lo: make_images(bank, bb, DB_SEED0 + lo // bb)
            for lo in range(0, n_db, bb)}
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    db_desc, db_geom, db_valid = _extract_all(
        [imgs[lo] for lo in range(0, n_db, bb)], dev, kq)
    db_desc, db_geom, db_valid = db_desc[:n_db], db_geom[:n_db], \
        db_valid[:n_db]
    emit("db_extract", {"images": n_db, "host_synthesis_s": t_gen,
                        "card_extract_s": time.perf_counter() - t0,
                        "feats_per_image": float(db_valid.sum() / n_db)})
    t0 = time.perf_counter()
    q_ids = rng.choice(n_db, size=n_q, replace=False)
    q_imgs = np.stack([query_image(imgs[qi - qi % bb][qi % bb], rng, dev)
                       for qi in q_ids])
    q_desc, q_geom, q_valid = _extract_all(
        [q_imgs[lo:lo + QB] for lo in range(0, n_q, QB)], dev, kq)
    emit("query_extract", {"images": n_q,
                           "seconds": time.perf_counter() - t0,
                           "feats_per_image": float(q_valid.sum() / n_q)})
    return db_desc, db_geom, db_valid, q_desc, q_geom, q_valid, q_ids


def _recalls(ids, names, q_ids) -> tuple[float, float]:
    ids = np.asarray(torch.as_tensor(ids).cpu())
    ranked = np.asarray([[int(names[i]) for i in row] for row in ids])
    return (float(np.mean(ranked[:, 0] == q_ids)),
            float(np.mean([q in row for q, row in zip(q_ids, ranked)])))


def part_a(dev: torch.device, *, n_words: int = A_WORDS,
           n_train: int = A_TRAIN, kq_use: int = KQ_USE,
           iters: int = ITERS, **sizes) -> dict:
    """Train, add, prepare, then the probes sweep and verification.
    `sizes` go to build_part_a (n_db, n_q, kq, bb)."""
    (db_desc, db_geom, db_valid, q_desc, q_geom, q_valid,
     q_ids) = build_part_a(dev, **sizes)
    n_db, n_q = len(db_desc), len(q_ids)
    train = db_desc[db_valid].reshape(-1, 128)
    sel = np.random.default_rng(0).choice(len(train),
                                          min(len(train), n_train),
                                          replace=False)
    idx = VocabHEIndex(n_words=n_words, probes=8, device=dev)
    t0 = time.perf_counter()
    idx.train(torch.Generator().manual_seed(0), train[sel], iters=iters)
    sync(dev)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(n_db):
        idx.add_image(db_desc[i], name=str(i), geometries=db_geom[i])
    idx.prepare()
    sync(dev)
    report = emit("train_add", {"n_words": n_words, "train_rows": len(sel),
                                "train_s": t_train,
                                "add_prepare_s": time.perf_counter() - t0})
    qd, qv = q_desc[:, :kq_use], q_valid[:, :kq_use]
    sweep = {}
    for probes in A_PROBES:
        idx.probes = probes
        idx.query_batch(qd, topk=A_TOPK, valid=qv)             # warm
        t0 = time.perf_counter()
        ids, _, names = idx.query_batch(qd, topk=A_TOPK, valid=qv)
        sync(dev)
        dt = time.perf_counter() - t0
        r1, r5 = _recalls(ids, names, q_ids)
        label = "exact" if probes == 0 else f"probes={probes}"
        sweep[label] = emit(label, {"recall_at_1": r1, "recall_at_5": r5,
                                    "img_per_s": n_q / dt,
                                    "ms_per_img": dt / n_q * 1e3})
    idx.probes = 8
    t0 = time.perf_counter()
    ids, _, names = idx.query_batch(qd, topk=A_TOPK, valid=qv,
                                    verify=A_VERIFY,
                                    geometries=q_geom[:, :kq_use])
    sync(dev)
    dt = time.perf_counter() - t0
    r1, r5 = _recalls(ids, names, q_ids)
    sweep[f"probes=8+verify{A_VERIFY}"] = emit(
        f"probes=8+verify{A_VERIFY}", {"recall_at_1": r1, "recall_at_5": r5,
                                       "img_per_s": n_q / dt,
                                       "ms_per_img": dt / n_q * 1e3})
    return dict(report, corpus={"n_db": n_db, "n_q": n_q,
                                "kq": q_desc.shape[1], "kq_use": kq_use,
                                "queries": "homography-warped re-renders"},
                sweep=sweep)


def part_b(dev: torch.device, *, data_dir: str = dogfood.DATA_DIR,
           n_words: int = B_WORDS, n_train: int = B_TRAIN,
           n_images: int = B_IMAGES, per: int = B_PER, n_q: int = B_Q,
           q_start: int = B_Q_START, iters: int = ITERS) -> dict:
    """W n_words on the dogfood corpus in `data_dir` (extracted first at
    `dogfood`'s sizes where absent): train, add, prepare, batched
    queries."""
    path = os.path.join(data_dir, dogfood.BASE_NAME)
    if not os.path.exists(path):
        print(f"vocab5 B: no dogfood corpus at {path}; running dogfood "
              f"extract first", flush=True)
        dogfood.extract(dev, data_dir=data_dir)
    base = read_bvecs(path).astype(np.float32)
    reset_peak(dev)
    idx = VocabHEIndex(n_words=n_words, probes=8, device=dev)
    t0 = time.perf_counter()
    idx.train(torch.Generator().manual_seed(1), base[:n_train], iters=iters)
    sync(dev)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(n_images):
        idx.add_image(base[i * per:(i + 1) * per], name=str(i))
    idx.prepare()
    sync(dev)
    out = emit("b_train_add", {"n_words": n_words,
                               "train_rows": min(n_train, len(base)),
                               "train_s": t_train,
                               "add_prepare_s": time.perf_counter() - t0,
                               "bucket_cap": idx._b_img.shape[1],
                               "overflow": idx.n_overflow})
    q = base[q_start:q_start + n_q * per].reshape(n_q, per, 128)
    rows = {}
    for probes in B_PROBES:
        idx.probes = probes
        t0 = time.perf_counter()
        idx.query_batch(q, topk=10)
        sync(dev)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx.query_batch(q, topk=10)
        sync(dev)
        dt = time.perf_counter() - t0
        rows[f"probes={probes}"] = emit(f"b_probes={probes}", {
            "q_batch": n_q, "img_per_s_steady": n_q / dt,
            "ms_per_img_steady": dt / n_q * 1e3, "first_call_s": first})
    return dict(out, queries=rows, peak_mib=peak_mib(dev))


def main(device=None, stage: str = "A", *, part_a_sizes: dict | None = None,
         part_b_sizes: dict | None = None) -> dict:
    """Run the parts named in `stage` (the card unless asked for the
    CPU)."""
    if not stage or set(stage) - {"A", "B"}:
        raise ValueError(f"stage must be A, B or AB: {stage!r}")
    run = Run("vocab5", device)
    out = {"stage": stage}
    with full_precision():
        if "A" in stage:
            out["A"] = part_a(run.dev, **(part_a_sizes or {}))
        if "B" in stage:
            out["B"] = part_b(run.dev, **(part_b_sizes or {}))
    return run.result(**out, kernels={})


if __name__ == "__main__":
    args, device = parse_args(stage_help="A | B | AB")
    main(device, *args[:1])
