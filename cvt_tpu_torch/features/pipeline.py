"""Batched feature-extraction pipeline: host IO threads feeding the card
(counterpart of `cvt_tpu.features.pipeline`).

Reference: retrieval/vlindex/src/feature/extraction.h:50-152 — COLMAP's
3-stage producer-consumer pipeline (ImageReader -> ImageResizerThread(s)
-> SiftFeatureExtractorThread(s) -> FeatureWriterThread) connected by
JobQueue (util/threading.h:260-319), writing into the SQLite Database.

The device wants LARGE batches, not per-image tasks. So the pipeline is
  reader threads (decode + resize to a fixed [H, W], host, parallel)
    -> a bounded batch assembler (fixed [B, H, W] stacks)
    -> ONE extract_sift call per batch (CUDA launches are asynchronous:
       the card computes batch i+1 while the host writes batch i)
    -> the main thread draining finished batches into FeatureDatabase.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

import numpy as np

from cvt_tpu_torch.features.covdet import extract_sift
from cvt_tpu_torch.io.database import FeatureDatabase
from cvt_tpu_torch.utils.device import resolve_device


@dataclass
class PipelineStats:
    n_images: int = 0
    n_skipped: int = 0
    n_failed: int = 0


def _default_loader(path: str, size: tuple[int, int]) -> np.ndarray:
    """Decode to gray float32 [H, W] in [0, 1], aspect-preserving resize
    + pad to the fixed pipeline shape."""
    from PIL import Image
    img = Image.open(path).convert("L")
    h, w = size
    scale = min(h / img.height, w / img.width)
    nh, nw = max(int(img.height * scale), 1), max(int(img.width * scale), 1)
    img = img.resize((nw, nh), Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    out = np.zeros((h, w), np.float32)
    out[:nh, :nw] = arr
    return out


class FeatureExtractionPipeline:
    """Extract features for a list of images into a FeatureDatabase.

    Batches are extracted on `device` (default the card; `device="cpu"`
    asks for the CPU) unless `extract_fn` is given, which then decides."""

    def __init__(self, db: FeatureDatabase, *,
                 image_size: tuple[int, int] = (480, 640),
                 batch_size: int = 8,
                 max_features: int = 512,
                 n_reader_threads: int = 4,
                 loader: Optional[Callable] = None,
                 extract_fn: Optional[Callable] = None,
                 queue_capacity: int = 4,
                 device=None):
        self.db = db
        self.image_size = image_size
        self.batch_size = batch_size
        self.max_features = max_features
        self.n_readers = n_reader_threads
        self.loader = loader or _default_loader
        if extract_fn is None:
            dev = resolve_device(device)
            extract_fn = (lambda imgs: extract_sift(
                imgs, max_features=max_features, device=dev))
        self.extract_fn = extract_fn
        self.queue_capacity = queue_capacity

    def run(self, names_and_paths: Iterable[tuple[str, str]],
            skip_existing: bool = True) -> PipelineStats:
        """names_and_paths: (image name, file path or ndarray) pairs."""
        stats = PipelineStats()
        jobs: "queue.Queue" = queue.Queue()
        loaded: "queue.Queue" = queue.Queue(maxsize=self.queue_capacity
                                            * self.batch_size)

        # register images + incremental skip (matching.cc:829-836 pattern)
        todo = []
        for name, src in names_and_paths:
            image_id = self.db.add_image(name)
            if skip_existing and self.db.has_features(image_id):
                stats.n_skipped += 1
                continue
            todo.append((image_id, src))
        for item in todo:
            jobs.put(item)
        n_jobs = len(todo)

        # ---- stage 1: reader pool (decode + resize, host) ---------------
        def reader():
            while True:
                try:
                    image_id, src = jobs.get_nowait()
                except queue.Empty:
                    return
                try:
                    if isinstance(src, np.ndarray):
                        img = src.astype(np.float32)
                    else:
                        img = self.loader(src, self.image_size)
                    loaded.put((image_id, img))
                except Exception:
                    loaded.put((image_id, None))

        readers = [threading.Thread(target=reader, daemon=True)
                   for _ in range(max(self.n_readers, 1))]
        for t in readers:
            t.start()

        # ---- stage 3: writer (drain device -> sqlite, MAIN thread) -------
        # SQLite connections are bound to their creating thread
        # (database.h:51-52 documents the same single-thread constraint);
        # finished batches wait in an in-flight deque instead. CUDA
        # launches return before the work is done, so the card computes
        # batch i+1 while the main thread converts + writes batch i.
        inflight: deque = deque()

        def write_result(ids, feats):
            kp = feats.frames.cpu().numpy()       # [B, K, 4]
            desc = feats.descriptors.cpu().numpy()
            valid = feats.valid.cpu().numpy()
            for bi, image_id in enumerate(ids):
                n = int(valid[bi].sum())
                self.db.write_keypoints(image_id, kp[bi, :n])
                self.db.write_descriptors(image_id, desc[bi, :n])
            self.db.commit()

        # ---- stage 2: batch assembler + device extraction ----------------
        pend_ids: list[int] = []
        pend_imgs: list[np.ndarray] = []

        def flush():
            if not pend_ids:
                return
            ids = list(pend_ids)
            batch = np.stack(pend_imgs)
            pend_ids.clear()
            pend_imgs.clear()
            feats = self.extract_fn(batch)     # asynchronous on the card
            inflight.append((ids, feats))
            while len(inflight) > self.queue_capacity:
                write_result(*inflight.popleft())

        received = 0
        while received < n_jobs:
            image_id, img = loaded.get()
            received += 1
            if img is None:
                stats.n_failed += 1
                continue
            pend_ids.append(image_id)
            pend_imgs.append(img)
            stats.n_images += 1
            if len(pend_ids) == self.batch_size:
                flush()
        flush()

        while inflight:
            write_result(*inflight.popleft())
        for t in readers:
            t.join()
        return stats
