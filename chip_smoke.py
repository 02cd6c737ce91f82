"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

1. Card and kernels: refuses to run without CUDA; prints the card's name
   and power limit (nvidia-smi); pins float32 matrix products to full
   precision and leaves cuDNN's TF32 flag at PyTorch's default (the
   port's convolutions set full precision for their own calls); builds
   the CUDA kernels from csrc/ (timed) and prints each kernel's
   registers and spills (ptxas) and, where the toolkit has
   cuobjdump, the count of each scoring instruction class in its SASS
   (IMMA / IGMMA: int8 tensor cores; IDP4A: dp4a on the CUDA cores);
   `ivf_page` must show IGMMA and no IDP4A.
2. Kernel against twin on seeded random inputs: both ADC kernels and
   their plain PyTorch twins (Npad = 65,536, B = 1,024, D = 128, M = 8,
   K = 256), then the decode kernel at every smaller segment size
   (64 / 32 / 16 / 8, tiles 1,024 and 256, the last tile partly valid).
3. Main path at the real size (BASELINE config 2 at bench.py's settings):
   synthetic_sift(1M, 128, 8192 fresh queries) -> OPQ.train(M=8, K=256)
   on 131,072 vectors -> FlatADCIndex(device="cuda").add -> exact ground
   truth (FlatIndex, 2,048 queries) -> search fast and exact=True at
   B = 8,192 -> build_decoded_cache + search -> the reference engine
   `_adc_scan`'s recall as the parity reference.
4. Asserts: both kernels launched during the main path; decoded-cache ids
   equal the fast path's; |recall@1(fast) - recall@1(reference)| <= 1.0
   point; every id below n and every distance finite.
5. Kernel against twin at the main path's own arguments: the index's
   codes, decoded cache and norms, the 8,192 folded queries, and the
   tiles the index picks at 1M (2,048 for the decode scan, 4,096 for the
   cached scan). The `kernels` line reports this comparison.
6. Times (CUDA events) of fast, exact and decoded-cache search at 1M x
   8192, of each kernel beside its twin, and encode codes/s.
7. IVF-ADC at the reference operating point (coarseK 8192, m 16, K 256,
   opq/src/IVFOPQ.cpp:56-63) on the same 1M base, queries and ground
   truth: the `ivf_page` kernel against its twin on seeded random inputs
   (pad rows, masked segments, Bpad > B), every slot live and with the
   last 4 of 48 slots fill slots (n_live 44); IVFADCIndex.train on 262,144
   vectors (10 + 10 iterations) -> build (codes/s) -> search_fast at
   B = 256, k = 10, nprobe 8 / 16 / 64 over 2,048 queries -> the reference
   engine search() at nprobe 16. Asserts: the kernel launched, no page
   dropped, ids in [0, n) or -1 without duplicates, finite distances,
   |recall@10(search_fast) - recall@10(search)| <= 1.0 point at nprobe 16.
   Then the kernel against its twin on one nprobe-16 batch's own
   arguments (n_live as search_fast passes it), and times (CUDA events)
   of search_fast, search() and the kernel beside its twin; the kernel
   also on one batch's arguments at nprobe 8 and 64, each with its live
   slot count.
8. The int8 SQ lane (BASELINE config 1) on the same base and queries,
   L2-normalised: exact ground truth (FlatIndex, 2,048 queries) ->
   ScalarQuantizer.train / encode on the card (codes/s) ->
   FlatSQIndex.add -> search in bf16 and int8 modes and search_fast at
   B = 8,192, k = 10. Asserts: the cached kernel launched, ids in [0, n),
   finite distances, |recall@10(search_fast) - recall@10(bf16)| <= 1.0
   point. Then the cached kernel against its twin at the path's own
   arguments (Npad 1,000,448, tile 1,024), and times of each mode.
9. The serving front end (BASELINE config 5) on one card: a 1-rank NCCL
   group (init_distributed) and a 'db' mesh of 1; MultiHostADCServer
   over the flat phase's OPQ and 1M codes with the allgather and the ring
   merge serves 2,048 queries at B = 1,024, k = 10; serve_pipelined
   [2, 1,024] and ShardedADCSearcher(impl="kernel") must give serve's
   ids; QueryBatcher answers 8 threads' blocks of 1 / 37 / 256 / 500
   rows; |recall@1(serve) - recall@1(reference engine)| <= 1.0 point.
   Then the `adc_segmin` kernel against its twin at the server's own
   arguments, sharded_kmeans_step against one `_lloyd` step, and
   `python -m cvt_tpu_torch.cli serve` as a subprocess on a saved pack
   (batch mode and --stdin), whose ids must equal the in-process serve.
   Times of serve with each merge and of serve_pipelined.
10. The split of each ADC call at the flat path's shape into its scan
   kernel and `tiletop_kernel` (torch.profiler device time; last, since
   the profiler's hooks slow the host side of what runs after it).
   Each kernel's bound at each path's shape: the larger of the bytes it
   must move (each input read once, each output written once) over 3.35
   TB/s and its int8 operations (2 per multiply-add; IVF: the n_live live
   page slots only) over 1,979 TOP/s, the H100 SXM data sheet's rates;
   and its time's share of that bound. One JSON line describing the three
   kernels (launches summed over the paths that run each, max_abs_err the
   worst of its comparisons, ms / bound at the flat path's shape for the
   ADC kernels and at the nprobe-16 batch for `ivf_page`, every path under
   by_path, `ivf_page` at each nprobe under by_nprobe with its live slot
   count; no one PyTorch call computes packed segment minima, so
   library_ms is null) and, last, the device line.

11. The tie-exact top-k (ops/topk.py) against the stable sort it
   replaced, bitwise, values and ids, on the card at the paths' shapes
   with heavy ties: the SQ search's chunk [8,192, 65,536] float32 (also
   with +inf padding), the flat path's segment keys [8,192, 7,936] int32
   with INT32_MAX fills and their float32 casts, for k = 1, 10 and N,
   and the seed selection of vote-and-verify (largest 8 of [1,280,
   16,384] bins, most tied at -1). Times of the sort and the selection
   at each shape.
12. The vocabulary tree with Hamming embedding at the reference's
   default operating point (visual_index.h: W = 65,536 words,
   hierarchical 256 x 256; the recipe of _bench_vocab5.py:159-221 on
   synthetic_sift in place of extracted SIFT): 1,024 images x 512
   descriptors (synthetic_sift(524,288, 128), seeded frames), train on
   400,000 of them (iters 10), add and prepare every image, then
   query_batch for 128 queries (128 noisy descriptors of every 8th image,
   frames moved by one seeded similarity each) at probes 2, 8 and exact
   (0), and at probes 8 with verify=10. Asserts: ids in range, finite
   scores, recall@1 >= 0.90 against the source image at probes 8 with and
   without verification, single queries agree with the batch, and the
   index saved and loaded on the CPU answers 8 queries as the card (rank
   by rank within rtol 1e-5, a rank whose score lies within 1e-5 of a
   neighbour's may swap: float32 sums in another order; with
   verification the top-1, the rest counted). The path launches none of
   the three kernels: their counts, zeroed before it, stay 0.
13. `python -m cvt_tpu_torch.cli vocab_tree_retriever` as a subprocess on
   a FeatureDatabase (io/database.py) holding 8 indexed images and 8
   query images, with --vocab_index at the phase's saved index: its
   ranked names must equal the in-process query_batch's.
14. SIFT extraction at the vlindex operating point (sift.h:44-113:
   first octave -1, 3 scales, peak 0.02/3, edge 10; 2 orientations,
   RootSIFT) on procedural_images 640 x 480: extract_sift at K 8,192,
   B 8 and at K 2,048, B 16. Times per batch (CUDA events, median of 7
   after a warm call), images/s, keypoints per image, peak memory.
   Asserts: shapes, descriptor norms 1 +- 1e-3, frames inside the image,
   > 500 valid keypoints per image at K 2,048, and the card against the
   CPU on 2 images of 320 x 240 at K 1,024 (>= 98% of the CPU's valid
   keypoints matched within 0.01 px and 1e-3 rad, descriptor cosine >=
   0.999: the CPU parity tests' tolerance). The torch.profiler list of the
   top device operations of one K 8,192 batch is printed last.
15. Retrieval over extracted features: 512 procedural images (8 seeded
   chunks of 64) at K 2,048 (~1M descriptors) in an ImageRetrievalIndex
   (exact FlatIndex); 64 re-rendered views of every 8th image (seeded
   similarity: scale 0.85-1.15, shift +-24 px, rotation +-5 degrees;
   bilinear resampling, gain, offset, noise) searched with rerank None /
   svf / ransac, topk 10. Asserts: ids in range, finite scores, recall@1
   of the source image >= 0.90 with svf; an index on the CPU holding the
   card's features ranks 4 queries as the card (the near-tie rule of step
   12). Then VocabHEIndex (W 65,536, hierarchical 256 x 256, trained on
   400,000 of the corpus's descriptors, iters 10) over the same images,
   query_batch for the 64 views at probes 2 / 8 / exact and probes 8 with
   verify 10 (gate: ids in range, finite scores). Times: extraction
   images/s, add_image per image, per query image in each mode. The
   three kernels' counts, zeroed before steps 14 and 15, stay 0.
16. `python -m cvt_tpu_torch.cli feature_extractor` on 16 uint8 images
   (with --database) and on 4 views, then `cli retrieve`, as
   subprocesses: the ranked names must equal the in-process extract_sift
   -> ImageRetrievalIndex.search results.
17. The matching front end: a seeded 64-image FeatureDatabase at K 8,192
   (multiview_scene), match_pairs over the 2,016 exhaustive pairs at
   COLMAP's defaults with per-pair CUDA-event splits, guided matching
   over the 63 sequential pairs, one calibrated estimate at 4 px and 1 px,
   and 16 pairs again on the CPU against the card.
18. The five matcher commands, matches_importer and the three database
   commands as subprocesses on 16 rendered views, each line against the
   same work in-process.
19. The reconstruction on step 17's scene and its verified inlier tables:
   tracks (CorrespondenceGraph.build_tracks over every verified pair;
   gate: >= 0.99 of tracks pure, every observation of one true point);
   image_to_world / world_to_image over all 64 x 8,192 keypoints, pinhole
   against (uv - c) / f and an opencv lens (k1 -0.12, k2 0.03, p1 5e-4,
   p2 -3e-4) as a round trip, the card against the CPU; every track
   triangulated from the true poses, then ransac_pnp per image at 4 px
   (gate: every image registers with >= 30 inliers, within RC_GATES'
   rotation and centre errors); bundle_adjust at its defaults (20 LM x 30
   CG, cameras 1-2 fixed) from seeded perturbed poses, re-triangulated,
   then filter_points at 4 px and filter_images(10) (gates on the mean
   reprojection error and, after a similarity alignment, the rotation and
   centre errors); the same BA on 8 images on the CPU and the card
   (cost, poses, points within RC_GATES); cluster_scene over the
   inlier-weighted match graph (leaves <= 16); save and load on the CPU,
   equal.
20. image_deleter (4 names, on step 19's scene and on a feature database),
   image_filterer (a threshold that drops images) and image_undistorter
   (--device cuda and --device cpu, 16 procedural 1,200 x 1,600 x 3
   frames through step 19's opencv lens) as parallel subprocesses: every
   line and file equals the same call in-process, the card's frames
   within 1e-4 of the CPU's. The three kernels' counts, zeroed before step
   19, stay 0 through step 20. A torch.profiler breakdown of one
   bundle_adjust call on step 19's scene is printed at the end.

21. Logo detection and video object match at 640 x 480: 4 logos x 2
   templates (160 x 160 crops of procedural images), LogoDetector.detect
   over 256 procedural images (contrast halved) in batches of 16, every
   odd one holding one template pasted under a seeded similarity (scale
   0.8-1.2, rotation +-10 degrees). Gates: >= 0.95 of pasted images
   flagged with the right logo, <= 2% of clean images flagged; the pack
   saved, loaded on the CPU, the same hits on 8 images.
   VideoObjectMatcher.match_frames over a 250-frame clip (one background,
   seeded noise) whose frames 60-189 hold a template moving across, in
   chunks of 50, without and with hog_threshold: >= 0.95 of those frames
   hit, <= 2% of the others. Where cv2 can write the clip, match_video from
   the file and from bytes (the hits within +- 2 frames of the in-memory
   run); else one line says it did not run. Images come from
   procedural_on_card: procedural_images' numpy draws, its sums on the
   card (checked against the host function).
22. Perceptual hash: 8,192 procedural 640 x 480 images through
   resize_gray_32 and phash in batches of 512; hamming_distance [1,024 x
   8,192] for a photometric edit (gain, offset, noise) of every 8th image.
   Gates: the source is the first nearest hash for >= 0.95 of edits; 64
   images hash on the card as on the CPU up to near-mean bits;
   is_pure_image right on 64 constant and 64 textured images.
23. decode_fastestdet + nms on FastestDet's head (352 x 352 input, stride
   16: 22 x 22 x (5 + 80)), B 256, max_dets 64, 8 planted boxes per image:
   keep masks equal on the CPU, every planted box kept. detect_motion_area
   on 250 x 480 x 640 frames with a 280 x 200 picture-in-picture window of
   moving content (box within 4 px), find_topk_boxes(3). find_pupil on
   1,024 render_eye crops (96 x 128, seeded centres, axes, angles): >= 0.95
   ok with the centre within 1.5 px; 16 crops through the CPU's core on
   the same picks (centre 1e-4 px, inliers equal).
24. detect_line_segments on 16 procedural 640 x 480 images, 128 segments
   (ms per image, label-propagation steps); 2 images on the CPU: the
   same step count; labels equal when both start from the CPU's angles;
   from their own angles, pixels labelled otherwise (a pair within an
   ulp of tau) counted with the components they touch, and at most 2
   segments per touched component without a partner within
   tests/_lines_tolerance.py's rectangle bounds.
25. EmbeddingExtractor.simple_cnn(dim 128, 224) over 4,096 procedural
   images (three tone curves as RGB) in batches of 64 (images/s, peak
   memory; 16 on the CPU within 1e-4); the vectors in ScalarQuantizer +
   FlatSQIndex: search_fast (the cached kernel) and bf16 search for 1,024
   noisy copies at k 10 against exact FlatIndex ground truth (gate: recall@10
   within 1.0 point), the kernel against its twin at this path's own
   arguments, its time and bound. TextEmbedder.random at dim 300 with 2M
   buckets and 200,000 words: embed_sentences over 10,000 sentences of 12
   words (10% out of vocabulary) and embed_ids at [4,096, 32], the card
   against the CPU within 1e-6. The three kernels' counts, zeroed before
   step 21: adc_segmin_cached launched, the other two 0. A torch.profiler
   list of one step-21 batch is printed at the end.

26. Records -> ArcFace training -> embeddings -> cvt records -> SQ and
   HNSW indexes, at the ArcFace head's published widths (25,088 -> 512
   over 85,742 classes, batch 512, s 64, m 0.5; Deng et al., CVPR 2019):
   8,192 seeded class-structured samples (1,024 identities x 8: a centre,
   a 64-d nuisance subspace, noise) written by RecordDataset.from_arrays;
   one step on the card against the CPU from the same parameters (loss
   rtol 1e-4, gradients max|diff| <= 1e-4 max|g|), make_sharded_train_step
   on a 1-rank NCCL group against train_step, Timer and profile.trace
   around one step each; 120 steps (10 epochs of the 6 trained samples per
   identity) through RecordDataset.batches with CUDA-event step times, the
   host data time apart (gate: the last loss <= 0.5 of the first); embed
   a gallery (the trained samples and one held-out sample per identity)
   and the second held-out samples as queries; write_cvt_records (native)
   and read_cvt_records, bytes equal the Python loop's; FlatSQIndex
   search_fast (the cached kernel at D 512, seg 64) and bf16 search
   (gates: same-identity recall@1 >= 0.95, recall@1 parity against the
   exact nearest <= 1.0 pt),
   the kernel against its twin at these arguments, its time and bound;
   HnswIndex(ip, M 32, efC 80) over the same embeddings (recall@1 >=
   0.95), HnswIndex(l2) over the first 100,000 of the main path's base
   (recall@10 against exact FlatIndex >= 0.90 at ef 100); the dry run
   (parallel.dryrun) on the 1-rank group. Counts zeroed before step 26:
   adc_segmin launched by the dry run's server, adc_segmin_cached by the
   search, ivf_page 0.

27. The port's north-star benchmark as a user runs it: `python -m
   cvt_tpu_torch.cli bench` as a subprocess (timeout BENCH_TIMEOUT_S) at
   bench.py's sizes (1M x 128, B 8,192, 32 batches per window, recall on
   2,048 queries, the parity sweep at 131,072). Gates: a line for every
   lane and the last line with every key of BENCH_KEYS; every number in
   it finite, and positive but for the parity figures; |recall parity|
   <= 1.0 pt (BASELINE.md's 0.5 pt target printed beside it);
   recall@1 exact >= fast - 0.5 pt; the sweep's largest parity <= 2.0
   pt; the bench's own counts of `adc_segmin` and `adc_segmin_cached`
   launches >= 1 each (its process starts at 0); the device line equals
   this card's. Its QPS with their spread, recall and launches are
   printed, and its launches join the kernels line under
   launches_by_path["bench"]. It runs last, after the profiles, with
   every tensor of steps 1-26 dropped and the allocator's cache emptied
   (what this process still holds on the card is printed), so that the
   bench has the card to itself. Then, in this process, the two kernels
   against their twins at the shapes only the bench gives, on the
   arguments its own indexes hand the wrappers: `adc_segmin_cached` in
   the SQ lane at d 64 (1M rows, B 8,192) and `adc_segmin` in the
   sweep's first point (131,072 rows, B 2,048); their errors join the
   two kernels' max_abs_err.

Every ADC kernel-against-twin check demands segpack and tiletop bitwise
equal, except that a row whose norm/qs lies within 1e-4 of a half-integer
may move its key by seg (float32 summation order); such rows are counted
and printed. The IVF kernel sums no floats, so it must equal its twin
bitwise everywhere. Any failure raises, so the exit code is non-zero and
no result is printed.
"""

from __future__ import annotations

import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from cvt_tpu_torch.ops.kernels import launch_counts, zero_launch_counts
from cvt_tpu_torch.utils.profile import (adc_bound, card_line, ivf_bound,
                                         live_slots)

SEED = 0
N_DB, N_QUERIES, N_TRAIN, N_REC = 1_000_000, 8192, 131_072, 2048
D, M, KSUB, K = 128, 8, 256, 10
DEV = "cuda"
KERNEL_SRC = "cvt_tpu_torch/csrc/adc_scan.cu"
IVF_SRC = "cvt_tpu_torch/csrc/ivf_scan.cu"
# IVF-ADC at the reference operating point (_bench_ivf.py:63-64's training)
IVF_KC, IVF_M, IVF_SAMPLE, IVF_ITERS, IVF_B = 8192, 16, 262_144, 10, 256
IVF_NPROBES, IVF_REF_NPROBE = (8, 16, 64), 16
SEG_VARIANTS = (64, 32, 16, 8)
# the serving front end (BASELINE config 5) on one card
SERVE_B, KM_N, KM_K, CLI_STDIN_ROWS = 1024, 65_536, 256, 4
BATCHER_BLOCKS = (1, 37, 256, 500)
# the top-k repair's shapes: the SQ search's chunk, the flat fast path's
# segment minima at 1M rows (7,936 segments of 128), the vote seeds of 128
# queries x 10 verified candidates
TOPK_SQ, TOPK_SEG, TOPK_BINS, TOPK_SEEDS = (8192, 65_536), (8192, 7936), \
    (1280, 16_384), 8
# the vocabulary tree at visual_index.h's default (BENCH_VOCAB5.md)
VOCAB_W, VOCAB_IMAGES, VOCAB_PER_IMAGE, VOCAB_TRAIN = 65_536, 1024, 512, \
    400_000
VOCAB_EVERY, VOCAB_KQ, VOCAB_TOPK, VOCAB_VERIFY = 8, 128, 5, 10
VOCAB_PROBES, VOCAB_CPU_Q, VOCAB_CLI_Q, VOCAB_RTOL = (2, 8, 0), 8, 8, 1e-5
# SIFT extraction at the vlindex operating point (sift.h:44-113,
# BENCH_FEATURES.md): K 8,192 at B 8 and K 2,048 at B 16, 640 x 480
FEAT_H, FEAT_W, FEAT_RUNS, FEAT_REPS = 480, 640, ((8192, 8), (2048, 16)), 7
FEAT_OPTS = dict(first_octave=-1, n_scales=3, peak_threshold=0.02 / 3,
                 edge_threshold=10.0, n_orientations=2, rootsift=True)
FEAT_CPU_B, FEAT_CPU_H, FEAT_CPU_W, FEAT_CPU_K = 2, 240, 320, 1024
# retrieval over extracted features: 512 images at K 2,048, 64 views of
# every 8th, the app's defaults (topk 10, rerank depth 10)
RET_IMAGES, RET_K, RET_B, RET_EVERY, RET_TOPK, RET_CPU_Q = 512, 2048, 16, \
    8, 10, 4
RET_RERANKS = (None, "svf", "ransac")
FEAT_CLI_IMAGES, FEAT_CLI_Q = 16, 4
# the matching front end (steps 17-18): K 8,192 is COLMAP's
# SiftExtraction.max_num_features default; match_pairs' defaults follow
# SiftMatchingOptions / TwoViewGeometryOptions
MV_CAMS, MV_K, MV_W, MV_H, MV_F = 64, 8192, 1600, 1200, 1400.0
MV_GENERAL, MV_FACADE, MV_DISTRACT, MV_TWINS = 16_000, 9000, 1024, 0.15
MV_NOISE_PX, MV_DESC_NOISE, MV_CPU_PAIRS, MV_PROFILE_PAIRS = 0.5, 0.03, 16, 8
MATCH_CLI_VIEWS, MATCH_CLI_WORDS = 16, 256
# the reconstruction (steps 19-20) on step 17's scene and verified pairs:
# COLMAP's 4 px filters (Mapper.filter_max_reproj_error,
# abs_pose_max_error), 30 inliers to register (abs_pose_min_num_inliers),
# an opencv lens of a real camera's order (barrel k1, k2, small
# tangential), seeded pose noise for bundle adjustment
RC_PX, RC_MIN_INLIERS, RC_LENS = 4.0, 30, (-0.12, 0.03, 5e-4, -3e-4)
RC_ROT_NOISE, RC_T_NOISE, RC_CUT, RC_LEAF = 0.005, 0.05, 8, 16
RC_DELETE, RC_UNDIST_N, RC_PROFILE_ITERS = 4, 16, 20
# gates, set from a CPU run of steps 19-20 on the same 64 cameras with an
# eighth of the points (PnP max 0.16 deg / 0.031; BA 0.60 px, max 0.024
# deg / 0.0033 after) with margin; centres in scene units (arc radius 12).
# Card against CPU: image_to_world 1e-5 (normalized), undistorted frames
# 1e-4 (a source coordinate near 1,600 px has a float32 ulp of 1.2e-4 px)
RC_GATES = dict(pure=0.99, lens_px=0.01, pnp_rot_deg=0.5, pnp_centre=0.1,
                ba_px=0.8, ba_rot_deg=0.1, ba_centre=0.02,
                cut_cost_rtol=1e-3, cut_pose=1e-3, cut_point=1e-2,
                cam_cpu=1e-5, undistort=1e-4)
# the features / apps slice (steps 21-25). Step 21: 4 logos x 2 templates,
# 160 x 160 crops, 256 images (half pasted) at 640 x 480 in batches of 16,
# the pack checked on the CPU on 8; a 250-frame clip (10 s at 25 fps) with
# the template in frames 60-189, matched in chunks of 50
LOGO_NAMES, LOGO_PER, LOGO_SIZE, LOGO_IMAGES, LOGO_B, LOGO_CPU = \
    4, 2, 160, 256, 16, 8
LOGO_BG_CONTRAST = 0.5
LOGO_GATES = dict(recall=0.95, false=0.02)
VIDEO_T, VIDEO_IN, VIDEO_B, VIDEO_HOG = 250, (60, 190), 50, 0.8
VIDEO_GATES = {"in": 0.95, "out": 0.02}
# step 22: phash over 8,192 images in batches of 512, an edit of every 8th
PHASH_N, PHASH_B, PHASH_EVERY, PHASH_CPU, PHASH_PURE = 8192, 512, 8, 64, 64
PHASH_GATES = dict(top1=0.95)
# step 23: FastestDet's published head (352 x 352 input, stride 16, 5 + 80
# COCO classes) at B 256; a 250-frame clip with a 280 x 200 PiP window
# (x1, y1, x2, y2); 1,024 eye crops, 16 on the CPU
DET_IN, DET_STRIDE, DET_CLASSES, DET_B, DET_MAX, DET_PLANT = \
    352, 16, 80, 256, 64, 8
MOTION_T, MOTION_BOX, MOTION_GATE_PX = 250, (300, 120, 580, 320), 4
PUPIL_N, PUPIL_CPU = 1024, 16
PUPIL_GATES = dict(good=0.95, px=1.5)
# step 24: LSD on 16 images, 128 segments, 2 on the CPU
LSD_N, LSD_K, LSD_CPU = 16, 128, 2
# step 25: the simple CNN (dim 128, 224 input) over 4,096 images in batches
# of 64; 1,024 noisy copies searched at k 10; TextEmbedder at fastText's
# width (dim 300, 2M buckets: fastText's `bucket` default) with a 200,000
# word vocabulary (a cut of the published 2M-word vectors)
EMB_N, EMB_B, EMB_DIM, EMB_CPU, EMB_Q, EMB_K, EMB_NOISE = \
    4096, 64, 128, 16, 1024, 10, 0.02
TEXT_DIM, TEXT_BUCKETS, TEXT_VOCAB, TEXT_SENTS, TEXT_LEN = \
    300, 2_000_000, 200_000, 10_000, 12
TEXT_OOV, TEXT_IDS = 0.10, (4096, 32)
# step 26: the ArcFace output head at its published widths (Deng et al.,
# ArcFace, CVPR 2019, arXiv:1801.07698, sections 3 and 4.1): the "E"
# layer, FC from the 512 x 7 x 7 = 25,088-d last feature map to a 512-d
# embedding; s 64, m 0.5; batch 512; MS1MV2's 85,742 identities as the
# head's width. Cuts: 1,024 identities carry samples, 8 each (6 trained
# on, 2 held out); seeded class-structured features stand in for a
# ResNet-100's maps (no weights on disk): an identity centre, a shared
# 64-d nuisance subspace at 3x the centre's scale per axis (pose, light),
# unit noise. HNSW at hnsw_sifts_retrieval's operating point (M 32, efC
# 80), also over the first 100,000 of the main path's base (cut from 1M)
ARC_IN, ARC_EMB, ARC_CLASSES, ARC_B, ARC_S, ARC_M = \
    25_088, 512, 85_742, 512, 64.0, 0.5
ARC_IDS, ARC_PER, ARC_TRAIN_PER, ARC_EPOCHS = 1024, 8, 6, 10
ARC_NUIS_DIM, ARC_NUIS, ARC_NOISE, ARC_EMBED_CHUNK = 64, 3.0, 1.0, 1024
HNSW_M, HNSW_EFC, HNSW_EF, HNSW_N = 32, 80, 100, 100_000
# gates, set from a CPU run at reduced size (PERF.md, section 6)
ARC_GATES = dict(loss_ratio=0.5, recall=0.95, parity_pt=1.0,
                 hnsw_recall10=0.90, loss_rtol=1e-4, grad=1e-4)
# step 27: `cli bench` at bench.py's sizes as a subprocess. Gates: parity
# within the limit every path here is held to (BASELINE.md's 0.5 pt target
# printed beside it), exact recall@1 no more than 0.5 pt under the fast
# path's, the sweep's spread within bench.py's 2 pt of sampling noise
# (bench.py:325-326)
BENCH_TIMEOUT_S, BENCH_GATES = 480, dict(parity_pt=1.0, target_pt=0.5,
                                         exact_pt=0.5, sweep_pt=2.0)
# the keys of bench.py's last line, less `vs_baseline` and
# `tflops_effective`, plus the port's
BENCH_KEYS = (
    "metric", "value", "unit", "recall_at_1", "recall_at_10",
    "recall_at_1_ref_f32_adc", "recall_at_10_ref_f32_adc",
    "recall_parity_pt", "qps_decoded_cache", "qps_exact",
    "recall_at_1_exact", "recall_at_10_exact", "codes_per_sec",
    "ingest_codes_per_sec", "ingest_codes_per_sec_u8", "sq_d64_qps",
    "sq_d64_recall_at_1", "sq_d64_recall_at_10", "sq_d128_qps",
    "sq_d128_recall_at_10", "parity_sweep_pt", "parity_spread_pt_max",
    "launch_overhead_ms", "n_db", "batch", "code_bits", "data",
    "ms_per_batch", "total_bench_s", "int8_tops_effective", "bound_ms",
    "bound_share", "value_spread", "qps_decoded_cache_spread",
    "qps_exact_spread", "sq_d64_qps_spread", "sq_d128_qps_spread",
    "ingest_codes_per_sec_u8_spread", "device", "kernel_launches")
# H100 SXM data sheet: float32 outside the tensor cores (TF32 is off)
PEAK_FP32_FLOPS = 67e12
SASS_CLASSES = ("IMMA", "IGMMA", "IDP4A")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def share(ms: float, b: dict) -> dict:
    return dict(b, ms=ms, bound_share=b["bound_ms"] / ms)


def print_bound(name: str, shape: str, r: dict, stamp: str) -> None:
    print(f"{name} at {shape}: {r['ms']:.3f} ms, bound {r['bound_ms']:.3f} "
          f"ms ({r['bound_by']}: {r['ops']:.3e} int8 ops, "
          f"{r['bytes'] / 1e6:.1f} MB), {r['bound_share']:.1%} of the "
          f"bound {stamp}")


def kernel_split(fn, reps: int) -> dict:
    """Device ms per call of the scan kernel and of tiletop_kernel in one
    ADC wrapper call (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"scan_ms": 0.0, "tiletop_ms": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        key = "tiletop_ms" if "tiletop_kernel" in e.key else (
            "scan_ms" if "adc_segmin" in e.key else None)
        if key:
            out[key] += e.self_device_time_total / 1e3 / reps
    if not out["scan_ms"]:
        raise RuntimeError("the profiler recorded no ADC scan kernel")
    return out


def kernel_name(mangled: str) -> str | None:
    """'adc_segmin_kernel<128>' from a mangled kernel name, else None."""
    m = re.search(r"\d+([a-z_]+_kernel)(?:ILi(\d+)E)?", mangled)
    if m is None:
        return None
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def ptxas_report(log: str) -> dict:
    """{kernel: 'N registers, spill stores/loads'} from the build log,
    with any ptxas performance warning about the kernel appended."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        regs = re.search(r"Used (\d+) registers", line)
        if m:
            name = kernel_name(m.group(1))
        elif "Performance Loss" in line:
            fn = re.search(r"function '(\S+)'", line)
            key = kernel_name(fn.group(1)) if fn else name
            out[key] = f"{out.get(key, '')}; {line.strip()}"
        elif name and "spill" in line:
            out[name] = line.strip()
        elif name and regs:
            out[name] = f"{regs.group(1)} registers, {out.get(name, '')}"
    return out


def sass_classes(lib: str) -> dict:
    """{kernel: {class: count}} of the scoring instruction classes in the
    library's SASS, or {} where the toolkit has no cuobjdump."""
    from cvt_tpu_torch.ops.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if tool is None:
        return {}
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            if name:
                out[name] = dict.fromkeys(SASS_CLASSES, 0)
            continue
        op = re.search(r"\b(IMMA|IGMMA|IDP\.?4A)\b", line)
        if name and op:                     # dp4a is IDP.4A in SASS
            out[name][op.group(1).replace(".", "")] += 1
    return out


def random_kernel_args(npad: int, b: int, n_valid: int):
    """Seeded random arguments for both kernels, plus the norm column
    (D = 128, M = 8, K = 256)."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    g = torch.Generator().manual_seed(SEED)
    cb = torch.randn((M, KSUB, D // M), generator=g) * 20
    cb_q, srow = T._quantize_codebooks(cb)
    codes = torch.randint(0, KSUB, (npad, M), generator=g,
                          dtype=torch.uint8).to(DEV)
    q = (torch.randn((b, D), generator=g) * 50).to(DEV)
    cb_q, srow = cb_q.to(DEV), srow.to(DEV)
    s2 = srow * srow
    q2s, qs = T._fold_for(q, srow, D)
    dec = T.decode_int8(codes, cb_q)
    norm_col = T._row_norms(dec, s2)[:, None].contiguous()
    dec_args = (q2s, qs, codes, cb_q, s2, n_valid, T.fast_tile_n(npad))
    cached_args = (q2s, qs, dec.T.contiguous(), norm_col, n_valid,
                   T.cached_tile_n(npad))
    return dec_args, cached_args, norm_col[:, 0]


def main_path_kernel_args(idx, q_dev):
    """The arguments the index's search gives each kernel: the decode
    scan's (fast and exact lanes) and the decoded-cache scan's, each with
    its own query fold and tile."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    n = idx.ntotal
    codes, _, cb_q, srow = idx._kernel_arrays()
    qr = idx._rotate(q_dev)
    q2s, qs = T._fold_for(qr, srow, D)
    dec_args = (q2s, qs, codes, cb_q, srow * srow, n,
                T.fast_tile_n(codes.shape[0]))
    vcap, _ = T._pack_caps(T.SEG, D)
    q2s_c, qs_c = T._fold_queries(qr, idx._srow_cache,
                                  torch.amax(idx._norm_col), vcap)
    cached_args = (q2s_c, qs_c, idx._dec8_t, idx._norm_col, n,
                   T.cached_tile_n(idx._dec8_t.shape[1]))
    return dec_args, cached_args


def compare_kernel_to_twin(kernel, twin, args, norm, qs, tile_n,
                           seg: int = 128) -> dict:
    """Run a kernel and its twin on the same arguments. Differences are
    allowed only in segments (and tiles) holding a row whose norm/qs lies
    within 1e-4 of a half-integer, and a segment minimum may move by at
    most seg; anything else raises."""
    r = norm.double() / float(qs)
    near_half = torch.nonzero((r - torch.floor(r) - 0.5).abs() < 1e-4)[:, 0]
    got = kernel(*args)
    want = twin(*args)
    max_err, n_diff = 0, 0
    for a, b, rows in zip(got, want, (seg, tile_n)):
        allowed = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
        allowed[near_half // rows] = True
        diff = (a.long() - b.long()).abs()
        bad = diff.flatten(1).amax(1) > 0
        n_diff += int(bad.sum())
        if bool((bad & ~allowed).any()):
            raise AssertionError(f"{kernel.__name__}: kernel differs from "
                                 f"its twin outside near-half rows")
        max_err = max(max_err, int(diff.max()))
    if int((got[0].long() - want[0].long()).abs().max()) > seg:
        raise AssertionError(f"{kernel.__name__}: segpack off by > seg")
    return {"near_half_rows": int(near_half.numel()), "max_abs_err": max_err,
            "rows_differ": n_diff}


def compare_both(dec_args, cached_args, dec_norm) -> dict:
    """Both kernels against their twins; the decode kernel's in-kernel
    norm is `dec_norm`, the cached kernel reads its norm column."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    return {
        "adc_segmin": compare_kernel_to_twin(
            T.adc_segmin, T.adc_segmin_plain, dec_args, dec_norm,
            dec_args[1], dec_args[-1]),
        "adc_segmin_cached": compare_kernel_to_twin(
            T.adc_segmin_cached, T.adc_segmin_cached_plain, cached_args,
            cached_args[3][:, 0], cached_args[1], cached_args[-1])}


def compare_seg_variants(dec_args, dec_norm) -> dict:
    """The decode kernel against its twin at each segment size below 128
    (the sharded searcher and the server halve it on small shards), at
    tiles 1,024 and 256, on random arguments whose last tile is partly
    valid. Per seg, the worst of the two tiles."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    out = {}
    for seg in SEG_VARIANTS:
        cmps = [compare_kernel_to_twin(
            T.adc_segmin, T.adc_segmin_plain, dec_args[:6] + (tile_n, seg),
            dec_norm, dec_args[1], tile_n, seg) for tile_n in (1024, 256)]
        out[seg] = {key: max(c[key] for c in cmps) for key in cmps[0]}
    return out


def phase_main_path() -> dict:
    """Steps 3-4: the port's main path through its public entry points."""
    from cvt_tpu_torch.index import FlatADCIndex, FlatIndex
    from cvt_tpu_torch.index.flat_adc import _adc_scan
    from cvt_tpu_torch.io import synthetic_sift
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    from cvt_tpu_torch.quant import OPQ
    from cvt_tpu_torch.utils import recall_at_k

    T.adc_segmin.launches = 0
    T.adc_segmin_cached.launches = 0
    res = {}
    t0 = time.perf_counter()
    base, queries = synthetic_sift(N_DB, D, n_queries=N_QUERIES, seed=SEED,
                                   query_mode="fresh")
    res["data_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    opq = OPQ.train(torch.Generator().manual_seed(SEED), base[:N_TRAIN],
                    m=M, k=KSUB, opq_iters=4, kmeans_iters=6,
                    final_kmeans_iters=12, device=DEV)
    torch.cuda.synchronize()
    res["opq_train_s"] = time.perf_counter() - t0

    base_dev = torch.from_numpy(base).to(DEV)
    q_dev = torch.from_numpy(queries).to(DEV)
    warm = FlatADCIndex(opq, device=DEV)
    warm.add(base_dev[:FlatADCIndex.ENC_CHUNK])
    warm._materialize()
    torch.cuda.synchronize()
    del warm

    idx = FlatADCIndex(opq, device=DEV)
    t0 = time.perf_counter()
    idx.add(base_dev)
    idx._materialize()
    torch.cuda.synchronize()
    res["encode_codes_per_s"] = N_DB / (time.perf_counter() - t0)
    assert idx._resolve_impl() == "kernel"

    exact_index = FlatIndex(D, "l2", chunk=131_072, device=DEV)
    exact_index.add(base_dev)
    gt = torch.cat([exact_index.search(q_dev[s:min(s + 512, N_REC)], 1)[1]
                    for s in range(0, N_REC, 512)])[:, 0].cpu()
    del exact_index

    d_fast, i_fast = idx.search(q_dev, K)
    d_exact, i_exact = idx.search(q_dev, K, exact=True)
    # the reference engine over the same codes, as bench.py scores parity
    n = idx.ntotal
    npad_ref = -(-n // 16384) * 16384
    codes_ref, dsq_ref = idx._padded(npad_ref)
    ids_ref = []
    for s in range(0, N_REC, 1024):
        qr = idx._rotate(q_dev[s:min(s + 1024, N_REC)])
        ids_ref.append(_adc_scan(qr, torch.sum(qr * qr, -1), codes_ref,
                                 dsq_ref, opq.pq.codebooks, K, 16384,
                                 n)[1])
    ids_ref = torch.cat(ids_ref)
    idx.build_decoded_cache()
    d_cached, i_cached = idx.search(q_dev, K)
    torch.cuda.synchronize()
    res["launches"] = {"adc_segmin": T.adc_segmin.launches,
                       "adc_segmin_cached": T.adc_segmin_cached.launches}

    for name, ids in (("fast", i_fast), ("exact", i_exact),
                      ("reference", ids_ref)):
        res[f"recall_at_1_{name}"] = recall_at_k(ids[:N_REC], gt, k=1)
        res[f"recall_at_10_{name}"] = recall_at_k(ids[:N_REC], gt, k=10)
    res["parity_pt"] = 100 * (res["recall_at_1_reference"]
                              - res["recall_at_1_fast"])
    for name, (d, i) in (("fast", (d_fast, i_fast)),
                         ("exact", (d_exact, i_exact)),
                         ("cached", (d_cached, i_cached))):
        assert i.shape == (N_QUERIES, K), name
        assert int(i.max()) < n and int(i.min()) >= 0, name
        assert bool(torch.isfinite(d).all()), name
    # top-1 is exact in both by the segment lemma; the cached scan takes a
    # larger tile (4096) at 1M, so for k > 1 the best-two-per-tile cap can
    # differ: compare all k ids at the fast path's tile as well
    res["cached_top1_equal"] = bool(torch.equal(i_cached[:, 0],
                                                i_fast[:, 0]))
    res["cached_all_ids_equal_frac"] = float(
        (i_cached == i_fast).float().mean())
    qr = idx._rotate(q_dev)
    _, i_same_tile = T.adc_search_cached(
        qr, idx._dec8_t, idx._norm_col, idx._srow_cache, K, n,
        tile_n=T.fast_tile_n(idx._dec8_t.shape[1]))
    res["cached_same_tile_ids_equal"] = bool(torch.equal(i_same_tile,
                                                         i_fast))
    assert res["launches"]["adc_segmin"] > 0
    assert res["launches"]["adc_segmin_cached"] > 0
    assert res["cached_top1_equal"], "decoded-cache top-1 != fast top-1"
    assert res["cached_same_tile_ids_equal"], "decoded-cache ids != fast"
    assert abs(res["parity_pt"]) <= 1.0, res["parity_pt"]
    res["_index"], res["_q"], res["_base"], res["_gt"] = (idx, q_dev,
                                                          base_dev, gt)
    res["_ids_ref"] = ids_ref
    return res


def phase_timing(idx, q_dev, dec_args, cached_args, reps: int) -> dict:
    """Step 6: CUDA-event times at the main path's shapes."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    out = {}
    # the index scans its decoded cache while _dec8_n matches its size:
    # hide the cache to time the decode kernel's fast and exact paths
    dec8 = idx._dec8_n
    idx._dec8_n = None
    out["fast_ms"] = cuda_ms(lambda: idx.search(q_dev, K), reps)
    out["exact_ms"] = cuda_ms(lambda: idx.search(q_dev, K, exact=True),
                              reps)
    idx._dec8_n = dec8
    out["cached_ms"] = cuda_ms(lambda: idx.search(q_dev, K), reps)
    out["adc_segmin_ms"] = cuda_ms(lambda: T.adc_segmin(*dec_args),
                                   2 * reps)
    out["adc_segmin_plain_ms"] = cuda_ms(
        lambda: T.adc_segmin_plain(*dec_args), 1)
    out["adc_segmin_cached_ms"] = cuda_ms(
        lambda: T.adc_segmin_cached(*cached_args), 2 * reps)
    out["adc_segmin_cached_plain_ms"] = cuda_ms(
        lambda: T.adc_segmin_cached_plain(*cached_args), 1)
    return out


def random_ivf_args(d: int, b: int, seed: int = SEED):
    """Seeded ivf_page arguments over 64 pages of 512 rows (seg 32) for a
    batch of b queries: BIG pad rows and a whole page of them, BIG-masked
    cip entries and padded query columns, a repeated fill page in sel."""
    from cvt_tpu_torch.ops.kernels import ivf_scan as V
    g = torch.Generator().manual_seed(seed)
    nvcap, _ = V._ivf_pack_caps(32, d)
    lp, spt, n_pages, s = 512, 16, 64, 48
    bpad = -(-b // 128) * 128
    qs = torch.rand((1,), generator=g) + 0.5
    dec8_t = torch.randint(-127, 128, (d, n_pages * lp), generator=g,
                           dtype=torch.int8)
    nrm = torch.rand((n_pages * lp, 1), generator=g) * 0.9 * nvcap * qs
    nrm[torch.rand(nrm.shape, generator=g) < 0.1] = V.BIG
    nrm[5 * lp:6 * lp] = V.BIG
    sel = torch.randperm(n_pages, generator=g)[:s].to(torch.int32)
    sel[-4:] = 0
    cip = torch.rand((s * spt, bpad), generator=g) * 0.9 * 127 ** 2 * d * qs
    cip[torch.rand(cip.shape, generator=g) < 0.3] = V.BIG
    cip[-4 * spt:] = V.BIG
    cip[:, b:] = V.BIG
    q2s = torch.randint(-127, 128, (bpad, d), generator=g, dtype=torch.int8)
    q2s[b:] = 0
    return [x.to(DEV) for x in (q2s, qs, dec8_t, nrm, cip, sel)] + [lp, 32]


def compare_ivf_kernel(args) -> dict:
    """The ivf_page kernel against its twin on the same arguments:
    bitwise, or raise."""
    from cvt_tpu_torch.ops.kernels import ivf_scan as V
    got = V.ivf_pages_segmin(*args)
    want = V.ivf_pages_segmin_plain(*args)
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError(f"ivf_page kernel differs from its twin by "
                             f"{err}")
    return {"max_abs_err": err, "shape": list(got.shape)}


def ivf_batches(idx, q_dev, fn):
    """fn(idx, batch) over the first N_REC queries in batches of IVF_B;
    the results concatenated."""
    outs = [fn(idx, q_dev[s:s + IVF_B]) for s in range(0, N_REC, IVF_B)]
    return [torch.cat([o[j] for o in outs]) for j in range(len(outs[0]))]


def fast_batch(idx, q, nprobe: int):
    """search_fast on one batch -> (dists, ids, n_dropped as [1])."""
    d, i, dropped = idx.search_fast(q, K, nprobe=nprobe)
    return d, i, dropped.reshape(1)


def check_ids(d, i, n: int, name: str) -> None:
    """ids in [0, n) or -1, no duplicate id in a row, finite distances
    wherever an id is given."""
    ic = i.cpu().numpy()
    assert ((ic >= 0) & (ic < n) | (ic == -1)).all(), name
    for row in ic:
        v = row[row >= 0]
        assert len(set(v.tolist())) == len(v), name
    assert bool(torch.isfinite(d[i >= 0]).all()), name


def phase_ivf(base_dev, q_dev, gt) -> dict:
    """Step 7's main path: train, build, search_fast, search."""
    from cvt_tpu_torch.index import IVFADCIndex
    from cvt_tpu_torch.ops.kernels import ivf_scan as V
    from cvt_tpu_torch.utils import recall_at_k
    res = {}
    idx = IVFADCIndex(coarse_k=IVF_KC, m=IVF_M, k=KSUB, device=DEV)
    t0 = time.perf_counter()
    idx.train(torch.Generator().manual_seed(SEED), base_dev,
              coarse_iters=IVF_ITERS, pq_iters=IVF_ITERS, sample=IVF_SAMPLE)
    torch.cuda.synchronize()
    res["train_s"] = time.perf_counter() - t0
    idx.encode_chunk(base_dev[:IVFADCIndex.ENC_CHUNK])      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx.build(base_dev)
    torch.cuda.synchronize()
    res["build_codes_per_s"] = N_DB / (time.perf_counter() - t0)
    res["pages"] = idx._pg_dec8_t.shape[1] // idx._pg_lp
    res["rows_padded"] = idx._pg_dec8_t.shape[1]
    res["tail_len"] = idx.tail_len
    res["bucket_cap"] = idx._buckets.shape[1]

    n = idx.ntotal
    V.ivf_pages_segmin.launches = 0
    for nprobe in IVF_NPROBES:
        d, i, dropped = ivf_batches(
            idx, q_dev, lambda x, q: fast_batch(x, q, nprobe))
        check_ids(d, i, n, f"search_fast nprobe {nprobe}")
        res[f"recall_at_10_fast_{nprobe}"] = recall_at_k(i, gt, k=10)
        res[f"recall_at_1_fast_{nprobe}"] = recall_at_k(i, gt, k=1)
        res[f"n_dropped_{nprobe}"] = int(dropped.sum())
    d, i = ivf_batches(idx, q_dev, lambda x, q: x.search(
        q, K, nprobe=IVF_REF_NPROBE))
    torch.cuda.synchronize()
    res["launches"] = V.ivf_pages_segmin.launches
    check_ids(d, i, n, "search")
    res["recall_at_10_ref"] = recall_at_k(i, gt, k=10)
    res["recall_at_1_ref"] = recall_at_k(i, gt, k=1)
    res["parity_pt"] = 100 * (res["recall_at_10_ref"]
                              - res[f"recall_at_10_fast_{IVF_REF_NPROBE}"])
    assert res["launches"] > 0, "the ivf_page kernel never launched"
    for nprobe in IVF_NPROBES:
        assert res[f"n_dropped_{nprobe}"] == 0, nprobe
    assert abs(res["parity_pt"]) <= 1.0, res["parity_pt"]
    res["_index"] = idx
    return res


def main_path_ivf_args(idx, q_dev, nprobe: int = IVF_REF_NPROBE):
    """The ivf_page kernel's arguments (n_live included) in one search_fast
    batch at nprobe, recorded where the wrapper validates them before its
    launch."""
    from cvt_tpu_torch.ops.kernels import ivf_scan as V
    seen = []
    check = V._check_launch

    def record(*args):
        seen.append(args)
        check(*args)
    V._check_launch = record
    try:
        idx.search_fast(q_dev[:IVF_B], K, nprobe=nprobe)
    finally:
        V._check_launch = check
    return list(seen[0])


def phase_ivf_timing(idx, q_dev, args_by_nprobe, reps: int) -> dict:
    """Step 7's CUDA-event times at the IVF path's shapes: search_fast and
    the kernel at each nprobe, search() and the twin at nprobe 16."""
    from cvt_tpu_torch.ops.kernels import ivf_scan as V
    q = q_dev[:IVF_B]
    out = {f"fast_{p}_ms": cuda_ms(lambda: idx.search_fast(q, K, nprobe=p),
                                   reps) for p in IVF_NPROBES}
    out["ref_ms"] = cuda_ms(lambda: idx.search(q, K, nprobe=IVF_REF_NPROBE),
                            reps)
    for p, args in args_by_nprobe.items():
        out[f"ivf_page_{p}_ms"] = cuda_ms(
            lambda: V.ivf_pages_segmin(*args), reps)
    out["ivf_page_ms"] = out[f"ivf_page_{IVF_REF_NPROBE}_ms"]
    out["ivf_page_plain_ms"] = cuda_ms(lambda: V.ivf_pages_segmin_plain(
        *args_by_nprobe[IVF_REF_NPROBE]), 2)
    return out


def phase_sq(base_dev, q_dev) -> dict:
    """Step 8's main path (BASELINE config 1): the L2-normalised base and
    queries, exact ground truth, ScalarQuantizer train / encode on the
    card, FlatSQIndex search in bf16 and int8 modes and search_fast (the
    decoded-cache kernel), all at B = 8,192, k = 10."""
    from cvt_tpu_torch.index import FlatIndex, FlatSQIndex
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    from cvt_tpu_torch.ops.linalg import l2_normalize
    from cvt_tpu_torch.quant import ScalarQuantizer
    from cvt_tpu_torch.utils import recall_at_k
    res = {}
    xb, xq = l2_normalize(base_dev), l2_normalize(q_dev)
    exact_index = FlatIndex(D, "l2", chunk=131_072, device=DEV)
    exact_index.add(xb)
    gt = torch.cat([exact_index.search(xq[s:min(s + 512, N_REC)], 1)[1]
                    for s in range(0, N_REC, 512)])[:, 0].cpu()
    del exact_index

    T.adc_segmin_cached.launches = 0
    t0 = time.perf_counter()
    sq = ScalarQuantizer.train(xb)
    torch.cuda.synchronize()
    res["train_s"] = time.perf_counter() - t0
    sq.encode(xb[:65_536])                                    # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes = sq.encode(xb)
    torch.cuda.synchronize()
    res["encode_codes_per_s"] = N_DB / (time.perf_counter() - t0)
    idx = {}
    for mode in ("bf16", "int8"):
        idx[mode] = FlatSQIndex(sq, mode=mode)
        idx[mode].add(codes=codes)
    out = {mode: idx[mode].search(xq, K) for mode in idx}
    out["fast"] = idx["bf16"].search_fast(xq, K)
    torch.cuda.synchronize()
    res["launches"] = T.adc_segmin_cached.launches

    n = idx["bf16"].ntotal
    for name, (d, i) in out.items():
        assert i.shape == (N_QUERIES, K), name
        assert int(i.min()) >= 0 and int(i.max()) < n, name
        assert bool(torch.isfinite(d).all()), name
        res[f"recall_at_1_{name}"] = recall_at_k(i[:N_REC], gt, k=1)
        res[f"recall_at_10_{name}"] = recall_at_k(i[:N_REC], gt, k=10)
    res["parity_pt"] = 100 * (res["recall_at_10_bf16"]
                              - res["recall_at_10_fast"])
    assert res["launches"] > 0, "the cached kernel never launched"
    assert abs(res["parity_pt"]) <= 1.0, res["parity_pt"]
    res["_index"], res["_xq"] = idx, xq
    return res


def sq_kernel_args(idx, xq):
    """The cached kernel's arguments in FlatSQIndex.search_fast: the
    bias-folded queries, the index's cache and norm column, its tile and
    the segment of its width."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    sq = idx.sq
    q = xq - (sq.bias + 128.0 * sq.scale)[None, :]
    seg = T.cached_seg(xq.shape[1])
    vcap, _ = T._pack_caps(seg, xq.shape[1])
    q2s, qs = T._fold_queries(q, sq.scale, torch.amax(idx._norm_col), vcap)
    return (q2s, qs, idx._dec8_t, idx._norm_col, idx.ntotal,
            T.cached_tile_n(idx._dec8_t.shape[1]), seg)


def phase_sq_timing(idx, xq, args, reps: int) -> dict:
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    out = {f"{mode}_ms": cuda_ms(lambda: idx[mode].search(xq, K), 2)
           for mode in ("bf16", "int8")}
    out["fast_ms"] = cuda_ms(lambda: idx["bf16"].search_fast(xq, K), reps)
    out["kernel_ms"] = cuda_ms(lambda: T.adc_segmin_cached(*args),
                               2 * reps)
    out["plain_ms"] = cuda_ms(lambda: T.adc_segmin_cached_plain(*args), 1)
    return out


def batched(fn, q, b: int):
    """fn(batch, K) over q in batches of b -> (dists, ids) concatenated."""
    outs = [fn(q[s:s + b], K) for s in range(0, q.shape[0], b)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def run_batcher(srv, q_host) -> dict:
    """QueryBatcher over srv.serve: 8 threads submit blocks of 1, 37, 256
    and 500 rows at once; every future must resolve to [rows, k] results
    with ids in [0, n)."""
    import threading
    from cvt_tpu_torch.parallel import QueryBatcher
    batcher = QueryBatcher(srv.serve, batch_size=SERVE_B, k=K,
                           max_wait_ms=5.0)
    futs, lock = [], threading.Lock()

    def submit(t: int):
        rows = BATCHER_BLOCKS[t % len(BATCHER_BLOCKS)]
        f = batcher.submit(q_host[t * 200:t * 200 + rows])
        with lock:
            futs.append((rows, f))
    threads = [threading.Thread(target=submit, args=(t,)) for t in range(8)]
    t0 = time.perf_counter()
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        done = [(rows, f.result(timeout=120)) for rows, f in futs]
    finally:
        batcher.close()
    wall = time.perf_counter() - t0
    for rows, (d, i) in done:
        assert d.shape == (rows, K) and i.shape == (rows, K), rows
        assert (i >= 0).all() and (i < srv._n).all(), rows
        assert np.isfinite(d).all(), rows
    return {"futures": len(done), "rows": sum(r for r, _ in done),
            "wall_s": wall}


def run_cli(idx, q_host, tmp: str) -> dict:
    """`python -m cvt_tpu_torch.cli serve` as a subprocess on a saved pack:
    batch mode over the first N_REC queries (fvecs) and --stdin mode over
    CLI_STDIN_ROWS JSON lines. Returns each mode's ids and wall time."""
    from cvt_tpu_torch.io.vecs import write_fvecs
    pack, qf = os.path.join(tmp, "pack.npz"), os.path.join(tmp, "q.fvecs")
    idx.save(pack)
    write_fvecs(qf, q_host[:N_REC])
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "cvt_tpu_torch.cli", "serve", "--index",
           pack, "--k", str(K), "--batch", str(SERVE_B)]
    stdin = "".join(json.dumps(row.tolist()) + "\n"
                    for row in q_host[:CLI_STDIN_ROWS])
    out = {}
    for mode, extra, text in (("batch", ["--queries", qf], None),
                              ("stdin", ["--stdin"], stdin)):
        t0 = time.perf_counter()
        run = subprocess.run(cmd + extra, input=text, capture_output=True,
                             text=True, cwd=root, timeout=300)
        if run.returncode:
            raise RuntimeError(f"cli serve ({mode}) exited "
                               f"{run.returncode}: {run.stderr[-2000:]}")
        out[f"{mode}_s"] = time.perf_counter() - t0
        out[mode] = np.array([json.loads(line)["ids"]
                              for line in run.stdout.splitlines()
                              if line.startswith("{")])
    return out


def phase_serve(flat_idx, q_dev, gt, ids_ref) -> dict:
    """Step 9's main path (BASELINE config 5's front end on one card): a
    1-rank NCCL group and a 'db' mesh of 1; MultiHostADCServer over the
    flat phase's OPQ and 1M codes with both merges, serve_pipelined,
    ShardedADCSearcher(impl='kernel') and QueryBatcher, all through the
    `adc_segmin` kernel."""
    import torch.distributed as dist
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    from cvt_tpu_torch.parallel import (MultiHostADCServer,
                                        ShardedADCSearcher, init_distributed,
                                        serving_mesh)
    from cvt_tpu_torch.quant import OPQ
    from cvt_tpu_torch.utils import recall_at_k
    res = {}
    t0 = time.perf_counter()
    assert init_distributed() == 0
    res["init_s"] = time.perf_counter() - t0
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    mesh = serving_mesh()
    assert mesh.device_type == "cuda"
    opq = OPQ(flat_idx.rotation, flat_idx.pq)
    codes = flat_idx._codes
    q = q_dev[:N_REC]

    T.adc_segmin.launches = 0
    srv, got = {}, {}
    for merge in ("allgather", "ring"):
        srv[merge] = MultiHostADCServer(opq, mesh, merge=merge)
        srv[merge].load(codes=codes)
        got[merge] = batched(srv[merge].serve, q, SERVE_B)
    pipe = srv["ring"].serve_pipelined(q.reshape(-1, SERVE_B, D), K)
    searcher = ShardedADCSearcher(opq, mesh, impl="kernel")
    searcher.load(codes=codes)
    got["searcher"] = batched(searcher.search, q, SERVE_B)
    res["batcher"] = run_batcher(srv["allgather"], q.cpu().numpy())
    torch.cuda.synchronize()
    res["launches"] = T.adc_segmin.launches

    ids = got["allgather"][1]
    n = srv["allgather"]._n
    assert ids.shape == (N_REC, K)
    assert int(ids.min()) >= 0 and int(ids.max()) < n
    assert bool(torch.isfinite(got["allgather"][0]).all())
    for name in ("ring", "searcher"):
        res[f"{name}_ids_equal"] = bool(torch.equal(got[name][1], ids))
    res["pipelined_ids_equal"] = bool(torch.equal(pipe[1], got["ring"][1]))
    res["pipelined_dists_equal"] = bool(torch.equal(pipe[0],
                                                    got["ring"][0]))
    res["recall_at_1_serve"] = recall_at_k(ids, gt, k=1)
    res["recall_at_10_serve"] = recall_at_k(ids, gt, k=10)
    res["recall_at_1_ref"] = recall_at_k(ids_ref, gt, k=1)
    res["parity_pt"] = 100 * (res["recall_at_1_ref"]
                              - res["recall_at_1_serve"])
    assert res["launches"] > 0, "the adc_segmin kernel never launched"
    for key in ("ring_ids_equal", "searcher_ids_equal",
                "pipelined_ids_equal", "pipelined_dists_equal"):
        assert res[key], key
    assert abs(res["parity_pt"]) <= 1.0, res["parity_pt"]
    res["_servers"], res["_ids"] = srv, ids.cpu().numpy()
    return res


def serve_kernel_args(srv, q):
    """The `adc_segmin` arguments of srv.serve on one batch q (1 shard):
    its rotated and folded queries, its shard, tile and segment."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    from cvt_tpu_torch.parallel.sharded_search import _segment_plan
    tile_n, seg = _segment_plan(srv._per, srv.tile_n, srv.seg, K)
    q2s, qs = T._fold_queries(srv._rotate(q), srv._srow)
    s2 = srv._srow * srv._srow
    args = (q2s, qs, srv._codes_l, srv._cb_q, s2, min(srv._n, srv._per),
            tile_n, seg)
    norm = T._row_norms(T.decode_int8(srv._codes_l, srv._cb_q), s2)
    return args, norm


def phase_kmeans(base_dev) -> dict:
    """sharded_kmeans_step over a 'dp' mesh of 1 (NCCL all_reduce) against
    one step of the port's _lloyd on the same points and centroids; numpy
    input lands on the mesh's card."""
    from cvt_tpu_torch.ops.kmeans import _lloyd, kmeans_assign
    from cvt_tpu_torch.parallel import make_mesh, sharded_kmeans_step
    x = base_dev[:KM_N]
    c0 = x[:KM_K].clone()
    mesh = make_mesh({"dp": 1})
    c, obj = sharded_kmeans_step(mesh, x, c0)
    cn, _ = sharded_kmeans_step(mesh, x.cpu().numpy(), c0.cpu().numpy())
    assert cn.device == x.device, cn.device
    assert torch.allclose(cn, c, rtol=1e-5, atol=1e-4)
    want, _, _ = _lloyd(x, c0, KM_K, 1, None)
    _, d0 = kmeans_assign(x, c0)
    err = float((c - want).abs().max())
    obj_rel = abs(float(obj) - float(d0.mean())) / float(d0.mean())
    assert torch.allclose(c, want, rtol=1e-5, atol=1e-4), err
    assert obj_rel <= 1e-5, obj_rel
    return {"max_abs_err": err, "objective_rel_err": obj_rel}


def topk_cases():
    """Seeded tie-heavy inputs at the top-k repair's shapes, on the card:
    (name, x, largest, ks)."""
    g = torch.Generator(device=DEV).manual_seed(SEED)
    sq = torch.randint(0, 64, TOPK_SQ, generator=g, device=DEV).float()
    padded = sq.clone()
    padded[:, -TOPK_SQ[1] // 4:] = float("inf")   # a ragged chunk's tail
    padded[torch.rand(TOPK_SQ, generator=g, device=DEV) < 0.1] = \
        float("inf")
    keys = ((torch.randint(0, 8, TOPK_SEG, generator=g, device=DEV) << 7)
            | torch.randint(0, 4, TOPK_SEG, generator=g, device=DEV))
    keys = keys.to(torch.int32)
    keys[torch.rand(TOPK_SEG, generator=g, device=DEV) < 0.05] = 2 ** 31 - 1
    bins = torch.full(TOPK_BINS, -1.0, device=DEV)
    occupied = torch.rand(TOPK_BINS, generator=g, device=DEV) < 0.003
    bins[occupied] = torch.randint(1, 4, TOPK_BINS, generator=g,
                                   device=DEV).float()[occupied]
    return [("SQ chunk f32", sq, False, (1, 10, TOPK_SQ[1])),
            ("SQ chunk f32 +inf padded", padded, False,
             (1, 10, TOPK_SQ[1])),
            ("segment keys int32", keys, False, (1, 10, TOPK_SEG[1])),
            ("segment keys f32 cast", keys.float(), False,
             (1, 10, TOPK_SEG[1])),
            ("vote bins f32, largest", bins, True, (TOPK_SEEDS,))]


def phase_topk(stamp: str) -> dict:
    """Step 11: the selection against the stable sort, bitwise, and the
    two timed at each shape."""
    from cvt_tpu_torch.ops import topk
    out = {}
    for name, x, largest, ks in topk_cases():
        for k in ks:
            def sort():
                v, i = torch.sort(x, dim=-1, descending=largest, stable=True)
                return v[..., :k], i[..., :k]

            def select():
                return (topk.top_k_largest if largest
                        else topk.top_k_smallest)(x, k)
            (v, i), (sv, si) = select(), sort()
            if not (torch.equal(v, sv) and torch.equal(i, si)):
                raise AssertionError(f"top-k differs from the stable sort: "
                                     f"{name}, k {k}")
            key = f"{name}, k {k}"
            out[key] = {"sort_ms": cuda_ms(sort, 3),
                        "select_ms": cuda_ms(select, 3)}
            print(f"top-k {list(x.shape)} {key}: equal to the stable sort "
                  f"(values and ids); sort {out[key]['sort_ms']:.3f} ms, "
                  f"selection {out[key]['select_ms']:.3f} ms{' (k = N: the '
                  'sort itself)' if k == x.shape[-1] else ''} {stamp}")
        del x
    torch.cuda.empty_cache()
    return out


def vocab_data():
    """The vocabulary phase's seeded data: corpus descriptors [I, P, D]
    and frames [I, P, 4], the 128 queries' descriptors and frames
    [Q, KQ, D / 4], their source images, and the training sample."""
    from cvt_tpu_torch.io import synthetic_sift
    rng = np.random.default_rng(SEED)
    n_img, per = VOCAB_IMAGES, VOCAB_PER_IMAGE
    desc = synthetic_sift(n_img * per, D, seed=SEED).reshape(n_img, per, D)
    frames = np.stack([rng.uniform(0, 1024, (n_img, per)),
                       rng.uniform(0, 1024, (n_img, per)),
                       rng.uniform(1.5, 8.0, (n_img, per)),
                       rng.uniform(-np.pi, np.pi, (n_img, per))],
                      -1).astype(np.float32)
    src = np.arange(0, n_img, VOCAB_EVERY)
    pick = np.stack([rng.choice(per, VOCAB_KQ, replace=False) for _ in src])
    q = desc[src[:, None], pick] + rng.normal(0, 6.0, (len(src), VOCAB_KQ,
                                                       D))
    q = np.clip(q, 0, 255).astype(np.float32)
    qf = frames[src[:, None], pick].copy()
    for j in range(len(src)):                # one similarity per query
        th = rng.uniform(-np.pi / 12, np.pi / 12)
        s = rng.uniform(0.85, 1.15)
        rot = s * np.array([[np.cos(th), -np.sin(th)],
                            [np.sin(th), np.cos(th)]])
        qf[j, :, :2] = (qf[j, :, :2] @ rot.T + rng.uniform(-50, 50, 2)
                        + rng.normal(0, 0.5, (VOCAB_KQ, 2)))
        qf[j, :, 2] *= s
        qf[j, :, 3] = np.angle(np.exp(1j * (qf[j, :, 3] + th)))
    train = rng.choice(n_img * per, VOCAB_TRAIN, replace=False)
    return desc, frames, q, qf.astype(np.float32), src, train


def rankings_agree(ids_a, sc_a, ids_b, sc_b, k: int,
                   atol: float = 1e-7) -> int:
    """The first k ranks of two [Q, >k] rankings agree: scores within
    VOCAB_RTOL (plus atol), ids equal except where a score lies within
    that of a neighbour's (float32 sums in another order may swap such a
    pair). Raises on a disagreement; returns the count of excused ranks."""
    sa, sb = np.asarray(sc_a), np.asarray(sc_b)
    np.testing.assert_allclose(sb[:, :k], sa[:, :k], rtol=VOCAB_RTOL,
                               atol=atol)
    tol = VOCAB_RTOL * np.abs(sa) + atol
    gap = np.abs(np.diff(sa, axis=1)) <= tol[:, 1:]
    near = np.zeros(sa.shape, bool)
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    differ = np.asarray(ids_a)[:, :k] != np.asarray(ids_b)[:, :k]
    if (differ & ~near[:, :k]).any():
        raise AssertionError(f"rankings differ beyond near-ties: "
                             f"{np.argwhere(differ & ~near[:, :k])}")
    return int(differ.sum())


def phase_vocab(stamp: str) -> dict:
    """Step 12: the vocabulary-tree path through VocabHEIndex's public
    methods; returns the phase's results with the index, queries and the
    saved file's path for the CLI step."""
    import tempfile
    from cvt_tpu_torch.index import VocabHEIndex
    t_phase = time.perf_counter()
    desc, frames, q, qf, src, train = vocab_data()
    res = {"data_s": time.perf_counter() - t_phase}
    zero_launch_counts()
    idx = VocabHEIndex(n_words=VOCAB_W, probes=8, device=DEV)
    assert idx.hierarchical
    t0 = time.perf_counter()
    idx.train(torch.Generator().manual_seed(SEED),
              desc.reshape(-1, D)[train], iters=10)
    torch.cuda.synchronize()
    res["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(VOCAB_IMAGES):
        idx.add_image(desc[i], name=f"img_{i:04d}", geometries=frames[i])
    torch.cuda.synchronize()
    res["encode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.prepare()
    torch.cuda.synchronize()
    res["prepare_s"] = time.perf_counter() - t0
    res["bucket_cap"], res["n_overflow"] = (idx._b_img.shape[1],
                                            idx.n_overflow)

    def run(probes: int, verify: int = 0, rows=slice(None)):
        idx.probes = probes
        t0 = time.perf_counter()
        out = idx.query_batch(q[rows], topk=VOCAB_TOPK + 1, verify=verify,
                              geometries=qf[rows] if verify else None,
                              image_extent=1024.0)
        return out, time.perf_counter() - t0
    runs = {}
    for probes, verify in [(p, 0) for p in VOCAB_PROBES] + [(8, VOCAB_VERIFY)]:
        run(probes, verify)                                     # warm
        (ids, sc, _), dt = run(probes, verify)
        label = ("exact" if probes == 0 else f"probes {probes}") + (
            f" + verify {verify}" if verify else "")
        assert ids.shape == (len(src), VOCAB_TOPK + 1), label
        assert ids.min() >= 0 and ids.max() < VOCAB_IMAGES, label
        assert np.isfinite(sc).all(), label
        runs[label] = {"ids": ids, "scores": sc,
                       "recall_at_1": float(np.mean(ids[:, 0] == src)),
                       "recall_at_5": float(np.mean(
                           (ids[:, :VOCAB_TOPK] == src[:, None]).any(1))),
                       "ms_per_image": dt / len(src) * 1e3}
    torch.cuda.synchronize()
    res["launches"] = launch_counts()
    for label in ("probes 8", f"probes 8 + verify {VOCAB_VERIFY}"):
        assert runs[label]["recall_at_1"] >= 0.90, (label, runs[label])
    assert not any(res["launches"].values()), res["launches"]

    # single queries against the batch (probes 8, no verification)
    idx.probes = 8
    base = runs["probes 8"]
    single = [idx.query(q[j], topk=VOCAB_TOPK + 1) for j in range(4)]
    res["single_excused"] = rankings_agree(
        base["ids"][:4], base["scores"][:4],
        [[int(n[4:]) for n in names] for names, _ in single],
        [s for _, s in single], VOCAB_TOPK)

    # the same index saved and loaded on the CPU answers as the card
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "vocab.npz")
    idx.save(path)
    cpu = VocabHEIndex.load(path, device="cpu")
    rows = slice(0, VOCAB_CPU_Q)
    c_ids, c_sc, _ = cpu.query_batch(q[rows], topk=VOCAB_TOPK + 1)
    res["cpu_excused"] = rankings_agree(base["ids"][rows],
                                        base["scores"][rows], c_ids, c_sc,
                                        VOCAB_TOPK)
    ver = runs[f"probes 8 + verify {VOCAB_VERIFY}"]
    v_ids, v_sc, _ = cpu.query_batch(q[rows], topk=VOCAB_TOPK + 1,
                                     verify=VOCAB_VERIFY,
                                     geometries=qf[rows],
                                     image_extent=1024.0)
    res["cpu_verified_excused"] = rankings_agree(
        ver["ids"][rows, :1], ver["scores"][rows, :1], v_ids[:, :1],
        v_sc[:, :1], 1)
    res["cpu_verified_other_ranks_differ"] = int(
        (v_ids[:, 1:VOCAB_TOPK] != ver["ids"][rows, 1:VOCAB_TOPK]).sum()
        + (~np.isclose(v_sc[:, 1:VOCAB_TOPK], ver["scores"][rows,
                                                           1:VOCAB_TOPK],
                       rtol=VOCAB_RTOL, atol=1e-7)).sum())
    res["phase_s"] = time.perf_counter() - t_phase
    res["runs"] = runs
    res["_index"], res["_q"], res["_path"], res["_tmp"] = idx, q, path, tmp
    res["_desc"], res["_frames"], res["_src"] = desc, frames, src
    return res


def run_vocab_cli(idx, q, path: str, desc, frames, tmp: str) -> dict:
    """Step 13: `cli vocab_tree_retriever` on a FeatureDatabase with the
    first VOCAB_CLI_Q indexed images and the first VOCAB_CLI_Q queries
    (stored as images of their own), --vocab_index at the saved index.
    Returns its ranked ids and scores, and the process wall time."""
    from cvt_tpu_torch.io.database import FeatureDatabase
    db_path = os.path.join(tmp, "db.sqlite")
    with FeatureDatabase(db_path) as db:
        for i in range(VOCAB_CLI_Q):
            iid = db.add_image(f"img_{i:04d}")
            db.write_descriptors(iid, desc[i])
            db.write_keypoints(iid, frames[i])
        for j in range(VOCAB_CLI_Q):
            iid = db.add_image(f"query_{j:03d}")
            db.write_descriptors(iid, q[j])
        db.commit()
    lists = {}
    for kind, names in (("db", [f"img_{i:04d}" for i in range(VOCAB_CLI_Q)]),
                        ("q", [f"query_{j:03d}" for j in range(VOCAB_CLI_Q)])):
        lists[kind] = os.path.join(tmp, f"{kind}.txt")
        with open(lists[kind], "w") as f:
            f.write("\n".join(names) + "\n")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "cvt_tpu_torch.cli", "vocab_tree_retriever",
         "--database", db_path, "--vocab_index", path,
         "--database_image_list", lists["db"], "--query_image_list",
         lists["q"], "--topk", str(VOCAB_TOPK + 1)],
        capture_output=True, text=True, cwd=root, timeout=300)
    wall = time.perf_counter() - t0
    if run.returncode:
        raise RuntimeError(f"cli vocab_tree_retriever exited "
                           f"{run.returncode}: {run.stderr[-2000:]}")
    ids, scores = [], []
    for line in run.stdout.splitlines():
        if line.startswith("Querying for image"):
            ids.append([])
            scores.append([])
        elif line.startswith("  image_name="):
            name, score = line.strip()[len("image_name="):].split(
                ", score=")
            ids[-1].append(int(name[4:]))
            scores[-1].append(float(score))
    idx.probes = 8
    want_ids, want_sc, _ = idx.query_batch(q[:VOCAB_CLI_Q],
                                           topk=VOCAB_TOPK + 1)
    # the command prints scores to 6 decimals: atol one printed unit
    assert len(ids) == VOCAB_CLI_Q, run.stdout[-2000:]
    excused = rankings_agree(want_ids, want_sc, np.array(ids),
                             np.array(scores), VOCAB_TOPK, atol=1e-6)
    return {"wall_s": wall, "excused": excused}


def run_vocab(stamp: str) -> dict:
    """Steps 12-13: the vocabulary-tree phase, its CLI run and prints."""
    from cvt_tpu_torch.index import VocabHEIndex
    vb = phase_vocab(stamp)
    idx, q, path, tmp = (vb.pop("_index"), vb.pop("_q"), vb.pop("_path"),
                         vb.pop("_tmp"))
    desc, frames, _ = vb.pop("_desc"), vb.pop("_frames"), vb.pop("_src")
    k1, k2 = VocabHEIndex._factor(VOCAB_W)
    print(f"vocab tree W={VOCAB_W} (hierarchical {k1} x {k2}), "
          f"{VOCAB_IMAGES} images x {VOCAB_PER_IMAGE} descriptors: data "
          f"{vb['data_s']:.1f} s, train on {VOCAB_TRAIN} (iters 10) "
          f"{vb['train_s']:.1f} s, add (encode on the card) "
          f"{vb['encode_s']:.1f} s, prepare (host layout + "
          f"self-similarity) {vb['prepare_s']:.1f} s; bucket cap "
          f"{vb['bucket_cap']}, overflow tail {vb['n_overflow']} {stamp}")
    for label, r in vb["runs"].items():
        print(f"vocab query_batch B={len(q)} Kq={VOCAB_KQ} topk "
              f"{VOCAB_TOPK}, {label}: recall@1 {r['recall_at_1']:.4f} "
              f"recall@5 {r['recall_at_5']:.4f}, {r['ms_per_image']:.3f} "
              f"ms/image (synchronised wall clock) {stamp}")
    print(f"vocab single query vs batch (4 queries): agree, "
          f"{vb['single_excused']} near-tie ranks swapped; the index "
          f"loaded on the CPU vs the card ({VOCAB_CPU_Q} queries): agree, "
          f"{vb['cpu_excused']} near-tie ranks swapped; verified top-1 "
          f"agrees, {vb['cpu_verified_other_ranks_differ']} names or "
          f"scores differ at verified ranks 2-{VOCAB_TOPK}; launches "
          f"during the vocabulary-tree path: {vb['launches']} {stamp}")
    try:
        cli = run_vocab_cli(idx, q, path, desc, frames, tmp)
    finally:
        shutil.rmtree(tmp)
    print(f"cli vocab_tree_retriever: {VOCAB_CLI_Q} queries against the "
          f"saved index ranked as in-process query_batch ({cli['excused']} "
          f"near-tie ranks swapped), {cli['wall_s']:.1f} s process wall "
          f"clock; vocabulary phase {vb['phase_s']:.1f} s {stamp}")
    vb["cli"] = cli
    return vb


def cuda_median_ms(fn, reps: int) -> tuple[float, list]:
    """Median milliseconds of `reps` calls, each between two CUDA events,
    after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times


def procedural_corpus(n: int, seed: int, chunk: int = 64) -> np.ndarray:
    """procedural_images in chunks of `chunk` (seeds seed*1000 + chunk
    index), generated by one thread per chunk: numpy releases the GIL in
    its array passes."""
    from concurrent.futures import ThreadPoolExecutor
    from cvt_tpu_torch.io.datasets import procedural_images
    starts = range(0, n, chunk)
    with ThreadPoolExecutor(min(8, len(starts))) as pool:
        parts = list(pool.map(lambda c: procedural_images(
            min(chunk, n - c), FEAT_H, FEAT_W, seed=seed * 1000 + c // chunk),
            starts))
    return np.concatenate(parts)


def render_views(images: np.ndarray, seed: int) -> np.ndarray:
    """One re-rendered view per image: a seeded similarity about the
    centre (scale 0.85-1.15, shift +-24 px, rotation +-5 degrees),
    bilinear resampling with clamped borders, gain 0.8-1.2, offset +-0.05
    and Gaussian noise of 0.01, clipped to [0, 1]."""
    rng = np.random.default_rng(seed)
    n, h, w = images.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.empty_like(images)
    for i in range(n):
        s = rng.uniform(0.85, 1.15)
        th = np.deg2rad(rng.uniform(-5.0, 5.0))
        tx, ty = rng.uniform(-24.0, 24.0, 2)
        du = xx - (w - 1) / 2 - tx
        dv = yy - (h - 1) / 2 - ty
        x = (w - 1) / 2 + (np.cos(th) * du + np.sin(th) * dv) / s
        y = (h - 1) / 2 + (-np.sin(th) * du + np.cos(th) * dv) / s
        x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 2)
        y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 2)
        fx = np.clip(x - x0, 0.0, 1.0)
        fy = np.clip(y - y0, 0.0, 1.0)
        im = images[i]
        v = ((1 - fy) * ((1 - fx) * im[y0, x0] + fx * im[y0, x0 + 1])
             + fy * ((1 - fx) * im[y0 + 1, x0] + fx * im[y0 + 1, x0 + 1]))
        v = v * rng.uniform(0.8, 1.2) + rng.uniform(-0.05, 0.05)
        out[i] = np.clip(v + rng.normal(0.0, 0.01, (h, w)), 0.0, 1.0)
    return out


def feature_match(want, got, px: float = 0.01, rad: float = 1e-3):
    """Share of `want`'s valid keypoints matched by a valid keypoint of
    `got` (x, y, sigma within px, angle within rad) and the least
    descriptor cosine over the matches: the CPU parity tests' measure
    (tests/test_torch_features.py)."""
    matched, total, cos = 0, 0, 1.0
    for b in range(want.valid.shape[0]):
        vw, vg = want.valid[b].cpu().numpy(), got.valid[b].cpu().numpy()
        fw = want.frames[b].cpu().numpy()[vw]
        fg = got.frames[b].cpu().numpy()[vg]
        dw = want.descriptors[b].cpu().numpy()[vw]
        dg = got.descriptors[b].cpu().numpy()[vg]
        for i in range(len(fw)):
            total += 1
            ok = ((np.abs(fg[:, :3] - fw[i, :3]).max(1) <= px)
                  & (np.abs(np.angle(np.exp(1j * (fg[:, 3] - fw[i, 3]))))
                     <= rad))
            if ok.any():
                matched += 1
                cos = min(cos, float(dw[i] @ dg[np.argmax(ok)]))
    return matched / max(total, 1), cos, total


def check_features(f, b: int, k: int, min_valid: int = 0) -> np.ndarray:
    """Shapes, unit descriptors, frames inside the image; returns the
    valid keypoints per image."""
    assert tuple(f.frames.shape) == (b, k, 4), f.frames.shape
    assert tuple(f.descriptors.shape) == (b, k, 128), f.descriptors.shape
    v = f.valid
    n = v.sum(-1).cpu().numpy()
    assert (n > min_valid).all(), n
    fr = f.frames[v]
    assert bool(torch.isfinite(fr).all())
    assert bool(((fr[:, 0] >= 0) & (fr[:, 0] < FEAT_W) & (fr[:, 1] >= 0)
                 & (fr[:, 1] < FEAT_H)).all()), "frame outside the image"
    norms = torch.linalg.vector_norm(f.descriptors[v], dim=-1)
    err = float(torch.abs(norms - 1.0).max())
    assert err <= 1e-3, err
    return n


def phase_extract(stamp: str) -> dict:
    """Step 14: extract_sift at the operating point, times, memory, and
    the card against the CPU on small images."""
    from cvt_tpu_torch.features import extract_sift
    from cvt_tpu_torch.io.datasets import procedural_images
    t_phase = time.perf_counter()
    imgs = procedural_images(max(b for _, b in FEAT_RUNS), FEAT_H, FEAT_W,
                             seed=SEED)
    res = {"runs": {}}
    zero_launch_counts()
    for k, b in FEAT_RUNS:
        x = torch.from_numpy(imgs[:b]).to(DEV)

        def run():
            return extract_sift(x, max_features=k, **FEAT_OPTS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, times = cuda_median_ms(run, FEAT_REPS)
        f = run()
        n = check_features(f, b, k, 500 if k == 2048 else 0)
        res["runs"][(k, b)] = {
            "ms": ms, "times": times, "images_per_s": b / ms * 1e3,
            "kp_mean": float(n.mean()), "kp_min": int(n.min()),
            "kp_max": int(n.max()),
            "max_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    small = procedural_images(FEAT_CPU_B, FEAT_CPU_H, FEAT_CPU_W,
                              seed=SEED + 2)
    cpu = extract_sift(small, max_features=FEAT_CPU_K, device="cpu",
                       **FEAT_OPTS)
    gpu = extract_sift(small, max_features=FEAT_CPU_K, device=DEV,
                       **FEAT_OPTS)
    share, cos, total = feature_match(cpu, gpu)
    assert share >= 0.98 and cos >= 0.999, (share, cos)
    res["cpu"] = {"share": share, "cos": cos, "total": total,
                  "n_cpu": int(cpu.n_valid.sum()),
                  "n_gpu": int(gpu.n_valid.sum())}
    res["launches"] = launch_counts()
    assert not any(res["launches"].values()), res["launches"]
    res["phase_s"] = time.perf_counter() - t_phase
    res["_profile_input"] = torch.from_numpy(imgs[:FEAT_RUNS[0][1]]).to(DEV)
    return res


def names_to_ids(names) -> list:
    return [int(n[4:]) for n in names]


def phase_retrieval(stamp: str) -> dict:
    """Step 15: ImageRetrievalIndex over 512 extracted images, queried
    with 64 re-rendered views in each rerank mode; the CPU against the
    card on 4 queries; VocabHEIndex on the same features."""
    from cvt_tpu_torch.apps import ImageRetrievalIndex
    from cvt_tpu_torch.features import extract_sift
    from cvt_tpu_torch.index import VocabHEIndex
    t_phase = time.perf_counter()
    db = procedural_corpus(RET_IMAGES, SEED + 1)
    src = np.arange(0, RET_IMAGES, RET_EVERY)
    views = render_views(db[src], SEED + 3)
    res = {"data_s": time.perf_counter() - t_phase}
    zero_launch_counts()
    opts = dict(max_features=RET_K, **FEAT_OPTS)
    feats = []
    t0 = time.perf_counter()
    for lo in range(0, RET_IMAGES, RET_B):
        feats.append(extract_sift(torch.from_numpy(db[lo:lo + RET_B]).to(DEV),
                                  **opts))
    qfeats = [extract_sift(torch.from_numpy(views[lo:lo + RET_B]).to(DEV),
                           **opts) for lo in range(0, len(src), RET_B)]
    torch.cuda.synchronize()
    res["extract_images_per_s"] = (RET_IMAGES + len(src)) / (
        time.perf_counter() - t0)
    idx = ImageRetrievalIndex(device=DEV)
    t0 = time.perf_counter()
    for i in range(RET_IMAGES):
        idx.add_image(feats[i // RET_B], name=f"img_{i:04d}",
                      batch_index=i % RET_B)
    idx._finalize()
    torch.cuda.synchronize()
    res["add_ms_per_image"] = (time.perf_counter() - t0) / RET_IMAGES * 1e3
    res["n_descriptors"] = idx.index.ntotal
    res["kp_per_view"] = float(np.mean([int(f.n_valid.sum()) for f in qfeats])
                               / RET_B)

    def query(index, j, rerank):
        return index.search(qfeats[j // RET_B], batch_index=j % RET_B,
                            topk=RET_TOPK, rerank=rerank)
    res["modes"] = {}
    for rerank in RET_RERANKS:
        query(idx, 0, rerank)                                   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [query(idx, j, rerank) for j in range(len(src))]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ids = [names_to_ids(n) for n, _ in out]
        assert all(len(r) == RET_TOPK and min(r) >= 0
                   and max(r) < RET_IMAGES for r in ids), rerank
        assert all(np.isfinite(sc).all() for _, sc in out), rerank
        res["modes"][str(rerank)] = {
            "recall_at_1": float(np.mean([r[0] == s
                                          for r, s in zip(ids, src)])),
            "recall_at_5": float(np.mean([s in r[:5]
                                          for r, s in zip(ids, src)])),
            "ms_per_query": dt / len(src) * 1e3,
            "_ids": ids, "_scores": [sc for _, sc in out]}
    assert res["modes"]["svf"]["recall_at_1"] >= 0.90, res["modes"]["svf"]

    # the same features in an index on the CPU rank 4 queries as the card
    cpu = ImageRetrievalIndex(device="cpu")
    for i in range(RET_IMAGES):
        f = feats[i // RET_B]
        cpu.add_image(type(f)(*(a[i % RET_B:i % RET_B + 1].cpu() for a in (
            f.frames, f.descriptors, f.response, f.valid))),
            name=f"img_{i:04d}")
    t0 = time.perf_counter()
    c_out = [cpu.search(type(qfeats[0])(*(a[j % RET_B:j % RET_B + 1].cpu()
                                          for a in (
        qfeats[j // RET_B].frames, qfeats[j // RET_B].descriptors,
        qfeats[j // RET_B].response, qfeats[j // RET_B].valid))),
        topk=RET_TOPK, rerank="svf") for j in range(RET_CPU_Q)]
    res["cpu_s_per_query"] = (time.perf_counter() - t0) / RET_CPU_Q
    card = res["modes"]["svf"]
    res["cpu_excused"] = rankings_agree(
        np.array(card["_ids"][:RET_CPU_Q]),
        np.array(card["_scores"][:RET_CPU_Q]),
        np.array([names_to_ids(n) for n, _ in c_out]),
        np.array([sc for _, sc in c_out]), RET_TOPK)
    del cpu

    # the vocabulary tree on the same corpus and views
    rng = np.random.default_rng(SEED)
    db_desc = [f.descriptors[f.valid] for f in feats]
    all_desc = torch.cat(db_desc)
    train = torch.from_numpy(rng.choice(all_desc.shape[0], VOCAB_TRAIN,
                                        replace=False)).to(DEV)
    vidx = VocabHEIndex(n_words=VOCAB_W, probes=8, device=DEV)
    t0 = time.perf_counter()
    vidx.train(torch.Generator().manual_seed(SEED), all_desc[train],
               iters=10)
    torch.cuda.synchronize()
    res["vocab_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(RET_IMAGES):
        f, r = feats[i // RET_B], i % RET_B
        v = f.valid[r]
        vidx.add_image(f.descriptors[r][v], name=f"img_{i:04d}",
                       geometries=f.frames[r][v].cpu().numpy())
    vidx.prepare()
    torch.cuda.synchronize()
    res["vocab_add_prepare_s"] = time.perf_counter() - t0
    qd = torch.cat([f.descriptors for f in qfeats])
    qv = torch.cat([f.valid for f in qfeats])
    qg = torch.cat([f.frames for f in qfeats])
    res["vocab"] = {}
    for probes, verify in [(p, 0) for p in VOCAB_PROBES] + [(8, VOCAB_VERIFY)]:
        vidx.probes = probes
        kw = dict(topk=RET_TOPK, valid=qv, verify=verify,
                  geometries=qg if verify else None,
                  image_extent=float(FEAT_W))
        vidx.query_batch(qd, **kw)                               # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, sc, _ = vidx.query_batch(qd, **kw)
        dt = time.perf_counter() - t0
        label = ("exact" if probes == 0 else f"probes {probes}") + (
            f" + verify {verify}" if verify else "")
        assert ids.shape == (len(src), RET_TOPK), label
        assert ids.min() >= 0 and ids.max() < RET_IMAGES, label
        assert np.isfinite(sc).all(), label
        res["vocab"][label] = {
            "recall_at_1": float(np.mean(ids[:, 0] == src)),
            "recall_at_5": float(np.mean((ids[:, :5] == src[:, None]).any(1))),
            "ms_per_image": dt / len(src) * 1e3}
    res["launches"] = launch_counts()
    assert not any(res["launches"].values()), res["launches"]
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def run_feature_cli(tmp: str) -> dict:
    """Step 16: `cli feature_extractor` on 16 uint8 images (with
    --database) and on 4 views, then `cli retrieve`, as subprocesses; the
    ranked names must equal the in-process extract_sift ->
    ImageRetrievalIndex results on the same uint8 images."""
    from cvt_tpu_torch.apps import ImageRetrievalIndex
    from cvt_tpu_torch.features import extract_sift
    from cvt_tpu_torch.io.database import FeatureDatabase
    from cvt_tpu_torch.io.datasets import procedural_images
    db = procedural_images(FEAT_CLI_IMAGES, FEAT_H, FEAT_W, seed=SEED + 4)
    src = np.arange(0, FEAT_CLI_IMAGES, FEAT_CLI_IMAGES // FEAT_CLI_Q)
    u8 = {"db": (db * 255).round().astype(np.uint8),
          "q": (render_views(db[src], SEED + 5) * 255).round().astype(
              np.uint8)}
    paths = {}
    for name, a in u8.items():
        paths[name] = os.path.join(tmp, f"{name}.npy")
        np.save(paths[name], a)
    root = os.path.dirname(os.path.abspath(__file__))

    def cli(*args) -> str:
        run = subprocess.run([sys.executable, "-m", "cvt_tpu_torch.cli",
                              *args], capture_output=True, text=True,
                             cwd=root, timeout=300)
        if run.returncode:
            raise RuntimeError(f"cli {args[0]} exited {run.returncode}: "
                               f"{run.stderr[-2000:]}")
        return run.stdout
    t0 = time.perf_counter()
    out = {"extract_db": cli("feature_extractor", "--images", paths["db"],
                             "--database", os.path.join(tmp, "f.sqlite"),
                             "--out", os.path.join(tmp, "f.npz")).strip(),
           "extract_q": cli("feature_extractor", "--images", paths["q"],
                            "--out", os.path.join(tmp, "q.npz")).strip()}
    lines = cli("retrieve", "--db", os.path.join(tmp, "f.npz"), "--query",
                os.path.join(tmp, "q.npz")).splitlines()
    out["wall_s"] = time.perf_counter() - t0
    got = [json.loads(line)["results"] for line in lines]
    with FeatureDatabase(os.path.join(tmp, "f.sqlite")) as fdb:
        assert len(list(fdb.iter_images())) == FEAT_CLI_IMAGES
    feats = extract_sift(u8["db"].astype(np.float32) / 255.0,
                         max_features=512, rootsift=True, device=DEV)
    qfeats = extract_sift(u8["q"].astype(np.float32) / 255.0,
                          max_features=512, rootsift=True, device=DEV)
    idx = ImageRetrievalIndex(device=DEV)
    for b in range(FEAT_CLI_IMAGES):
        idx.add_image(feats, batch_index=b)
    want = [idx.search(qfeats, batch_index=b, topk=RET_TOPK)[0]
            for b in range(FEAT_CLI_Q)]
    assert got == want, (got, want)
    out["top1"] = [r[0] for r in got]
    out["recall_at_1"] = float(np.mean([r[0] == f"img_{s}"
                                        for r, s in zip(got, src)]))
    return out


def device_ops(prof) -> list:
    """(name, self device ms, calls) of a profile's operations, largest
    first: the CUDA kernels, or every operation with device time where
    the profiler tags none as CUDA."""
    from torch.autograd import DeviceType
    ev = prof.key_averages()
    ops = [(e.key, e.self_device_time_total / 1e3, e.count) for e in ev
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    if not ops:
        ops = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in ev if e.self_device_time_total > 0]
    return sorted(ops, key=lambda o: -o[1])


def host_ops(prof) -> list:
    """(name, self host ms, calls), largest first."""
    return sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), key=lambda o: -o[1])


def feature_profile(x: torch.Tensor, k: int, top: int = 12) -> dict:
    """torch.profiler over one extract_sift batch: the top device
    operations by self device time, their sum and the wall clock."""
    from torch.profiler import ProfilerActivity, profile
    from cvt_tpu_torch.features import extract_sift
    extract_sift(x, max_features=k, **FEAT_OPTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        extract_sift(x, max_features=k, **FEAT_OPTS)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ops = device_ops(prof)
    return {"wall_ms": wall, "device_ms": sum(o[1] for o in ops),
            "top": ops[:top]}


def run_features(stamp: str) -> dict:
    """Steps 14-16: extraction, retrieval over extracted features and the
    two commands, with their prints; returns what the last profile
    needs."""
    import tempfile
    t_all = time.perf_counter()
    ex = phase_extract(stamp)
    for (k, b), r in ex["runs"].items():
        print(f"extract_sift {FEAT_W}x{FEAT_H} B={b} K={k} (first octave -1, "
              f"3 scales, peak 0.02/3, edge 10, 2 orientations, RootSIFT): "
              f"{r['ms']:.2f} ms/batch (median of {FEAT_REPS}; "
              f"{min(r['times']):.2f}-{max(r['times']):.2f}), "
              f"{r['images_per_s']:.1f} images/s, keypoints/image mean "
              f"{r['kp_mean']:.1f} (min {r['kp_min']}, max {r['kp_max']}), "
              f"max memory allocated {r['max_mem_gb']:.2f} GB {stamp}")
    c = ex["cpu"]
    print(f"extract_sift card vs CPU ({FEAT_CPU_B} x {FEAT_CPU_W}x"
          f"{FEAT_CPU_H}, K {FEAT_CPU_K}): {c['share']:.4f} of the CPU's "
          f"{c['total']} valid keypoints matched within 0.01 px / 1e-3 rad, "
          f"descriptor cosine >= {c['cos']:.6f}; valid {c['n_gpu']} card, "
          f"{c['n_cpu']} CPU {stamp}")
    print(f"launches during extraction: {ex['launches']}; phase "
          f"{ex['phase_s']:.1f} s {stamp}")
    rt = phase_retrieval(stamp)
    print(f"retrieval corpus: {RET_IMAGES} procedural images {FEAT_W}x"
          f"{FEAT_H} at K {RET_K} -> {rt['n_descriptors']} descriptors in "
          f"the flat store; {RET_IMAGES // RET_EVERY} views (scale 0.85-1.15,"
          f" shift +-24 px, rotation +-5 deg, gain, noise), "
          f"{rt['kp_per_view']:.0f} keypoints/view; data {rt['data_s']:.1f} "
          f"s; extraction {rt['extract_images_per_s']:.1f} images/s (B "
          f"{RET_B}, synchronised wall clock); add_image "
          f"{rt['add_ms_per_image']:.3f} ms/image {stamp}")
    for mode, r in rt["modes"].items():
        print(f"ImageRetrievalIndex.search rerank={mode} topk {RET_TOPK}: "
              f"recall@1 {r['recall_at_1']:.4f} recall@5 "
              f"{r['recall_at_5']:.4f}, {r['ms_per_query']:.2f} ms per query "
              f"image (synchronised wall clock) {stamp}")
    print(f"retrieval on the CPU ({RET_CPU_Q} queries, svf, the card's "
          f"features) ranks as the card: {rt['cpu_excused']} near-tie ranks "
          f"swapped, {rt['cpu_s_per_query']:.2f} s per query on the CPU "
          f"{stamp}")
    print(f"vocab tree on extracted features: W={VOCAB_W}, train on "
          f"{VOCAB_TRAIN} (iters 10) {rt['vocab_train_s']:.1f} s, add + "
          f"prepare {rt['vocab_add_prepare_s']:.1f} s {stamp}")
    for label, r in rt["vocab"].items():
        print(f"vocab query_batch on extracted features, {label}: recall@1 "
              f"{r['recall_at_1']:.4f} recall@5 {r['recall_at_5']:.4f}, "
              f"{r['ms_per_image']:.3f} ms/image {stamp}")
    print(f"launches during retrieval: {rt['launches']}; phase "
          f"{rt['phase_s']:.1f} s {stamp}")
    with tempfile.TemporaryDirectory() as tmp:
        cl = run_feature_cli(tmp)
    print(f"cli feature_extractor: {cl['extract_db']!r} / "
          f"{cl['extract_q']!r}; cli retrieve ranked {FEAT_CLI_Q} views as "
          f"in-process (top-1 {cl['top1']}, recall@1 "
          f"{cl['recall_at_1']:.2f}), {cl['wall_s']:.1f} s process wall "
          f"clock {stamp}")
    print(f"steps 14-16 took {time.perf_counter() - t_all:.1f} s {stamp}")
    return {"profile_input": ex.pop("_profile_input")}


def multiview_scene(seed: int):
    """A seeded multi-view set at the matcher's full width: MV_CAMS
    cameras on a 220-degree arc (radius 12, heights +-0.5) around a
    volume of MV_GENERAL points (each seen within 60 degrees of its own
    horizontal normal) and a planar facade of MV_FACADE points (3 units
    out at -85 degrees, 10 x 6, facing out; it hides what lies behind it),
    pinhole f = 1,400 at 1,600 x 1,200. Each image holds MV_K keypoints:
    its visible projections with MV_NOISE_PX of noise (at most MV_K -
    MV_DISTRACT of them, a random subset), then distractors at random
    places; one nonnegative unit descriptor per point with per-view
    noise, and a share of points whose descriptor is a near copy of
    another's (repeated structure: some of their matches are wrong).
    Returns (images: dicts of keypoints [K, 4], descriptors [K, 128],
    point ids [K] (-1: distractor), rotation, centre; K [3, 3])."""
    rng = np.random.default_rng(seed)
    general = rng.uniform([-4, -2.5, -4], [4, 2.5, 4], (MV_GENERAL, 3))
    th0 = np.deg2rad(-85.0)
    n0 = np.array([np.sin(th0), 0.0, np.cos(th0)])          # facade normal
    u0 = np.array([np.cos(th0), 0.0, -np.sin(th0)])         # its x axis
    q0 = 3.0 * n0
    fa, fb = rng.uniform(-5, 5, MV_FACADE), rng.uniform(-3, 3, MV_FACADE)
    pts = np.concatenate([general, q0 + fa[:, None] * u0
                          + fb[:, None] * np.array([0.0, 1.0, 0.0])])
    facing_ang = np.concatenate([rng.uniform(-np.pi, np.pi, MV_GENERAL),
                                 np.full(MV_FACADE, th0)])
    desc = np.abs(rng.normal(size=(len(pts), D)))
    twins = rng.choice(len(pts), int(MV_TWINS * len(pts)), replace=False)
    desc[twins] = np.abs(desc[rng.permutation(twins)] + MV_DESC_NOISE
                         * rng.normal(size=(len(twins), D)))
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    kmat = np.array([[MV_F, 0, MV_W / 2], [0, MV_F, MV_H / 2], [0, 0, 1]])
    images = []
    for th in np.deg2rad(np.linspace(-110.0, 110.0, MV_CAMS)):
        c = 12.0 * np.array([np.sin(th), rng.uniform(-0.5, 0.5),
                             np.cos(th)])
        fwd = -c / np.linalg.norm(c)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        rot = np.stack([right, np.cross(fwd, right), fwd])  # world -> camera
        cam = (pts - c) @ rot.T
        uv = cam[:, :2] / cam[:, 2:3] * MV_F + [MV_W / 2, MV_H / 2]
        ray = c - pts
        facing = (np.cos(np.arctan2(ray[:, 0], ray[:, 2]) - facing_ang)
                  > np.cos(np.deg2rad(60.0)))
        sc, sp = (c - q0) @ n0, (pts - q0) @ n0
        behind = (sc > 0) & (sp < -1e-9)
        hit = c + (pts - c) * (sc / np.where(behind, sc - sp, 1.0))[:, None]
        hidden = behind & (np.abs((hit - q0) @ u0) < 5) & (np.abs(hit[:, 1])
                                                          < 3)
        vis = np.nonzero((cam[:, 2] > 0.5) & (uv[:, 0] >= 0)
                         & (uv[:, 0] < MV_W) & (uv[:, 1] >= 0)
                         & (uv[:, 1] < MV_H) & facing & ~hidden)[0]
        if len(vis) > MV_K - MV_DISTRACT:
            vis = np.sort(rng.choice(vis, MV_K - MV_DISTRACT, replace=False))
        nd = MV_K - len(vis)
        xy = np.concatenate([uv[vis] + rng.normal(0, MV_NOISE_PX,
                                                  (len(vis), 2)),
                             rng.uniform([0, 0], [MV_W, MV_H], (nd, 2))])
        d = np.abs(np.concatenate([desc[vis] + MV_DESC_NOISE * rng.normal(
            size=(len(vis), D)), rng.normal(size=(nd, D))]))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        ids = np.concatenate([vis, np.full(nd, -1)])
        order = rng.permutation(MV_K)
        kp = np.c_[xy, rng.uniform(1.5, 8.0, MV_K),
                   rng.uniform(-np.pi, np.pi, MV_K)]
        images.append({"kp": kp[order].astype(np.float32),
                       "desc": d[order].astype(np.float32),
                       "ids": ids[order], "rot": rot, "centre": c})
    return images, kmat


def write_feature_db(path: str, images) -> None:
    from cvt_tpu_torch.io.database import FeatureDatabase
    with FeatureDatabase(path) as db:
        for i, im in enumerate(images):
            iid = db.add_image(f"view_{i:03d}", width=MV_W, height=MV_H)
            db.write_keypoints(iid, im["kp"])
            db.write_descriptors(iid, im["desc"])
        db.commit()


def timed_database():
    """A FeatureDatabase class whose reads and writes add their host time
    to the current pair's record in its `times` list; match_pairs' first
    call for each pair (has_matches) opens the record."""
    from cvt_tpu_torch.io.database import FeatureDatabase

    class TimedDatabase(FeatureDatabase):
        times = [{"db_ms": 0.0}]

    def timed(name):
        def call(self, *args, **kw):
            if name == "has_matches":
                self.times.append({"db_ms": 0.0})
            t0 = time.perf_counter()
            try:
                return getattr(FeatureDatabase, name)(self, *args, **kw)
            finally:
                self.times[-1]["db_ms"] += (time.perf_counter() - t0) * 1e3
        return call
    for name in ("read_descriptors", "read_keypoints", "write_matches",
                 "write_two_view_geometry", "has_matches", "commit"):
        setattr(TimedDatabase, name, timed(name))
    return TimedDatabase


class PairClock:
    """Times match_pairs' parts without touching it: while entered, the
    pipeline module's matcher and two-view estimator are wrapped in CUDA
    events (device time from the call's first launch to its last), each
    added to the current pair's record in `times`."""

    def __init__(self, times: list):
        self.times = times
        self.events = []

    def __enter__(self):
        from cvt_tpu_torch.match import pipelines as pl
        self.saved = pl.match_descriptors, pl.estimate_two_view_geometry

        def evented(fn, key):
            def call(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                end.record()
                self.events.append((self.times[-1], key, start, end))
                return out
            return call
        pl.match_descriptors = evented(self.saved[0], "match_ms")
        pl.estimate_two_view_geometry = evented(self.saved[1], "two_view_ms")
        return self

    def __exit__(self, *exc):
        from cvt_tpu_torch.match import pipelines as pl
        pl.match_descriptors, pl.estimate_two_view_geometry = self.saved
        torch.cuda.synchronize()
        for rec, key, start, end in self.events:
            rec[key] = start.elapsed_time(end)


def read_tables(path: str, pairs) -> dict:
    """{pair: (matches [M, 2], inlier rows [I, 2] or None, config or
    None)} of a database."""
    from cvt_tpu_torch.io.database import FeatureDatabase
    out = {}
    with FeatureDatabase(path) as db:
        for a, b in pairs:
            g = db.read_two_view_geometry(a, b)
            out[(a, b)] = (db.read_matches(a, b),
                           None if g is None else g[0],
                           None if g is None else g[1])
    return out


def true_rows(images, a: int, b: int, rows) -> np.ndarray:
    """Which match rows [M, 2] of images a, b (database ids) join two
    projections of one scene point."""
    ia, ib = images[a - 1]["ids"], images[b - 1]["ids"]
    return (ia[rows[:, 0]] >= 0) & (ia[rows[:, 0]] == ib[rows[:, 1]])


def shared_points(images, a: int, b: int) -> int:
    ia, ib = images[a - 1]["ids"], images[b - 1]["ids"]
    return len(np.intersect1d(ia[ia >= 0], ib[ib >= 0]))


def rotation_error_deg(r_est: np.ndarray, r_true: np.ndarray) -> float:
    """The angle of r_est r_true^T in degrees, taken by scipy from the
    nearest rotation: a float32 r_est is orthogonal only to ~1e-7, which
    the arccos of the trace near 1 turns into ~0.02 degrees of noise."""
    from scipy.spatial.transform import Rotation
    return float(np.degrees(Rotation.from_matrix(
        np.asarray(r_est, np.float64)
        @ np.asarray(r_true, np.float64).T).magnitude()))


def near_tie_rows(d1: np.ndarray, d2: np.ndarray, ratio: float,
                  max_dist: float) -> np.ndarray:
    """Rows of a 2-NN match whose outcome float32 rounding may decide:
    top-2 gap, ratio margin or max-distance margin within 1e-5 relative,
    or a best column whose two nearest rows are that close (float64
    distances on the card)."""
    a = torch.from_numpy(d1).to(DEV, torch.float64)
    b = torch.from_numpy(d2).to(DEV, torch.float64)
    d = (a * a).sum(1)[:, None] - 2.0 * a @ b.T + (b * b).sum(1)[None, :]
    v = torch.topk(d, 2, dim=1, largest=False).values
    best, second = v[:, 0], v[:, 1]
    tie = (((second - best) <= 1e-5 * second)
           | ((best - ratio * ratio * second).abs() <= 1e-5 * second)
           | ((best - max_dist).abs() <= 1e-5 * max_dist))
    col = torch.topk(d, 2, dim=0, largest=False).values
    ctie = (col[1] - col[0]) <= 1e-5 * col[1]
    return (tie | ctie[torch.argmin(d, 1)]).cpu().numpy()


def compare_cpu(images, tables: dict, pairs, ratio: float,
                max_dist: float) -> dict:
    """The card's tables against the CPU's on the same pairs: matches
    equal but for near-tie rows (counted), configurations equal, inlier
    rows equal outside near-tie rows."""
    card, cpu = tables["card"], tables["cpu"]
    ties = rows = 0
    for a, b in pairs:
        (mg, ig, cg), (mc, ic, cc) = card[(a, b)], cpu[(a, b)]
        tie = near_tie_rows(images[a - 1]["desc"], images[b - 1]["desc"],
                            ratio, max_dist)
        ties += int(tie.sum())
        rows += len(tie)
        keep = (lambda m: {tuple(r) for r in m if not tie[r[0]]})
        assert keep(mg) == keep(mc), f"matches differ on pair {(a, b)}"
        assert cg == cc, f"config {cg} on the card, {cc} on the CPU {(a, b)}"
        if ig is not None:
            assert keep(ig) == keep(ic), f"inliers differ on pair {(a, b)}"
    assert ties <= 0.005 * rows, (ties, rows)
    return {"pairs": len(pairs), "near_tie_rows": ties, "rows": rows}


def phase_match(stamp: str) -> dict:
    """Step 17: match_pairs over the exhaustive pairs of a 64-image
    database at K 8,192 on the card (COLMAP's defaults), then guided over
    the sequential pairs, one calibrated two-view estimate, and the same
    pipeline on the CPU for 16 pairs."""
    import tempfile
    from cvt_tpu_torch.io.database import FeatureDatabase
    from cvt_tpu_torch.match import estimate_two_view_geometry
    from cvt_tpu_torch.match import pipelines as pl
    t_phase = time.perf_counter()
    res = {}
    t0 = time.perf_counter()
    images, kmat = multiview_scene(SEED + 7)
    res["data_s"] = time.perf_counter() - t0
    ids = list(range(1, MV_CAMS + 1))
    pairs = pl.exhaustive_pairs(ids)
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "features.sqlite")
        t0 = time.perf_counter()
        write_feature_db(base, images)
        res["db_write_s"] = time.perf_counter() - t0
        paths = {}
        for name in ("exhaustive", "guided", "card", "cpu"):
            paths[name] = os.path.join(tmp, f"{name}.sqlite")
            shutil.copy(base, paths[name])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        Timed = timed_database()
        times = Timed.times
        with Timed(paths["exhaustive"]) as db, PairClock(times):
            t0 = time.perf_counter()
            stats = pl.match_pairs(db, pairs, device=DEV)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        per_pair = times[1:]
        assert len(per_pair) == len(pairs), (len(per_pair), len(pairs))
        res.update(pairs=len(pairs), wall_s=wall, pairs_per_s=len(pairs) / wall,
                   configs=stats.configs, n_matched=stats.n_matched,
                   n_verified=stats.n_verified)
        for key in ("match_ms", "two_view_ms", "db_ms"):
            v = [t[key] for t in per_pair if key in t]
            res[key] = (float(np.median(v)), float(np.percentile(v, 90)),
                        len(v))
        tables = read_tables(paths["exhaustive"], pairs)
        n_match = [len(m) for m, _, _ in tables.values()]
        n_inl = [len(i) for _, i, _ in tables.values() if i is not None]
        true = sum(int(true_rows(images, a, b, i).sum())
                   for (a, b), (_, i, _) in tables.items() if i is not None)
        res["matches_per_pair"] = (float(np.mean(n_match)),
                                   float(np.median(n_match)))
        res["inliers_per_verified_pair"] = (float(np.mean(n_inl)),
                                            float(np.median(n_inl)))
        res["true_inlier_share"] = true / max(sum(n_inl), 1)
        assert res["true_inlier_share"] >= 0.95, res["true_inlier_share"]
        shared = {p: shared_points(images, *p) for p in pairs}
        missed = [p for p in pairs if shared[p] >= 200
                  and tables[p][2] in (None, 1)]
        res["pairs_200_shared"] = sum(s >= 200 for s in shared.values())
        assert not missed, f"unverified pairs with >= 200 shared: {missed}"
        assert {"uncalibrated", "planar_or_panoramic"} <= set(stats.configs)

        # guided re-matching over the consecutive pairs
        seq = pl.sequential_pairs(ids, overlap=1)
        torch.cuda.reset_peak_memory_stats()
        with FeatureDatabase(paths["guided"]) as db:
            t0 = time.perf_counter()
            gstats = pl.match_pairs(db, seq, guided=True, device=DEV)
            torch.cuda.synchronize()
            res["guided_s"] = time.perf_counter() - t0
        res["guided_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        gt = read_tables(paths["guided"], seq)
        g_inl = sum(len(i) for _, i, _ in gt.values() if i is not None)
        g_true = sum(int(true_rows(images, a, b, i).sum())
                     for (a, b), (_, i, _) in gt.items() if i is not None)
        p_inl = sum(len(tables[p][1]) for p in seq
                    if tables[p][1] is not None)
        res["guided"] = {"pairs": len(seq), "verified": gstats.n_verified,
                         "inliers": g_inl, "plain_inliers": p_inl,
                         "true_share": g_true / max(g_inl, 1),
                         "configs": gstats.configs}
        assert res["guided"]["true_share"] >= 0.95, res["guided"]
        assert gstats.n_verified == sum(tables[p][2] not in (None, 1)
                                        for p in seq)

        # the calibrated 5-point path on the general pair with most inliers
        # among pairs 4 cameras apart, at COLMAP's 4 px and at 1 px (twice
        # the keypoint noise). At 4 px every point is an inlier of most
        # 5-point hypotheses: the first of them is kept, since the LO refit
        # must support strictly more (as in cvt_tpu), so the pose is that
        # of one minimal sample (tests/test_torch_geometry.py holds that
        # choice against cvt_tpu's on an all-inlier scene). At 1 px the
        # supports tell the hypotheses apart and the refit over all inliers
        # wins; the gate holds it.
        cand = [(len(tables[p][1]), p) for p in pairs
                if p[1] - p[0] == 4 and tables[p][2] == 3]
        _, (a, b) = max(cand)
        rows = tables[(a, b)][1]
        src = torch.from_numpy(images[a - 1]["kp"][rows[:, 0], :2]).to(DEV)
        dst = torch.from_numpy(images[b - 1]["kp"][rows[:, 1], :2]).to(DEV)
        r_true = images[b - 1]["rot"] @ images[a - 1]["rot"].T
        t_true = images[b - 1]["rot"] @ (images[a - 1]["centre"]
                                         - images[b - 1]["centre"])
        res["calibrated"] = {"pair": (a, b), "points": len(rows)}
        for px in (4.0, 1.0):
            t0 = time.perf_counter()
            geom = estimate_two_view_geometry(
                torch.Generator().manual_seed(SEED), src, dst, k1=kmat,
                k2=kmat, f_threshold=px)
            ms = (time.perf_counter() - t0) * 1e3
            assert geom.config_name == "calibrated", (px, geom.config_name)
            res["calibrated"][px] = {
                "inliers": geom.n_inliers, "ms": ms,
                "rot_err_deg": rotation_error_deg(geom.r, r_true),
                "t_err_deg": float(np.degrees(np.arccos(np.clip(abs(
                    geom.t @ t_true) / np.linalg.norm(geom.t)
                    / np.linalg.norm(t_true), -1.0, 1.0))))}
        assert res["calibrated"][1.0]["rot_err_deg"] < 1.0, res["calibrated"]

        # the same pipeline on the CPU for 16 pairs, each side fresh
        by_config = {}
        for p in pairs:
            by_config.setdefault(tables[p][2], []).append(p)
        few = (by_config.get(3, [])[:8] + by_config.get(6, [])[:6]
               + by_config.get(None, [])[:1] + by_config.get(1, [])[:1])
        few = sorted(few + [p for p in pairs if p not in few][
            :max(MV_CPU_PAIRS - len(few), 0)])
        cmp_tables, cmp_s = {}, {}
        for name, dev in (("card", DEV), ("cpu", "cpu")):
            with FeatureDatabase(paths[name]) as db:
                t0 = time.perf_counter()
                pl.match_pairs(db, few, device=dev)
                cmp_s[name] = time.perf_counter() - t0
            cmp_tables[name] = read_tables(paths[name], few)
        res["cpu"] = compare_cpu(images, cmp_tables, few, 0.8,
                                 0.7 ** 2 * 2.0)
        res["cpu"].update(s_per_pair={k: v / len(few)
                                      for k, v in cmp_s.items()})
    res["phase_s"] = time.perf_counter() - t_phase
    res["_images"], res["_tables"] = images, tables
    return res


def render_pair_views():
    """Step 18's input: MATCH_CLI_VIEWS re-rendered views (render_views)
    of 2 procedural images, the first half of the first, uint8."""
    from cvt_tpu_torch.io.datasets import procedural_images
    src = procedural_images(2, FEAT_H, FEAT_W, seed=SEED + 8)
    per = MATCH_CLI_VIEWS // 2
    views = render_views(np.repeat(src, per, axis=0), SEED + 9)
    return (views * 255).round().astype(np.uint8), np.repeat([0, 1], per)


def run_match_cli(tmp: str) -> dict:
    """Step 18: `cli feature_extractor --database` on 16 views of 2
    images, then the five matcher commands and the three database
    commands as subprocesses (the matchers in parallel, each on its own
    copy), each JSON line against the same work done in-process."""
    from concurrent.futures import ThreadPoolExecutor
    from cvt_tpu_torch.cli import stats_line
    from cvt_tpu_torch.index import VocabHEIndex
    from cvt_tpu_torch.io.database import FeatureDatabase
    from cvt_tpu_torch.match import pipelines as pl
    root = os.path.dirname(os.path.abspath(__file__))

    def cli(*args) -> str:
        run = subprocess.run([sys.executable, "-m", "cvt_tpu_torch.cli",
                              *args], capture_output=True, text=True,
                             cwd=root, timeout=300)
        if run.returncode:
            raise RuntimeError(f"cli {args[0]} exited {run.returncode}: "
                               f"{run.stderr[-2000:]}")
        return run.stdout.strip().splitlines()[-1]

    def path(name: str) -> str:
        return os.path.join(tmp, name)
    views, source = render_pair_views()
    np.save(path("views.npy"), views)
    t0 = time.perf_counter()
    cli("feature_extractor", "--images", path("views.npy"), "--out",
        path("views.npz"), "--database", path("base.sqlite"))
    out = {"extract_s": time.perf_counter() - t0}
    with FeatureDatabase(path("base.sqlite")) as db:
        ids = [i for i, _ in db.iter_images()]
    pairs = pl.exhaustive_pairs(ids)
    # in-process, each on its own copy of the database
    want = {}

    def inproc(name, fn):
        shutil.copy(path("base.sqlite"), path(f"in_{name}.sqlite"))
        with FeatureDatabase(path(f"in_{name}.sqlite")) as db:
            want[name] = fn(db)
    inproc("exhaustive", lambda db: stats_line(
        "exhaustive", pl.match_pairs(db, pairs, device=DEV)))
    inproc("sequential", lambda db: stats_line(
        "sequential", pl.match_pairs(db, pl.sequential_pairs(ids),
                                     device=DEV)))
    with open(path("pairs.txt"), "w") as f:
        f.write("image_000000 image_000001\nimage_000002 image_000009\n"
                "image_000003 missing\n5 6\n")
    inproc("image_pairs", lambda db: stats_line(
        "image_pairs", pl.match_pairs(db, pl.pairs_from_file(
            db, path("pairs.txt")), device=DEV)))

    def vocab(db):
        train = np.concatenate([db.read_descriptors(i) for i in ids])
        index = VocabHEIndex(n_words=min(MATCH_CLI_WORDS,
                                         max(len(train) // 4, 16)),
                             dim=train.shape[1], device=DEV)
        index.train(torch.Generator().manual_seed(0),
                    train.astype(np.float32), iters=10)
        return stats_line("vocab_tree", pl.match_pairs(
            db, pl.vocab_tree_pairs(db, index, num_images=20), device=DEV))
    inproc("vocab_tree", vocab)
    with FeatureDatabase(path("in_exhaustive.sqlite")) as db:
        blocks = [f"image_{a - 1:06d} image_{b - 1:06d}\n" + "\n".join(
            f"{i} {j}" for i, j in db.read_matches(a, b))
            for a, b in ((1, 2), (9, 12), (3, 4), (2, 10))]
    with open(path("matches.txt"), "w") as f:
        f.write("\n\n".join(blocks) + "\n")
    inproc("importer", lambda db: stats_line(
        "feature_pairs", pl.import_feature_matches(db, path("matches.txt"),
                                                   device=DEV)))
    commands = {
        "exhaustive": ("exhaustive_matcher",),
        "sequential": ("sequential_matcher",),
        "image_pairs": ("image_pairs_matcher", "--pair-list",
                        path("pairs.txt")),
        "vocab_tree": ("vocab_tree_matcher", "--num-words",
                       str(MATCH_CLI_WORDS)),
        "importer": ("matches_importer", "--match-list",
                     path("matches.txt"))}
    for name in commands:
        shutil.copy(path("base.sqlite"), path(f"cli_{name}.sqlite"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(commands)) as pool:
        got = dict(zip(commands, pool.map(
            lambda n: cli(commands[n][0], "--database",
                          path(f"cli_{n}.sqlite"), *commands[n][1:]),
            commands)))
    out["matchers_s"] = time.perf_counter() - t0
    for name in commands:
        assert got[name] == want[name], (name, got[name], want[name])
    out["lines"] = got
    # same-source pairs verify, cross-source pairs stay under 15 matches
    tables = read_tables(path("cli_exhaustive.sqlite"), pairs)
    for (a, b), (m, _, config) in tables.items():
        if source[a - 1] == source[b - 1]:
            assert config not in (None, 1), ("unverified", a, b)
        else:
            assert len(m) < 15, ("cross-source matches", a, b, len(m))
    out["same_source_inliers"] = float(np.mean([
        len(i) for (a, b), (_, i, _) in tables.items()
        if source[a - 1] == source[b - 1]]))
    out["cross_source_max_matches"] = max(
        len(m) for (a, b), (m, _, _) in tables.items()
        if source[a - 1] != source[b - 1])
    # the database commands on copies
    shutil.copy(path("cli_exhaustive.sqlite"), path("clean.sqlite"))
    t0 = time.perf_counter()
    db_lines = [cli("database_creator", "--database", path("new.sqlite")),
                cli("database_cleaner", "--database", path("clean.sqlite"),
                    "--type", "matches"),
                cli("database_merger", "--database1", path("base.sqlite"),
                    "--database2", path("new.sqlite"), "--merged_database",
                    path("merged.sqlite"))]
    out["db_commands_s"] = time.perf_counter() - t0
    assert db_lines == [
        json.dumps({"created": path("new.sqlite")}),
        json.dumps({"cleared": "matches"}),
        json.dumps({"merged": path("merged.sqlite"),
                    "n_images": MATCH_CLI_VIEWS})], db_lines
    with FeatureDatabase(path("clean.sqlite")) as db:
        assert not any(db.has_matches(a, b) for a, b in pairs)
        assert db.num_images() == MATCH_CLI_VIEWS
    return out


def match_profile(images, n_pairs: int, top: int = 10) -> dict:
    """torch.profiler over match_pairs on n_pairs consecutive pairs of
    step 17's images (a fresh database): top device operations by self
    device time, their sum, the wall clock, and the top host operations
    and CUDA runtime calls by self host time (where the host waits)."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from cvt_tpu_torch.io.database import FeatureDatabase
    from cvt_tpu_torch.match import pipelines as pl
    pairs = pl.sequential_pairs(range(1, n_pairs + 2), overlap=1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "p.sqlite")
        write_feature_db(path, images[:n_pairs + 1])
        with FeatureDatabase(path) as db:
            pl.match_pairs(db, pairs[:1], device=DEV)        # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                pl.match_pairs(db, pairs, device=DEV, skip_existing=False)
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    ops, host = device_ops(prof), host_ops(prof)
    return {"pairs": len(pairs), "wall_ms": wall,
            "device_ms": sum(o[1] for o in ops), "top": ops[:top],
            "host": host[:top]}


def run_matching(stamp: str) -> dict:
    """Steps 17-18 with their prints; returns the images for the last
    profile."""
    import tempfile
    t_all = time.perf_counter()
    zero_launch_counts()
    mt = phase_match(stamp)
    print(f"matching database: {MV_CAMS} images {MV_W}x{MV_H} at K {MV_K} "
          f"(D {D}), {MV_GENERAL} volume + {MV_FACADE} facade points; data "
          f"{mt['data_s']:.1f} s, database write {mt['db_write_s']:.1f} s "
          f"{stamp}")
    print(f"match_pairs exhaustive ({mt['pairs']} pairs; ratio 0.8, "
          f"max_dist 0.98, cross-check, min 15, F 4 px, H 12 px, 256 "
          f"hypotheses): {mt['wall_s']:.2f} s, {mt['pairs_per_s']:.2f} "
          f"pairs/s, peak memory allocated {mt['peak_gb']:.2f} GB {stamp}")
    for key, what in (("match_ms", "matching (CUDA events)"),
                      ("two_view_ms", "two-view (CUDA events)"),
                      ("db_ms", "database (host clock)")):
        med, p90, n = mt[key]
        print(f"  per pair, {what}: median {med:.3f} ms, p90 {p90:.3f} ms "
              f"over {n} pairs {stamp}")
    print(f"  matches per pair mean {mt['matches_per_pair'][0]:.1f} (median "
          f"{mt['matches_per_pair'][1]:.0f}); inliers per verified pair mean "
          f"{mt['inliers_per_verified_pair'][0]:.1f} (median "
          f"{mt['inliers_per_verified_pair'][1]:.0f}); matched "
          f"{mt['n_matched']}, verified {mt['n_verified']} by configuration "
          f"{mt['configs']}; {mt['true_inlier_share']:.4f} of stored inliers "
          f"are true correspondences (gate 0.95); all "
          f"{mt['pairs_200_shared']} pairs with >= 200 shared points "
          f"verified {stamp}")
    g = mt["guided"]
    print(f"match_pairs guided over {g['pairs']} sequential pairs: "
          f"{mt['guided_s']:.2f} s, verified {g['verified']} "
          f"{g['configs']}, inliers {g['inliers']} (plain {g['plain_inliers']}),"
          f" {g['true_share']:.4f} true, peak memory allocated "
          f"{mt['guided_peak_gb']:.2f} GB {stamp}")
    c = mt["calibrated"]
    for px in (4.0, 1.0):
        print(f"estimate_two_view_geometry with K on pair {c['pair']} "
              f"({c['points']} points), F / E threshold {px:g} px: "
              f"calibrated, {c[px]['inliers']} inliers, rotation error "
              f"{c[px]['rot_err_deg']:.4f} deg (gate < 1 at 1 px), "
              f"translation direction error {c[px]['t_err_deg']:.4f} deg, "
              f"{c[px]['ms']:.1f} ms (wall) {stamp}")
    cp = mt["cpu"]
    print(f"match_pairs card vs CPU on {cp['pairs']} pairs (seed {SEED}): "
          f"tables equal, {cp['near_tie_rows']} near-tie rows of "
          f"{cp['rows']}; {cp['s_per_pair']['card']:.3f} s/pair card, "
          f"{cp['s_per_pair']['cpu']:.3f} s/pair CPU {stamp}")
    print(f"step 17 took {mt['phase_s']:.1f} s {stamp}")
    with tempfile.TemporaryDirectory() as tmp:
        cl = run_match_cli(tmp)
    for name, line in cl["lines"].items():
        print(f"cli {name}: {line}")
    print(f"step 18: feature_extractor {cl['extract_s']:.1f} s, five "
          f"matchers in parallel {cl['matchers_s']:.1f} s, database "
          f"commands {cl['db_commands_s']:.1f} s (process wall clock); every "
          f"line equals in-process; same-source pairs verified (mean "
          f"{cl['same_source_inliers']:.1f} inliers), cross-source pairs at "
          f"most {cl['cross_source_max_matches']} matches {stamp}")
    launches = launch_counts()
    print(f"launches during steps 17-18: {launches} {stamp}")
    assert not any(launches.values()), launches
    print(f"steps 17-18 took {time.perf_counter() - t_all:.1f} s {stamp}")
    return {"images": mt.pop("_images"), "tables": mt.pop("_tables")}


class DeviceSpan:
    """While entered, a module function is wrapped in CUDA events; `ms`
    sums the device time of its calls (first launch to last)."""

    def __init__(self, module, name: str):
        self.module, self.name, self.events = module, name, []

    def __enter__(self):
        self.saved = getattr(self.module, self.name)

        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.saved(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out
        setattr(self.module, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)
        torch.cuda.synchronize()
        self.ms = sum(a.elapsed_time(b) for a, b in self.events)


def true_poses(images):
    """World -> camera (rvec, tvec) of each image, float64 (scipy's
    rotation vector: the float32 axis extraction is ill-conditioned near
    the arc's 180-degree rotations)."""
    from scipy.spatial.transform import Rotation
    return [(Rotation.from_matrix(im["rot"]).as_rotvec(),
             -im["rot"] @ im["centre"]) for im in images]


def normalized_keypoints(im) -> np.ndarray:
    return (im["kp"][:, :2].astype(np.float64)
            - [MV_W / 2, MV_H / 2]) / MV_F


def track_purity(tracks, images) -> float:
    """Share of tracks whose observations all carry one true point id."""
    flat = np.concatenate(tracks)
    ids = np.stack([im["ids"] for im in images])[flat[:, 0] - 1, flat[:, 1]]
    starts = np.cumsum([0] + [len(t) for t in tracks[:-1]])
    lo, hi = np.minimum.reduceat(ids, starts), np.maximum.reduceat(ids,
                                                                   starts)
    return float(np.mean((lo == hi) & (lo >= 0)))


def observations(rec) -> dict:
    """{image id: (world points [N, 3], normalized keypoints [N, 2])} of
    the 3D points each image observes."""
    pts = list(rec.points3d.values())
    flat = np.concatenate([p.track for p in pts])
    xyz = np.repeat(np.stack([p.xyz for p in pts]),
                    [len(p.track) for p in pts], axis=0)
    return {iid: (xyz[flat[:, 0] == iid],
                  im.keypoints[flat[flat[:, 0] == iid, 1]])
            for iid, im in rec.images.items()}


def centre_of(rvec, tvec) -> np.ndarray:
    from scipy.spatial.transform import Rotation
    return -Rotation.from_rotvec(rvec).as_matrix().T @ tvec


def pose_errors(rec, images) -> dict:
    """Rotation (degrees) and centre errors of every registered image after
    a similarity_transform alignment of the centres to the truth."""
    from scipy.spatial.transform import Rotation
    from cvt_tpu_torch.match import similarity_transform
    ids = sorted(rec.images)
    est = np.stack([centre_of(rec.images[i].rvec, rec.images[i].tvec)
                    for i in ids])
    true = np.stack([images[i - 1]["centre"] for i in ids])
    sc, r, t = (a.cpu().double().numpy() for a in similarity_transform(
        torch.from_numpy(est).float(), torch.from_numpy(true).float()))
    cerr = np.linalg.norm(sc * est @ r.T + t - true, axis=1)
    rerr = [rotation_error_deg(Rotation.from_rotvec(rec.images[i].rvec)
                               .as_matrix() @ r.T, images[i - 1]["rot"])
            for i in ids]
    return {"scale": float(sc), "centre_mean": float(cerr.mean()),
            "centre_max": float(cerr.max()),
            "rot_mean_deg": float(np.mean(rerr)),
            "rot_max_deg": float(np.max(rerr))}


def scene_cost(rec) -> tuple[float, float, int]:
    """(0.5 * sum of squared reprojection errors, mean error in pixels,
    observations) of a scene in normalized coordinates."""
    from cvt_tpu_torch.match import reprojection_errors
    prob = rec.to_ba_problem()[0]
    err = reprojection_errors(prob.poses, prob.points, prob.cam_idx,
                              prob.pt_idx, prob.uv, prob.mask).double()
    return (float(0.5 * (err * err).sum()), float(err.mean()) * MV_F,
            int(err.numel()))


def near_limit(rec, limit: float) -> int:
    """Points whose mean reprojection error lies within 1e-5 relative of
    `limit`: where filter_points' float64 mean and cvt_tpu's float32 mean
    may decide apart."""
    from cvt_tpu_torch.match import reprojection_errors
    prob = rec.to_ba_problem()[0]
    err = reprojection_errors(prob.poses, prob.points, prob.cam_idx,
                              prob.pt_idx, prob.uv, prob.mask).cpu().numpy()
    pid = prob.pt_idx.cpu().numpy()
    mean = np.bincount(pid, weights=err) / np.maximum(np.bincount(pid), 1)
    return int(np.sum(np.abs(mean / limit - 1.0) < 1e-5))


def perturbed_scene(images, tracks, poses, ids, device, seed: int):
    """A Reconstruction of `ids` whose poses past the first two carry
    seeded noise (RC_ROT_NOISE rad per axis, RC_T_NOISE per translation
    component), triangulated from those poses."""
    from cvt_tpu_torch.match import Reconstruction
    rng = np.random.default_rng(seed)
    rec = Reconstruction(device=device)
    for k, iid in enumerate(ids):
        rv, tv = poses[iid - 1]
        if k >= 2:
            rv = rv + rng.normal(0, RC_ROT_NOISE, 3)
            tv = tv + rng.normal(0, RC_T_NOISE, 3)
        rec.register_image(iid, f"view_{iid - 1:03d}", rv, tv,
                           normalized_keypoints(images[iid - 1]))
    rec.triangulate(tracks)
    return rec


def same_reconstruction(a, b) -> bool:
    if sorted(a.images) != sorted(b.images) or list(a.points3d) != list(
            b.points3d) or a._next_pt != b._next_pt:
        return False
    for iid, im in a.images.items():
        o = b.images[iid]
        if (im.name, im.camera_id) != (o.name, o.camera_id) or not all(
                np.array_equal(getattr(im, f), getattr(o, f))
                for f in ("rvec", "tvec", "keypoints")):
            return False
    return all(np.array_equal(p.xyz, b.points3d[k].xyz)
               and np.array_equal(p.track, b.points3d[k].track)
               and p.error == b.points3d[k].error
               for k, p in a.points3d.items())


def phase_reconstruct(images, tables, tmp: str) -> dict:
    """Step 19: tracks from step 17's verified inliers, the camera models
    over every keypoint, registration by PnP against points triangulated
    from the true poses, bundle adjustment from perturbed poses (and at a
    cut size on the CPU against the card), scene clustering, save/load."""
    import copy
    from cvt_tpu_torch.match import (CorrespondenceGraph, Reconstruction,
                                     cluster_scene, image_to_world,
                                     ransac_pnp, world_to_image)
    from cvt_tpu_torch.match import reconstruction as R
    res = {}
    t_phase = time.perf_counter()
    verified = {p: v[1] for p, v in tables.items()
                if v[1] is not None and v[2] not in (None, 1)}
    # 1. tracks
    graph = CorrespondenceGraph()
    t0 = time.perf_counter()
    for (a, b), rows in verified.items():
        graph.add_correspondences(a, b, rows)
    tracks = graph.build_tracks()
    res["tracks_s"] = time.perf_counter() - t0
    lens = np.array([len(t) for t in tracks])
    res["tracks"] = {"pairs": len(verified),
                     "correspondences": int(sum(len(r) for r in
                                                verified.values())),
                     "count": len(tracks), "mean_len": float(lens.mean()),
                     "median_len": float(np.median(lens)),
                     "max_len": int(lens.max()),
                     "pure": track_purity(tracks, images)}
    assert res["tracks"]["pure"] >= RC_GATES["pure"], res["tracks"]

    # 2. camera models over every keypoint, on the card and the CPU
    uv = torch.from_numpy(np.stack([im["kp"][:, :2] for im in images])
                          ).to(DEV)                     # [64, K, 2]
    pin = torch.tensor([MV_F, MV_F, MV_W / 2, MV_H / 2], device=DEV)
    lens_p = torch.tensor([MV_F, MV_F, MV_W / 2, MV_H / 2, *RC_LENS],
                          device=DEV)
    xy = image_to_world("pinhole", pin, uv)
    cams = {"pinhole_err": float((xy - (uv - pin[2:]) / MV_F).abs().max())}
    cams["pinhole_back_px"] = float((world_to_image("pinhole", pin, xy)
                                     - uv).abs().max())
    cams["opencv_ms"], _ = cuda_median_ms(
        lambda: image_to_world("opencv", lens_p, uv), 5)
    xy_l = image_to_world("opencv", lens_p, uv)
    cams["opencv_back_px"] = float((world_to_image("opencv", lens_p, xy_l)
                                    - uv).abs().max())
    xy_cpu = image_to_world("opencv", lens_p.cpu(), uv.cpu())
    cams["card_vs_cpu"] = float((xy_l.cpu() - xy_cpu).abs().max())
    cams["points"] = int(uv.shape[0] * uv.shape[1])
    res["cameras"] = cams
    assert cams["opencv_back_px"] <= RC_GATES["lens_px"], cams
    assert cams["card_vs_cpu"] <= RC_GATES["cam_cpu"], cams
    assert cams["pinhole_err"] <= 1e-6, cams

    # 3. registration: points from the true poses, then PnP per image
    poses = true_poses(images)
    ids = list(range(1, MV_CAMS + 1))
    truth = Reconstruction(device=DEV)
    for iid in ids:
        truth.register_image(iid, f"view_{iid - 1:03d}", *poses[iid - 1],
                             normalized_keypoints(images[iid - 1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with DeviceSpan(R, "triangulate_tracks") as span:
        res["true_points"] = truth.triangulate(tracks,
                                               max_error=RC_PX / MV_F)
    res["true_triangulate_s"] = time.perf_counter() - t0
    res["true_triangulate_device_ms"] = span.ms
    gen = torch.Generator().manual_seed(SEED)
    pnp = []
    t0 = time.perf_counter()
    obs = observations(truth)
    for iid in ids:
        world, norm = obs[iid]
        r, t, _, n_inl = ransac_pnp(gen, torch.from_numpy(world).float().to(
            DEV), torch.from_numpy(norm).float().to(DEV),
            threshold=RC_PX / MV_F)
        r, t = r.cpu().double().numpy(), t.cpu().double().numpy()
        im = images[iid - 1]
        pnp.append({"image": iid, "obs": len(world), "inliers": int(n_inl),
                    "rot_deg": rotation_error_deg(r, im["rot"]),
                    "centre": float(np.linalg.norm(-r.T @ t
                                                   - im["centre"]))})
    res["pnp_s"] = time.perf_counter() - t0
    res["pnp"] = pnp
    bad = [p for p in pnp if p["inliers"] < RC_MIN_INLIERS
           or p["rot_deg"] > RC_GATES["pnp_rot_deg"]
           or p["centre"] > RC_GATES["pnp_centre"]]
    assert not bad, bad

    # 4. bundle adjustment from perturbed poses
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with DeviceSpan(R, "triangulate_tracks") as span:
        rec = perturbed_scene(images, tracks, poses, ids, DEV, SEED + 19)
    res["triangulate_s"] = time.perf_counter() - t0
    res["triangulate_device_ms"] = span.ms
    res["before"] = dict(zip(("cost", "mean_px", "obs"), scene_cost(rec)),
                         **pose_errors(rec, images))
    res["points"], res["cameras_n"] = len(rec.points3d), len(rec.images)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with DeviceSpan(R, "bundle_adjust") as span:
        res["ba_cost"] = rec.bundle_adjust(n_fixed_poses=2)
    res["ba_s"] = time.perf_counter() - t0
    res["ba_device_ms"] = span.ms
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["after"] = dict(zip(("cost", "mean_px", "obs"), scene_cost(rec)),
                        **pose_errors(rec, images))
    res["near_limit"] = near_limit(rec, RC_PX / MV_F)
    t0 = time.perf_counter()
    res["filtered_points"] = rec.filter_points(RC_PX / MV_F)
    res["filtered_images"] = rec.filter_images(10)
    res["filter_s"] = time.perf_counter() - t0
    a = res["after"]
    assert a["mean_px"] <= RC_GATES["ba_px"], a
    assert a["rot_max_deg"] <= RC_GATES["ba_rot_deg"], a
    assert a["centre_max"] <= RC_GATES["ba_centre"], a
    assert res["ba_cost"] < res["before"]["cost"], res

    # the same BA on the CPU and the card at a cut size
    cut = ids[:RC_CUT]
    cut_tracks = [t[t[:, 0] <= RC_CUT] for t in tracks]
    cut_tracks = [t for t in cut_tracks if len(t) >= 2]
    base = perturbed_scene(images, cut_tracks, poses, cut, "cpu", SEED + 20)
    both = {}
    for dev in ("cpu", DEV):
        sc = copy.deepcopy(base)
        sc.device = dev
        t0 = time.perf_counter()
        cost = sc.bundle_adjust(n_fixed_poses=2)
        both[dev] = (sc, cost, time.perf_counter() - t0)
    (c_sc, c_cost, c_s), (g_sc, g_cost, g_s) = both["cpu"], both[DEV]
    pose_d = max(float(np.abs(np.r_[c_sc.images[i].rvec - g_sc.images[i].rvec,
                                    c_sc.images[i].tvec - g_sc.images[i].tvec]
                              ).max()) for i in cut)
    pt_d = np.array([np.abs(c_sc.points3d[k].xyz - g_sc.points3d[k].xyz).max()
                     for k in c_sc.points3d])
    res["cut"] = {"images": RC_CUT, "points": len(base.points3d),
                  "cost_cpu": c_cost, "cost_card": g_cost,
                  "cost_rel": abs(g_cost - c_cost) / c_cost,
                  "pose_max": pose_d, "point_max": float(pt_d.max()),
                  "point_p99": float(np.percentile(pt_d, 99)),
                  "cpu_s": c_s, "card_s": g_s}
    cu = res["cut"]
    assert cu["cost_rel"] <= RC_GATES["cut_cost_rtol"], cu
    assert cu["pose_max"] <= RC_GATES["cut_pose"], cu
    assert cu["point_max"] <= RC_GATES["cut_point"], cu

    # 5. scene clustering over the match graph
    edges = np.array([(a - 1, b - 1) for a, b in verified])
    weights = [float(len(r)) for r in verified.values()]
    root = cluster_scene(ids, edges, weights, leaf_max_images=RC_LEAF)
    leaves = root.leaves()
    res["leaves"] = [len(lf.image_ids) for lf in leaves]
    assert sorted(i for lf in leaves for i in lf.image_ids) == ids
    assert max(res["leaves"]) <= RC_LEAF

    # 6. save, then load on the CPU
    path = os.path.join(tmp, "scene.npz")
    t0 = time.perf_counter()
    rec.save(path)
    loaded = Reconstruction.load(path, device="cpu")
    res["save_load_s"] = time.perf_counter() - t0
    assert same_reconstruction(rec, loaded), "loaded scene differs"
    res["phase_s"] = time.perf_counter() - t_phase
    res["_scene"], res["_rec"] = path, rec
    return res


def run_recon_cli(images, scene: str, tmp: str) -> dict:
    """Step 20: image_deleter (on step 19's scene and on a feature
    database), image_filterer and image_undistorter (--device cuda and
    --device cpu) as subprocesses, in parallel, each against the same call
    in-process."""
    import contextlib
    import io
    from concurrent.futures import ThreadPoolExecutor
    from cvt_tpu_torch.apps import undistort_images
    from cvt_tpu_torch.cli import main as cli_main
    from cvt_tpu_torch.io.database import FeatureDatabase
    from cvt_tpu_torch.io.datasets import procedural_images
    from cvt_tpu_torch.match import Reconstruction
    root = os.path.dirname(os.path.abspath(__file__))

    def path(name: str) -> str:
        return os.path.join(tmp, name)

    def cli(*args):
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", "cvt_tpu_torch.cli",
                              *args], capture_output=True, text=True,
                             cwd=root, timeout=300)
        if run.returncode:
            raise RuntimeError(f"cli {args[0]} exited {run.returncode}: "
                               f"{run.stderr[-2000:]}")
        return run.stdout.strip().splitlines(), time.perf_counter() - t0

    def inproc(*args):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli_main(list(args))
        return out.getvalue().strip().splitlines()

    rec = Reconstruction.load(scene, device="cpu")
    # the names of every other one of the first 2 * RC_DELETE images, in
    # the scene and in a database holding those images
    db_ids = sorted(rec.images)[:2 * RC_DELETE]
    names = [rec.images[i].name for i in db_ids[::2]]
    with open(path("names.txt"), "w") as f:
        f.write("\n".join(names + ["missing.jpg"]) + "\n")
    with FeatureDatabase(path("db.sqlite")) as db:
        for i in db_ids:
            iid = db.add_image(rec.images[i].name, width=MV_W, height=MV_H)
            db.write_keypoints(iid, images[i - 1]["kp"])
            db.write_descriptors(iid, images[i - 1]["desc"])
        db.commit()
    for tag in ("cli", "in"):
        shutil.copy(path("db.sqlite"), path(f"db_{tag}.sqlite"))
    counts = sorted(rec.num_observations(i) for i in rec.images)
    min_obs = str(counts[RC_DELETE] + 1)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:     # numpy releases the GIL
        gray = np.concatenate(list(pool.map(lambda c: procedural_images(
            RC_UNDIST_N // 4, MV_H, MV_W, seed=SEED + 21 + c), range(4))))
    rgb = np.stack([gray, gray[:, ::-1], 1.0 - gray], -1)
    np.save(path("frames.npy"), (rgb * 255).round().astype(np.uint8))
    out = {"frames_s": time.perf_counter() - t0}
    lens = ",".join(str(v) for v in (MV_F, MV_F, MV_W / 2, MV_H / 2,
                                     *RC_LENS))
    und = ("image_undistorter", "--images", path("frames.npy"), "--model",
           "opencv", "--params", lens)
    calls = {
        "image_deleter": ("image_deleter", "--input_path", scene,
                          "--output_path", path("del_cli.npz"),
                          "--image_names_path", path("names.txt")),
        "image_deleter_db": ("image_deleter", "--database",
                             path("db_cli.sqlite"), "--image_names_path",
                             path("names.txt")),
        "image_filterer": ("image_filterer", "--input_path", scene,
                           "--output_path", path("filt_cli.npz"),
                           "--min_num_observations", min_obs),
        "undistort_cuda": und + ("--out", path("und_cuda.npy"),
                                 "--device", DEV),
        "undistort_cpu": und + ("--out", path("und_cpu.npy"), "--device",
                                "cpu")}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(calls)) as pool:
        got = dict(zip(calls, pool.map(lambda k: cli(*calls[k]), calls)))
    out["wall_s"] = time.perf_counter() - t0
    out["process_s"] = {k: v[1] for k, v in got.items()}
    want = {
        "image_deleter": inproc("image_deleter", "--input_path", scene,
                                "--output_path", path("del_in.npz"),
                                "--image_names_path", path("names.txt")),
        "image_deleter_db": inproc("image_deleter", "--database",
                                   path("db_in.sqlite"),
                                   "--image_names_path", path("names.txt")),
        "image_filterer": inproc("image_filterer", "--input_path", scene,
                                 "--output_path", path("filt_in.npz"),
                                 "--min_num_observations", min_obs),
        "undistort_cuda": inproc(*und, "--out", path("und_in.npy"),
                                 "--device", DEV)}
    for k, lines in want.items():
        assert got[k][0] == lines, (k, got[k][0], lines)
    assert got["undistort_cpu"][0] == want["undistort_cuda"]
    out["lines"] = {k: v[0][-1] for k, v in got.items()}
    for a, b in (("del_cli.npz", "del_in.npz"),
                 ("filt_cli.npz", "filt_in.npz")):
        assert same_reconstruction(
            Reconstruction.load(path(a), device="cpu"),
            Reconstruction.load(path(b), device="cpu")), a
    deleted = Reconstruction.load(path("del_cli.npz"), device="cpu")
    assert len(deleted.images) == len(rec.images) - RC_DELETE
    assert json.loads(out["lines"]["image_deleter_db"])["deleted"] == \
        RC_DELETE
    with FeatureDatabase(path("db_cli.sqlite")) as a, \
            FeatureDatabase(path("db_in.sqlite")) as b:
        assert list(a.iter_images()) == list(b.iter_images())
        assert a.num_images() == RC_DELETE
    out["filtered"] = out["lines"]["image_filterer"]
    card = np.load(path("und_cuda.npy"))
    assert np.array_equal(card, np.load(path("und_in.npy")))
    out["cuda_vs_cpu"] = float(np.abs(card - np.load(path("und_cpu.npy"))
                                      ).max())
    assert out["cuda_vs_cpu"] <= RC_GATES["undistort"], out["cuda_vs_cpu"]
    frames = torch.from_numpy(np.load(path("frames.npy"))).to(DEV).float()
    frames /= 255.0
    params = np.float32([MV_F, MV_F, MV_W / 2, MV_H / 2, *RC_LENS])
    ms, _ = cuda_median_ms(lambda: undistort_images(frames, "opencv",
                                                    params), 5)
    out["undistort_ms_per_image"] = ms / RC_UNDIST_N
    out["min_obs"] = min_obs
    return out


def ba_profile(rec, top: int = 10) -> dict:
    """torch.profiler over one bundle_adjust call on step 19's scene (its
    BAProblem, RC_PROFILE_ITERS LM steps): top device and host operations
    and the count of kernel launches."""
    from torch.profiler import ProfilerActivity, profile
    from cvt_tpu_torch.match import bundle as B
    prob = rec.to_ba_problem()[0]
    B.bundle_adjust(prob, iters=1, cg_iters=1, n_fixed_poses=2)      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        B.bundle_adjust(prob, iters=RC_PROFILE_ITERS, n_fixed_poses=2)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    ops, host = device_ops(prof), host_ops(prof)
    launches = sum(e.count for e in ev if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))
    return {"wall_ms": wall, "device_ms": sum(o[1] for o in ops),
            "top": ops[:top], "host": host[:top], "launches": launches,
            "obs": int(prob.cam_idx.numel())}


def run_reconstruction(stamp: str, match: dict) -> dict:
    """Steps 19-20 with their prints; returns the scene for the profile."""
    import tempfile
    t_all = time.perf_counter()
    zero_launch_counts()
    images, tables = match["images"], match["tables"]
    with tempfile.TemporaryDirectory() as tmp:
        rc = phase_reconstruct(images, tables, tmp)
        tr = rc["tracks"]
        print(f"tracks from {tr['pairs']} verified pairs "
              f"({tr['correspondences']} inlier correspondences): "
              f"{tr['count']} tracks, length mean {tr['mean_len']:.2f}, "
              f"median {tr['median_len']:.0f}, max {tr['max_len']}; "
              f"{tr['pure']:.4f} pure (gate {RC_GATES['pure']}); "
              f"build_tracks {rc['tracks_s']:.2f} s host {stamp}")
        c = rc["cameras"]
        print(f"camera models over {c['points']} keypoints: pinhole "
              f"image_to_world vs (uv - c) / f max {c['pinhole_err']:.3g}, "
              f"back {c['pinhole_back_px']:.3g} px; opencv (k1 "
              f"{RC_LENS[0]}, k2 {RC_LENS[1]}, p1 {RC_LENS[2]}, p2 "
              f"{RC_LENS[3]}) round trip max {c['opencv_back_px']:.3g} px "
              f"(gate {RC_GATES['lens_px']}), image_to_world "
              f"{c['opencv_ms']:.3f} ms (CUDA events), card vs CPU max "
              f"{c['card_vs_cpu']:.3g} (gate {RC_GATES['cam_cpu']}) "
              f"{stamp}")
        pn = rc["pnp"]
        print(f"true-pose triangulation: {rc['true_points']} points "
              f"(<= {RC_PX} px mean error), {rc['true_triangulate_s']:.2f} "
              f"s wall, {rc['true_triangulate_device_ms']:.2f} ms "
              f"triangulate_tracks (CUDA events) {stamp}")
        print(f"ransac_pnp per image ({RC_PX} px, 64 hypotheses): all "
              f"{len(pn)} registered (>= {RC_MIN_INLIERS} inliers); "
              f"inliers min {min(p['inliers'] for p in pn)} / median "
              f"{np.median([p['inliers'] for p in pn]):.0f}; rotation "
              f"error mean {np.mean([p['rot_deg'] for p in pn]):.4f}, max "
              f"{max(p['rot_deg'] for p in pn):.4f} deg (gate "
              f"{RC_GATES['pnp_rot_deg']}); centre error mean "
              f"{np.mean([p['centre'] for p in pn]):.5f}, max "
              f"{max(p['centre'] for p in pn):.5f} (gate "
              f"{RC_GATES['pnp_centre']}); {rc['pnp_s']:.2f} s {stamp}")
        print("  per image (image, observations, inliers, rotation deg, "
              "centre): " + "; ".join(
                  f"{p['image']} {p['obs']} {p['inliers']} "
                  f"{p['rot_deg']:.4f} {p['centre']:.5f}" for p in pn))
        b, a = rc["before"], rc["after"]
        print(f"bundle_adjust (20 LM x 30 CG, cameras 1-2 fixed; pose noise "
              f"{RC_ROT_NOISE} rad, {RC_T_NOISE} per axis): O {b['obs']}, "
              f"P {rc['points']}, C {rc['cameras_n']}; cost {b['cost']:.6g}"
              f" -> {a['cost']:.6g}; mean reprojection error "
              f"{b['mean_px']:.4f} -> {a['mean_px']:.4f} px (gate "
              f"{RC_GATES['ba_px']}); after alignment rotation error mean "
              f"{a['rot_mean_deg']:.5f}, max {a['rot_max_deg']:.5f} deg "
              f"(before max {b['rot_max_deg']:.4f}; gate "
              f"{RC_GATES['ba_rot_deg']}), centre error mean "
              f"{a['centre_mean']:.5f}, max {a['centre_max']:.5f} (before "
              f"max {b['centre_max']:.4f}; gate {RC_GATES['ba_centre']}) "
              f"{stamp}")
        print(f"bundle_adjust {rc['ba_s']:.3f} s wall, "
              f"{rc['ba_device_ms']:.2f} ms first launch to last (CUDA "
              f"events), {rc['ba_device_ms'] / 20:.2f} ms per LM step; "
              f"triangulation {rc['triangulate_s']:.3f} s with host packing,"
              f" {rc['triangulate_device_ms']:.2f} ms triangulate_tracks; "
              f"peak memory allocated {rc['peak_gb']:.3f} GB; filter_points "
              f"({RC_PX} px) removed {rc['filtered_points']} ("
              f"{rc['near_limit']} points within 1e-5 of the limit), "
              f"filter_images(10) removed {rc['filtered_images']} "
              f"({rc['filter_s']:.2f} s) {stamp}")
        cu = rc["cut"]
        print(f"bundle_adjust card vs CPU on {cu['images']} images, "
              f"{cu['points']} points: cost {cu['cost_card']:.8g} / "
              f"{cu['cost_cpu']:.8g} (rel {cu['cost_rel']:.3g}, gate "
              f"{RC_GATES['cut_cost_rtol']}), poses max "
              f"{cu['pose_max']:.3g} (gate {RC_GATES['cut_pose']}), points "
              f"max {cu['point_max']:.3g}, p99 {cu['point_p99']:.3g} (gate "
              f"{RC_GATES['cut_point']}); {cu['card_s']:.2f} s card, "
              f"{cu['cpu_s']:.2f} s CPU {stamp}")
        print(f"cluster_scene (inlier-weighted match graph, leaves <= "
              f"{RC_LEAF}): {len(rc['leaves'])} leaves of {rc['leaves']}; "
              f"save + load(device='cpu') {rc['save_load_s']:.2f} s, equal "
              f"{stamp}")
        print(f"step 19 took {rc['phase_s']:.1f} s {stamp}")
        cl = run_recon_cli(images, rc["_scene"], tmp)
    for name, line in cl["lines"].items():
        print(f"cli {name}: {line}")
    print(f"step 20: five commands in parallel {cl['wall_s']:.1f} s "
          f"(process wall clock: " + ", ".join(
              f"{k} {v:.1f}" for k, v in cl["process_s"].items())
          + f"); every line and file equals in-process; image_filterer at "
          f"{cl['min_obs']}; undistorted {RC_UNDIST_N} x {MV_H}x{MV_W}x3 "
          f"card vs CPU max {cl['cuda_vs_cpu']:.3g} (gate "
          f"{RC_GATES['undistort']}), {cl['undistort_ms_per_image']:.3f} "
          f"ms per image (CUDA events, in-process) {stamp}")
    launches = launch_counts()
    print(f"launches during steps 19-20: {launches} {stamp}")
    assert not any(launches.values()), launches
    print(f"steps 19-20 took {time.perf_counter() - t_all:.1f} s {stamp}")
    return {"rec": rc["_rec"]}


# ---------------------------------------------------------------------------
# steps 21-25: the features / apps slice


def procedural_on_card(n: int, h: int, w: int, seed: int,
                       dev=None) -> torch.Tensor:
    """io.datasets.procedural_images(n, h, w, seed=seed) built on `dev`:
    the same numpy draws in the same order on the host (the grids and
    rectangles, a few kB per image), the upsampling and rectangle sums
    in torch. Equal to the host function up to float32 rounding
    (checked at the start of step 21)."""
    dev = dev or DEV
    rng = np.random.default_rng(seed)
    out = torch.zeros((n, h, w), dtype=torch.float32, device=dev)

    def up(grid, hh, ww):
        gh, gw = grid.shape[1:]
        ys = torch.linspace(0, gh - 1, hh, dtype=torch.float32, device=dev)
        xs = torch.linspace(0, gw - 1, ww, dtype=torch.float32, device=dev)
        y0 = torch.clamp(ys.long(), max=gh - 2)
        x0 = torch.clamp(xs.long(), max=gw - 2)
        fy = (ys - y0)[None, :, None]
        fx = (xs - x0)[None, None, :]
        g = torch.from_numpy(grid).to(dev)
        a = g[:, y0][:, :, x0]
        b = g[:, y0][:, :, x0 + 1]
        c = g[:, y0 + 1][:, :, x0]
        d = g[:, y0 + 1][:, :, x0 + 1]
        return ((1 - fy) * ((1 - fx) * a + fx * b)
                + fy * ((1 - fx) * c + fx * d))

    amp = 1.0
    for o in range(6):
        gh, gw = max(2, h >> (o + 2)), max(2, w >> (o + 2))
        out += amp * up(rng.normal(size=(n, gh, gw)).astype(np.float32),
                        h, w)
        amp *= 1.35
    yy = torch.arange(h, device=dev)[None, :, None]
    xx = torch.arange(w, device=dev)[None, None, :]
    for _ in range(24):
        p = [torch.from_numpy(v.reshape(n, 1, 1)).to(dev) for v in (
            rng.integers(0, h - 8, size=(n, 1, 1)),
            rng.integers(0, w - 8, size=(n, 1, 1)),
            rng.integers(4, h // 2, size=(n, 1, 1)),
            rng.integers(4, w // 2, size=(n, 1, 1)),
            rng.uniform(-1.2, 1.2, size=(n, 1, 1)).astype(np.float32))]
        y0s, x0s, hs, ws, a = p
        out += a * ((yy >= y0s) & (yy < y0s + hs) & (xx >= x0s)
                    & (xx < x0s + ws))
    mn = torch.amin(out, dim=(1, 2), keepdim=True)
    mx = torch.amax(out, dim=(1, 2), keepdim=True)
    return (out - mn) / torch.clamp_min(mx - mn, 1e-6)


def procedural_batches(n: int, seed: int, chunk: int = 256, h: int = FEAT_H,
                       w: int = FEAT_W, dev=None):
    """procedural_on_card in chunks (seeds seed*1000 + chunk index, as
    procedural_corpus): yields [chunk, h, w] on `dev`."""
    for c in range(0, n, chunk):
        yield procedural_on_card(min(chunk, n - c), h, w,
                                 seed * 1000 + c // chunk, dev)


def similarity(scale: float, angle: float, tx: float, ty: float):
    """[2, 3] template -> image: rotate by angle, scale, then shift."""
    ca, sa = np.cos(angle) * scale, np.sin(angle) * scale
    return np.array([[ca, -sa, tx], [sa, ca, ty]], np.float32)


def paste(images: torch.Tensor, templates: torch.Tensor, models) -> None:
    """Paste templates[i] [th, tw] into images[i] under models[i] ([2, 3]
    template -> image), bilinear, in place; pixels outside the warped
    template keep the image."""
    b, h, w = images.shape
    th, tw = templates.shape[1:]
    dev = images.device
    inv = []
    for m in models:
        a = np.vstack([m, [0, 0, 1]]).astype(np.float64)
        inv.append(np.linalg.inv(a)[:2])
    inv = torch.tensor(np.stack(inv), dtype=torch.float32, device=dev)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    u = (inv[:, 0, 0, None, None] * xs + inv[:, 0, 1, None, None] * ys
         + inv[:, 0, 2, None, None])
    v = (inv[:, 1, 0, None, None] * xs + inv[:, 1, 1, None, None] * ys
         + inv[:, 1, 2, None, None])
    inside = (u >= 0) & (u <= tw - 1) & (v >= 0) & (v <= th - 1)
    grid = torch.stack([u / (tw - 1) * 2 - 1, v / (th - 1) * 2 - 1], -1)
    smp = torch.nn.functional.grid_sample(templates[:, None], grid,
                                          align_corners=True)[:, 0]
    images.copy_(torch.where(inside, smp, images))


def logo_scene(dev=None):
    """Step 21's set-up: LOGO_NAMES x LOGO_PER templates (LOGO_SIZE crops
    of procedural images) and LOGO_IMAGES procedural images, the pasted half
    (every odd image) each holding one template under a seeded similarity
    (scale 0.8-1.2, rotation +-10 degrees). The images' contrast is
    LOGO_BG_CONTRAST of the templates' (a mark on a softer scene, as the
    reference tests' frames at 0.2). Returns (templates {name:
    [arrays]}, images [n, H, W] on dev, the logo name of each image or
    None)."""
    dev = dev or DEV
    n_images = LOGO_IMAGES
    rng = np.random.default_rng(SEED + 21)
    src = procedural_on_card(LOGO_NAMES * LOGO_PER, FEAT_H, FEAT_W,
                             SEED + 2100, dev)
    crops = []
    for i in range(src.shape[0]):
        y, x = rng.integers(0, FEAT_H - LOGO_SIZE), rng.integers(
            0, FEAT_W - LOGO_SIZE)
        crops.append(src[i, y:y + LOGO_SIZE, x:x + LOGO_SIZE].clone())
    names = [f"logo{j}" for j in range(LOGO_NAMES)]
    templates = {nm: [crops[j * LOGO_PER + k].cpu().numpy()
                      for k in range(LOGO_PER)]
                 for j, nm in enumerate(names)}
    images = torch.cat(list(procedural_batches(n_images, SEED + 22,
                                               dev=dev)))
    images = images * LOGO_BG_CONTRAST + (1 - LOGO_BG_CONTRAST) / 2
    truth, sel, models = [None] * n_images, [], []
    for i in range(1, n_images, 2):
        t = int(rng.integers(LOGO_NAMES * LOGO_PER))
        s = rng.uniform(0.8, 1.2)
        a = np.deg2rad(rng.uniform(-10, 10))
        half = LOGO_SIZE * s * 0.75
        cx = rng.uniform(half, FEAT_W - half)
        cy = rng.uniform(half, FEAT_H - half)
        m = similarity(s, a, 0, 0)
        c = m[:, :2] @ [LOGO_SIZE / 2, LOGO_SIZE / 2]
        m[:, 2] = [cx - c[0], cy - c[1]]
        truth[i] = names[t // LOGO_PER]
        sel.append((i, t))
        models.append(m)
    idx = torch.tensor([i for i, _ in sel], device=dev)
    tmpl = torch.stack([crops[t] for _, t in sel])
    part = images[idx]
    paste(part, tmpl, models)
    images[idx] = part
    return templates, images, truth


def video_clip(template: torch.Tensor):
    """Step 21's clip: VIDEO_T frames of one procedural background (the
    logo scene's contrast) with seeded per-frame noise (sd 0.01); frames
    VIDEO_IN[0]..VIDEO_IN[1]-1 hold the template moving along a straight
    line. Returns (frames [T, H, W] on the template's device, the frames
    that hold it)."""
    dev = template.device
    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    bg = procedural_on_card(1, FEAT_H, FEAT_W, SEED + 2300, dev)[0]
    bg = bg * LOGO_BG_CONTRAST + (1 - LOGO_BG_CONTRAST) / 2
    frames = bg[None].repeat(VIDEO_T, 1, 1)
    frames += 0.01 * torch.randn(frames.shape, generator=g, device=dev)
    lo, hi = VIDEO_IN
    ids = list(range(lo, hi))
    models = []
    for j, _ in enumerate(ids):
        f = j / max(len(ids) - 1, 1)
        models.append(similarity(1.0, 0.0, 40 + f * (FEAT_W - 240),
                                 40 + f * (FEAT_H - 240)))
    part = frames[lo:hi]
    paste(part, template[None].expand(len(ids), -1, -1).contiguous(), models)
    frames[lo:hi] = part
    return frames.clamp_(0.0, 1.0), set(ids)


def timed(fn):
    """(result, seconds) of fn() with the card synchronized around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_logo_video(tmp: str) -> dict:
    """Step 21: LogoDetector over the logo scene in batches, its pack on
    the CPU, VideoObjectMatcher over the clip with and without the HOG
    signal, match_video from a file and from bytes where a decoder
    exists."""
    from cvt_tpu_torch.apps.template_match import LogoDetector
    from cvt_tpu_torch.apps.video_match import VideoObjectMatcher
    from cvt_tpu_torch.features.covdet import extract_sift
    from cvt_tpu_torch.io import video as vid
    from cvt_tpu_torch.io.datasets import procedural_images
    res = {}
    host = procedural_images(2, 64, 80, seed=7)
    card = procedural_on_card(2, 64, 80, 7).cpu().numpy()
    res["gen_err"] = float(np.abs(host - card).max())
    assert res["gen_err"] < 1e-5, res["gen_err"]
    templates, images, truth = logo_scene()
    det, res["templates_s"] = timed(lambda: LogoDetector(templates,
                                                         device=DEV))
    hits, t_all = [], 0.0
    for s in range(0, LOGO_IMAGES, LOGO_B):
        out, dt = timed(lambda: det.detect(images[s:s + LOGO_B]))
        hits += out
        t_all += dt
    # the split of one batch: extraction, then every template's match
    feats, t_ext = timed(lambda: extract_sift(images[:LOGO_B], rootsift=True))
    _, t_ver = timed(lambda: [m.match_features(feats) for ms in
                              det.matchers.values() for m in ms])
    pasted = [i for i, tr in enumerate(truth) if tr is not None]
    clean = [i for i, tr in enumerate(truth) if tr is None]
    res["logo_recall"] = np.mean([truth[i] in hits[i] for i in pasted])
    res["logo_wrong"] = sum(any(k != truth[i] for k in hits[i])
                            for i in pasted)
    res["logo_false"] = np.mean([bool(hits[i]) for i in clean])
    res["logo_inliers"] = sorted(hits[i].get(truth[i], 0) for i in pasted)
    res["logo_s"] = t_all
    res["logo_split_ms"] = (t_ext * 1e3, t_ver * 1e3)
    res["logo_images_per_s"] = LOGO_IMAGES / t_all
    assert res["logo_recall"] >= LOGO_GATES["recall"], res
    assert res["logo_false"] <= LOGO_GATES["false"], res
    pack = os.path.join(tmp, "logos.npz")
    det.save(pack)
    cpu_det = LogoDetector.load(pack, device="cpu")
    some = list(range(LOGO_CPU))
    cpu_hits, res["logo_cpu_s"] = timed(
        lambda: cpu_det.detect(images[some].cpu()))
    res["logo_cpu_equal"] = [set(h) for h in cpu_hits] == [
        set(hits[i]) for i in some]
    assert res["logo_cpu_equal"], (cpu_hits, [hits[i] for i in some])
    res["_detector"], res["_batch"] = det, images[:LOGO_B]

    template = torch.from_numpy(templates["logo0"][0]).to(DEV)
    frames, inside = video_clip(template)
    outside = set(range(VIDEO_T)) - inside
    for name, kw in (("sift", {}), ("hog", dict(hog_threshold=VIDEO_HOG))):
        vm = VideoObjectMatcher(template, device=DEV, **kw)
        ids, t_all = [], 0.0
        for s in range(0, VIDEO_T, VIDEO_B):
            r, dt = timed(lambda: vm.match_frames(frames[s:s + VIDEO_B]))
            ids += (r.frame_ids + s).tolist()
            t_all += dt
        # the split of one chunk: extraction, then verification
        feats, ext = timed(lambda: extract_sift(
            frames[:VIDEO_B], max_features=vm.matcher.max_features,
            rootsift=True))
        _, ver = timed(lambda: vm.matcher.match_features(feats))
        got = set(ids)
        res[f"video_{name}"] = dict(
            hit_in=len(got & inside) / len(inside),
            hit_out=len(got - inside) / len(outside), s=t_all,
            split_ms=(ext * 1e3, ver * 1e3), fps=VIDEO_T / t_all,
            hits=sorted(got))
        assert res[f"video_{name}"]["hit_in"] >= VIDEO_GATES["in"], res
        assert res[f"video_{name}"]["hit_out"] <= VIDEO_GATES["out"], res
    res["video_file"] = None
    try:
        path = os.path.join(tmp, "clip.mp4")
        vid.write_video(path, frames.cpu().numpy(), fps=25.0)
    except RuntimeError as e:
        res["video_file"] = f"did not run: {e}"
    if res["video_file"] is None:
        vm = VideoObjectMatcher(template, device=DEV, batch_size=VIDEO_B)
        want = res["video_sift"]["hits"]
        runs = {}
        for src, data in (("file", path), ("bytes", open(path, "rb").read())):
            r, dt = timed(lambda: vm.match_video(data))
            runs[src] = dict(n=int(r.n_frames), hits=r.frame_ids.tolist(),
                             s=dt)
            got = r.frame_ids.tolist()
            ok = (abs(len(got) - len(want)) <= 2 and got and
                  abs(got[0] - want[0]) <= 2 and abs(got[-1] - want[-1]) <= 2)
            assert r.n_frames == VIDEO_T and ok, (src, got, want)
        backend = "native ffdecode" if vid._native_lib() else "cv2"
        res["video_file"] = dict(runs, backend=backend)
    return res


def phase_phash() -> dict:
    """Step 22: resize_gray_32 + phash over PHASH_N procedural images in
    batches, hamming_distance of PHASH_EDITS photometric edits against
    all, the card against the CPU on PHASH_CPU images, is_pure_image."""
    import importlib
    ph = importlib.import_module("cvt_tpu_torch.apps.phash")
    g = torch.Generator(device=DEV).manual_seed(SEED + 22)
    hashes, edit_hashes, src_ids = [], [], []
    t_hash, first = 0.0, None
    for c, batch in enumerate(procedural_batches(PHASH_N, SEED + 220,
                                                 chunk=PHASH_B)):
        h, dt = timed(lambda: ph.phash(ph.resize_gray_32(batch)))
        hashes.append(h)
        t_hash += dt
        sel = torch.arange(0, batch.shape[0], PHASH_EVERY, device=DEV)
        n = sel.numel()
        gain = 0.7 + 0.6 * torch.rand((n, 1, 1), generator=g, device=DEV)
        off = -0.15 + 0.3 * torch.rand((n, 1, 1), generator=g, device=DEV)
        noise = 0.02 * torch.randn((n,) + batch.shape[1:], generator=g,
                                   device=DEV)
        edited = (batch[sel] * gain + off + noise).clamp(0, 1)
        edit_hashes.append(ph.phash(ph.resize_gray_32(edited)))
        src_ids.append(sel + c * PHASH_B)
        if first is None:
            first = batch[:PHASH_CPU].cpu()
    db = torch.cat(hashes)
    q = torch.cat(edit_hashes)
    src = torch.cat(src_ids)
    dist = ph.hamming_distance(q, db)
    top1 = torch.argmin(dist, 1)                      # the first minimum
    res = dict(hash_s=t_hash, images_per_s=PHASH_N / t_hash,
               hamming_ms=cuda_median_ms(
                   lambda: ph.hamming_distance(q, db), 10)[0],
               shape=tuple(dist.shape),
               top1=float((top1 == src).float().mean()),
               src_dist_median=float(torch.median(
                   dist[torch.arange(len(src)), src].float())),
               other_dist_median=float(torch.median(dist.float())))
    assert res["top1"] >= PHASH_GATES["top1"], res
    coef = ph.dct_block(ph.resize_gray_32(first)).numpy()
    near = np.abs(coef - coef.mean(-1, keepdims=True)) < 1e-5
    h_cpu = ph.phash(ph.resize_gray_32(first)).numpy()
    differ = np.unpackbits((h_cpu ^ db[:PHASH_CPU].cpu().numpy()).view(
        np.uint8), bitorder="little").reshape(near.shape).astype(bool)
    res["cpu_bits_differ"] = int(differ.sum())
    res["cpu_near_mean_bits"] = int(near.sum())
    assert not np.any(differ & ~near), "phash: card differs from CPU"
    const = torch.rand((PHASH_PURE, 1, 1), generator=g, device=DEV) * 255
    const = const.expand(-1, FEAT_H, FEAT_W)
    textured = next(procedural_batches(PHASH_PURE, SEED + 221)) * 255
    pure = ph.is_pure_image(torch.cat([const, textured]))
    res["pure_right"] = int(pure[:PHASH_PURE].sum()
                            + (~pure[PHASH_PURE:]).sum())
    assert res["pure_right"] == 2 * PHASH_PURE, res
    return res


def planted_head():
    """Step 23's FastestDet head [DET_B, 22, 22, 85]: background logits
    (objectness ~ N(-4, 1)), DET_PLANT boxes per image at cells at least
    5 apart, each of its own class with objectness 5 and class logit 8."""
    rng = np.random.default_rng(SEED + 230)
    hw = DET_IN // DET_STRIDE
    head = rng.normal(size=(DET_B, hw, hw, 5 + DET_CLASSES)).astype(
        np.float32)
    head[..., 0] -= 4.0
    head[..., 3:5] = -1.5                     # boxes ~0.18 of the input
    planted = []
    cells = [(y, x) for y in range(1, hw, 5) for x in range(1, hw, 5)]
    for b in range(DET_B):
        pick = rng.choice(len(cells), DET_PLANT, replace=False)
        cls = rng.choice(DET_CLASSES, DET_PLANT, replace=False)
        for p, c in zip(pick, cls):
            y, x = cells[p]
            head[b, y, x, 0] = 5.0
            head[b, y, x, 5 + c] = 8.0
            planted.append((b, y * hw + x))
    return head, planted


def phase_detect_motion_pupil() -> dict:
    """Step 23: decode + NMS at FastestDet's head shape, the motion area
    of a picture-in-picture clip, find_pupil on render_eye crops."""
    from cvt_tpu_torch.apps import detect, motion_area, pupil
    from cvt_tpu_torch.ops.topk import top_k_largest
    res = {}
    head, planted = planted_head()
    head_dev = torch.from_numpy(head).to(DEV)
    run = lambda h: detect.nms(detect.decode_fastestdet(  # noqa: E731
        h, max_dets=DET_MAX))
    out = run(head_dev)
    res["det_ms"] = cuda_median_ms(lambda: run(head_dev), 10)[0]
    cpu = run(torch.from_numpy(head))
    res["det_keep_equal"] = bool(torch.equal(out.valid.cpu(), cpu.valid))
    assert res["det_keep_equal"]
    assert bool(torch.allclose(out.scores.cpu(), cpu.scores, atol=1e-6))
    # each planted cell must sit in a kept slot
    hw = DET_IN // DET_STRIDE
    score = torch.sigmoid(head_dev[..., 0]) * torch.softmax(
        head_dev[..., 5:], -1).amax(-1)
    _, topi = top_k_largest(torch.sqrt(score).reshape(DET_B, -1), DET_MAX)
    kept = {(b, int(topi[b, k])) for b, k in
            torch.nonzero(out.valid).tolist()}
    res["det_planted_kept"] = sum(p in kept for p in planted)
    res["det_planted"] = len(planted)
    res["det_kept"] = int(out.valid.sum())
    res["det_decoded"] = int(detect.decode_fastestdet(
        head_dev, max_dets=DET_MAX).valid.sum())
    assert res["det_planted_kept"] == len(planted), res
    assert hw == 22

    g = torch.Generator(device=DEV).manual_seed(SEED + 231)
    bg = procedural_on_card(1, FEAT_H, FEAT_W, SEED + 2310)[0]
    big = procedural_on_card(1, FEAT_H * 2, FEAT_W * 2, SEED + 2311)[0]
    frames = bg[None].repeat(MOTION_T, 1, 1)
    frames += 0.01 * torch.randn(frames.shape, generator=g, device=DEV)
    x1, y1 = MOTION_BOX[:2]
    ph_, pw = MOTION_BOX[3] - y1, MOTION_BOX[2] - x1
    for t_ in range(MOTION_T):
        oy, ox = (3 * t_) % (FEAT_H * 2 - ph_), (2 * t_) % (FEAT_W * 2 - pw)
        frames[t_, y1:y1 + ph_, x1:x1 + pw] = big[oy:oy + ph_, ox:ox + pw]
    frames.clamp_(0, 1)
    mb, dt = timed(lambda: motion_area.detect_motion_area(frames))
    res["motion_box"] = mb.box.tolist()
    res["motion_cov"] = float(mb.coverage)
    res["motion_ms"] = dt * 1e3
    res["motion_err"] = int(np.abs(np.array(res["motion_box"])
                                   - MOTION_BOX).max())
    assert res["motion_err"] <= MOTION_GATE_PX, res
    res["motion_topk"], _ = motion_area.find_topk_boxes(frames, 3)

    rng = np.random.default_rng(SEED + 232)
    truth = np.stack([rng.uniform(45, 83, PUPIL_N), rng.uniform(38, 58,
                                                                PUPIL_N)], 1)
    eyes = np.stack([pupil.render_eye(
        cx=float(cx), cy=float(cy), a=float(rng.uniform(9, 15)),
        b=float(rng.uniform(7, 11)), angle=float(rng.uniform(-1.2, 1.2)))
        for cx, cy in truth])
    eyes_dev = torch.from_numpy(eyes).to(DEV)
    gen = torch.Generator().manual_seed(SEED)
    pr, dt = timed(lambda: pupil.find_pupil(gen, eyes_dev))
    err = np.linalg.norm(pr.center.cpu().numpy() - truth, axis=1)
    good = pr.ok.cpu().numpy() & (err <= PUPIL_GATES["px"])
    res.update(pupil_ms=dt * 1e3, pupil_good=float(good.mean()),
               pupil_err_median=float(np.median(err)),
               pupil_ok=float(pr.ok.float().mean()))
    assert res["pupil_good"] >= PUPIL_GATES["good"], res
    ed = pupil.pupil_edges(eyes_dev[:PUPIL_CPU])
    ec = pupil.pupil_edges(eyes[:PUPIL_CPU], device="cpu")
    picks = pupil.sample_edge_picks(torch.Generator().manual_seed(1),
                                    ec.valid, 64)
    rg, rc = pupil.fit_pupil(ed, picks.to(DEV)), pupil.fit_pupil(ec, picks)
    res["pupil_cpu_centre"] = float(np.abs(
        rg.center.cpu().numpy() - rc.center.numpy()).max())
    res["pupil_cpu_inliers_equal"] = bool(torch.equal(rg.n_inliers.cpu(),
                                                      rc.n_inliers))
    res["pupil_cpu_edges_equal"] = bool(torch.equal(ed.valid.cpu(),
                                                    ec.valid))
    assert res["pupil_cpu_edges_equal"] and res["pupil_cpu_inliers_equal"]
    assert res["pupil_cpu_centre"] <= 1e-4, res
    return res


def lines_tolerance():
    """tests/_lines_tolerance.py (numpy only): the line detector's
    rectangle tolerances, shared with the CPU parity tests."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "_lines_tolerance.py")
    spec = importlib.util.spec_from_file_location("_lines_tolerance", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_lines() -> dict:
    """Step 24: detect_line_segments on LSD_N procedural images at
    640 x 480, 128 segments; LSD_CPU of them on the CPU."""
    from cvt_tpu_torch.features import lines
    x = next(procedural_batches(LSD_N, SEED + 240))
    lines.detect_line_segments(x[:2], max_segments=LSD_K)            # warm
    out, dt = timed(lambda: lines.detect_line_segments(x, max_segments=LSD_K))
    res = dict(ms_per_image=dt * 1e3 / LSD_N,
               steps=lines.last_propagation_steps,
               valid_mean=float(out.valid.sum(1).float().mean()))
    xc = x[:LSD_CPU].cpu()
    cpu, res["cpu_s"] = timed(lambda: lines.detect_line_segments(
        xc, max_segments=LSD_K))
    res["cpu_steps"] = lines.last_propagation_steps
    one = lines.detect_line_segments(x[:LSD_CPU], max_segments=LSD_K)
    res["card_steps_2"] = lines.last_propagation_steps
    assert res["cpu_steps"] == res["card_steps_2"], res
    # arctan2 differs by an ulp between the card and the CPU: a pixel pair
    # whose angle difference lies that close to tau may join on one only.
    # Such near-tie pixels are counted; the components they touch may
    # give other rectangles, or move in the count ranking (so segments are
    # matched as sets), and nothing else may differ
    tau = float(np.float32(np.deg2rad(22.5)))
    ang, mag = lines._level_lines(xc)
    lab_c, _ = lines._components(ang, mag > 0.02, tau)
    lab_g, _ = lines._components(ang.to(DEV), mag.to(DEV) > 0.02, tau)
    ang_g, mag_g = lines._level_lines(x[:LSD_CPU])
    lab_own, _ = lines._components(ang_g, mag_g > 0.02, tau)
    lab_g, lab_own = lab_g.cpu(), lab_own.cpu()
    assert torch.equal(lab_g, lab_c), "labels: card differs on equal angles"
    differ = lab_own != lab_c
    res["angle_max_diff"] = float((ang_g.cpu() - ang).abs().max())
    res["label_pixels_differ"] = int(differ.sum())
    res["components_touched"] = len(
        set(lab_c[differ].tolist()) | set(lab_own[differ].tolist()))
    tol = lines_tolerance()
    res["unmatched"] = sum(
        tol.unmatched_segments(*(tol._numpy(type(s)(*(a[b] for a in s)))
                                 for s in (one, cpu)))
        for b in range(LSD_CPU))
    assert res["unmatched"] <= 2 * res["components_touched"], res
    assert bool(torch.isfinite(out.nfa).all()) and res["valid_mean"] > 10
    return res


def rgb(gray: torch.Tensor) -> torch.Tensor:
    """[B, H, W] gray in [0, 1] -> [B, H, W, 3]: three tone curves."""
    return torch.stack([gray, gray ** 1.5, 1.0 - gray], -1)


def phase_embeddings() -> dict:
    """Step 25: the simple CNN over EMB_N procedural images, its vectors
    in ScalarQuantizer + FlatSQIndex (search_fast and bf16 search against
    exact FlatIndex ground truth), the cached kernel against its twin at
    this path's arguments; then TextEmbedder at fastText's width."""
    from cvt_tpu_torch.features.embedding import EmbeddingExtractor
    from cvt_tpu_torch.features.text import TextEmbedder, embed_ids
    from cvt_tpu_torch.index import FlatIndex, FlatSQIndex
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    from cvt_tpu_torch.ops.linalg import l2_normalize
    from cvt_tpu_torch.quant import ScalarQuantizer
    from cvt_tpu_torch.utils import recall_at_k
    res = {}
    ext = EmbeddingExtractor.simple_cnn(dim=EMB_DIM, input_size=224,
                                        device=DEV)
    torch.cuda.reset_peak_memory_stats()
    embs, t_cnn, first = [], 0.0, None
    for batch in procedural_batches(EMB_N, SEED + 250, chunk=512):
        x = rgb(batch)
        e, dt = timed(lambda: ext.compute(x, batch_size=EMB_B))
        embs.append(e)
        t_cnn += dt
        if first is None:
            first = x[:EMB_CPU].cpu()
    emb = torch.cat(embs)
    res.update(images_per_s=EMB_N / t_cnn, cnn_s=t_cnn,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    norms = torch.linalg.vector_norm(emb, dim=1)
    assert float((norms - 1).abs().max()) <= 1e-4
    cpu_ext = EmbeddingExtractor._from_weights(
        [w.permute(2, 3, 1, 0).cpu() for w in ext.fn.convs],
        ext.fn.head.cpu(), device="cpu")
    e_cpu = cpu_ext.compute(first, batch_size=EMB_CPU)
    res["cpu_err"] = float((emb[:EMB_CPU].cpu() - e_cpu).abs().max())
    assert res["cpu_err"] <= 1e-4 * float(e_cpu.abs().max()), res

    g = torch.Generator(device=DEV).manual_seed(SEED + 251)
    src = torch.randint(0, EMB_N, (EMB_Q,), generator=g, device=DEV)
    q = l2_normalize(emb[src] + EMB_NOISE * torch.randn(
        (EMB_Q, EMB_DIM), generator=g, device=DEV))
    exact = FlatIndex(EMB_DIM, "l2", device=DEV)
    exact.add(emb)
    gt = exact.search(q, 1)[1][:, 0].cpu()
    sq = ScalarQuantizer.train(emb)
    idx = FlatSQIndex(sq, mode="bf16")
    idx.add(emb)
    T.adc_segmin_cached.launches = 0
    d_f, i_f = idx.search_fast(q, EMB_K)
    torch.cuda.synchronize()
    res["launches"] = T.adc_segmin_cached.launches
    d_b, i_b = idx.search(q, EMB_K)
    for name, (d, i) in (("fast", (d_f, i_f)), ("bf16", (d_b, i_b))):
        assert int(i.min()) >= 0 and int(i.max()) < EMB_N, name
        assert bool(torch.isfinite(d).all()), name
        res[f"recall_at_10_{name}"] = recall_at_k(i, gt, k=10)
        res[f"recall_at_1_{name}"] = recall_at_k(i, gt, k=1)
    res["parity_pt"] = 100 * (res["recall_at_10_bf16"]
                              - res["recall_at_10_fast"])
    assert res["launches"] > 0, "the cached kernel never launched"
    assert abs(res["parity_pt"]) <= 1.0, res
    args = sq_kernel_args(idx, q)
    res["cmp"] = compare_kernel_to_twin(
        T.adc_segmin_cached, T.adc_segmin_cached_plain, args,
        args[3][:, 0], args[1], args[5], args[6])
    res["fast_ms"] = cuda_median_ms(lambda: idx.search_fast(q, EMB_K), 10)[0]
    res["bf16_ms"] = cuda_median_ms(lambda: idx.search(q, EMB_K), 10)[0]
    res["kernel_ms"] = cuda_median_ms(lambda: T.adc_segmin_cached(*args),
                                      20)[0]
    res["plain_ms"] = cuda_median_ms(
        lambda: T.adc_segmin_cached_plain(*args), 3)[0]
    res["bound"] = share(res["kernel_ms"], adc_bound(args, cached=True))
    res["npad"], res["tile"] = args[2].shape[1], args[5]

    rng = np.random.default_rng(SEED + 252)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))

    def words(n):
        lens = rng.integers(3, 11, n)
        chars = letters[rng.integers(0, 26, int(lens.sum()))]
        cut = np.cumsum(lens)[:-1]
        return ["".join(c) for c in np.split(chars, cut)]
    vocab = list(dict.fromkeys(words(TEXT_VOCAB * 2)))[:TEXT_VOCAB]
    known = set(vocab)
    oov = [w + "q" for w in words(TEXT_SENTS) if w + "q" not in known]
    te, res["text_build_s"] = timed(lambda: TextEmbedder.random(
        vocab, dim=TEXT_DIM, n_buckets=TEXT_BUCKETS, seed=SEED,
        device=DEV))
    toks = rng.integers(0, TEXT_VOCAB, (TEXT_SENTS, TEXT_LEN))
    is_oov = rng.random((TEXT_SENTS, TEXT_LEN)) < TEXT_OOV
    sents = [" ".join(oov[j % len(oov)] if is_oov[i, j] else vocab[t]
                      for j, t in enumerate(row))
             for i, row in enumerate(toks)]
    s_emb, res["sentences_s"] = timed(lambda: te.embed_sentences(sents))
    cpu_te = TextEmbedder(te.vocab, te.vectors.cpu(), te.ngrams.cpu(),
                          device="cpu")
    res["text_cpu_err"] = float((s_emb.cpu() - cpu_te.embed_sentences(
        sents)).abs().max())
    ids = torch.randint(0, TEXT_VOCAB, TEXT_IDS, generator=g, device=DEV)
    mask = (torch.rand(TEXT_IDS, generator=g, device=DEV) < 0.8).float()
    out_ids = embed_ids(te.vectors, ids, mask)
    res["ids_ms"] = cuda_median_ms(lambda: embed_ids(te.vectors, ids, mask),
                                   10)[0]
    res["ids_cpu_err"] = float((out_ids.cpu() - embed_ids(
        cpu_te.vectors, ids.cpu(), mask.cpu())).abs().max())
    res["oov_share"] = float(is_oov.mean())
    assert res["text_cpu_err"] <= 1e-6 and res["ids_cpu_err"] <= 1e-6, res
    return res


def apps_profile(det, batch: torch.Tensor, top: int = 10) -> dict:
    """torch.profiler over one step-21 batch (LogoDetector.detect on
    LOGO_B images): top device and host operations by self time."""
    from torch.profiler import ProfilerActivity, profile
    det.detect(batch)                                         # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        det.detect(batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ops, host = device_ops(prof), host_ops(prof)
    return {"wall_ms": wall, "device_ms": sum(o[1] for o in ops),
            "top": ops[:top], "host": host[:top]}


def run_apps(stamp: str) -> dict:
    """Steps 21-25 with their prints; the three kernels' counts are zeroed
    before step 21 and read after step 25. Returns the step-21 batch for
    the profile and step 25's kernel figures for the kernels line."""
    import tempfile
    t_all = time.perf_counter()
    zero_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        lv, dt = timed(lambda: phase_logo_video(tmp))
    print(f"step 21 data: procedural_on_card vs procedural_images max "
          f"{lv['gen_err']:.3g}; {LOGO_NAMES} logos x {LOGO_PER} templates "
          f"({LOGO_SIZE} x {LOGO_SIZE}) in {lv['templates_s']:.2f} s {stamp}")
    print(f"LogoDetector.detect over {LOGO_IMAGES} images {FEAT_W} x "
          f"{FEAT_H} in batches of {LOGO_B}: pasted flagged with the right "
          f"logo {lv['logo_recall']:.4f} (gate {LOGO_GATES['recall']}), "
          f"with a wrong logo {lv['logo_wrong']}, clean flagged "
          f"{lv['logo_false']:.4f} (gate {LOGO_GATES['false']}); inliers "
          f"min {lv['logo_inliers'][0]} / median "
          f"{np.median(lv['logo_inliers']):.0f}; {lv['logo_s']:.2f} s, "
          f"{lv['logo_images_per_s']:.1f} images/s; one batch split: "
          f"extract_sift {lv['logo_split_ms'][0]:.1f} ms, the "
          f"{LOGO_NAMES * LOGO_PER} templates' match_features "
          f"{lv['logo_split_ms'][1]:.1f} ms; pack loaded on "
          f"the CPU: the same hits on {LOGO_CPU} images "
          f"({lv['logo_cpu_s']:.1f} s) {stamp}")
    for name in ("sift", "hog"):
        v = lv[f"video_{name}"]
        print(f"VideoObjectMatcher.match_frames ({name}"
              + (f", hog_threshold {VIDEO_HOG}" if name == "hog" else "")
              + f") over {VIDEO_T} frames in chunks of {VIDEO_B}: frames "
              f"{VIDEO_IN[0]}-{VIDEO_IN[1] - 1} hit {v['hit_in']:.4f} (gate "
              f"{VIDEO_GATES['in']}), others {v['hit_out']:.4f} (gate "
              f"{VIDEO_GATES['out']}); {v['fps']:.1f} frames/s; one chunk "
              f"split: extract_sift {v['split_ms'][0]:.1f} ms, "
              f"match_features {v['split_ms'][1]:.1f} ms {stamp}")
    vf = lv["video_file"]
    if isinstance(vf, str):
        print(f"match_video from a file and from bytes {vf} {stamp}")
    else:
        print(f"match_video ({vf['backend']}) from a file: "
              f"{len(vf['file']['hits'])} hits in {vf['file']['s']:.2f} s, "
              f"from bytes: {len(vf['bytes']['hits'])} hits in "
              f"{vf['bytes']['s']:.2f} s; the in-memory frames' hits +- 2 "
              f"{stamp}")
    print(f"step 21 took {dt:.1f} s {stamp}")

    ph, dt = timed(phase_phash)
    print(f"phash over {PHASH_N} procedural images {FEAT_W} x {FEAT_H} in "
          f"batches of {PHASH_B}: resize_gray_32 + phash {ph['hash_s']:.3f} "
          f"s, {ph['images_per_s']:.0f} images/s; hamming_distance "
          f"{ph['shape'][0]} x {ph['shape'][1]} {ph['hamming_ms']:.3f} ms "
          f"(median of 10); "
          f"source top-1 for {ph['top1']:.4f} of photometric edits (gate "
          f"{PHASH_GATES['top1']}), Hamming to the source median "
          f"{ph['src_dist_median']:.0f}, to all median "
          f"{ph['other_dist_median']:.0f}; card vs CPU on {PHASH_CPU} images:"
          f" {ph['cpu_bits_differ']} bits differ, {ph['cpu_near_mean_bits']}"
          f" near-mean bits; is_pure_image {ph['pure_right']} of "
          f"{2 * PHASH_PURE} right; step 22 took {dt:.1f} s {stamp}")

    dm, dt = timed(phase_detect_motion_pupil)
    print(f"decode_fastestdet + nms at {DET_IN} x {DET_IN} / {DET_STRIDE} "
          f"(22 x 22 x {5 + DET_CLASSES}), B {DET_B}, max_dets {DET_MAX}: "
          f"{dm['det_ms']:.3f} ms (median, CUDA events); decoded "
          f"{dm['det_decoded']}, kept {dm['det_kept']}; planted kept "
          f"{dm['det_planted_kept']} of {dm['det_planted']}; keep masks "
          f"equal on the CPU {dm['det_keep_equal']} {stamp}")
    print(f"detect_motion_area on {MOTION_T} x {FEAT_H} x {FEAT_W}: box "
          f"{dm['motion_box']} (true {list(MOTION_BOX)}, max error "
          f"{dm['motion_err']} px, gate {MOTION_GATE_PX}), coverage "
          f"{dm['motion_cov']:.4f}, {dm['motion_ms']:.2f} ms; "
          f"find_topk_boxes(3) {dm['motion_topk']} {stamp}")
    print(f"find_pupil on {PUPIL_N} render_eye crops 96 x 128: ok "
          f"{dm['pupil_ok']:.4f}, ok and centre <= {PUPIL_GATES['px']} px "
          f"{dm['pupil_good']:.4f} (gate {PUPIL_GATES['good']}), centre "
          f"error median {dm['pupil_err_median']:.3f} px, "
          f"{dm['pupil_ms']:.1f} ms; {PUPIL_CPU} crops on the CPU core "
          f"with the same picks: centre max {dm['pupil_cpu_centre']:.3g} px"
          f", inliers equal {dm['pupil_cpu_inliers_equal']}; step 23 took "
          f"{dt:.1f} s {stamp}")

    ln, dt = timed(phase_lines)
    print(f"detect_line_segments on {LSD_N} procedural {FEAT_W} x {FEAT_H}"
          f", {LSD_K} segments: {ln['ms_per_image']:.2f} ms per image, "
          f"label propagation {ln['steps']} steps, {ln['valid_mean']:.1f} "
          f"valid segments per image; {LSD_CPU} images on the CPU "
          f"({ln['cpu_s']:.1f} s, {ln['cpu_steps']} steps): angles max "
          f"{ln['angle_max_diff']:.3g} apart, labels equal on equal "
          f"angles, {ln['label_pixels_differ']} pixels labelled otherwise "
          f"(near ties at tau) in {ln['components_touched']} components, "
          f"{ln['unmatched']} segments without a partner within the "
          f"rectangle tolerances (gate: <= 2 per touched component); step "
          f"24 took {dt:.1f} s {stamp}")

    em, dt = timed(phase_embeddings)
    print(f"EmbeddingExtractor.simple_cnn(dim {EMB_DIM}, 224) over {EMB_N} "
          f"procedural {FEAT_W} x {FEAT_H} x 3 in batches of {EMB_B}: "
          f"{em['images_per_s']:.1f} images/s, peak memory allocated "
          f"{em['peak_gb']:.3f} GB; card vs CPU on {EMB_CPU} images max "
          f"{em['cpu_err']:.3g} {stamp}")
    print(f"embeddings -> ScalarQuantizer + FlatSQIndex ({EMB_N} x "
          f"{EMB_DIM}), {EMB_Q} noisy copies, k {EMB_K}: recall@10 "
          f"search_fast {em['recall_at_10_fast']:.4f}, bf16 "
          f"{em['recall_at_10_bf16']:.4f} (parity {em['parity_pt']:.2f} pt,"
          f" limit 1.0); search_fast {em['fast_ms']:.3f} ms, bf16 "
          f"{em['bf16_ms']:.3f} ms; adc_segmin_cached launched "
          f"{em['launches']} time(s) by the search {stamp}")
    print_compare(f"embeddings path's arguments, Npad={em['npad']} "
                  f"B={EMB_Q} tile {em['tile']}",
                  {"adc_segmin_cached": em["cmp"]}, stamp)
    print(f"adc_segmin_cached at the embeddings path: kernel "
          f"{em['kernel_ms']:.4f} ms, twin {em['plain_ms']:.3f} ms {stamp}")
    print_bound("adc_segmin_cached", f"the embeddings path (Npad "
                f"{em['npad']}, Bpad {EMB_Q}, tile {em['tile']})",
                em["bound"], stamp)
    print(f"TextEmbedder dim {TEXT_DIM}, {TEXT_BUCKETS} buckets, vocabulary "
          f"{TEXT_VOCAB}: built in {em['text_build_s']:.1f} s; "
          f"embed_sentences over {TEXT_SENTS} x {TEXT_LEN} words "
          f"({em['oov_share']:.3f} OOV) {em['sentences_s']:.2f} s, card vs "
          f"CPU max {em['text_cpu_err']:.3g}; embed_ids {TEXT_IDS} "
          f"{em['ids_ms']:.3f} ms, card vs CPU max {em['ids_cpu_err']:.3g}; "
          f"step 25 took {dt:.1f} s {stamp}")
    launches = launch_counts()
    print(f"launches during steps 21-25: {launches} {stamp}")
    assert launches["adc_segmin"] == 0 and launches["ivf_page"] == 0
    assert launches["adc_segmin_cached"] >= em["launches"] > 0, launches
    print(f"steps 21-25 took {time.perf_counter() - t_all:.1f} s {stamp}")
    return {"detector": lv["_detector"], "batch": lv["_batch"], "emb": em}


def arcface_data():
    """Step 26's samples on the card: ARC_IDS identities x ARC_PER, each
    an identity centre + a shared ARC_NUIS_DIM-d nuisance subspace (ARC_NUIS
    per axis) + unit noise at ARC_IN; each identity's class column drawn
    from all ARC_CLASSES. Returns (x [N, ARC_IN] host float32, class
    labels [N], identity [N], sample index within the identity [N])."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 260)
    cls = torch.randperm(ARC_CLASSES, generator=g, device=DEV)[:ARC_IDS]
    n = ARC_IDS * ARC_PER
    ident = torch.arange(ARC_IDS, device=DEV).repeat_interleave(ARC_PER)
    centres = torch.randn((ARC_IDS, ARC_IN), generator=g, device=DEV)
    basis = torch.randn((ARC_IN, ARC_NUIS_DIM), generator=g,
                        device=DEV) / ARC_NUIS_DIM ** 0.5
    z = ARC_NUIS * torch.randn((n, ARC_NUIS_DIM), generator=g, device=DEV)
    x = centres[ident] + z @ basis.T + ARC_NOISE * torch.randn(
        (n, ARC_IN), generator=g, device=DEV)
    x_host = x.cpu().numpy()
    del x, centres
    ident = ident.cpu().numpy()
    return (x_host, cls.cpu().numpy()[ident].astype(np.int32), ident,
            np.arange(n) % ARC_PER)


def clone_params(params, device) -> dict:
    return {"layers": [{k: v.detach().to(device, copy=True)
                        for k, v in lyr.items()} for lyr in params["layers"]],
            "head": params["head"].detach().to(device, copy=True)}


def arcface_grads(params, x, y, device):
    """(loss, gradients) of one step's loss at `device`, from copies of
    `params`; no optimizer step."""
    from cvt_tpu_torch.train import arcface_loss, parameters, \
        state_from_params
    st, _ = state_from_params(clone_params(params, device))
    loss = arcface_loss(st.params, torch.from_numpy(x).to(device),
                        torch.from_numpy(y).to(device), scale=ARC_S,
                        margin=ARC_M)
    loss.backward()
    return float(loss.detach()), [p.grad for p in parameters(st.params)]


def step_flops(b: int) -> float:
    """Multiply-adds x 2 of one train step: the E layer's and the head's
    products forward, their weight gradients and the embedding's gradient
    backward (the input needs none)."""
    return 2.0 * b * (2 * ARC_IN * ARC_EMB + 3 * ARC_EMB * ARC_CLASSES)


def step_bytes(params) -> float:
    """The least bytes of one train step: the batch read once, the logits
    written once, and Adam reading parameters, gradients and both moments
    and writing parameters and moments (float32)."""
    n = sum(p.numel() for p in params)
    return 4.0 * (ARC_B * ARC_IN + ARC_B * ARC_CLASSES + 7 * n)


def identity_recall(ids, gal_ident, q_ident) -> float:
    """Share of queries whose first hit is an image of their identity."""
    ids = np.asarray(torch.as_tensor(ids).cpu())[:, 0]
    return float(np.mean((ids >= 0) & (gal_ident[ids] == q_ident)))


def phase_records_training(tmp: str, base_dev, q_dev) -> dict:
    """Step 26: records -> ArcFace training -> embeddings -> cvt_records ->
    SQ and HNSW indexes, the dry run; see the module docstring."""
    import torch.distributed as dist
    from cvt_tpu_torch.index import FlatIndex, FlatSQIndex, HnswIndex
    from cvt_tpu_torch.io import read_cvt_records, write_cvt_records
    from cvt_tpu_torch.io import vecs
    from cvt_tpu_torch.native import load_library
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    from cvt_tpu_torch.ops.linalg import l2_normalize
    from cvt_tpu_torch.parallel.dryrun import dryrun_multichip
    from cvt_tpu_torch.quant import ScalarQuantizer
    from cvt_tpu_torch.train import (RecordDataset, create_state, embed,
                                     make_sharded_train_step, parameters,
                                     state_from_params, train_step)
    from cvt_tpu_torch.utils import Timer, recall_at_k, roofline, trace
    res = {}
    kw = dict(scale=ARC_S, margin=ARC_M)
    (x, y, ident, samp), res["data_s"] = timed(arcface_data)
    train = samp < ARC_TRAIN_PER
    paths = {k: os.path.join(tmp, f"{k}.cvtr") for k in ("train", "held")}
    t0 = time.perf_counter()
    RecordDataset.from_arrays(paths["train"], x[train], y[train])
    RecordDataset.from_arrays(paths["held"], x[~train], y[~train])
    res["records_write_s"] = time.perf_counter() - t0
    res["records_mb"] = sum(os.path.getsize(p) for p in paths.values()) / 1e6
    # the file system's own rate: one sequential pass over the train file
    t0 = time.perf_counter()
    with open(paths["train"], "rb") as f:
        while f.read(1 << 24):
            pass
    res["seq_read_mb_s"] = (os.path.getsize(paths["train"]) / 1e6
                            / (time.perf_counter() - t0))
    ds = RecordDataset(paths["train"])
    assert len(ds) == int(train.sum()) and ds.num_classes <= ARC_CLASSES
    assert np.array_equal(ds[5][0], x[train][5]) and ds[5][1] == y[train][5]

    state, opt = create_state(SEED, dim_in=ARC_IN, num_classes=ARC_CLASSES,
                              dim_emb=ARC_EMB, device=DEV)
    xb0, yb0 = next(ds.batches(ARC_B, seed=SEED + 262))
    # card against CPU: one step's loss and gradients, same parameters
    (loss_g, grads_g), res["grad_card_s"] = timed(
        lambda: arcface_grads(state.params, xb0, yb0, DEV))
    t0 = time.perf_counter()
    loss_c, grads_c = arcface_grads(state.params, xb0, yb0, "cpu")
    res["grad_cpu_s"] = time.perf_counter() - t0
    res["loss_card"], res["loss_cpu"] = loss_g, loss_c
    res["grad_rel"] = max(float((g.cpu() - c).abs().max() / c.abs().max())
                          for g, c in zip(grads_g, grads_c))
    del grads_g, grads_c
    assert abs(loss_g - loss_c) <= ARC_GATES["loss_rtol"] * abs(loss_c), res
    assert res["grad_rel"] <= ARC_GATES["grad"], res

    # the data-parallel step on a 1-rank NCCL group against train_step
    sa, oa = state_from_params(clone_params(state.params, DEV))
    sb, ob = state_from_params(clone_params(state.params, DEV))
    step = make_sharded_train_step(None, ob, device=DEV, **kw)
    sa, la = train_step(sa, xb0, yb0, oa, **kw)
    sb, lb = step(sb, xb0, yb0)
    torch.cuda.synchronize()
    res["sharded_loss_equal"] = float(la) == float(lb)
    res["sharded_grad_max"] = max(
        float((p.grad - q.grad).abs().max()) for p, q in
        zip(parameters(sa.params), parameters(sb.params)))
    res["sharded_param_max"] = max(
        float((p - q).detach().abs().max()) for p, q in
        zip(parameters(sa.params), parameters(sb.params)))
    assert abs(float(la) - float(lb)) <= 1e-6 * abs(float(la)), res
    assert res["sharded_grad_max"] <= 1e-6 * max(
        float(p.grad.abs().max()) for p in parameters(sa.params)), res
    del sb, ob, step

    # training: ARC_EPOCHS epochs over the record file, batches to the card
    torch.cuda.reset_peak_memory_stats()
    it = ds.batches(ARC_B, seed=SEED + 261, epochs=ARC_EPOCHS)
    losses, events, data_s = [], [], []
    torch.cuda.synchronize()
    t_train = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        data_s.append(time.perf_counter() - t0)
        if batch is None:
            break
        xd = torch.from_numpy(batch[0]).to(DEV)
        yd = torch.from_numpy(batch[1]).to(DEV)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        state, loss = train_step(state, xd, yd, opt, **kw)
        ev[1].record()
        losses.append(loss)
        events.append(ev)
    torch.cuda.synchronize()
    res["train_wall_s"] = time.perf_counter() - t_train
    losses = torch.stack(losses).cpu().numpy()
    step_ms = np.array([a.elapsed_time(b) for a, b in events])
    res.update(steps=len(losses), loss_first=float(losses[0]),
               loss_last=float(losses[-1]),
               loss_ratio=float(losses[-1] / losses[0]),
               step_ms_median=float(np.median(step_ms)),
               step_ms_q=[float(v) for v in np.percentile(step_ms,
                                                          [0, 25, 75, 100])],
               data_ms_median=float(np.median(data_s[:-1]) * 1e3),
               data_s_total=float(np.sum(data_s)),
               samples_per_s=len(losses) * ARC_B / res["train_wall_s"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=[float(v) for v in losses[::12]])
    res["roofline"] = str(roofline(step_flops(ARC_B), step_bytes(
        parameters(state.params)), res["step_ms_median"] / 1e3))
    res["fp32_share"] = (step_flops(ARC_B) / PEAK_FP32_FLOPS * 1e3
                         / res["step_ms_median"])
    assert state.step == ARC_EPOCHS * (int(train.sum()) // ARC_B)
    assert np.isfinite(losses).all()
    assert res["loss_ratio"] <= ARC_GATES["loss_ratio"], res

    # Timer and the profiler around one step each (on the copy; after the
    # loop, since the profiler's hooks slow the host side of later steps)
    xd, yd = torch.from_numpy(xb0).to(DEV), torch.from_numpy(yb0).to(DEV)
    with Timer("arcface step") as t:
        t.observe(train_step(sa, xd, yd, oa, **kw)[1])
    res["timer_ms"] = t.elapsed * 1e3
    with trace(os.path.join(tmp, "trace")) as prof:
        train_step(sa, xd, yd, oa, **kw)
        torch.cuda.synchronize()
    res["profile_top"] = device_ops(prof)[:8]
    res["trace_files"] = len(os.listdir(os.path.join(tmp, "trace")))
    del sa, oa, xd, yd

    # embed: gallery = the trained samples + each identity's first held-out
    # sample; queries = each identity's second held-out sample
    gal = np.concatenate([np.flatnonzero(train),
                          np.flatnonzero(samp == ARC_TRAIN_PER)])
    qry = np.flatnonzero(samp == ARC_TRAIN_PER + 1)

    def embed_rows(rows):
        return torch.cat([embed(state.params, torch.from_numpy(
            x[rows[s:s + ARC_EMBED_CHUNK]]).to(DEV))
            for s in range(0, len(rows), ARC_EMBED_CHUNK)])
    (emb_g, emb_q), res["embed_s"] = timed(
        lambda: (embed_rows(gal), embed_rows(qry)))
    gal_ident, q_ident = ident[gal], ident[qry]
    # the raw features' own recall (the task without training)
    raw = FlatIndex(ARC_IN, "ip", chunk=2048, device=DEV)
    raw.add(l2_normalize(torch.from_numpy(x[gal]).to(DEV)))
    res["raw_recall_at_1"] = identity_recall(raw.search(
        l2_normalize(torch.from_numpy(x[qry]).to(DEV)), 1)[1], gal_ident,
        q_ident)
    del raw

    # the embeddings as a cvt record stream: native writer and reader,
    # the bytes against the Python loop's
    load_library("vecs_io")        # raises with the compiler's message
    names = [f"id{int(i):05d}/{int(j)}" for i, j in zip(ident[gal],
                                                        samp[gal])]
    emb_np = emb_g.cpu().numpy()
    rec = {k: os.path.join(tmp, f"emb_{k}.bin") for k in ("native", "py")}
    _, res["cvtr_write_s"] = timed(
        lambda: write_cvt_records(rec["native"], names, emb_g))
    t0 = time.perf_counter()
    back_names, back = read_cvt_records(rec["native"])
    res["cvtr_read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vecs._write_cvt_records_py(rec["py"], names, emb_np)
    res["cvtr_write_py_s"] = time.perf_counter() - t0
    res["cvtr_mb"] = os.path.getsize(rec["native"]) / 1e6
    with open(rec["native"], "rb") as a, open(rec["py"], "rb") as b:
        res["cvtr_bytes_equal"] = a.read() == b.read()
    assert back_names == names and np.array_equal(back, emb_np), \
        "cvt_records round trip"
    assert res["cvtr_bytes_equal"], "native and Python record bytes differ"

    # SQ: search_fast (the cached kernel at D ARC_EMB) and bf16 search
    exact = FlatIndex(ARC_EMB, "l2", device=DEV)
    exact.add(emb_g)
    gt = exact.search(emb_q, 1)[1][:, 0].cpu()
    sq = ScalarQuantizer.train(emb_g)
    idx = FlatSQIndex(sq, mode="bf16")
    idx.add(emb_g)
    before = T.adc_segmin_cached.launches
    d_f, i_f = idx.search_fast(emb_q, EMB_K)
    torch.cuda.synchronize()
    res["launches"] = T.adc_segmin_cached.launches - before
    d_b, i_b = idx.search(emb_q, EMB_K)
    for name, (d, i) in (("fast", (d_f, i_f)), ("bf16", (d_b, i_b))):
        assert int(i.min()) >= 0 and int(i.max()) < len(gal), name
        assert bool(torch.isfinite(d).all()), name
        res[f"recall_at_1_{name}"] = recall_at_k(i, gt, k=1)
        res[f"recall_at_10_{name}"] = recall_at_k(i, gt, k=10)
        res[f"identity_recall_{name}"] = identity_recall(i, gal_ident,
                                                         q_ident)
    # parity at top-1, the fast path's exact rank: the gallery holds each
    # identity's rows side by side, and for k > 1 the fast path keeps one
    # winner per segment (adc_scan.py:27-32), which recall@10 shows
    res["parity_pt"] = 100 * (res["recall_at_1_bf16"]
                              - res["recall_at_1_fast"])
    assert res["launches"] > 0, "the cached kernel never launched"
    assert abs(res["parity_pt"]) <= ARC_GATES["parity_pt"], res
    assert res["identity_recall_fast"] >= ARC_GATES["recall"], res
    args = sq_kernel_args(idx, emb_q)
    res["cmp"] = compare_kernel_to_twin(
        T.adc_segmin_cached, T.adc_segmin_cached_plain, args,
        args[3][:, 0], args[1], args[5], args[6])
    res["fast_ms"] = cuda_median_ms(lambda: idx.search_fast(emb_q, EMB_K),
                                    10)[0]
    res["kernel_ms"] = cuda_median_ms(lambda: T.adc_segmin_cached(*args),
                                      20)[0]
    res["plain_ms"] = cuda_median_ms(
        lambda: T.adc_segmin_cached_plain(*args), 3)[0]
    res["bound"] = share(res["kernel_ms"], adc_bound(args, cached=True))
    res["npad"], res["tile"], res["seg"] = args[2].shape[1], args[5], args[6]

    # HNSW over the same embeddings (inner product, the reference's point)
    q_np = emb_q.cpu().numpy()
    hn = HnswIndex(ARC_EMB, metric="ip", capacity=len(gal), m=HNSW_M,
                   ef_construction=HNSW_EFC, seed=SEED)
    t0 = time.perf_counter()
    hn.add(emb_np)
    res["hnsw_emb_build_per_s"] = len(gal) / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    _, h_ids = hn.search(q_np, EMB_K, ef=HNSW_EF)
    res["hnsw_emb_search_ms"] = (time.perf_counter() - t0) * 1e3
    res["identity_recall_hnsw"] = identity_recall(h_ids, gal_ident, q_ident)
    assert res["identity_recall_hnsw"] >= ARC_GATES["recall"], res

    # HNSW (L2) over the first HNSW_N of the main path's base
    base = base_dev[:HNSW_N]
    qs = q_dev[:N_REC]
    exact = FlatIndex(D, "l2", chunk=131_072, device=DEV)
    exact.add(base)
    gt10 = exact.search(qs, 10)[1].cpu().numpy()
    del exact
    hs = HnswIndex(D, metric="l2", capacity=HNSW_N, m=HNSW_M,
                   ef_construction=HNSW_EFC, seed=SEED)
    t0 = time.perf_counter()
    hs.add(base.cpu().numpy())
    res["hnsw_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, s_ids = hs.search(qs.cpu().numpy(), 10, ef=HNSW_EF)
    res["hnsw_search_ms"] = (time.perf_counter() - t0) * 1e3
    res["hnsw_recall_at_10"] = recall_at_k(s_ids, gt10[:, 0], k=10)
    res["hnsw_recall_at_1"] = recall_at_k(s_ids, gt10[:, 0], k=1)
    res["hnsw_10_at_10"] = recall_at_k(s_ids, gt10, k=10, gt_count=10)
    assert res["hnsw_recall_at_10"] >= ARC_GATES["hnsw_recall10"], res

    # the multi-device dry run on the 1-rank NCCL group
    before = T.adc_segmin.launches
    res["dryrun"], res["dryrun_s"] = timed(lambda: dryrun_multichip(
        verbose=False))
    res["dryrun_launches"] = T.adc_segmin.launches - before
    dist.destroy_process_group()
    return res


def run_records_training(stamp: str, base_dev, q_dev) -> dict:
    """Step 26 with its prints; the three kernels' counts are zeroed before
    it and read after."""
    import tempfile
    zero_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        r, dt = timed(lambda: phase_records_training(tmp, base_dev, q_dev))
    g = ARC_GATES
    print(f"step 26 data: {ARC_IDS} identities x {ARC_PER} samples of "
          f"{ARC_IN} (seeded on the card, {r['data_s']:.1f} s); "
          f"RecordDataset.from_arrays {r['records_mb']:.0f} MB in "
          f"{r['records_write_s']:.2f} s "
          f"({r['records_mb'] / r['records_write_s']:.0f} MB/s) {stamp}")
    print(f"ArcFace {ARC_IN} -> {ARC_EMB} x {ARC_CLASSES}, batch {ARC_B}, s "
          f"{ARC_S}, m {ARC_M}: card vs CPU one step: loss {r['loss_card']:.6f}"
          f" / {r['loss_cpu']:.6f}, gradients max|diff|/max|g| "
          f"{r['grad_rel']:.3g} (limit {g['grad']}); CPU step "
          f"{r['grad_cpu_s']:.1f} s {stamp}")
    print(f"make_sharded_train_step on a 1-rank NCCL group vs train_step: "
          f"loss equal {r['sharded_loss_equal']}, gradients max|diff| "
          f"{r['sharded_grad_max']:.3g}, parameters after the step max|diff| "
          f"{r['sharded_param_max']:.3g} {stamp}")
    print(f"training: {r['steps']} steps ({ARC_EPOCHS} epochs of "
          f"{ARC_IDS * ARC_TRAIN_PER} records): loss {r['loss_first']:.4f} -> "
          f"{r['loss_last']:.4f} (ratio {r['loss_ratio']:.4g}, limit "
          f"{g['loss_ratio']}); every 12th: {[round(v, 3) for v in r['losses']]}"
          f" {stamp}")
    q = r["step_ms_q"]
    print(f"training step (CUDA events): median {r['step_ms_median']:.3f} ms, "
          f"min {q[0]:.3f}, quartiles {q[1]:.3f}-{q[2]:.3f}, max {q[3]:.3f}; "
          f"{r['roofline']} at the median, {r['fp32_share']:.1%} of the float32"
          f" peak; host data {r['data_ms_median']:.2f} ms per batch "
          f"({r['data_s_total']:.2f} s in all; the train file reads "
          f"sequentially at {r['seq_read_mb_s']:.0f} MB/s); "
          f"{r['samples_per_s']:.0f} samples/s end to end ({r['train_wall_s']:.2f} s); peak memory "
          f"{r['peak_gb']:.3f} GB {stamp}")
    print(f"Timer around one step: {r['timer_ms']:.3f} ms; profile.trace "
          f"({r['trace_files']} trace file) of one step, top device "
          f"operations (self ms, calls): " + "; ".join(
              f"{name[:60]} {ms:.3f} ({n})" for name, ms, n in
              r["profile_top"]) + f" {stamp}")
    print(f"embed {ARC_IDS * (ARC_TRAIN_PER + 2)} samples in "
          f"{r['embed_s']:.2f} s; same-identity recall@1 of the raw features "
          f"{r['raw_recall_at_1']:.4f} {stamp}")
    print(f"write_cvt_records (native) {r['cvtr_mb']:.1f} MB in "
          f"{r['cvtr_write_s'] * 1e3:.1f} ms, Python loop "
          f"{r['cvtr_write_py_s'] * 1e3:.1f} ms, bytes equal "
          f"{r['cvtr_bytes_equal']}; read_cvt_records "
          f"{r['cvtr_read_s'] * 1e3:.1f} ms, round trip equal {stamp}")
    print(f"held-out same-identity recall@1: SQ search_fast "
          f"{r['identity_recall_fast']:.4f}, bf16 "
          f"{r['identity_recall_bf16']:.4f}, HNSW (ip, M {HNSW_M}, efC "
          f"{HNSW_EFC}, ef {HNSW_EF}) {r['identity_recall_hnsw']:.4f} "
          f"(limit {g['recall']}); SQ against the exact nearest: recall@1 "
          f"fast {r['recall_at_1_fast']:.4f} / bf16 "
          f"{r['recall_at_1_bf16']:.4f} (parity {r['parity_pt']:.2f} pt, "
          f"limit {g['parity_pt']}), recall@10 {r['recall_at_10_fast']:.4f} "
          f"/ {r['recall_at_10_bf16']:.4f}; "
          f"search_fast {r['fast_ms']:.3f} ms; adc_segmin_cached launched "
          f"{r['launches']} time(s) by the search {stamp}")
    print_compare(f"records path's arguments, Npad={r['npad']} B={ARC_IDS} "
                  f"D={ARC_EMB} tile {r['tile']} seg {r['seg']}",
                  {"adc_segmin_cached": r["cmp"]}, stamp)
    print(f"adc_segmin_cached at the records path: kernel "
          f"{r['kernel_ms']:.4f} ms, twin {r['plain_ms']:.3f} ms {stamp}")
    print_bound("adc_segmin_cached", f"the records path (Npad {r['npad']}, "
                f"Bpad {ARC_IDS}, D {ARC_EMB}, tile {r['tile']}, seg "
                f"{r['seg']})", r["bound"], stamp)
    print(f"HNSW (ip) over {ARC_IDS * (ARC_TRAIN_PER + 1)} embeddings: build "
          f"{r['hnsw_emb_build_per_s']:.0f} vectors/s, search {ARC_IDS} "
          f"queries at ef {HNSW_EF} {r['hnsw_emb_search_ms']:.1f} ms {stamp}")
    print(f"HNSW (l2, M {HNSW_M}, efC {HNSW_EFC}) over the first {HNSW_N} of "
          f"the main path's base: build {r['hnsw_build_s']:.2f} s "
          f"({HNSW_N / r['hnsw_build_s']:.0f} vectors/s); {N_REC} queries at "
          f"ef {HNSW_EF} {r['hnsw_search_ms']:.1f} ms; recall@10 "
          f"{r['hnsw_recall_at_10']:.4f} (limit {g['hnsw_recall10']}), "
          f"recall@1 {r['hnsw_recall_at_1']:.4f}, 10@10 "
          f"{r['hnsw_10_at_10']:.4f} against exact FlatIndex {stamp}")
    d = r["dryrun"]
    print(f"dryrun_multichip on a 1-rank NCCL group: mesh dp={d['dp']} x "
          f"db={d['db']}, objective {d['objective']:.3f}, config-5 top-1 "
          f"parity {d['agree']:.2f}, pipelined {d['agree_pipelined']:.2f}; "
          f"{r['dryrun_s']:.1f} s, adc_segmin launched "
          f"{r['dryrun_launches']} time(s) {stamp}")
    launches = launch_counts()
    print(f"launches during step 26: {launches} {stamp}")
    assert launches["ivf_page"] == 0
    assert launches["adc_segmin"] == r["dryrun_launches"] > 0, launches
    assert launches["adc_segmin_cached"] >= r["launches"] > 0, launches
    print(f"step 26 took {dt:.1f} s (target 90 s) {stamp}")
    return r


def numbers(x):
    """Every int or float inside a JSON value (lists and dicts walked)."""
    if isinstance(x, dict):
        for v in x.values():
            yield from numbers(v)
    elif isinstance(x, list):
        for v in x:
            yield from numbers(v)
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        yield x


def check_bench(lanes: list, r: dict) -> None:
    """Step 27's gates on the bench's lane lines and last line."""
    from cvt_tpu_torch.bench import LANES
    g = BENCH_GATES
    assert [ln["lane"] for ln in lanes] == list(LANES), lanes
    missing = set(BENCH_KEYS) - set(r)
    assert not missing, missing
    signed = ("recall_parity_pt", "parity_sweep_pt", "parity_spread_pt_max",
              "kernel_launches")
    for key, v in r.items():
        for x in numbers(v):
            assert np.isfinite(x), (key, x)
            assert key in signed or x > 0, (key, x)
    assert all(v >= 0 for v in numbers(r["kernel_launches"]))
    assert r["parity_spread_pt_max"] >= 0
    assert abs(r["recall_parity_pt"]) <= g["parity_pt"], r["recall_parity_pt"]
    assert r["recall_at_1_exact"] >= r["recall_at_1"] - g["exact_pt"] / 100
    assert r["parity_spread_pt_max"] <= g["sweep_pt"], r["parity_sweep_pt"]
    assert r["kernel_launches"]["adc_segmin"] >= 1, r["kernel_launches"]
    assert r["kernel_launches"]["adc_segmin_cached"] >= 1, r["kernel_launches"]
    assert r["n_db"] == N_DB and r["batch"] == N_QUERIES, r
    assert r["device"] == card_line(), r["device"]


def run_bench(stamp: str) -> dict:
    """Step 27: `python -m cvt_tpu_torch.cli bench` as a subprocess at
    bench.py's sizes (1M x 128, B 8,192; the kernels the parent built);
    its lane lines and last line are printed and checked. Returns the last
    line."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "cvt_tpu_torch.cli",
                          "bench"], capture_output=True, text=True, cwd=root,
                         timeout=BENCH_TIMEOUT_S)
    dt = time.perf_counter() - t0
    if run.returncode:
        raise RuntimeError(f"cli bench exited {run.returncode}: "
                           f"{run.stderr[-3000:]}")
    rows = [json.loads(line) for line in run.stdout.splitlines()
            if line.startswith("{")]
    lanes, r = rows[:-1], rows[-1]
    for ln in lanes:
        print(f"bench lane {json.dumps(ln)}")
    print(f"bench result {json.dumps(r)}")
    check_bench(lanes, r)
    g = BENCH_GATES
    print(f"bench on {r['device']}: fast {r['value']:.0f} QPS (windows "
          f"{r['value_spread'][0]:.0f}-{r['value_spread'][1]:.0f}), "
          f"{r['ms_per_batch']:.3f} ms per batch of {r['batch']}; decoded "
          f"cache {r['qps_decoded_cache']:.0f} "
          f"({r['qps_decoded_cache_spread'][0]:.0f}-"
          f"{r['qps_decoded_cache_spread'][1]:.0f}); exact "
          f"{r['qps_exact']:.0f} ({r['qps_exact_spread'][0]:.0f}-"
          f"{r['qps_exact_spread'][1]:.0f}); SQ d64 {r['sq_d64_qps']:.0f}, "
          f"d128 {r['sq_d128_qps']:.0f} QPS {stamp}")
    print(f"bench recall@1 fast {r['recall_at_1']:.4f}, reference "
          f"{r['recall_at_1_ref_f32_adc']:.4f}, exact "
          f"{r['recall_at_1_exact']:.4f}; parity {r['recall_parity_pt']:.2f}"
          f" pt (limit {g['parity_pt']}, BASELINE.md's target "
          f"{g['target_pt']}); sweep {r['parity_sweep_pt']} (max "
          f"{r['parity_spread_pt_max']:.2f}, limit {g['sweep_pt']}); "
          f"adc_segmin {r['adc_segmin_ms']:.3f} ms, "
          f"{r['bound_share']:.1%} of its {r['bound_ms']:.3f} ms bound; "
          f"launches {r['kernel_launches']} {stamp}")
    print(f"step 27 took {dt:.1f} s ({r['total_bench_s']:.1f} s inside the "
          f"bench) {stamp}")
    return r


def recorded_kernel_args(call, n_valid: int) -> tuple:
    """The arguments of the first ADC kernel launch in `call()`, recorded
    where the wrapper validates them: its tensors, then n_valid, the tile
    and the segment, in the wrapper's order."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    seen = []
    check = T._check_launch

    def record(q2s, qs, npad, tile_n, seg, tensors, *rest):
        seen.append(tuple(tensors.values()) + (n_valid, tile_n, seg))
        check(q2s, qs, npad, tile_n, seg, tensors, *rest)
    T._check_launch = record
    try:
        call()
    finally:
        T._check_launch = check
    return seen[0]


def phase_bench_kernels(stamp: str) -> dict:
    """Step 27's kernel checks at the two shapes only the bench gives,
    each on the arguments the bench's own index hands the wrapper:
    `adc_segmin_cached` in the SQ lane at d 64 (1M rows, B 8,192) and
    `adc_segmin` in the parity sweep (131,072 rows, B 2,048; its first
    point, isotropic seed 0)."""
    from cvt_tpu_torch import bench
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    t0 = time.perf_counter()
    dev = torch.device(DEV)
    base, queries, _, _ = bench.load_data(N_DB, N_QUERIES)
    sqi, _, q_sq = bench.sq_index(base, queries, 64, dev)
    del base
    args = recorded_kernel_args(lambda: sqi.search_fast(q_sq, K),
                                sqi.ntotal)
    assert args[0].shape[0] == N_QUERIES and args[2].shape[0] == 64, args
    out = {"adc_segmin_cached": compare_kernel_to_twin(
        T.adc_segmin_cached, T.adc_segmin_cached_plain, args,
        args[3][:, 0], args[1], args[5], args[6])}
    print_compare(f"the bench's SQ lane at d 64, Npad "
                  f"{args[2].shape[1]} B={N_QUERIES} tile {args[5]} seg "
                  f"{args[6]}", out, stamp)
    del sqi, q_sq, args
    idx, _, q_sw = bench.sweep_index("isotropic", 0, bench.N_SWEEP, dev)
    args = recorded_kernel_args(lambda: idx.search(q_sw, K), idx.ntotal)
    assert args[0].shape[0] == bench.NQ_SWEEP, args[0].shape
    norm = T._row_norms(T.decode_int8(args[2], args[3]), args[4])
    cmp = compare_kernel_to_twin(T.adc_segmin, T.adc_segmin_plain, args,
                                 norm, args[1], args[6], args[7])
    print_compare(f"the bench's parity sweep (isotropic, seed 0), Npad "
                  f"{args[2].shape[0]} B={bench.NQ_SWEEP} tile {args[6]}",
                  {"adc_segmin": cmp}, stamp)
    out["adc_segmin"] = cmp
    print(f"step 27's kernel checks took {time.perf_counter() - t0:.1f} s "
          f"{stamp}")
    return out


def print_compare(what: str, cmp: dict, stamp: str) -> None:
    for name, c in cmp.items():
        print(f"kernel vs twin, {what}: {name} max|diff| {c['max_abs_err']}"
              f", {c['rows_differ']} rows differ, {c['near_half_rows']} "
              f"rows within 1e-4 of a half-integer {stamp}")


def run_sq(base_dev, q_dev, stamp: str) -> dict:
    """Step 8: the SQ phase, its kernel-against-twin check and times."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    sq = phase_sq(base_dev, q_dev)
    idx, xq = sq.pop("_index"), sq.pop("_xq")
    print(f"SQ (config 1, 1M x 128 L2-normalised): train {sq['train_s']:.3f}"
          f" s, encode {sq['encode_codes_per_s']:.0f} codes/s {stamp}")
    for name in ("bf16", "int8", "fast"):
        print(f"SQ search {name}: recall@1 {sq[f'recall_at_1_{name}']:.4f} "
              f"recall@10 {sq[f'recall_at_10_{name}']:.4f} {stamp}")
    print(f"SQ parity (bf16 - search_fast recall@10): {sq['parity_pt']:.2f}"
          f" pt (limit 1.0); launches during the SQ path: "
          f"adc_segmin_cached {sq['launches']} {stamp}")
    args = sq_kernel_args(idx["bf16"], xq)
    sq["cmp"] = compare_kernel_to_twin(
        T.adc_segmin_cached, T.adc_segmin_cached_plain, args,
        args[3][:, 0], args[1], args[5], args[6])
    print_compare(f"SQ path's arguments, Npad={args[2].shape[1]} "
                  f"B={N_QUERIES} tile {args[5]}",
                  {"adc_segmin_cached": sq["cmp"]}, stamp)
    stm = phase_sq_timing(idx, xq, args, reps=5)
    for name in ("bf16", "int8", "fast"):
        ms = stm[f"{name}_ms"]
        print(f"SQ search {name} 1M x 8192, k=10: {ms:.3f} ms/batch, "
              f"{N_QUERIES / ms * 1e3:.0f} QPS {stamp}")
    print(f"adc_segmin_cached at the SQ path: kernel {stm['kernel_ms']:.3f}"
          f" ms, twin {stm['plain_ms']:.3f} ms {stamp}")
    sq["bound"] = share(stm["kernel_ms"], adc_bound(args, cached=True))
    print_bound("adc_segmin_cached", f"the SQ path (Npad "
                f"{args[2].shape[1]}, Bpad {args[0].shape[0]}, tile "
                f"{args[5]})", sq["bound"], stamp)
    return sq


def run_serving(flat_idx, q_dev, gt, ids_ref, base_dev, stamp: str) -> dict:
    """Step 9: the serving phase, its kernel-against-twin check, sharded
    k-means, the CLI and times; ends the process group."""
    import tempfile
    import torch.distributed as dist
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    sv = phase_serve(flat_idx, q_dev, gt, ids_ref)
    srv, ids = sv.pop("_servers"), sv.pop("_ids")
    print(f"serving: 1-rank NCCL group up in {sv['init_s']:.2f} s; ring, "
          f"ShardedADCSearcher and serve_pipelined ids equal serve's: "
          f"{sv['ring_ids_equal']}, {sv['searcher_ids_equal']}, "
          f"{sv['pipelined_ids_equal']} {stamp}")
    print(f"serve recall@1 {sv['recall_at_1_serve']:.4f} recall@10 "
          f"{sv['recall_at_10_serve']:.4f}; reference engine recall@1 "
          f"{sv['recall_at_1_ref']:.4f}; parity {sv['parity_pt']:.2f} pt "
          f"(limit 1.0) {stamp}")
    b = sv["batcher"]
    print(f"QueryBatcher: {b['futures']} futures from 8 threads "
          f"({b['rows']} rows) resolved in {b['wall_s']:.3f} s {stamp}")
    print(f"launches during the serving path: adc_segmin {sv['launches']} "
          f"{stamp}")
    args, norm = serve_kernel_args(srv["allgather"], q_dev[:SERVE_B])
    sv["cmp"] = compare_kernel_to_twin(T.adc_segmin, T.adc_segmin_plain,
                                       args, norm, args[1], args[-2],
                                       args[-1])
    print_compare(f"server's arguments, Npad={args[2].shape[0]} "
                  f"B={SERVE_B} tile {args[-2]} seg {args[-1]}",
                  {"adc_segmin": sv["cmp"]}, stamp)
    sv["bound"] = share(cuda_ms(lambda: T.adc_segmin(*args), 20),
                        adc_bound(args, cached=False))
    print_bound("adc_segmin", f"the server's batch (Npad "
                f"{args[2].shape[0]}, Bpad {args[0].shape[0]}, tile "
                f"{args[-2]}, seg {args[-1]})", sv["bound"], stamp)
    km = phase_kmeans(base_dev)
    print(f"sharded_kmeans_step ('dp' mesh of 1, {KM_N} x {D}, K {KM_K}) "
          f"vs _lloyd: max|diff| {km['max_abs_err']:.3g}, objective rel "
          f"{km['objective_rel_err']:.3g} {stamp}")
    with tempfile.TemporaryDirectory() as tmp:
        cli = run_cli(flat_idx, q_dev.cpu().numpy(), tmp)
    stdin_want = np.concatenate([
        srv["allgather"].serve(q_dev[j:j + 1], K)[1].cpu().numpy()
        for j in range(CLI_STDIN_ROWS)])
    assert np.array_equal(cli["batch"], ids), "cli batch ids != serve"
    assert np.array_equal(cli["stdin"], stdin_want), "cli stdin ids != serve"
    print(f"cli serve: batch mode {cli['batch'].shape[0]} rows in "
          f"{cli['batch_s']:.1f} s, --stdin {cli['stdin'].shape[0]} rows in "
          f"{cli['stdin_s']:.1f} s (process wall clock); ids equal "
          f"in-process serve {stamp}")
    q = q_dev[:N_REC]
    for merge in ("allgather", "ring"):
        ms = cuda_ms(lambda: srv[merge].serve(q[:SERVE_B], K), 10)
        print(f"serve ({merge}) 1M, B={SERVE_B}, k=10: {ms:.3f} ms/batch, "
              f"{SERVE_B / ms * 1e3:.0f} QPS {stamp}")
    ms = cuda_ms(lambda: srv["ring"].serve_pipelined(
        q.reshape(-1, SERVE_B, D), K), 5) / (N_REC // SERVE_B)
    print(f"serve_pipelined [{N_REC // SERVE_B}, {SERVE_B}]: {ms:.3f} "
          f"ms/batch, {SERVE_B / ms * 1e3:.0f} QPS {stamp}")
    dist.destroy_process_group()
    return sv


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from cvt_tpu_torch.ops.kernels import _build

    card = card_line()
    print(card)
    stamp = f"({card})"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    # cuDNN's flag stays at PyTorch's default (TF32 allowed): every
    # convolution of the port turns it off for its own call
    # (ops.linalg.full_precision_conv), which steps 14-25 then check
    conv = getattr(torch.backends.cudnn, "conv", None)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; cuDNN float32 convolutions "
          f"at PyTorch's default: " + (
              f"conv.fp32_precision {conv.fp32_precision!r}" if conv is not
              None else f"allow_tf32 {torch.backends.cudnn.allow_tf32}"))

    stale = _build.library_path()
    if os.path.exists(stale):
        os.unlink(stale)                     # build from the sources, now
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s {stamp}")
    with open(stale[:-3] + ".log") as f:
        for name, line in ptxas_report(f.read()).items():
            print(f"  ptxas {name}: {line}")
    sass = sass_classes(stale)
    for name, counts in sass.items():
        if "adc_segmin" in name or "ivf_page" in name:
            print(f"  SASS {name}: " + ", ".join(
                f"{c} {n}" for c, n in counts.items()))
        if "ivf_page" in name:
            assert counts["IGMMA"] > 0 and counts["IDP4A"] == 0, name
    if not sass:
        print("  SASS: cuobjdump not found; instruction classes not read")

    rand_dec, rand_cached, rand_norm = random_kernel_args(65_536, 1024,
                                                          65_536 - 1000)
    print_compare("random codes, Npad=65536 B=1024",
                  compare_both(rand_dec, rand_cached, rand_norm), stamp)
    segv = compare_seg_variants(rand_dec, rand_norm)
    for seg, c in segv.items():
        print(f"kernel vs twin, random codes, Npad=65536 B=1024 n_valid "
              f"{65_536 - 1000}, seg {seg} (tiles 1024 and 256): adc_segmin "
              f"max|diff| {c['max_abs_err']}, {c['rows_differ']} rows "
              f"differ, {c['near_half_rows']} rows within 1e-4 of a "
              f"half-integer {stamp}")

    ivf_rand = compare_ivf_kernel(random_ivf_args(D, 200))
    print(f"kernel vs twin, random inputs, S=48 pages B=200 (Bpad 256): "
          f"ivf_page max|diff| {ivf_rand['max_abs_err']} {stamp}")
    ivf_rand_live = compare_ivf_kernel(random_ivf_args(D, 200) + [
        torch.tensor([44], dtype=torch.int32, device=DEV)])
    print(f"kernel vs twin, random inputs, S=48 pages B=200, n_live 44: "
          f"ivf_page max|diff| {ivf_rand_live['max_abs_err']} {stamp}")

    phase_topk(stamp)

    res = phase_main_path()
    idx, q_dev = res.pop("_index"), res.pop("_q")
    base_dev, gt = res.pop("_base"), res.pop("_gt")
    ids_ref = res.pop("_ids_ref")
    print(f"main path: data {res['data_s']:.1f} s, OPQ train "
          f"{res['opq_train_s']:.1f} s {stamp}")
    print(f"encode: {res['encode_codes_per_s']:.0f} codes/s {stamp}")
    for name in ("fast", "exact", "reference"):
        print(f"recall@1 {name}: {res[f'recall_at_1_{name}']:.4f}  "
              f"recall@10 {name}: {res[f'recall_at_10_{name}']:.4f} {stamp}")
    print(f"parity (reference - fast recall@1): {res['parity_pt']:.2f} pt "
          f"(target 0.5, limit 1.0) {stamp}")
    print(f"decoded cache vs fast: top-1 equal {res['cached_top1_equal']}, "
          f"all ids equal {res['cached_all_ids_equal_frac']:.6f}, at the "
          f"fast path's tile {res['cached_same_tile_ids_equal']} {stamp}")
    print(f"launches during the main path: {res['launches']} {stamp}")

    dec_args, cached_args = main_path_kernel_args(idx, q_dev)
    cmp = compare_both(dec_args, cached_args, idx._norm_col[:, 0])
    npad = dec_args[2].shape[0]
    print_compare(f"main path's arguments, Npad={npad} B={N_QUERIES} "
                  f"tiles {dec_args[-1]}/{cached_args[-1]}", cmp, stamp)

    tm = phase_timing(idx, q_dev, dec_args, cached_args, reps=5)
    for name in ("fast", "exact", "cached"):
        ms = tm[f"{name}_ms"]
        print(f"search {name} 1M x 8192, k=10: {ms:.3f} ms/batch, "
              f"{N_QUERIES / ms * 1e3:.0f} QPS {stamp}")
    flat_b = {"adc_segmin": adc_bound(dec_args, cached=False),
              "adc_segmin_cached": adc_bound(cached_args, cached=True)}
    for name in ("adc_segmin", "adc_segmin_cached"):
        print(f"{name} 1M x 8192: kernel {tm[name + '_ms']:.3f} ms, twin "
              f"{tm[name + '_plain_ms']:.3f} ms {stamp}")
        flat_b[name] = share(tm[name + "_ms"], flat_b[name])
        print_bound(name, f"the flat path (Npad {npad}, Bpad {N_QUERIES})",
                    flat_b[name], stamp)

    iv = phase_ivf(base_dev, q_dev, gt)
    ivf_idx = iv.pop("_index")
    print(f"IVF-ADC {IVF_KC} cells, m={IVF_M}, K={KSUB}: train "
          f"{iv['train_s']:.1f} s, build {iv['build_codes_per_s']:.0f} "
          f"codes/s, {iv['pages']} pages ({iv['rows_padded']} padded "
          f"rows), bucket cap {iv['bucket_cap']}, tail {iv['tail_len']} "
          f"{stamp}")
    for p in IVF_NPROBES:
        print(f"IVF search_fast nprobe {p}: recall@1 "
              f"{iv[f'recall_at_1_fast_{p}']:.4f} recall@10 "
              f"{iv[f'recall_at_10_fast_{p}']:.4f}, dropped pages "
              f"{iv[f'n_dropped_{p}']} {stamp}")
    print(f"IVF search (reference engine) nprobe {IVF_REF_NPROBE}: recall@1 "
          f"{iv['recall_at_1_ref']:.4f} recall@10 "
          f"{iv['recall_at_10_ref']:.4f}; parity (reference - fast "
          f"recall@10) {iv['parity_pt']:.2f} pt (limit 1.0), tail "
          f"{iv['tail_len']} entries scanned by every reference query "
          f"{stamp}")
    print(f"launches during the IVF path: ivf_page {iv['launches']} {stamp}")
    ivf_by_p = {p: main_path_ivf_args(ivf_idx, q_dev, p)
                for p in IVF_NPROBES}
    ivf_args = ivf_by_p[IVF_REF_NPROBE]
    assert ivf_args[8] is not None, "search_fast passed no n_live"
    ivf_cmp = compare_ivf_kernel(ivf_args)
    print(f"kernel vs twin, IVF main path's arguments (nprobe "
          f"{IVF_REF_NPROBE}, B={IVF_B}, segpack {ivf_cmp['shape']}, "
          f"n_live {live_slots(ivf_args)}): ivf_page max|diff| "
          f"{ivf_cmp['max_abs_err']} {stamp}")
    itm = phase_ivf_timing(ivf_idx, q_dev, ivf_by_p, reps=10)
    for p in IVF_NPROBES:
        ms = itm[f"fast_{p}_ms"]
        print(f"IVF search_fast 1M, B={IVF_B}, nprobe {p}: {ms:.3f} "
              f"ms/batch, {IVF_B / ms * 1e3:.0f} QPS {stamp}")
    print(f"IVF search (reference engine) nprobe {IVF_REF_NPROBE}: "
          f"{itm['ref_ms']:.3f} ms/batch {stamp}")
    print(f"ivf_page at the nprobe-{IVF_REF_NPROBE} batch: kernel "
          f"{itm['ivf_page_ms']:.3f} ms, twin {itm['ivf_page_plain_ms']:.3f}"
          f" ms {stamp}")
    ivf_bp = {}
    for p, args in ivf_by_p.items():
        ivf_bp[p] = dict(share(itm[f"ivf_page_{p}_ms"], ivf_bound(args)),
                         live_slots=live_slots(args),
                         slots=args[5].shape[0])
        print_bound("ivf_page", f"the nprobe-{p} batch (B {IVF_B}, "
                    f"{ivf_bp[p]['live_slots']} live of "
                    f"{ivf_bp[p]['slots']} page slots)", ivf_bp[p], stamp)
    ivf_b = ivf_bp[IVF_REF_NPROBE]

    sq = run_sq(base_dev, q_dev, stamp)
    sv = run_serving(idx, q_dev, gt, ids_ref, base_dev, stamp)
    run_vocab(stamp)
    feat = run_features(stamp)
    match = run_matching(stamp)
    recon = run_reconstruction(stamp, match)
    apps = run_apps(stamp)
    arc = run_records_training(stamp, base_dev, q_dev)
    # the profiler leaves its hooks behind, which slows the host side of
    # whatever runs after it in this process (step 27 runs in its own)
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    split = {"adc_segmin": kernel_split(lambda: T.adc_segmin(*dec_args), 5),
             "adc_segmin_cached": kernel_split(
                 lambda: T.adc_segmin_cached(*cached_args), 5)}
    for name, s in split.items():
        print(f"{name} at the flat path, split (profiler, device ms per "
              f"call): scan kernel {s['scan_ms']:.3f}, tiletop_kernel "
              f"{s['tiletop_ms']:.3f} {stamp}")
    k, b = FEAT_RUNS[0]
    prof = feature_profile(feat["profile_input"], k)
    print(f"extract_sift B={b} K={k} under torch.profiler: wall "
          f"{prof['wall_ms']:.2f} ms, device {prof['device_ms']:.2f} ms; top "
          f"device operations (self ms, calls): " + "; ".join(
              f"{name[:60]} {ms:.3f} ({n})" for name, ms, n in prof["top"])
          + f" {stamp}")
    mp = match_profile(match["images"], MV_PROFILE_PAIRS)
    print(f"match_pairs over {mp['pairs']} pairs at K {MV_K} under "
          f"torch.profiler: wall {mp['wall_ms']:.2f} ms, device "
          f"{mp['device_ms']:.2f} ms; top device operations (self ms, "
          f"calls): " + "; ".join(f"{name[:60]} {ms:.3f} ({n})"
                                  for name, ms, n in mp["top"])
          + f" {stamp}")
    print(f"match_pairs over {mp['pairs']} pairs, top host operations (self "
          f"ms, calls): " + "; ".join(f"{name[:50]} {ms:.3f} ({n})"
                                     for name, ms, n in mp["host"])
          + f" {stamp}")
    bp = ba_profile(recon["rec"])
    print(f"bundle_adjust ({bp['obs']} observations, {RC_PROFILE_ITERS} LM x "
          f"30 CG) under torch.profiler: wall {bp['wall_ms']:.2f} ms, device "
          f"{bp['device_ms']:.2f} ms, {bp['launches']} kernel launches; top "
          f"device operations (self ms, calls): " + "; ".join(
              f"{name[:60]} {ms:.3f} ({n})" for name, ms, n in bp["top"])
          + f" {stamp}")
    print("bundle_adjust, top host operations (self ms, calls): " + "; ".join(
        f"{name[:50]} {ms:.3f} ({n})" for name, ms, n in bp["host"])
        + f" {stamp}")
    ap = apps_profile(apps["detector"], apps["batch"])
    print(f"LogoDetector.detect ({LOGO_B} images, {LOGO_NAMES * LOGO_PER} "
          f"templates) under torch.profiler: wall {ap['wall_ms']:.2f} ms, "
          f"device {ap['device_ms']:.2f} ms; top device operations (self ms,"
          f" calls): " + "; ".join(f"{name[:60]} {ms:.3f} ({n})"
                                  for name, ms, n in ap["top"]) + f" {stamp}")
    print("LogoDetector.detect, top host operations (self ms, calls): "
          + "; ".join(f"{name[:50]} {ms:.3f} ({n})"
                      for name, ms, n in ap["host"]) + f" {stamp}")
    em = apps["emb"]

    seg_err = {str(s): c["max_abs_err"] for s, c in segv.items()}

    def sass_of(name: str) -> dict | None:
        """The scoring classes summed over a kernel's SEG instances, or None
        where no SASS was read (no cuobjdump)."""
        if not sass:
            return None
        return {c: sum(v[c] for k, v in sass.items()
                       if k.startswith(name + "<")) for c in SASS_CLASSES}

    def entry(name, source, replaces, launches, max_err, ms, plain_ms, b,
              **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                    library_ms=None, bound_share=b["bound_ms"] / ms, **extra)

    def path(b: dict) -> dict:
        return {k: b[k] for k in ("ms", "bound_ms", "bound_by",
                                  "bound_share")}
    kernels = [
        entry("adc_segmin", KERNEL_SRC, "cvt_tpu/ops/pallas/adc_scan.py:76",
              res["launches"]["adc_segmin"] + sv["launches"]
              + arc["dryrun_launches"],
              max(cmp["adc_segmin"]["max_abs_err"],
                  sv["cmp"]["max_abs_err"], *seg_err.values()),
              tm["adc_segmin_ms"], tm["adc_segmin_plain_ms"],
              flat_b["adc_segmin"],
              launches_by_path={"flat": res["launches"]["adc_segmin"],
                                "serve": sv["launches"],
                                "dryrun": arc["dryrun_launches"]},
              seg_variants_max_abs_err=seg_err,
              by_path={"flat": path(flat_b["adc_segmin"]),
                       "serve": path(sv["bound"])},
              split_ms=split["adc_segmin"], sass=sass_of("adc_segmin_kernel")),
        entry("adc_segmin_cached", KERNEL_SRC,
              "cvt_tpu/ops/pallas/adc_scan.py:448",
              res["launches"]["adc_segmin_cached"] + sq["launches"]
              + em["launches"] + arc["launches"],
              max(cmp["adc_segmin_cached"]["max_abs_err"],
                  sq["cmp"]["max_abs_err"], em["cmp"]["max_abs_err"],
                  arc["cmp"]["max_abs_err"]),
              tm["adc_segmin_cached_ms"], tm["adc_segmin_cached_plain_ms"],
              flat_b["adc_segmin_cached"],
              launches_by_path={"flat": res["launches"]["adc_segmin_cached"],
                                "sq": sq["launches"],
                                "embeddings": em["launches"],
                                "records": arc["launches"]},
              by_path={"flat": path(flat_b["adc_segmin_cached"]),
                       "sq": path(sq["bound"]),
                       "embeddings": dict(path(em["bound"]),
                                          plain_ms=em["plain_ms"]),
                       "records": dict(path(arc["bound"]),
                                       plain_ms=arc["plain_ms"],
                                       seg=arc["seg"])},
              split_ms=split["adc_segmin_cached"],
              sass=sass_of("adc_segmin_cached_kernel")),
        entry("ivf_page", IVF_SRC, "cvt_tpu/ops/pallas/ivf_scan.py:82",
              iv["launches"],
              max(ivf_cmp["max_abs_err"], ivf_rand["max_abs_err"],
                  ivf_rand_live["max_abs_err"]),
              itm["ivf_page_ms"], itm["ivf_page_plain_ms"], ivf_b,
              live_slots=ivf_b["live_slots"], by_path={"ivf": path(ivf_b)},
              by_nprobe={str(p): dict(path(b), live_slots=b["live_slots"])
                         for p, b in ivf_bp.items()},
              sass=sass_of("ivf_page_kernel"))]

    # step 27 last, with every tensor of steps 1-26 dropped, so that the
    # bench's process has the card to itself
    del (rand_dec, rand_cached, rand_norm, idx, q_dev, base_dev, gt,
         ids_ref, dec_args, cached_args, ivf_idx, ivf_by_p, ivf_args, res,
         iv, sq, sv, feat, match, recon, apps, arc, em, prof, mp, bp, ap)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before step 27 this process holds "
          f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB reserved on the "
          f"card {stamp}")
    launches = run_bench(stamp)["kernel_launches"]
    bcmp = phase_bench_kernels(stamp)
    for e in kernels:
        if e["name"] in bcmp:
            e["launches"] += launches[e["name"]]
            e["launches_by_path"]["bench"] = launches[e["name"]]
            e["max_abs_err"] = max(e["max_abs_err"],
                                   bcmp[e["name"]]["max_abs_err"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
