"""cvt-tpu's retrieval core on PyTorch and CUDA (NVIDIA Hopper).

The counterpart of `cvt_tpu`, module by module at the same relative
paths. Plain tensor code is PyTorch; every kernel that `cvt_tpu` wrote in
Pallas is a hand-written CUDA C++ kernel under `csrc/`, built with nvcc for
sm_90a on first use (`ops/kernels/_build.py`). Each kernel has a plain
PyTorch twin in the same module: the wrapper runs the twin for tensors on
the CPU and launches the kernel (or raises) for tensors on the card.

This package imports `torch` and numpy only, never `jax` or `cvt_tpu`.

Subpackages:
  io        fvecs/bvecs/ivecs, the cvt id+feature record stream (native
            reader / writer), SIFT-like synthetic data, procedural
            images, the SQLite feature database, the video reader
  ops       normalize, pairwise distances, full-precision convolutions,
            top-k with lax.top_k's tie order, flat / blocked /
            hierarchical k-means, bit and resize helpers; ops/kernels
            the flat ADC and IVF page scan kernels and their twins
  quant     ScalarQuantizer (int8 SQ), ProductQuantizer, OPQ, PCA
  index     FlatIndex (exact), FlatSQIndex (int8 SQ codes),
            FlatADCIndex (PQ/OPQ codes), IVFADCIndex (inverted lists of
            residual PQ codes), VocabHEIndex (vocabulary tree + Hamming
            embedding over images), HnswIndex (host-side native graph)
  features  Gaussian scale space, DoG / Hessian detection, orientations,
            SIFT / RootSIFT / DSP-SIFT descriptors, affine shapes,
            extract_sift and the batched extraction pipeline, LSD lines,
            CNN and text embeddings
  match     2-D solvers, SVF, batched RANSAC and vote-and-verify
            spatial verification, two-view geometry, matching pipelines,
            poses, bundle adjustment, the reconstruction
  apps      ImageRetrievalIndex (per-descriptor kNN votes re-ranked by
            SVF or RANSAC), undistortion, perceptual hash, detection
            decode + NMS, motion area, pupil tracking, template / logo /
            video object match
  train     ArcFace training (additive angular margin, autograd, a
            data-parallel step over a mesh) and the packed record store
  parallel  device meshes, ShardedADCSearcher, MultiHostADCServer,
            QueryBatcher, sharded k-means over torch.distributed, the
            multi-device dry run
  native    host C++ built by path: HNSW, the record stream, ffdecode
  utils     recall@k, AUC, Timer, torch.profiler traces, chained
            timing, roofline, launch overhead, the device rule, logging
  config    the typed configuration and its JSON (`cvt_tpu`'s format)
  convert   numpy parameters of `cvt_tpu` objects -> the port's objects
  cli       `python -m cvt_tpu_torch.cli <command> ...`
"""

__version__ = "0.1.0"
