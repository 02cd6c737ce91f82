"""cvt-tpu's retrieval core on PyTorch and CUDA (NVIDIA Hopper).

The counterpart of `cvt_tpu`, module by module at the same relative
paths. Plain tensor code is PyTorch; every kernel that `cvt_tpu` wrote in
Pallas is a hand-written CUDA C++ kernel under `csrc/`, built with nvcc for
sm_90a on first use (`ops/kernels/_build.py`). Each kernel has a plain
PyTorch twin in the same module: the wrapper runs the twin for tensors on
the CPU and launches the kernel (or raises) for tensors on the card.

This package imports `torch` and numpy only, never `jax` or `cvt_tpu`.

Subpackages:
  io        fvecs/bvecs/ivecs, SIFT-like synthetic data, procedural
            images, the SQLite feature database
  ops       normalize, pairwise distances, top-k with lax.top_k's tie
            order, flat / blocked / hierarchical k-means; ops/kernels
            the flat ADC and IVF page scan kernels and their twins
  quant     ScalarQuantizer (int8 SQ), ProductQuantizer, OPQ, PCA
  index     FlatIndex (exact), FlatSQIndex (int8 SQ codes),
            FlatADCIndex (PQ/OPQ codes), IVFADCIndex (inverted lists of
            residual PQ codes), VocabHEIndex (vocabulary tree + Hamming
            embedding over images)
  features  Gaussian scale space, DoG / Hessian detection, orientations,
            SIFT / RootSIFT / DSP-SIFT descriptors, affine shapes,
            extract_sift and the batched extraction pipeline
  match     2-D solvers, SVF, batched RANSAC and vote-and-verify
            spatial verification
  apps      ImageRetrievalIndex: per-descriptor kNN votes re-ranked by
            SVF or RANSAC
  parallel  device meshes, ShardedADCSearcher, MultiHostADCServer,
            QueryBatcher, sharded k-means over torch.distributed
  utils     recall@k, the device rule
  convert   numpy parameters of `cvt_tpu` objects -> the port's objects
  cli       `python -m cvt_tpu_torch.cli <command> ...`
"""

__version__ = "0.1.0"
