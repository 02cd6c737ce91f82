"""cvt-tpu's retrieval core on PyTorch and CUDA (NVIDIA Hopper).

The counterpart of `cvt_tpu`, module by module at the same relative
paths. Plain tensor code is PyTorch; every kernel that `cvt_tpu` wrote in
Pallas is a hand-written CUDA C++ kernel under `csrc/`, built with nvcc for
sm_90a on first use (`ops/kernels/_build.py`). Each kernel has a plain
PyTorch twin in the same module: the wrapper runs the twin for tensors on
the CPU and launches the kernel (or raises) for tensors on the card.

This package imports `torch` and numpy only, never `jax` or `cvt_tpu`.

Subpackages:
  io        fvecs/bvecs/ivecs, SIFT-like synthetic data
  ops       normalize, pairwise distances, stable top-k, k-means;
            ops/kernels the flat ADC and IVF page scan kernels and
            their twins
  quant     ProductQuantizer, OPQ
  index     FlatIndex (exact), FlatADCIndex (PQ/OPQ codes),
            IVFADCIndex (inverted lists of residual PQ codes)
  utils     recall@k
  convert   numpy parameters of `cvt_tpu` objects -> the port's objects
"""

__version__ = "0.1.0"
