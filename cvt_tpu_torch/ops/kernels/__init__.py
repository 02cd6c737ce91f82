"""Hand-written CUDA kernels (sources in `cvt_tpu_torch/csrc/`), their
wrappers and their plain PyTorch twins."""
