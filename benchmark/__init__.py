"""The benchmark of the PyTorch and CUDA port (`cvt_tpu_torch`)."""
