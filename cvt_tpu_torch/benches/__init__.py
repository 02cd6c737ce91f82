"""The repository's workload benches on the port: one module for each
top-level `_bench_*.py` script, run as

    python -m cvt_tpu_torch.benches.<name> [stage] [--device cpu]

  ivf       `_bench_ivf.py`       IVF-ADC against the flat scan, N 1M / 10M
  serve     `_bench_serve.py`     the serving tax at B 8,192 over 1M codes
  dogfood   `_bench_dogfood.py`   a 1M-descriptor extract_sift corpus and
                                  the config-1 / config-2 recall parity
  vocab5    `_bench_vocab5.py`    warped mosaic queries at W 65,536 (A),
                                  batched queries at W 1,048,576 (B)
  vocab     `_bench_vocab.py`     the 1,048,576-word tree end to end
  features  `_bench_features.py`  extraction sweep, 2-NN matching,
                                  two-view verification
  hnsw      `_bench_hnsw.py`      makeIdx.cpp's recall-against-latency sweep

Each prints one JSON line per lane as it ends, then a result object as its
last line with the device (nvidia-smi's name and power limit, or "cpu"),
the launches of the three kernel wrappers during the run and, for each
kernel lane, the kernel's time beside its bound. The suites run on the
card unless asked for the CPU, write nothing into the repository but the
git-ignored `_data/` (the dogfood corpus), and time the card with CUDA
events (`utils.profile.chained_time`).
"""
