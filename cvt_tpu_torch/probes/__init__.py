"""The repository's profiling probes on the port: one module for each
top-level `_prof_*.py` script that splits a device path into stages, run
as

    python -m cvt_tpu_torch.probes.<name> [--device cpu] [--reps R] [--quick]

  adc     `_prof_adc.py`     ADC phase 1 alone against the fast search at
                             B 4,096 / 8,192 / 16,384, and the tile sweep
  detect  `_prof_detect.py`  SIFT detection: the pyramid, the 3x3x3
                             stencil, the raw top-k, `detect_octave`
  feat    `_prof_feat.py`    the fast extraction path: pyramid, detection
                             and selection, orientations, descriptors
  orient  `_prof_orient.py`  the orientation pass: its gathers alone, its
                             histogram and peaks alone, the whole pass

Each prints one JSON line per stage (its name, the median ms per
iteration over the timed windows, the fastest and slowest window, the
shapes), then a result line with the device (nvidia-smi's name and power
limit, or "cpu") and the launches of the three kernel wrappers. They run
on the card unless asked for the CPU and time it with CUDA events
(`benches._common.timed_windows`). `--quick` takes one window per stage.
"""
