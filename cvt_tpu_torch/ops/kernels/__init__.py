"""Hand-written CUDA kernels (sources in `cvt_tpu_torch/csrc/`), their
wrappers and their plain PyTorch twins."""


def _wrappers() -> dict:
    """Each kernel's name and the wrapper that counts its launches."""
    from cvt_tpu_torch.ops.kernels import adc_scan, ivf_scan
    return {"adc_segmin": adc_scan.adc_segmin,
            "adc_segmin_cached": adc_scan.adc_segmin_cached,
            "ivf_page": ivf_scan.ivf_pages_segmin}


def launch_counts() -> dict:
    """The launches each kernel wrapper has counted (`.launches`) since its
    count was last set to 0."""
    return {name: w.launches for name, w in _wrappers().items()}


def zero_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for w in _wrappers().values():
        w.launches = 0
