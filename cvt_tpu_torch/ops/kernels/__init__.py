"""Hand-written CUDA kernels (sources in `cvt_tpu_torch/csrc/`), their
wrappers and their plain PyTorch twins.

Here: each wrapper's launch count, the arguments a call hands a wrapper
(`recorded_args`), and a kernel held against its twin on them
(`compare_kernel_to_twin`, `compare_ivf_kernel`, `twin_check`)."""

import torch


def wrappers() -> dict:
    """Each kernel's name and the wrapper that counts its launches."""
    from cvt_tpu_torch.ops.kernels import adc_scan, ivf_scan
    return {"adc_segmin": adc_scan.adc_segmin,
            "adc_segmin_cached": adc_scan.adc_segmin_cached,
            "ivf_page": ivf_scan.ivf_pages_segmin}


def launch_counts() -> dict:
    """The launches each kernel wrapper has counted (`.launches`) since its
    count was last set to 0."""
    return {name: w.launches for name, w in wrappers().items()}


def zero_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for w in wrappers().values():
        w.launches = 0


def recorded_args(name: str, call) -> tuple:
    """The positional arguments of the first call of kernel `name`'s
    wrapper inside call(), which runs as it would (the wrapper itself runs
    and counts its launches)."""
    w = wrappers()[name]
    w.recorded = []
    try:
        call()
        seen = w.recorded
    finally:
        w.recorded = None
    if not seen:
        raise RuntimeError(f"the call never reached the {name} wrapper")
    return seen[0]


def compare_kernel_to_twin(kernel, twin, args, norm, qs, tile_n,
                           seg: int = 128) -> dict:
    """Run an ADC kernel and its twin on the same arguments. Differences
    are allowed only in segments (and tiles) holding a row whose norm/qs
    lies within 1e-4 of a half-integer (float32 summation order), and a
    segment minimum may move by at most seg; anything else raises."""
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


def compare_ivf_kernel(args) -> dict:
    """The ivf_page kernel against its twin on the same arguments (it sums
    no floats): bitwise, or raise."""
    from cvt_tpu_torch.ops.kernels import ivf_scan as V
    got = V.ivf_pages_segmin(*args)
    want = V.ivf_pages_segmin_plain(*args)
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError(f"ivf_page kernel differs from its twin by "
                             f"{err}")
    return {"max_abs_err": err, "shape": list(got.shape)}


def twin_check(name: str, args: tuple) -> dict:
    """Kernel `name` against its twin on `args` (a call's own, as
    `recorded_args` gives them): `compare_ivf_kernel` for ivf_page, else
    `compare_kernel_to_twin` with the row norms the kernel scores; raises
    on a difference. The comparison's launch is not one of the path's, so
    it leaves the wrapper's count as it was."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    w = wrappers()[name]
    launches = w.launches
    try:
        if name == "ivf_page":
            return compare_ivf_kernel(args)
        if name == "adc_segmin":
            norm = T._row_norms(T.decode_int8(args[2], args[3]), args[4])
            return compare_kernel_to_twin(w, T.adc_segmin_plain, args, norm,
                                          args[1], args[6], args[7])
        return compare_kernel_to_twin(w, T.adc_segmin_cached_plain, args,
                                      args[3][:, 0], args[1], args[5],
                                      args[6])
    finally:
        w.launches = launches
