"""Hand-written CUDA kernels (sources in `cvt_tpu_torch/csrc/`), their
wrappers and their plain PyTorch twins.

Here: each wrapper's launch count, the arguments a call hands a wrapper
(`recorded_args`), and a kernel held against its twin on them
(`compare_kernel_to_twin`, `compare_ivf_kernel`,
`compare_rescore_kernel`, `compare_vocab_kernel`,
`compare_descend_kernel`, `twin_check`)."""

import torch


def wrappers() -> dict:
    """Each kernel's name and the wrapper that counts its launches."""
    from cvt_tpu_torch.ops.kernels import (adc_scan, ivf_scan,
                                           vocab_descend, vocab_score)
    return {"adc_segmin": adc_scan.adc_segmin,
            "adc_segmin_cached": adc_scan.adc_segmin_cached,
            "ivf_page": ivf_scan.ivf_pages_segmin,
            "ivf_rescore": ivf_scan.ivf_rescore,
            "vocab_score": vocab_score.vocab_score,
            "vocab_descend": vocab_descend.vocab_descend}


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


def rescore_tolerance(args) -> torch.Tensor:
    """[B, 1] bound on |kernel - twin| of an `ivf_rescore` distance on
    `args`: the twin rounds each product of the inner product and sums them
    in torch's order, the kernel fuses them and sums in its own, so each
    is within D * 2^-24 * sum_i |q_i srow16_i dec_i| of the exact sum; the
    distance takes -2 of it, and a few ulp of its size besides. The sum of
    |products| is bounded by ||q * srow16|| * the largest row norm."""
    dec16, srow16, q, q_sq = args[5], args[6], args[9], args[10]
    u = 2.0 ** -24
    rows = torch.linalg.vector_norm(dec16.double(), dim=1).amax()
    qf = torch.linalg.vector_norm(q.double() * srow16.double(), dim=1)
    size = q_sq.double().abs() + 2 * qf * rows
    return (4 * q.shape[1] * u * qf * rows + 8 * u * size)[:, None]


def compare_rescore_kernel(args) -> dict:
    """The ivf_rescore kernel against its twin on the same arguments (an
    `ivf_rescore` call's own): the same slots finite, distances within
    `rescore_tolerance`, no id twice in a row, and ids equal except at
    near-ties: where the kernel's id differs from the twin's, the twin's
    distance of the kernel's id (the twin run over the whole candidate
    pool) lies within twice the tolerance of that slot's; raise otherwise.
    Returns the largest error, its share of the tolerance, and the slots
    whose ids differ as (query, slot, kernel id, twin id)."""
    from cvt_tpu_torch.ops.kernels import ivf_scan as V
    got_d, got_i = V.ivf_rescore(*args)
    want_d, want_i = V.ivf_rescore_plain(*args)
    tol = rescore_tolerance(args)
    fin = torch.isfinite(want_d)
    if not torch.equal(torch.isfinite(got_d), fin):
        raise AssertionError("ivf_rescore kernel: finite slots differ")
    if bool((got_i[~fin] != -1).any()):
        raise AssertionError("ivf_rescore kernel: an id past the pool")
    err = torch.where(fin, (got_d.double() - want_d.double()).abs(), 0.0)
    if bool((err > tol).any()):
        raise AssertionError(f"ivf_rescore kernel: distance off by "
                             f"{float(err.max())}, over its tolerance")
    ids = torch.where(fin, got_i, -1).sort(dim=1).values
    if bool(((ids[:, 1:] == ids[:, :-1]) & (ids[:, 1:] >= 0)).any()):
        raise AssertionError("ivf_rescore kernel: an id twice in a row")
    differ = torch.nonzero(got_i != want_i).tolist()
    if differ:
        segpack, seg, k, slack = args[0], args[13], args[14], args[15]
        pool = min(k + slack, segpack.shape[0]) * seg
        pool_d, pool_i = (x.cpu() for x in V.ivf_rescore_plain(
            *args[:14], pool, k + slack - pool, *args[16:]))
        gi, wd, t = got_i.cpu(), want_d.double().cpu(), tol.cpu()
        for r, c in differ:
            hit = pool_i[r] == gi[r, c]
            if not bool(hit.any()):
                raise AssertionError(f"ivf_rescore kernel: id {int(gi[r, c])}"
                                     f" at query {r} is not a candidate")
            gap = (pool_d[r][hit].double() - wd[r, c]).abs().min()
            if float(gap) > 2 * float(t[r, 0]):
                raise AssertionError(f"ivf_rescore kernel: id differs from "
                                     f"its twin's at query {r}, slot {c}, "
                                     f"not a near-tie")
    wi = want_i.cpu()
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0,
            "max_err_share_of_tol": float((err / tol).max())
            if err.numel() else 0.0,
            "ids_differ": len(differ),
            "differ": [(r, c, int(got_i[r, c]), int(wi[r, c]))
                       for r, c in differ[:20]],
            "shape": list(got_i.shape)}


def compare_vocab_kernel(args) -> dict:
    """The vocab_score kernel against its twin on the same arguments: the
    same float32 terms summed in float64 in another order, so every score
    within 2^-23 of its size (a float32 rounding apart, for a sum at a
    rounding boundary); raise otherwise."""
    from cvt_tpu_torch.ops.kernels import vocab_score as V
    got = V.vocab_score(*args).cpu()
    want = V.vocab_score_plain(*(a.cpu() if torch.is_tensor(a) else a
                                 for a in args))
    err = (got.double() - want.double()).abs()
    bad = err > 2.0 ** -23 * want.double().abs()
    if bool(bad.any()):
        raise AssertionError(f"vocab_score kernel differs from its twin by "
                             f"{float(err.max())}")
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0,
            "scores_differ": int((err > 0).sum()),
            "shape": list(got.shape)}


def compare_descend_kernel(args) -> dict:
    """The vocab_descend kernel against its twin on the same arguments,
    the twin run where they lie (it sums integers in float64, exactly):
    distances and word ids bitwise, or raise. The wrapper's pair count
    stays as it was, as `twin_check` keeps its launch count."""
    from cvt_tpu_torch.ops.kernels import vocab_descend as V
    pairs = V.vocab_descend.pairs
    try:
        got_d, got_s = V.vocab_descend(*args)
    finally:
        V.vocab_descend.pairs = pairs
    want_d, want_s = V.vocab_descend_plain(*args)
    err = int((got_d.long() - want_d.long()).abs().max()) \
        if got_d.numel() else 0
    ids_differ = int((got_s != want_s).sum())
    if err or ids_differ:
        raise AssertionError(f"vocab_descend kernel differs from its twin: "
                             f"max|diff| {err}, {ids_differ} ids")
    return {"max_abs_err": err, "ids_differ": ids_differ,
            "pairs": int(got_d.numel()), "tiles": int(args[2].shape[0])}


def twin_check(name: str, args: tuple) -> dict:
    """Kernel `name` against its twin on `args` (a call's own, as
    `recorded_args` gives them): `compare_ivf_kernel` for ivf_page,
    `compare_rescore_kernel` for ivf_rescore, `compare_vocab_kernel` for
    vocab_score, `compare_descend_kernel` for vocab_descend, else
    `compare_kernel_to_twin` with the row norms the kernel scores; raises
    on a difference. The comparison's launch is not one of the path's, so
    it leaves the wrapper's count as it was."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    w = wrappers()[name]
    launches = w.launches
    try:
        if name == "ivf_page":
            return compare_ivf_kernel(args)
        if name == "ivf_rescore":
            return compare_rescore_kernel(args)
        if name == "vocab_score":
            return compare_vocab_kernel(args)
        if name == "vocab_descend":
            return compare_descend_kernel(args)
        if name == "adc_segmin":
            norm = T._row_norms(T.decode_int8(args[2], args[3]), args[4])
            return compare_kernel_to_twin(w, T.adc_segmin_plain, args, norm,
                                          args[1], args[6], args[7])
        return compare_kernel_to_twin(w, T.adc_segmin_cached_plain, args,
                                      args[3][:, 0], args[1], args[5],
                                      args[6])
    finally:
        w.launches = launches
