"""Inverted-file scoring of the vocabulary tree with 64-bit Hamming
embedding: every query feature against its word's list of database
entries (cvt's per-word lists, inverted_file.h), in CSR form.

The index (`index/vocab_he.py`) keeps its entries sorted by word:
`offsets` [W + 1] int64, and per entry its image `e_img` int32, signature
`e_sig` int64 and burstiness weight `e_burst` float32. A batch's query
features come flat: `f_word` int32 (-1 for none), `f_sig` int64 and
`f_query` int32, the query each belongs to. Each pair of a feature and
an entry of its word's list within `len(wtab) - 1` bits adds the float32
term (wtab[h] * idf[w]^2) * e_burst[e] to its query's score of the
entry's image, in float64, and the [Q, n_images] sums are rounded to
float32 once (inverted_file.h:295-353; wtab[h] = exp(-h^2 / sigma^2),
utils.h:52-83, is the caller's table).

`vocab_score` (`ops.kernels.Kernel`) launches the hand-written CUDA
kernel `vocab_score_kernel` (`csrc/vocab_score.cu`) for tensors on the
card and runs the plain twin `vocab_score_plain` for tensors on the CPU.
Both form
the same float32 terms from the same table; the float64 sums may differ
in order, so the float32 results agree bitwise bar a sum within ~1e-13
of a rounding boundary.
"""

from __future__ import annotations

import torch

from cvt_tpu_torch.ops.bits import _hamming
from cvt_tpu_torch.ops.kernels import kernel

_TWIN_PAIRS = 1 << 24         # pairs the twin scores per step
_BLOCKS_PER_SM = 8


def _lengths(f_word, offsets):
    """Each feature's list length (0 for f_word < 0), int64."""
    w = f_word.long()
    wc = w.clamp_min(0)
    return torch.where(w >= 0, offsets[wc + 1] - offsets[wc], 0)


def vocab_score_plain(f_word, f_sig, f_query, offsets, e_img, e_sig,
                      e_burst, idf, wtab, n_queries: int, n_images: int):
    """-> float32 scores [n_queries, n_images] (the module's contract),
    the features' pairs expanded in steps of at most `_TWIN_PAIRS`."""
    dev = f_word.device
    max_dist = wtab.shape[0] - 1
    length = _lengths(f_word, offsets)
    cum = torch.cumsum(length, 0)
    ends = cum.cpu()
    out = torch.zeros(n_queries * n_images, dtype=torch.float64, device=dev)
    lo = 0
    while lo < len(ends):
        base = int(ends[lo - 1]) if lo else 0
        hi = max(lo + 1, int(torch.searchsorted(ends, base + _TWIN_PAIRS,
                                                right=True)))
        n = int(ends[hi - 1]) - base
        fi = torch.repeat_interleave(torch.arange(lo, hi, device=dev),
                                     length[lo:hi], output_size=n)
        w = f_word[fi].long()
        e = offsets[w] + (torch.arange(base, base + n, device=dev)
                          - (cum[fi] - length[fi]))
        h = _hamming(f_sig[fi], e_sig[e])
        weight = torch.where(h <= max_dist, wtab[h.clamp_max(max_dist)], 0.0)
        term = weight * (idf[w] ** 2) * e_burst[e]
        out.index_add_(0, f_query[fi].long() * n_images + e_img[e].long(),
                       term.double())
        lo = hi
    return out.float().reshape(n_queries, n_images)


def _check(f_word, f_sig, f_query, offsets, e_img, e_sig, e_burst, idf,
           wtab, *_) -> None:
    want = {"f_word": (f_word, torch.int32), "f_sig": (f_sig, torch.int64),
            "f_query": (f_query, torch.int32),
            "offsets": (offsets, torch.int64), "e_img": (e_img, torch.int32),
            "e_sig": (e_sig, torch.int64), "e_burst": (e_burst, torch.float32),
            "idf": (idf, torch.float32), "wtab": (wtab, torch.float32)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"vocab_score: {name} must be a contiguous 1-D "
                             f"{dtype} tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != f_word.device:
            raise ValueError(f"vocab_score: {name} on {t.device}, not on "
                             f"{f_word.device}")
    n = f_word.shape[0]
    if f_sig.shape[0] != n or f_query.shape[0] != n:
        raise ValueError("vocab_score: f_word, f_sig, f_query differ in "
                         "length")
    if offsets.shape[0] != idf.shape[0] + 1:
        raise ValueError("vocab_score: offsets must be [W + 1] for idf [W]")
    if not 1 <= wtab.shape[0] <= 65:
        raise ValueError("vocab_score: wtab holds 1 to 65 weights")
    if not (e_img.shape[0] == e_sig.shape[0] == e_burst.shape[0]):
        raise ValueError("vocab_score: entry arrays differ in length")


def compare_vocab_kernel(args) -> dict:
    """The vocab_score kernel against its twin on the same arguments: the
    same float32 terms summed in float64 in another order, so every score
    within 2^-23 of its size (a float32 rounding apart, for a sum at a
    rounding boundary); raise otherwise."""
    got = vocab_score(*args).cpu()
    want = vocab_score_plain(*(a.cpu() if torch.is_tensor(a) else a
                                 for a in args))
    err = (got.double() - want.double()).abs()
    bad = err > 2.0 ** -23 * want.double().abs()
    if bool(bad.any()):
        raise AssertionError(f"vocab_score kernel differs from its twin by "
                             f"{float(err.max())}")
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0,
            "scores_differ": int((err > 0).sum()),
            "shape": list(got.shape)}


@kernel("vocab_score", symbol="cvt_vocab_score", args="pppp i pppppp iii pp",
        twin=vocab_score_plain, compare=compare_vocab_kernel, check=_check,
        span="kernel.vocab_score")
def vocab_score(f_word, f_sig, f_query, offsets, e_img, e_sig, e_burst, idf,
                wtab, n_queries: int, n_images: int):
    """-> float32 scores [n_queries, n_images] (the module's contract).

    Tensors on the CPU run the twin; tensors on the card launch
    `vocab_score_kernel` once a call, inside one `kernel.vocab_score`
    span with the lists' prefix sum and the zeroed float64 block. Any
    other device raises."""
    dev = f_word.device
    out = torch.zeros((n_queries, n_images), dtype=torch.float64, device=dev)
    n_feat = f_word.shape[0]
    if n_feat == 0 or out.numel() == 0:
        return out.float()
    cum = torch.cumsum(_lengths(f_word, offsets), 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    vocab_score.launch(
        f_word.data_ptr(), f_sig.data_ptr(), f_query.data_ptr(),
        cum.data_ptr(), n_feat, offsets.data_ptr(), e_img.data_ptr(),
        e_sig.data_ptr(), e_burst.data_ptr(), idf.data_ptr(), wtab.data_ptr(),
        wtab.shape[0] - 1, n_images, sms * _BLOCKS_PER_SM, out.data_ptr())
    return out.float()
