"""Candidate matches of the vocabulary tree's spatial verification, over
its inverted file in CSR form (cvt's per-word lists, inverted_file.h).

The index (`index/vocab_he.py`) keeps its entries sorted by word:
`offsets` [W + 1] int64, and per entry its image `e_img` int32,
signature `e_sig` int64 and database feature `e_feat` int32 (the entry's
row in the index's flat feature order, which finds its frame). A batch's
query features come flat as for `vocab_score`: `f_word` int32 (-1 for
none), `f_sig` int64, `f_query` int32. `cand` [Q, n_images] int32 holds,
for each query and image, the slot of that (query, candidate) pair, or
-1 for an image that is not one of the query's candidates.

Each pair of a feature f and an entry e of its word's list whose image is
a candidate of f's query and whose signatures lie within `max_dist` bits
(visual_index.h's max Hamming distance) is one record, int32 [4]:
(pair slot, f, e_feat[e], Hamming distance). The twin gives them in walk
order, feature by feature and each list in order; the kernel in the order
its atomics land: the caller sorts them (`compare_match_kernel` compares
sorted records).

`vocab_match` (`ops.kernels.Kernel`) launches the hand-written CUDA kernel
`vocab_match_kernel` (`csrc/vocab_match.cu`) for tensors on the card and
runs the plain twin `vocab_match_plain` for tensors on the CPU. On the
card `capacity` is the room the first launch gives: a call that finds more
records launches once more with room for them all (the count read back is
the call's one host sync). Counters: `.launches`, `.pairs` (pairs walked,
summed on the call's device: no host sync of its own) and `.matches`
(records returned).
"""

from __future__ import annotations

import torch

from cvt_tpu_torch.ops.bits import _hamming
from cvt_tpu_torch.ops.kernels import kernel

_TWIN_PAIRS = 1 << 24         # pairs the twin walks per step
_BLOCKS_PER_SM = 8


def _lengths(f_word, offsets):
    """Each feature's list length (0 for f_word < 0), int64."""
    w = f_word.long()
    wc = w.clamp_min(0)
    return torch.where(w >= 0, offsets[wc + 1] - offsets[wc], 0)


def vocab_match_plain(f_word, f_sig, f_query, offsets, e_img, e_sig, e_feat,
                      cand, max_dist: int, capacity: int = 1 << 20):
    """-> records [n, 4] int32 in walk order (the module's contract), the
    pairs expanded in steps of at most `_TWIN_PAIRS`; `capacity` is the
    card's and is not read here."""
    dev = f_word.device
    n_images = cand.shape[1]
    length = _lengths(f_word, offsets)
    cum = torch.cumsum(length, 0)
    ends = cum.cpu()
    out = [torch.zeros((0, 4), dtype=torch.int32, device=dev)]
    lo = 0
    while lo < len(ends):
        base = int(ends[lo - 1]) if lo else 0
        hi = max(lo + 1, int(torch.searchsorted(ends, base + _TWIN_PAIRS,
                                                right=True)))
        n = int(ends[hi - 1]) - base
        fi = torch.repeat_interleave(torch.arange(lo, hi, device=dev),
                                     length[lo:hi], output_size=n)
        e = offsets[f_word[fi].long()] + (torch.arange(base, base + n,
                                                       device=dev)
                                          - (cum[fi] - length[fi]))
        slot = cand.reshape(-1)[f_query[fi].long() * n_images
                                + e_img[e].long()]
        h = _hamming(f_sig[fi], e_sig[e])
        keep = (slot >= 0) & (h <= max_dist)
        out.append(torch.stack([slot, fi.int(), e_feat[e], h.int()],
                               1)[keep].int())
        lo = hi
    return torch.cat(out)


def _check(f_word, f_sig, f_query, offsets, e_img, e_sig, e_feat, cand,
           max_dist, capacity) -> None:
    want = {"f_word": (f_word, torch.int32), "f_sig": (f_sig, torch.int64),
            "f_query": (f_query, torch.int32),
            "offsets": (offsets, torch.int64), "e_img": (e_img, torch.int32),
            "e_sig": (e_sig, torch.int64), "e_feat": (e_feat, torch.int32)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype or not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"vocab_match: {name} must be a contiguous 1-D "
                             f"{dtype} tensor, got {t.dtype} {tuple(t.shape)}")
    if (cand.dtype != torch.int32 or not cand.is_contiguous()
            or cand.dim() != 2):
        raise ValueError(f"vocab_match: cand must be a contiguous 2-D int32 "
                         f"tensor, got {cand.dtype} {tuple(cand.shape)}")
    for name, t in (*((k, t) for k, (t, _) in want.items()), ("cand", cand)):
        if t.device != f_word.device:
            raise ValueError(f"vocab_match: {name} on {t.device}, not on "
                             f"{f_word.device}")
    n = f_word.shape[0]
    if f_sig.shape[0] != n or f_query.shape[0] != n:
        raise ValueError("vocab_match: f_word, f_sig, f_query differ in "
                         "length")
    if not (e_img.shape[0] == e_sig.shape[0] == e_feat.shape[0]):
        raise ValueError("vocab_match: entry arrays differ in length")
    if cand.shape[1] < 1:
        raise ValueError("vocab_match: cand holds no image")
    if not 0 <= max_dist <= 64:
        raise ValueError("vocab_match: max_dist lies in 0..64")
    if not 0 <= capacity < 2 ** 31:
        raise ValueError("vocab_match: capacity lies in 0..2^31 - 1")


def sorted_records(rec: torch.Tensor) -> torch.Tensor:
    """Records in (pair, query feature, database feature) order: a set of
    records, whatever order they were emitted in, gives one tensor."""
    r = rec.long()
    order = torch.argsort(r[:, 2], stable=True)
    order = order[torch.argsort(r[order, 1], stable=True)]
    order = order[torch.argsort(r[order, 0], stable=True)]
    return rec[order]


def compare_match_kernel(args) -> dict:
    """The vocab_match kernel against its twin on the same arguments: the
    same records once each, in another order; raise otherwise."""
    got = sorted_records(vocab_match(*args).cpu())
    want = sorted_records(vocab_match_plain(*(a.cpu() if torch.is_tensor(a)
                                              else a for a in args)))
    same = got.shape == want.shape and torch.equal(got, want)
    if not same:
        raise AssertionError(f"vocab_match kernel differs from its twin: "
                             f"{got.shape[0]} records against "
                             f"{want.shape[0]}")
    return {"max_abs_err": 0, "records": int(got.shape[0])}


@kernel("vocab_match", symbol="cvt_vocab_match",
        args="pppp i ppppp iiii ppp", twin=vocab_match_plain,
        compare=compare_match_kernel, check=_check,
        counts={"pairs": lambda _, f_word, f_sig, f_query, offsets, *a:
                _lengths(f_word, offsets).sum(),
                "matches": lambda out, *a: out.shape[0]})
def vocab_match(f_word, f_sig, f_query, offsets, e_img, e_sig, e_feat, cand,
                max_dist: int, capacity: int = 1 << 20):
    """-> records [n, 4] int32 (the module's contract).

    Tensors on the CPU run the twin; tensors on the card launch
    `vocab_match_kernel`, once, or twice where more than `capacity`
    records are found. Any other device raises."""
    dev = f_word.device
    n_feat = f_word.shape[0]
    if n_feat == 0 or e_img.shape[0] == 0:
        return torch.zeros((0, 4), dtype=torch.int32, device=dev)
    cum = torch.cumsum(_lengths(f_word, offsets), 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    while True:
        out = torch.empty((max(capacity, 1), 4), dtype=torch.int32,
                          device=dev)
        vocab_match.launch(
            f_word.data_ptr(), f_sig.data_ptr(), f_query.data_ptr(),
            cum.data_ptr(), n_feat, offsets.data_ptr(), e_img.data_ptr(),
            e_sig.data_ptr(), e_feat.data_ptr(), cand.data_ptr(),
            cand.shape[1], max_dist, capacity, sms * _BLOCKS_PER_SM,
            count.data_ptr(), out.data_ptr())
        n = int(count)
        if n <= capacity:
            return out[:n]
        if n >= 2 ** 31:
            raise ValueError(f"vocab_match: {n} records, past int32")
        capacity = n
        count.zero_()
