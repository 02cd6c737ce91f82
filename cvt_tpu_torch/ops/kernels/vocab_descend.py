"""The fine level of the vocabulary tree's descent on uint8 rows and an
integer tree: every (point, probe) pair against its cell's words, the
first nearest word and its ||f||^2 - 2<x, f>, exact in int32.

The caller (`ops/kmeans._hier_assign_chunk`) sorts the pairs p = point *
probes + probe by cell (`order` [n] int64) and cuts them into tiles of at
most `TILE` pairs of one cell (`tiles` [G, 3] int32: cell, first position
in `order`, count); every pair lies in one tile. `rows` [T, D] uint8 are
the points, `words` [K1, K2, D] uint8 the fine words and `fsq` [K1, K2]
int32 their squared norms. Returns (dist [n] int32, sub [n] int32), by
pair: the smallest fsq[c, j] - 2<rows[p // probes], words[c, j]> over
the pair's cell c and the first j that reaches it.

`vocab_descend` (`ops.kernels.Kernel`) launches the hand-written CUDA
kernel `vocab_descend_kernel` (`csrc/vocab_descend.cu`: uint8 wgmma,
the argmin in its epilogue) for tensors on the card and runs the plain
twin `vocab_descend_plain` for tensors on the CPU; besides its launches
it counts the pairs of every call, on either path, in `.pairs`. Every
product and sum is an integer below 2^25 in magnitude, so both give the
same bits.
"""

from __future__ import annotations

import torch

from cvt_tpu_torch.ops.kernels import kernel

TILE = 512                    # pairs of one cell a tile at most
MAX_D = 128                   # one 128-byte panel of K
MAX_K2 = 1024                 # the word block in shared memory
_TWIN_BYTES = 1 << 29         # bound on one twin step's float64 scores


def shape_ok(d: int, k2: int) -> bool:
    """Whether the kernel takes rows of width d against K2 words a cell."""
    return 0 < d <= MAX_D and d % 16 == 0 and 0 < k2 <= MAX_K2 \
        and k2 % 128 == 0


def vocab_descend_plain(rows, order, tiles, words, fsq, probes: int):
    """-> (dist [n] int32, sub [n] int32) (the module's contract), in
    float64, which holds every product and sum exactly; a step scores as
    many tiles as keep its [tiles, TILE, K2] scores under `_TWIN_BYTES`."""
    dev = rows.device
    n = order.shape[0]
    k2 = words.shape[1]
    dist = torch.empty(n, dtype=torch.int32, device=dev)
    sub = torch.empty(n, dtype=torch.int32, device=dev)
    cell, first, count = tiles.long().unbind(1)
    lane = torch.arange(TILE, device=dev)
    step = max(1, _TWIN_BYTES // (TILE * k2 * 8))
    for lo in range(0, tiles.shape[0], step):
        c = cell[lo:lo + step]
        pos = first[lo:lo + step, None] + lane[None, :]
        valid = lane[None, :] < count[lo:lo + step, None]
        pair = order[pos.clamp_max(n - 1)]                       # [G, R]
        x = rows[torch.div(pair, probes, rounding_mode="floor")].double()
        dd = (fsq[c].double()[:, None, :]
              - 2.0 * torch.bmm(x, words[c].double().mT))        # [G, R, K2]
        v, a = torch.min(dd, -1)
        dist[pair[valid]] = v[valid].to(torch.int32)
        sub[pair[valid]] = a[valid].to(torch.int32)
    return dist, sub


def _check(rows, order, tiles, words, fsq, probes: int) -> None:
    want = {"rows": (rows, torch.uint8, 2), "order": (order, torch.int64, 1),
            "tiles": (tiles, torch.int32, 2),
            "words": (words, torch.uint8, 3), "fsq": (fsq, torch.int32, 2)}
    for name, (t, dtype, dim) in want.items():
        if t.dtype != dtype or not t.is_contiguous() or t.dim() != dim:
            raise ValueError(f"vocab_descend: {name} must be a contiguous "
                             f"{dim}-D {dtype} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != rows.device:
            raise ValueError(f"vocab_descend: {name} on {t.device}, not on "
                             f"{rows.device}")
    k1, k2, d = words.shape
    if not shape_ok(d, k2):
        raise ValueError(f"vocab_descend: takes D a multiple of 16 up to "
                         f"{MAX_D} and K2 a multiple of 128 up to {MAX_K2}, "
                         f"got D {d}, K2 {k2}")
    if rows.shape[1] != d or tuple(fsq.shape) != (k1, k2):
        raise ValueError("vocab_descend: rows, words and fsq differ in shape")
    if tiles.shape[1] != 3:
        raise ValueError("vocab_descend: tiles must be [G, 3]")
    if probes < 1 or order.shape[0] > rows.shape[0] * probes \
            or rows.shape[0] * probes >= 2 ** 31:
        raise ValueError("vocab_descend: more pairs than rows x probes, or "
                         "2^31 or more")
    if rows.data_ptr() % 16 or words.data_ptr() % 16:
        raise ValueError("vocab_descend: rows and words must be 16-byte "
                         "aligned")


def compare_descend_kernel(args) -> dict:
    """The vocab_descend kernel against its twin on the same arguments,
    the twin run where they lie (it sums integers in float64, exactly):
    distances and word ids bitwise, or raise."""
    got_d, got_s = vocab_descend(*args)
    want_d, want_s = vocab_descend_plain(*args)
    err = int((got_d.long() - want_d.long()).abs().max()) \
        if got_d.numel() else 0
    ids_differ = int((got_s != want_s).sum())
    if err or ids_differ:
        raise AssertionError(f"vocab_descend kernel differs from its twin: "
                             f"max|diff| {err}, {ids_differ} ids")
    return {"max_abs_err": err, "ids_differ": ids_differ,
            "pairs": int(got_d.numel()), "tiles": int(args[2].shape[0])}


@kernel("vocab_descend", symbol="cvt_vocab_descend", args="pii ppi ppi ppp",
        twin=vocab_descend_plain, compare=compare_descend_kernel,
        check=_check,
        counts={"pairs": lambda _, __, order, *a: order.shape[0]})
def vocab_descend(rows, order, tiles, words, fsq, probes: int):
    """-> (dist [n] int32, sub [n] int32) (the module's contract).

    Tensors on the CPU run the twin; tensors on the card launch
    `vocab_descend_kernel` once a call, one block a tile. Any other
    device raises."""
    dev = rows.device
    n = order.shape[0]
    dist = torch.empty(n, dtype=torch.int32, device=dev)
    sub = torch.empty(n, dtype=torch.int32, device=dev)
    if tiles.shape[0] == 0:
        return dist, sub
    vocab_descend.launch(
        rows.data_ptr(), rows.shape[1], probes, order.data_ptr(),
        tiles.data_ptr(), tiles.shape[0], words.data_ptr(), fsq.data_ptr(),
        words.shape[1], dist.data_ptr(), sub.data_ptr())
    return dist, sub
