"""The coarse level of the vocabulary tree's descent: each point's P
nearest coarse cells, in float32.

`x` [T, D] float32 are the points and `centres` [K1, D] float32 the
coarse centres. Returns (dist [T, P] float32, cells [T, P] int64): the
first P of a stable sort of each row of

    d1 = ||x||^2 - 2 x @ centres.T + ||centres||^2        (float32)

so ascending by distance, ties to the lower cell, as `lax.top_k` breaks
them (`ops/kmeans._hier_assign_chunk` takes the cells).

`vocab_coarse` (`ops.kernels.Kernel`) launches the hand-written CUDA
kernel `vocab_coarse_kernel` (`csrc/vocab_coarse.cu`: FP32 FMAs, each
row's best P kept in its epilogue, no [T, K1] tensor in device memory)
for tensors on the card, where it takes D up to 128 and P up to 16
(`shape_ok`; anything else raises there), and runs the plain twin
`vocab_coarse_plain` (the GEMM expression and `top_k_smallest`) for
tensors on the CPU, of any shape;
besides its launches it counts the points of every call, on either
path, in `.rows`. The kernel sums each dot product in another order than
the twin's GEMM: the two give the same bits where every product and
partial sum is exact (integer-valued points and centres), and elsewhere
the same distances within `sum_bound` and the same cells on every row
whose P-th and (P+1)-th distances lie farther apart than that.
"""

from __future__ import annotations

import torch

from cvt_tpu_torch.ops.kernels import kernel
from cvt_tpu_torch.ops.topk import top_k_smallest

MAX_D = 128
MAX_P = 16                    # a half-warp's list
_BN, _BK = 128, 16            # the kernel's centre block and ring slice
_U = 2.0 ** -24               # float32's unit roundoff


def shape_ok(d: int, k1: int, probes: int) -> bool:
    """Whether the card takes points of width d, K1 centres and P."""
    return 0 < d <= MAX_D and 1 <= probes <= min(MAX_P, k1)


def vocab_coarse_plain(x, centres, probes: int):
    """-> (dist [T, P] float32, cells [T, P] int64) (the module's
    contract): the [T, K1] float32 distances and their stable sort's
    first P."""
    x_sq = torch.sum(x * x, -1, keepdim=True)                    # [T, 1]
    d1 = (x_sq - 2.0 * (x @ centres.T)
          + torch.sum(centres * centres, -1)[None, :])           # [T, K1]
    return top_k_smallest(d1, probes)


def sum_bound(x, centres) -> torch.Tensor:
    """[T] float64: for each row, a bound on how far any float32
    evaluation of its distances (the dot products summed in any order)
    lies from their exact values, doubled, so that it bounds the kernel's
    distance less the twin's. With g = D u / (1 - D u), u = 2^-24, each
    of ||x||^2, <x, c> and ||c||^2 is off by at most g times its sum of
    absolute terms, and the two roundings of the expression add u times
    their results: in all at most (g + 2 u) (|x| + max |c|)^2 (Cauchy-
    Schwarz)."""
    d = x.shape[1]
    g = d * _U / (1.0 - d * _U)
    cmax = torch.linalg.vector_norm(centres.double(), dim=-1).max() \
        if centres.shape[0] else torch.zeros((), dtype=torch.float64)
    xn = torch.linalg.vector_norm(x.double(), dim=-1)
    return 2.0 * (g + 2.0 * _U) * (xn + cmax) ** 2


def compare_coarse_kernel(args) -> dict:
    """The vocab_coarse kernel against its twin on the same arguments, the
    twin run where they lie, with one more column (the (P+1)-th): every
    distance within its row's `sum_bound` b, and the cells equal at every
    position whose twin distance lies farther than 2 b from both its
    neighbours' (only there can the two orders differ); or raise. Counts
    the rows whose P-th and (P+1)-th twin distances lie within 2 b
    (`near_rows`: the kernel may keep another P-th cell there) and the
    rows whose cells differ at all."""
    x, centres, probes = args
    got_d, got_i = vocab_coarse(*args)
    k1 = centres.shape[0]
    want_d, want_i = vocab_coarse_plain(x, centres, min(probes + 1, k1))
    t = got_d.shape[0]
    if t == 0:
        return {"max_abs_err": 0.0, "rows": 0, "near_rows": 0,
                "rows_differ": 0, "bound_max": 0.0}
    b = sum_bound(x, centres)[:, None]                           # [T, 1]
    w = want_d.double()
    err = (got_d.double() - w[:, :probes]).abs()
    close = (w[:, 1:] - w[:, :-1]) <= 2.0 * b                    # [T, q - 1]
    near = torch.zeros((t, probes), dtype=torch.bool, device=x.device)
    near[:, :close.shape[1]] |= close[:, :probes]                # next
    near[:, 1:] |= close[:, :probes - 1]                         # previous
    differ = got_i != want_i[:, :probes]
    out = {"max_abs_err": float(err.max()), "rows": t,
           "near_rows": int(close[:, probes - 1].sum())
           if close.shape[1] >= probes else 0,
           "rows_differ": int(differ.any(1).sum()),
           "bound_max": float(b.max())}
    if bool((err > b).any()) or bool((differ & ~near).any()):
        raise AssertionError(f"vocab_coarse kernel differs from its twin "
                             f"beyond the summation bound: {out}, "
                             f"{int((err > b).sum())} distances, "
                             f"{int((differ & ~near).sum())} cells")
    return out


def _check(x, centres, probes: int) -> None:
    for name, t in (("x", x), ("centres", centres)):
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"vocab_coarse: {name} must be a 2-D float32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
    if centres.device != x.device:
        raise ValueError(f"vocab_coarse: centres on {centres.device}, not "
                         f"on {x.device}")
    if not x.is_contiguous():
        raise ValueError("vocab_coarse: x must be contiguous")
    d, k1 = x.shape[1], centres.shape[0]
    if centres.shape[1] != d:
        raise ValueError(f"vocab_coarse: x has width {d}, centres "
                         f"{centres.shape[1]}")
    if x.device.type != "cpu" and not shape_ok(d, k1, probes):
        raise ValueError(f"vocab_coarse: the card takes D up to {MAX_D} "
                         f"and 1 <= P <= min({MAX_P}, K1), got D {d}, "
                         f"K1 {k1}, P {probes}")


@kernel("vocab_coarse", symbol="cvt_vocab_coarse", args="pii ppii ppp",
        twin=vocab_coarse_plain, compare=compare_coarse_kernel,
        check=_check, counts={"rows": lambda _, x, *a: x.shape[0]})
def vocab_coarse(x, centres, probes: int):
    """-> (dist [T, P] float32, cells [T, P] int64) (the module's
    contract).

    Tensors on the CPU run the twin; tensors on the card launch
    `vocab_coarse_kernel` once a call, one block a 128 rows, with the
    centres transposed and zero-padded beside it ([D rounded up to 16,
    K1 rounded up to 128], and their squared norms), and x copied with
    zero columns up to a multiple of 4 where D is not one or x is not
    16-byte aligned (the zeros add exact zeros: the same bits). Any other
    device raises."""
    t, d = x.shape
    k1 = centres.shape[0]
    dev = x.device
    dist = torch.empty((t, probes), dtype=torch.float32, device=dev)
    cells = torch.empty((t, probes), dtype=torch.int64, device=dev)
    if t == 0:
        return dist, cells
    if d % 4 or x.data_ptr() % 16:
        xp = torch.zeros((t, -(-d // 4) * 4), dtype=torch.float32,
                         device=dev)
        xp[:, :d] = x
        x = xp
    ct = torch.zeros((-(-d // _BK) * _BK, -(-k1 // _BN) * _BN),
                     dtype=torch.float32, device=dev)
    ct[:d, :k1] = centres.T
    csq = torch.zeros(ct.shape[1], dtype=torch.float32, device=dev)
    csq[:k1] = torch.sum(centres * centres, -1)
    vocab_coarse.launch(x.data_ptr(), t, x.shape[1], ct.data_ptr(), csq.data_ptr(),
                        k1, probes, dist.data_ptr(), cells.data_ptr())
    return dist, cells
