"""IVF-ADC union-probe page scan: packed segment minima + f32 rescore.

Counterpart of `cvt_tpu.ops.pallas.ivf_scan`. The database is stored
sorted by coarse cell, each cell padded to a multiple of `seg` rows (every
segment belongs to one cell), as a decoded int8 residual cache [D, N']
plus per-row reconstruction norms. A query batch's probed cells resolve to
the union of the 512-row pages that hold them, and phase 1 scores only the
selected pages:

    dist(q, row) = ||q||^2 + ||c + d||^2 - 2<q, c> - 2<q, d>

The residual term -2<q, d> is an int8 product against the folded queries,
the norm ||c + d||^2 rides a per-row f32 column, and the coarse term
-2<q, c> is constant per (segment, query) and enters as a per-segment
correction `cip`. Segments of cells a query did not probe carry a marker
that ranks them below every real candidate, so the union scan returns the
probed lists' top-k and not the batch union's.

Phase 1 is the hand-written CUDA kernel `ivf_page_kernel`
(`csrc/ivf_scan.cu`, int8 tensor cores) for tensors on the card and its
plain PyTorch twin `ivf_pages_segmin_plain` for tensors on the CPU,
behind the wrapper `ivf_pages_segmin` (`ops.kernels.Kernel`). `sel` pads
the probed pages to a fixed length with fill slots; both skip the slots
past `n_live` (a one-element tensor, read on the device) and write
INT32_MAX there. Phase 2 takes the k+slack best segments per query and
rescores their rows exactly in f32 from an int16 decode: the
hand-written CUDA kernel `ivf_rescore_kernel` (`csrc/ivf_rescore.cu`) on
the card, its twin `ivf_rescore_plain` (the plain PyTorch phase 2) on
the CPU, behind the wrapper `ivf_rescore`.

Integer packing (key = (ip + norm_i + cip_i) * seg + lane) and its bounds
are those of `_ivf_pack_caps`. The clips run in float32, so a pad row's
norm_i and a masked segment's cip_i are float32(marker), which differs
from the integer marker when marker > 2^24 (32,522,144 against 32,522,143
at seg = 32, D = 128); the bounds hold for that value too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from cvt_tpu_torch.ops.kernels import kernel
from cvt_tpu_torch.ops.kernels.adc_scan import (SMEM_LIMIT, _fold_queries,
                                                _quantize_codebooks)
from cvt_tpu_torch.ops.topk import top_k_smallest
from cvt_tpu_torch.utils.profile import span

BIG = 3.4e38
_ROWS = 128                  # rows per CUDA block: lp must be a multiple
_KERNEL_SEGS = (16, 32, 64, 128)
_TWIN_PAGES = 64             # pages the twin scores per step (bounds memory)
I32_MAX = 2 ** 31 - 1        # the key of a skipped slot or page


def _ivf_pack_caps(seg: int, d: int) -> tuple[int, int]:
    """(nvcap, marker) for the IVF packing.

    With A = 2^31 // seg, ipb = 127*127*d and markers NIB = CIB = marker:
      valid max  = ipb + nvcap + ipb
      masked min = CIB - ipb            > valid max
      pad min    = NIB - ipb            > valid max
      global max = ipb + NIB + CIB      <= A - 2*seg
    (a pad row of a masked segment carries both markers: the budget
    covers that worst case, with the markers rounded up to float32)."""
    ipb = 127 * 127 * d
    a = (2 ** 31) // seg
    nvcap = (a - 7 * ipb - 2 * seg - 2) // 2 - 1
    if nvcap <= 0:
        raise ValueError(
            f"IVF packed scan infeasible for seg={seg}, d={d}: no int32 "
            f"headroom; reduce seg or d")
    marker = nvcap + 3 * ipb + 1
    return nvcap, marker


def _marker_f32(marker: int) -> float:
    """The marker as the float32 clip bound rounds it."""
    return float(np.float32(marker))


def _clip_i32(x: torch.Tensor, qs, mk: float) -> torch.Tensor:
    """int32 of clip(round(x / qs), 0, mk) in float32 (half to even)."""
    return torch.clamp(torch.round(x / qs), 0.0, mk).to(torch.int32)


def ivf_pages_segmin_plain(q2s, qs, dec8_t, nrm_col, cip, sel, lp: int,
                           seg: int, n_live=None):
    """Plain PyTorch twin of the `ivf_page` kernel (same arguments and
    output); runs on any device.

    q2s [Bpad, D] int8 folded queries, qs their float32 scale (one
    element); dec8_t [D, N'] int8 cell-sorted residual cache; nrm_col
    [N', 1] f32 (BIG on pad rows); cip [S*spt, Bpad] f32 per-segment
    coarse terms (BIG = masked); sel [S] int32 selected page ids; n_live
    [1] int32, the live slots (None: all S). Returns segpack [S*spt, Bpad]
    int32: for live slot i and segment s of page sel[i], min over the
    segment's rows of (ip + norm_i + cip_i) * seg + row % seg; INT32_MAX
    for every segment of a slot past n_live or of a page id out of range.

    The scores are float32 products of int8 operands: every partial sum is
    an integer below 127^2 * D < 2^24, so the int32 cast is exact."""
    bpad, d = q2s.shape
    s = sel.shape[0]
    spt = lp // seg
    _, marker = _ivf_pack_caps(seg, d)
    mk = _marker_f32(marker)
    n_pages = dec8_t.shape[1] // lp
    pages = dec8_t.view(d, n_pages, lp)
    nrm = nrm_col[:, 0].view(n_pages, lp)
    qf = q2s.float().T                                           # [D, Bpad]
    lane = torch.arange(lp, device=q2s.device, dtype=torch.int32) % seg
    cip_sh = _clip_i32(cip, qs, mk) * seg                        # [S*spt, Bpad]
    out = torch.empty((s * spt, bpad), dtype=torch.int32, device=q2s.device)
    ok = (sel >= 0) & (sel < n_pages)
    if n_live is not None:
        ok &= torch.arange(s, device=sel.device) < n_live.to(sel.device)
    sel_l = torch.where(ok, sel, 0).long()
    for p0 in range(0, s, _TWIN_PAGES):
        pg = sel_l[p0:p0 + _TWIN_PAGES]
        c = pg.shape[0]
        ip = torch.einsum("dcl,db->clb", pages[:, pg, :].float(),
                          qf).to(torch.int32)                    # [c, lp, Bpad]
        base = _clip_i32(nrm[pg], qs, mk) * seg + lane           # [c, lp]
        mins = (ip * seg + base[:, :, None]).view(c, spt, seg, bpad).amin(2)
        rows = slice(p0 * spt, (p0 + c) * spt)
        out[rows] = mins.reshape(c * spt, bpad) + cip_sh[rows]
    return torch.where(ok.repeat_interleave(spt)[:, None], out, I32_MAX)


def _page_smem_bytes(d: int, nst: int) -> int:
    """Dynamic shared memory of one `ivf_page` block with nst 64-query
    tiles in its ring: `page_smem_bytes` of csrc/ivf_scan.cu (1,024 bytes
    of alignment slack, a 128-row tile and the query tiles, D in 128-byte
    panels, and the 128-entry key base column). The kernel takes three
    tiles where they fit, else two."""
    panels = -(-d // 128)
    return 1024 + 128 * 128 * panels + nst * 64 * 128 * panels + 128 * 4


def _check_launch(q2s, qs, dec8_t, nrm_col, cip, sel, lp: int, seg: int,
                  n_live=None) -> None:
    """Validate what the kernel takes before its pointers are passed."""
    bpad, d = q2s.shape
    dev = q2s.device
    tensors = dict(q2s=q2s, qs=qs, dec8_t=dec8_t, nrm_col=nrm_col, cip=cip,
                   sel=sel)
    dtypes = dict(q2s=torch.int8, qs=torch.float32, dec8_t=torch.int8,
                  nrm_col=torch.float32, cip=torch.float32, sel=torch.int32,
                  n_live=torch.int32)
    if n_live is not None:
        tensors["n_live"] = n_live
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q2s on {dev}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"{name} must be contiguous and 4-byte aligned")
    if qs.numel() != 1:
        raise ValueError("qs must hold one float32 scale")
    if n_live is not None and n_live.numel() != 1:
        raise ValueError("n_live must hold one int32 count")
    if bpad % 128 or d % 4:
        raise ValueError(f"q2s [{bpad}, {d}]: need Bpad % 128 == 0 and "
                         f"D % 4 == 0")
    smem = _page_smem_bytes(d, 2)
    if smem > SMEM_LIMIT:
        raise ValueError(f"D={d} needs {smem} bytes of shared memory per "
                         f"block, over the {SMEM_LIMIT}-byte (227 KB) limit")
    if seg not in _KERNEL_SEGS or lp % _ROWS:
        raise ValueError(f"kernel takes seg in {_KERNEL_SEGS} and lp a "
                         f"multiple of {_ROWS}; got seg={seg}, lp={lp}")
    n_rows = dec8_t.shape[1]
    if dec8_t.shape[0] != d or n_rows % lp or nrm_col.shape != (n_rows, 1):
        raise ValueError("dec8_t/nrm_col shapes disagree with q2s and lp")
    if sel.dim() != 1 or cip.shape != (sel.shape[0] * (lp // seg), bpad):
        raise ValueError(f"cip must be [S*{lp // seg}, {bpad}] for "
                         f"sel [S]; got {tuple(cip.shape)}")


def compare_ivf_kernel(args) -> dict:
    """The ivf_page kernel against its twin on the same arguments (it sums
    no floats): bitwise, or raise."""
    got = ivf_pages_segmin(*args)
    want = ivf_pages_segmin_plain(*args)
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError(f"ivf_page kernel differs from its twin by "
                             f"{err}")
    return {"max_abs_err": err, "shape": list(got.shape)}


@kernel("ivf_page", symbol="cvt_ivf_pages_segmin", args="ppppppp iiiiiii pp",
        twin=ivf_pages_segmin_plain, compare=compare_ivf_kernel,
        span="kernel.ivf_page")
def ivf_pages_segmin(q2s, qs, dec8_t, nrm_col, cip, sel, lp: int, seg: int,
                     n_live=None):
    """Phase 1 over the selected pages -> segpack [S*spt, Bpad] int32.

    Arguments as `ivf_pages_segmin_plain`. Tensors on the CPU run the
    twin; tensors on the card launch `ivf_page_kernel`, which reads n_live
    on the device, so nothing waits on the host; any other device raises.
    Traced, the call is one `kernel.ivf_page` span."""
    _check_launch(q2s, qs, dec8_t, nrm_col, cip, sel, lp, seg, n_live)
    bpad, d = q2s.shape
    _, marker = _ivf_pack_caps(seg, d)
    s = sel.shape[0]
    segpack = torch.empty((s * (lp // seg), bpad), dtype=torch.int32,
                          device=q2s.device)
    ivf_pages_segmin.launch(
        sel.data_ptr(), None if n_live is None else n_live.data_ptr(),
        qs.data_ptr(), dec8_t.data_ptr(), nrm_col.data_ptr(), cip.data_ptr(),
        q2s.data_ptr(), s, dec8_t.shape[1], d, bpad, lp, seg, marker,
        segpack.data_ptr())
    return segpack


def ivf_rescore_plain(segpack, n_live, sel, rowids, seg_cell, dec16_rm,
                      srow16, nrm_col, dsq_min: float, q, q_sq, coarse_ip,
                      probed_bk, seg: int, k: int, slack: int = 6,
                      exact_probe: bool = True):
    """Plain PyTorch twin of `ivf_rescore_kernel`: phase 2 of
    `ivf_union_search`; runs on any device.

    segpack [S*spt, Bpad] int32 and n_live [1] int32 as phase 1 leaves
    them (INT32_MAX in the rows of slots past n_live); sel [S] int32 page
    ids; rowids [N'], seg_cell [N'/seg] int32, dec16_rm [N', D] int16,
    srow16 [D], nrm_col [N', 1] f32 and dsq_min as `ivf_union_search`
    takes them; q [B, D], q_sq [B], coarse_ip [B, Kc] f32 and probed_bk
    [B, Kc] bool from the probe stage. Each query's k + slack segments of
    least float32(key), ties to the lower segment index (the order of
    cvt_tpu's lax.top_k), are rescored row by row in float32,

        q_sq + (nrm + dsq_min) - 2 coarse_ip[cell] - 2 <q * srow16, row>,

    with pad rows, dead cells, slots past n_live and (exact_probe) cells
    the query did not probe at +inf, and the k best rows are kept, ties to
    the lower candidate (segment rank, then lane). Returns (dists [B, k]
    f32, ids [B, k] int32), +inf / -1 past the pool."""
    b = q.shape[0]
    s_max = sel.shape[0]
    spt = segpack.shape[0] // s_max
    n_rows = dec16_rm.shape[0]
    kc = coarse_ip.shape[1]
    dev = q.device
    with span("ivf.rescore"):
        n_take = min(k + slack, segpack.shape[0])
        # f32 keys, as cvt_tpu ranks them; nearby large keys tie in f32 and
        # the stable sort breaks ties toward the lower index like lax.top_k
        _, seg_sel = top_k_smallest(segpack.T[:b].float(), n_take)  # [B, S2]
        # fill slots must not re-enter here
        slot_of = seg_sel // spt
        slot_live = (slot_of < n_live)[:, :, None].expand(b, n_take, seg)
        slot_live = slot_live.reshape(b, n_take * seg)
        gseg = sel.long()[slot_of.clamp(0, s_max - 1)] * spt + seg_sel % spt
        rows = (gseg[:, :, None] * seg
                + torch.arange(seg, device=dev)[None, None, :]
                ).reshape(b, n_take * seg)                       # [B, C]
        rows = rows.clamp(0, n_rows - 1)
        vec_ids = rowids[rows]                                   # [B, C]
        cells_r = seg_cell[rows // seg]                          # [B, C]
        cells_rc = cells_r.clamp(0, kc - 1).long()
        dec_c = dec16_rm[rows].float()                           # [B, C, D]
        qf = q * srow16[None, :]
        ip = torch.sum(dec_c * qf[:, None, :], dim=-1)           # <q, resid>
        cipv = -2.0 * torch.gather(coarse_ip, 1, cells_rc)
        nrm_c = nrm_col[rows, 0] + dsq_min
        dist = q_sq[:, None] + nrm_c + cipv - 2.0 * ip
        okc = (vec_ids >= 0) & (cells_r >= 0) & (nrm_c < BIG / 2) & slot_live
        if exact_probe:
            okc &= torch.gather(probed_bk, 1, cells_rc)
        dist = torch.where(okc, dist, float("inf"))

    # ---- final top-k -----------------------------------------------------
    with span("ivf.select"):
        k_eff = min(k, dist.shape[1])       # tiny index: pool may be < k
        out_d, j = top_k_smallest(dist, k_eff)
        ids = torch.gather(vec_ids, 1, j)
        ok = torch.isfinite(out_d)
        out_d = torch.where(ok, out_d, float("inf"))
        ids = torch.where(ok, ids, -1)
        if k_eff < k:                       # honor the [B, k] contract
            out_d = F.pad(out_d, (0, k - k_eff), value=float("inf"))
            ids = F.pad(ids, (0, k - k_eff), value=-1)
        return out_d, ids


# The selection pass of `ivf_rescore_kernel`: each thread keeps the best
# NT of its rows, NT the least of _SEL_LISTS >= k + slack (above the
# longest, rounds of 64 winners, each past the last round's); a block of
# 256 threads takes 32 queries (one per lane) over one chunk of segpack
# rows, and _SEL_BLOCKS_PER_SM of them fit an SM at each NT (its launch
# bounds).
_SEL_LISTS = (16, 32, 64)
_SEL_BLOCKS_PER_SM = {16: 4, 32: 2, 64: 1}
_SEL_WARPS = 8
_SEL_MIN_ROWS = 256          # rows of a chunk: 32 for each warp at least
_SEL_MAX_CHUNKS = 1024


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _rescore_geometry(b: int, n_segs: int, n_take: int, sms: int):
    """(nt, n_chunks, chunk_rows) of the selection pass for B queries over
    n_segs segpack rows: as many chunks as fill the card's resident blocks
    once (B / 32 query groups, each over every chunk), none shorter than
    _SEL_MIN_ROWS rows, chunk_rows a multiple of the block's 8 warps."""
    nt = next((n for n in _SEL_LISTS if n >= n_take), _SEL_LISTS[-1])
    groups = -(-b // 32)
    n_chunks = min(max(1, sms * _SEL_BLOCKS_PER_SM[nt] // groups),
                   max(1, n_segs // _SEL_MIN_ROWS), _SEL_MAX_CHUNKS)
    chunk_rows = -(-n_segs // n_chunks)
    chunk_rows = -(-chunk_rows // _SEL_WARPS) * _SEL_WARPS
    return nt, -(-n_segs // chunk_rows), chunk_rows


def _rescore_smem_bytes(d: int, n_take: int, seg: int, n_chunks: int,
                        spill: bool = False) -> int:
    """Dynamic shared memory of one `ivf_rescore_kernel` block
    (`rescore_smem_bytes` of csrc/ivf_rescore.cu): the folded query, the
    n_take * seg candidates' distances (8-byte keys) and ids unless they
    spill to device memory, each chunk list's head, and per winning
    segment its row, global segment, coarse term and mask."""
    c = 0 if spill else n_take * seg
    return 4 * d + 12 * c + 20 * n_take + 4 * n_chunks


def _check_rescore(segpack, n_live, sel, rowids, seg_cell, dec16_rm, srow16,
                   nrm_col, q, q_sq, coarse_ip, probed_bk, seg: int, k: int,
                   slack: int) -> None:
    """Validate what `ivf_rescore_kernel` takes before its pointers are
    passed."""
    dev = q.device
    tensors = dict(segpack=segpack, n_live=n_live, sel=sel, rowids=rowids,
                   seg_cell=seg_cell, dec16_rm=dec16_rm, srow16=srow16,
                   nrm_col=nrm_col, q=q, q_sq=q_sq, coarse_ip=coarse_ip,
                   probed_bk=probed_bk)
    dtypes = dict(segpack=torch.int32, n_live=torch.int32, sel=torch.int32,
                  rowids=torch.int32, seg_cell=torch.int32,
                  dec16_rm=torch.int16, srow16=torch.float32,
                  nrm_col=torch.float32, q=torch.float32,
                  q_sq=torch.float32, coarse_ip=torch.float32,
                  probed_bk=torch.bool)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dec16_rm.data_ptr() % 8:
        raise ValueError("dec16_rm must be 8-byte aligned (4-element loads)")
    b, d = q.shape
    n_rows = dec16_rm.shape[0]
    kc = coarse_ip.shape[1]
    if n_live.numel() != 1:
        raise ValueError("n_live must hold one int32 count")
    if seg not in _KERNEL_SEGS or d % 4:
        raise ValueError(f"kernel takes seg in {_KERNEL_SEGS} and D % 4 == "
                         f"0; got seg={seg}, D={d}")
    if (sel.dim() != 1 or segpack.dim() != 2 or sel.shape[0] == 0
            or segpack.shape[0] % sel.shape[0] or segpack.shape[1] < b):
        raise ValueError(f"segpack {tuple(segpack.shape)} must be [S*spt, "
                         f"Bpad >= {b}] for sel [S]")
    if (dec16_rm.shape != (n_rows, d) or n_rows % seg
            or rowids.shape != (n_rows,) or nrm_col.shape != (n_rows, 1)
            or seg_cell.shape != (n_rows // seg,) or srow16.shape != (d,)):
        raise ValueError("dec16_rm / rowids / nrm_col / seg_cell / srow16 "
                         "shapes disagree with each other, seg and D")
    if (q_sq.shape != (b,) or coarse_ip.shape != (b, kc)
            or probed_bk.shape != (b, kc)):
        raise ValueError("q_sq / coarse_ip / probed_bk must be [B], [B, Kc] "
                         "and [B, Kc]")
    n_take = min(k + slack, segpack.shape[0])
    if _rescore_smem_bytes(d, n_take, seg, _SEL_MAX_CHUNKS,
                           spill=True) > SMEM_LIMIT:
        raise ValueError(f"D={d}, k + slack={n_take} need more shared "
                         f"memory per block than the {SMEM_LIMIT}-byte "
                         f"(227 KB) limit")


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
    got_d, got_i = ivf_rescore(*args)
    want_d, want_i = ivf_rescore_plain(*args)
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
        pool_d, pool_i = (x.cpu() for x in ivf_rescore_plain(
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


@kernel("ivf_rescore", symbol="cvt_ivf_rescore",
        args="pppppppp f pppp iiiiiiiiiiiiii pppppppp",
        twin=ivf_rescore_plain, compare=compare_rescore_kernel, device="q")
def ivf_rescore(segpack, n_live, sel, rowids, seg_cell, dec16_rm, srow16,
                nrm_col, dsq_min: float, q, q_sq, coarse_ip, probed_bk,
                seg: int, k: int, slack: int = 6, exact_probe: bool = True):
    """Phase 2 of `ivf_union_search` -> (dists [B, k], ids [B, k]).

    Arguments and result as `ivf_rescore_plain`. Tensors on the CPU run
    the twin (its `ivf.rescore` and `ivf.select` spans); tensors on the
    card launch `ivf_rescore_kernel` (csrc/ivf_rescore.cu: a selection
    pass, then one block per query; for k + slack above 64 the selection
    runs in rounds of 64), counted once a call, inside one `ivf.rescore`
    span. It reads n_live on the device, so nothing waits on the host, and
    writes no copy of segpack and no [B, C, D] rows. Any other device
    raises."""
    with span("ivf.rescore"):
        _check_rescore(segpack, n_live, sel, rowids, seg_cell, dec16_rm,
                       srow16, nrm_col, q, q_sq, coarse_ip, probed_bk, seg, k,
                       slack)
        b, d = q.shape
        out_d = torch.empty((b, k), dtype=torch.float32, device=q.device)
        out_i = torch.empty((b, k), dtype=torch.int32, device=q.device)
        if b == 0 or k == 0:
            return out_d, out_i
        n_segs = segpack.shape[0]
        n_take = min(k + slack, n_segs)
        nt, n_chunks, chunk_rows = _rescore_geometry(
            b, n_segs, n_take, _sm_count(q.device.index or 0))
        empty = functools.partial(torch.empty, device=q.device)
        cand = empty((n_chunks, nt, b), dtype=torch.int64)
        # a selection longer than the lists runs in rounds: its winners
        # and each query's floor in device memory
        rounds = n_take > nt
        win = empty((b, n_take) if rounds else 0, dtype=torch.int32)
        lo = empty(b if rounds else 0, dtype=torch.int64)
        # candidates that do not fit in a block's shared memory spill
        spill = _rescore_smem_bytes(d, n_take, seg, n_chunks) > SMEM_LIMIT
        key_g = empty((b, n_take * seg) if spill else 0, dtype=torch.int64)
        id_g = empty((b, n_take * seg) if spill else 0, dtype=torch.int32)
        ptr = lambda t: t.data_ptr() if t.numel() else None
        ivf_rescore.launch(
            segpack.data_ptr(), n_live.data_ptr(), sel.data_ptr(),
            rowids.data_ptr(), seg_cell.data_ptr(), dec16_rm.data_ptr(),
            srow16.data_ptr(), nrm_col.data_ptr(), dsq_min, q.data_ptr(),
            q_sq.data_ptr(), coarse_ip.data_ptr(), probed_bk.data_ptr(),
            b, segpack.shape[1], sel.shape[0], n_segs // sel.shape[0], seg,
            dec16_rm.shape[0], d, coarse_ip.shape[1], n_take, k,
            int(exact_probe), nt, n_chunks, chunk_rows, cand.data_ptr(),
            ptr(win), ptr(lo), ptr(key_g), ptr(id_g), out_d.data_ptr(),
            out_i.data_ptr())
        return out_d, out_i


def coarse_probes(q, centroids, nprobe: int):
    """(coarse_ip [B, Kc], q_sq [B], probes [B, nprobe]): each query's
    nprobe nearest cells, ties toward the lower cell as lax.top_k breaks
    them."""
    coarse_ip = q @ centroids.T
    q_sq = torch.sum(q * q, dim=-1)
    c_sq = torch.sum(centroids * centroids, dim=-1)
    coarse_dist = q_sq[:, None] - 2.0 * coarse_ip + c_sq[None, :]
    _, probes = top_k_smallest(coarse_dist, nprobe)
    return coarse_ip, q_sq, probes


def _select_pages(page_probed: torch.Tensor, s_max: int):
    """jnp.nonzero(page_probed, size=s_max, fill_value=0) and its count:
    the probed page ids in ascending order, then page 0 in the fill slots,
    and the count as a one-element int32, the kernel's n_live. A stable
    sort puts the probed pages first without a host sync."""
    n_live = torch.sum(page_probed, dtype=torch.int32).reshape(1)
    order = torch.sort((~page_probed).to(torch.int32), stable=True).indices
    slot = torch.arange(s_max, device=page_probed.device)
    live = slot < n_live
    sel = torch.where(live, order[:s_max], 0).to(torch.int32)
    return sel, live, n_live


def ivf_union_search(q, centroids, dec8_t, dec16_rm, srow16, nrm_col,
                     seg_cell, rowids, srow, dsq_min: float, nprobe: int,
                     k: int, max_pages: int, lp: int = 512, seg: int = 32,
                     exact_probe: bool = True, slack: int = 6):
    """Batched IVF-ADC top-k via the union-probe page scan.

    q [B, D] raw space; centroids [Kc, D]; dec8_t [D, N'] int8 decoded
    residual cache (cell-sorted, segment-pure); dec16_rm [N', D] int16
    row-major decode (per-dim scale srow16) for the phase-2 rescore;
    nrm_col [N', 1] f32 = ||c + d||^2 - dsq_min (BIG on pad rows);
    seg_cell [N'/seg] int32 owning cell per segment (-1 = dead); rowids
    [N'] int32 original ids (-1 = pad); srow [D] dequant scales of the
    int8 cache. Returns (dists [B, k], ids [B, k] with -1 padding,
    n_dropped: probed pages past max_pages, a 0-dim tensor).

    exact_probe=True masks each query to its own nprobe lists (reference
    semantics, IVFOPQ.cpp:237-309); False scans the batch union. Float32
    throughout: keep TF32 off, a changed cip moves round(cip/qs)."""
    b, d = q.shape
    n_rows = dec8_t.shape[1]
    n_pages = n_rows // lp
    spt = lp // seg
    kc = centroids.shape[0]
    nvcap, _ = _ivf_pack_caps(seg, d)
    dev = q.device

    # ---- probe selection + page union ------------------------------------
    with span("ivf.probe"):
        coarse_ip, q_sq, probes = coarse_probes(q, centroids, nprobe)
        # which cells each query probed: a [B, Kc] table, gathered below
        # in place of comparing every cell with every probe
        probed_bk = torch.zeros((b, kc), dtype=torch.bool, device=dev)
        probed_bk.scatter_(1, probes, True)
        probed = probed_bk.any(0)
        cell_ok = seg_cell >= 0
        seg_probed = cell_ok & probed[seg_cell.clamp(0, kc - 1)]
        page_probed = seg_probed.view(n_pages, spt).any(1)
        s_max = min(max_pages, n_pages)
        sel, live, n_live = _select_pages(page_probed, s_max)
        n_dropped = torch.clamp_min(n_live[0] - s_max, 0)

    # ---- per-segment coarse correction rows [S*spt, B] -------------------
    with span("ivf.coarse_terms"):
        sel_segs = sel[:, None].long() * spt + torch.arange(spt, device=dev)
        cells = seg_cell[sel_segs.reshape(-1)]                   # [S*spt]
        cells_c = cells.clamp(0, kc - 1).long()
        cip = -2.0 * (q @ centroids[cells_c].T).T                # [S*spt, B]
        c0 = torch.amin(torch.where(cells[:, None] >= 0, cip, BIG), dim=0)
        cipz = cip - c0[None, :]
        if exact_probe:
            hit = probed_bk[:, cells_c].T & (cells >= 0)[:, None]
            cipz = torch.where(hit, cipz, BIG)
        dead = (cells < 0) | ~live.repeat_interleave(spt)
        cipz = torch.where(dead[:, None], BIG, cipz)

    # ---- query fold with marker-safe qs clamps ---------------------------
    with span("ivf.fold"):
        # the clamps reach _fold_queries before q2s is quantized, so ip,
        # norm_i and cip_i share one unit
        max_nrm = torch.amax(torch.where(nrm_col < BIG / 2, nrm_col, 0.0))
        max_cip = torch.amax(torch.where(cipz < BIG / 2, cipz, 0.0))
        qs_min = torch.maximum(max_nrm / nvcap, max_cip / (127 * 127 * d))
        q2s, qs = _fold_queries(q, srow, qs_min, 1)
        # the kernel's block spans the padded batch: padded query columns
        # are masked and dropped by segpack.T[:b]
        cip_pad = F.pad(cipz, (0, q2s.shape[0] - b), value=BIG).contiguous()
    # the fill slots are skipped: their keys (INT32_MAX) rank after every
    # live segment's, valid or masked, so the k+slack winners below are
    # those of a scan of every slot
    segpack = ivf_pages_segmin(q2s, qs.reshape(1), dec8_t, nrm_col, cip_pad,
                               sel, lp, seg, n_live)

    # ---- phase 2: exact f32 rescore of the winning segments --------------
    out_d, ids = ivf_rescore(segpack, n_live, sel, rowids, seg_cell, dec16_rm,
                             srow16, nrm_col, dsq_min, q.contiguous(), q_sq,
                             coarse_ip, probed_bk, seg, k, slack, exact_probe)
    return out_d, ids, n_dropped


def build_page_layout(codes, assign, dsq, codebooks, *, lp: int = 512,
                      seg: int = 32):
    """Host-side layout: cell-sorted, segment-pure decoded int8 pages.

    codes [N, M] u8 residual PQ codes; assign [N] int coarse cell; dsq [N]
    f32 full reconstruction norms; codebooks [M, K, ds] f32. Returns a
    dict of numpy arrays (see ivf_union_search), bit for bit those of
    `cvt_tpu`'s build_page_layout."""
    codes = np.asarray(codes, np.uint8)
    assign = np.asarray(assign)
    dsq = np.asarray(dsq, np.float32)
    n, m = codes.shape
    cb = np.asarray(codebooks, np.float32)
    _, k, ds = cb.shape
    d = m * ds
    kc = int(assign.max()) + 1 if n else 1

    counts = np.bincount(assign, minlength=kc)
    padded = -(-counts // seg) * seg                      # per-cell rows
    total = int(padded.sum())
    total_pg = -(-max(total, lp) // lp) * lp              # whole pages
    starts = np.zeros(kc + 1, np.int64)
    np.cumsum(padded, out=starts[1:])

    order = np.argsort(assign, kind="stable")
    in_starts = np.zeros(kc + 1, np.int64)
    np.cumsum(counts, out=in_starts[1:])
    rank = np.arange(n, dtype=np.int64) - in_starts[assign[order]]
    dest = starts[assign[order]] + rank                   # [N] slot

    rowids = np.full((total_pg,), -1, np.int32)
    rowids[dest] = order.astype(np.int32)
    nrm = np.full((total_pg,), BIG, np.float32)
    nrm[dest] = dsq[order]
    dsq_min = float(dsq.min()) if n else 0.0
    nrm[rowids >= 0] -= dsq_min

    # decoded int8 residual rows: the int8 codebooks of the flat kernels
    cb_q, srow = _quantize_codebooks(torch.from_numpy(cb))
    cb_q = cb_q.numpy()                                   # [M, K, ds]
    dec8 = np.zeros((total_pg, d), np.int8)
    dec8[dest] = np.concatenate(
        [cb_q[mm][codes[order, mm]] for mm in range(m)],
        axis=1) if n else 0
    dec8_t = np.ascontiguousarray(dec8.T)                 # [D, N']
    # int16 row-major decode for the exact phase-2 rescore (256x finer)
    scales16 = np.maximum(np.abs(cb).max(axis=1) / 32767.0, 1e-12)
    cb_q16 = np.clip(np.rint(cb / scales16[:, None, :]),
                     -32767, 32767).astype(np.int16)      # [M, K, ds]
    dec16 = np.zeros((total_pg, d), np.int16)
    dec16[dest] = np.concatenate(
        [cb_q16[mm][codes[order, mm]] for mm in range(m)],
        axis=1) if n else 0
    srow16 = scales16.reshape(d).astype(np.float32)

    seg_cell = np.full((total_pg // seg,), -1, np.int32)
    for c in range(kc):
        if padded[c]:
            seg_cell[starts[c] // seg:(starts[c] + padded[c]) // seg] = c

    return dict(dec8_t=dec8_t, dec16=dec16, srow16=srow16,
                nrm_col=nrm[:, None], seg_cell=seg_cell, rowids=rowids,
                srow=srow.numpy(), dsq_min=dsq_min, lp=lp, seg=seg)
