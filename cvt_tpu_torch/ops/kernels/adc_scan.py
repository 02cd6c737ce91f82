"""Two-phase flat ADC search: packed segment-min scan + selection.

Counterpart of `cvt_tpu.ops.pallas.adc_scan`. Phase 1 is one of two
hand-written CUDA kernels (`csrc/adc_scan.cu`):

  * `adc_segmin`: decodes each row's PQ codes to int8 (a gather from the
    int8-quantized codebooks), scores the rows against the int8-folded
    query batch with exact int32 dot products, and emits packed keys
        key = ip * seg + norm_i * seg + lane
    (an exact lexicographic (score, row) key) reduced to one minimum per
    `seg`-row segment (seg in {128, 64, 32, 16, 8}), plus each tile's best
    two keys;
  * `adc_segmin_cached`: the same over a pre-decoded int8 cache.

Each kernel has a plain PyTorch twin here (`*_plain`) computing the same
integers. The wrapper runs the twin for tensors on the CPU and launches
the kernel for tensors on the card, counting launches in `.launches`;
it never falls back from one to the other.

Phase 2 is PyTorch: a top-k over the tile candidates (fast path), or an
exact f32 re-score of the k+slack best segments (exact path).

Segment lemma: a query's k-th smallest distance tau bounds the segments
of interest — every candidate <= tau lies in a segment whose min <= tau,
and at most k segments have min <= tau. The fast path is exact for top-1;
for k > 1 a segment holding two true winners contributes only its best
and a tile holding three contributes only two. exact=True re-scores whole
winning segments.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cvt_tpu_torch.ops.kernels import _build
from cvt_tpu_torch.ops.topk import top_k_smallest

BIG = 3.4e38            # finite +inf stand-in for padded result slots
_IMAX = 2_147_000_000   # masks a tile's best key while finding its second
SEG = 128               # default rows per packed segment (one CUDA block)
SEGS = (128, 64, 32, 16, 8)     # segment sizes the kernels are built for


def _pack_caps(seg: int, d: int) -> tuple[int, int]:
    """(valid norm cap, invalid norm marker) for score*seg+lane packing.

    |ip| <= ipb = 127*127*d. The invariants are
      max valid key  = (vcap + ipb)*seg + seg-1  <  min invalid key
      min invalid key = (ibase - ipb)*seg
      max invalid key = (ibase + ipb)*seg + seg-1  <  2^31
    all satisfied by vcap = 2^31//seg - 3*ipb - 2*seg, ibase = vcap +
    2*ipb + 1. Raises when (seg, d) leaves no headroom instead of
    silently wrapping int32 keys.
    """
    ipb = 127 * 127 * d
    vcap = (2 ** 31) // seg - 3 * ipb - 2 * seg
    ibase = vcap + 2 * ipb + 1
    if vcap <= 0:
        raise ValueError(
            f"packed selection infeasible: seg={seg}, d={d} leaves no "
            f"int32 headroom (need 2^31/seg > 3*127^2*d); reduce seg or d")
    return vcap, ibase


def _unpack(packed: torch.Tensor, seg: int):
    """packed i32 key -> (score i32, lane i32). Exact for any sign of
    score: lane = floor-mod(packed, seg)."""
    lane = torch.remainder(packed, seg)
    score = torch.div(packed - lane, seg, rounding_mode="floor")
    return score, lane


def _quantize_codebooks(codebooks: torch.Tensor):
    """[M, K, ds] f32 -> (cb_q [M, K, ds] int8, srow [D] f32).

    Per-dimension symmetric int8 quantization over the K codewords:
    cb / scale rounded half-to-even into [-127, 127]. The scale is folded
    into the query operand at search time (and squared into the norm), so
    decode stays pure int8. The same numbers as `_group_codebooks` of
    `cvt_tpu`, which lays them out block-diagonally for the TPU's matrix
    unit; the CUDA kernels gather from [M, K, ds] directly."""
    cb = codebooks.float()
    scales = torch.clamp_min(cb.abs().amax(dim=1) / 127.0, 1e-12)  # [M, ds]
    cb_q = torch.clamp(torch.round(cb / scales[:, None, :]), -127, 127)
    return cb_q.to(torch.int8), scales.reshape(-1)


def decode_int8(codes: torch.Tensor, cb_q: torch.Tensor) -> torch.Tensor:
    """codes [N, M] uint8 -> int8 rows [N, D] gathered from cb_q
    [M, K, ds]. A code past K decodes to zeros, as the one-hot product of
    `cvt_tpu` gives."""
    m, k_sub, ds = cb_q.shape
    idx = codes.long()
    sub = torch.arange(m, device=codes.device)[None, :]
    dec = cb_q[sub, idx.clamp_max(k_sub - 1)]                    # [N, M, ds]
    dec = torch.where((idx < k_sub)[..., None], dec, 0)
    return dec.reshape(codes.shape[0], m * ds)


def _row_norms(dec: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """||srow * dec||^2 per row as sum_d dec_d^2 * s2_d in float32, in a
    fixed order: 32 interleaved accumulators (lane j takes the dims
    d = j mod 32) updated by fused multiply-adds, then lanes combined as
    ((a[0:8] + a[8:16]) + a[16:24]) + a[24:32] and halved 8 -> 4 -> 2 -> 1.

    That is the order in which `cvt_tpu`'s Pallas kernel sums this norm
    when it runs in interpret mode on the CPU, and the CUDA kernel sums in
    the same order, so the norm column (and through round(norm/qs) every
    packed key) agrees bit for bit across all three. A float32 sum in
    another order differs in the last bits and flips round(norm/qs) for
    about 1% of rows. Each fused step is taken in float64, where the
    product of an int8 square and a float32 is exact, then rounded to
    float32 (a double rounding that can differ from a true fused
    multiply-add only when the float64 sum lands exactly on a float32
    tie, about 2^-28 of steps)."""
    n, d = dec.shape
    acc = torch.zeros((n, 32), dtype=torch.float32, device=dec.device)
    for d0 in range(0, d, 32):
        w = min(32, d - d0)
        v = dec[:, d0:d0 + w].double()
        acc[:, :w] = (acc[:, :w].double()
                      + (v * v) * s2[d0:d0 + w].double()).float()
    v = ((acc[:, 0:8] + acc[:, 8:16]) + acc[:, 16:24]) + acc[:, 24:32]
    v = v[:, :4] + v[:, 4:]
    v = v[:, :2] + v[:, 2:]
    return v[:, 0] + v[:, 1]


def _norm_column(norm: torch.Tensor, qs: torch.Tensor, row0: int,
                 n_valid: int, vcap: int, ibase: int,
                 seg: int) -> torch.Tensor:
    """int32 base column norm_i*seg + lane of the packed keys; rows at or
    past n_valid get the invalid marker ibase."""
    t = norm.shape[0]
    rows = torch.arange(t, device=norm.device, dtype=torch.int32)
    norm_i = torch.clamp(torch.round(norm / qs), 0.0, float(vcap))
    norm_i = torch.where(row0 + rows < n_valid, norm_i.to(torch.int32),
                         ibase)
    return norm_i * seg + rows % seg


def _segmin_tiles(dec_tile, norm, q2s, qs, n_valid, tile_n, npad, seg):
    """Shared body of both twins: tile by tile, packed keys -> segment
    minima and each tile's best two, never holding an [Npad, B] block.

    The scores are float32 products of int8-valued operands: every partial
    sum is an integer of magnitude <= 127^2 * D < 2^24 (D <= 1040), so
    float32 holds it exactly and the int32 cast is exact."""
    bpad, d = q2s.shape
    if d > 1040:
        raise ValueError(f"D={d} breaks the exact float32 score bound")
    if seg not in SEGS or tile_n % seg or npad % tile_n:
        raise ValueError(f"seg {seg} must be one of {SEGS} dividing tile_n "
                         f"{tile_n}, which must divide Npad {npad}")
    vcap, ibase = _pack_caps(seg, d)
    spt = tile_n // seg
    n_tiles = npad // tile_n
    dev = q2s.device
    qf = q2s.float().T                                           # [D, Bpad]
    segpack = torch.empty((npad // seg, bpad), dtype=torch.int32, device=dev)
    tiletop = torch.zeros((n_tiles, 8, bpad), dtype=torch.int32, device=dev)
    seg_rows = torch.arange(spt, device=dev, dtype=torch.int32)[:, None]
    for t in range(n_tiles):
        r0 = t * tile_n
        dec = dec_tile(r0)                                       # [T, D] i8
        col = _norm_column(norm[r0:r0 + tile_n], qs, r0, n_valid, vcap,
                           ibase, seg)
        ip = (dec.float() @ qf).to(torch.int32)                  # [T, Bpad]
        pmins = (ip * seg + col[:, None]).view(spt, seg, bpad).amin(1)
        segpack[t * spt:(t + 1) * spt] = pmins
        m1 = pmins.amin(0)
        sel1 = pmins == m1
        r1 = torch.where(sel1, seg_rows, spt).amin(0)
        masked = torch.where(sel1, _IMAX, pmins)
        m2 = masked.amin(0)
        r2 = torch.where(masked == m2, seg_rows, spt).amin(0)
        tiletop[t, 0] = m1
        tiletop[t, 1] = m2
        tiletop[t, 2] = r1 * seg + (m1 & (seg - 1))
        tiletop[t, 3] = r2 * seg + (m2 & (seg - 1))
    return segpack, tiletop


def adc_segmin_plain(q2s, qs, codes, cb_q, s2, n_valid: int, tile_n: int,
                     seg: int = SEG):
    """Plain PyTorch twin of the `adc_segmin` kernel (same arguments and
    outputs); runs on any device."""
    dec = decode_int8(codes, cb_q)                               # [Npad, D]
    norm = _row_norms(dec, s2)
    return _segmin_tiles(lambda r0: dec[r0:r0 + tile_n], norm, q2s, qs,
                         n_valid, tile_n, codes.shape[0], seg)


def adc_segmin_cached_plain(q2s, qs, dec8_t, norm_col, n_valid: int,
                            tile_n: int, seg: int = SEG):
    """Plain PyTorch twin of the `adc_segmin_cached` kernel."""
    return _segmin_tiles(lambda r0: dec8_t[:, r0:r0 + tile_n].T,
                         norm_col[:, 0], q2s, qs, n_valid, tile_n,
                         dec8_t.shape[1], seg)


# sm_90's per-block opt-in shared memory, the kernels' budget
SMEM_LIMIT = 227 * 1024


def _smem_bytes(d: int, cb_bytes: int) -> int:
    """Least dynamic shared memory of one ADC kernel block: `smem_bytes`
    of csrc/adc_scan.cu at two query tiles of 64 rows (the kernel takes
    three where they fit). The row and query tiles hold D in 128-byte
    panels; the decode kernel's codebooks (cb_bytes) share the query tiles'
    region."""
    panels = -(-d // 128)
    qregion = max(2 * 64 * 128 * panels, -(-cb_bytes // 16) * 16)
    return 1024 + 128 * 128 * panels + qregion + 128 * 4


def _check_launch(q2s, qs, npad: int, tile_n: int, seg: int, tensors: dict,
                  dtypes: dict, cb_bytes: int = 0) -> None:
    """Validate what the kernels take before their pointers are passed.
    cb_bytes: the decode kernel's int8 codebooks, staged in shared memory."""
    bpad, d = q2s.shape
    dev = q2s.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q2s on {dev}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"{name} must be contiguous and 4-byte aligned")
    if qs.numel() != 1:
        raise ValueError("qs must hold one float32 scale")
    if bpad % 128 or d % 4:
        raise ValueError(f"q2s [{bpad}, {d}]: need Bpad % 128 == 0 and "
                         f"D % 4 == 0")
    if seg not in SEGS or tile_n % seg or npad % tile_n or npad % 128:
        raise ValueError(f"seg {seg} must be one of {SEGS} dividing tile_n "
                         f"{tile_n}, which must divide Npad {npad}, a "
                         f"multiple of 128 (one CUDA block's rows)")
    smem = _smem_bytes(d, cb_bytes)
    if smem > SMEM_LIMIT:
        raise ValueError(f"D={d} with {cb_bytes} codebook bytes needs "
                         f"{smem} bytes of shared memory per block, over "
                         f"the {SMEM_LIMIT}-byte (227 KB) limit")


def _outputs(npad: int, tile_n: int, bpad: int, seg: int, dev):
    """Uninitialised (segpack, tiletop); the kernels write every entry."""
    return (torch.empty((npad // seg, bpad), dtype=torch.int32, device=dev),
            torch.empty((npad // tile_n, 8, bpad), dtype=torch.int32,
                        device=dev))


def adc_segmin(q2s, qs, codes, cb_q, s2, n_valid: int, tile_n: int,
               seg: int = SEG):
    """Phase 1 with decode -> (segpack [Npad/seg, Bpad] i32, tiletop
    [n_tiles, 8, Bpad] i32).

    q2s [Bpad, D] int8 = quantize(-2 * q * srow) and qs [1] f32 its scale
    (a tensor, so no host sync is needed); codes [Npad, M] uint8, the
    index's own rows (not `cvt_tpu`'s transposed int32 `codes_t`); cb_q
    [M, K, ds] int8 quantized codebooks; s2 [D] f32 = srow^2. segpack rows
    are packed (score*seg + lane) segment minima; tiletop rows 0/1 are
    each tile's two best keys, rows 2/3 their rows within the tile, rows
    4-7 zero padding (the layout of `cvt_tpu`'s kernel).
    """
    npad = codes.shape[0]
    if q2s.device.type == "cpu":
        return adc_segmin_plain(q2s, qs, codes, cb_q, s2, n_valid, tile_n,
                                seg)
    if q2s.device.type != "cuda":
        raise ValueError(f"no adc_segmin kernel for {q2s.device}")
    m, k_sub, ds = cb_q.shape
    _check_launch(q2s, qs, npad, tile_n, seg,
                  dict(q2s=q2s, qs=qs, codes=codes, cb_q=cb_q, s2=s2),
                  dict(q2s=torch.int8, qs=torch.float32, codes=torch.uint8,
                       cb_q=torch.int8, s2=torch.float32), cb_q.numel())
    bpad, d = q2s.shape
    if codes.shape[1] != m or m * ds != d or s2.shape != (d,):
        raise ValueError("codes/cb_q/s2 shapes disagree with q2s")
    vcap, ibase = _pack_caps(seg, d)
    lib = _build.load()
    segpack, tiletop = _outputs(npad, tile_n, bpad, seg, q2s.device)
    with torch.cuda.device(q2s.device):
        _build.check(lib, lib.cvt_adc_segmin(
            codes.data_ptr(), cb_q.data_ptr(), q2s.data_ptr(),
            s2.data_ptr(), qs.data_ptr(), npad, m, k_sub, ds, bpad, n_valid,
            tile_n, seg, vcap, ibase, segpack.data_ptr(), tiletop.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "adc_segmin")
    adc_segmin.launches += 1
    return segpack, tiletop


adc_segmin.launches = 0


def adc_segmin_cached(q2s, qs, dec8_t, norm_col, n_valid: int, tile_n: int,
                      seg: int = SEG):
    """Phase 1 over the decoded cache -> (segpack, tiletop) as
    `adc_segmin`. dec8_t [D, Npad] int8; norm_col [Npad, 1] f32."""
    npad = dec8_t.shape[1]
    if q2s.device.type == "cpu":
        return adc_segmin_cached_plain(q2s, qs, dec8_t, norm_col, n_valid,
                                       tile_n, seg)
    if q2s.device.type != "cuda":
        raise ValueError(f"no adc_segmin_cached kernel for {q2s.device}")
    _check_launch(q2s, qs, npad, tile_n, seg,
                  dict(q2s=q2s, qs=qs, dec8_t=dec8_t, norm_col=norm_col),
                  dict(q2s=torch.int8, qs=torch.float32, dec8_t=torch.int8,
                       norm_col=torch.float32))
    bpad, d = q2s.shape
    if dec8_t.shape[0] != d or norm_col.shape != (npad, 1):
        raise ValueError("dec8_t/norm_col shapes disagree with q2s")
    vcap, ibase = _pack_caps(seg, d)
    lib = _build.load()
    segpack, tiletop = _outputs(npad, tile_n, bpad, seg, q2s.device)
    with torch.cuda.device(q2s.device):
        _build.check(lib, lib.cvt_adc_segmin_cached(
            dec8_t.data_ptr(), norm_col.data_ptr(), q2s.data_ptr(),
            qs.data_ptr(), npad, d, bpad, n_valid, tile_n, seg, vcap, ibase,
            segpack.data_ptr(), tiletop.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "adc_segmin_cached")
    adc_segmin_cached.launches += 1
    return segpack, tiletop


adc_segmin_cached.launches = 0


def _rescore_segments(q, q_sq, seg_ids, codes, dec_sq, codebooks, k: int,
                      seg: int, n_valid: int):
    """Phase 2 of the exact path: f32 ADC re-score of the chosen segments.

    seg_ids [B, S]; codes [Npad, M] u8; dec_sq [Npad] f32. Returns the
    final (dists [B, k], ids [B, k]) with full-precision LUT scoring.
    At B=8192, S=14 the gathered code indices take ~0.9 GB (int64)."""
    b, s = seg_ids.shape
    m, k_sub, ds = codebooks.shape
    rows = (seg_ids[:, :, None] * seg
            + torch.arange(seg, device=q.device)[None, None, :])
    rows = rows.reshape(b, s * seg)                              # [B, C]
    cand_codes = codes[rows]                                     # [B, C, M]
    cand_dsq = dec_sq[rows]                                      # [B, C]
    lut = -2.0 * torch.einsum("bms,mks->bmk", q.reshape(b, m, ds),
                              codebooks)                         # [B, M, K]
    g = torch.gather(lut, 2, cand_codes.permute(0, 2, 1).long())  # [B, M, C]
    dist = torch.sum(g, dim=1) + cand_dsq + q_sq[:, None]
    dist = torch.where(rows < n_valid, dist, float("inf"))
    d, j = top_k_smallest(dist, k)
    return d, torch.gather(rows, -1, j).to(torch.int32)


def _fold_queries(q, srow, norm_cap=None, vcap: int | None = None):
    """q [B, D] f32 -> (q2s [Bpad, D] int8, qs f32 0-dim tensor) with
    q2s * qs ~= -2 * q * srow, padded to B % 128 == 0.

    One symmetric scale for the whole batch keeps the kernel's dequant a
    single scalar on the int32 score, preserving exact integer packing.
    norm_cap (with vcap) clamps qs from BELOW so that the integer norm
    column round(norm/qs) can never exceed vcap: a low-magnitude query
    batch against large-norm rows would otherwise saturate every large
    norm to vcap and corrupt ranking."""
    b = q.shape[0]
    bpad = -(-b // 128) * 128
    q2 = -2.0 * q * srow[None, :]
    qs = torch.clamp_min(torch.amax(torch.abs(q2)) / 127.0, 1e-30)
    if norm_cap is not None:
        qs = torch.maximum(qs, norm_cap / vcap)
    q2s = torch.clamp(torch.round(q2 / qs), -127.0, 127.0).to(torch.int8)
    if bpad != b:
        q2s = F.pad(q2s, (0, 0, 0, bpad - b))
    return q2s, qs


def _select_tiletop(segpack, tiletop, qs, q_sq, b: int, k: int, tile_n: int,
                    seg: int, n_valid: int | None = None):
    """Shared selection tail: packed tile-top2 candidates -> (dist, ids).

    Ranks f32 casts of the int32 keys, as `cvt_tpu` does: nearby large
    keys collapse into exact f32 ties there, so ids agree only because
    the stable sort breaks ties toward the lower index as `lax.top_k`
    does. ids come from the row-in-tile sidecar."""
    n_tiles = tiletop.shape[0]
    spt = tile_n // seg
    # only tiles overlapping real rows can contribute candidates: a
    # database padded far beyond n_valid must fall back to segment-minima
    # selection or the top-2-per-tile cap truncates the candidate pool
    # below k and padding sentinels leak into the tail of the results
    real_tiles = (n_tiles if n_valid is None
                  else min(n_tiles, -(-int(n_valid) // tile_n)))
    if 2 * real_tiles < k or spt < 2:
        # tiny database: flat selection over all packed segment minima
        packed, j = top_k_smallest(segpack.T[:b], min(k, segpack.shape[0]))
        score, lane = _unpack(packed, seg)
        ids = (j * seg + lane).to(torch.int32)
        dist = score.float() * qs + q_sq[:, None]
        if ids.shape[1] < k:
            pad = (0, k - ids.shape[1])
            dist = F.pad(dist, pad, value=BIG)
            ids = F.pad(ids, pad, value=2 ** 30)
        return dist, ids
    packs = torch.cat([tiletop[:, 0, :], tiletop[:, 1, :]], 0)   # [2T, Bpad]
    rows = torch.cat([tiletop[:, 2, :], tiletop[:, 3, :]], 0)
    keys, j = top_k_smallest(packs.float().T[:b], k)
    tile = torch.where(j < n_tiles, j, j - n_tiles)
    rowint = torch.gather(rows.T[:b], -1, j)
    ids = (tile * tile_n + rowint).to(torch.int32)
    dist = (keys / seg) * qs + q_sq[:, None]
    return dist, ids


def _fold_for(q, srow, d: int):
    """Fold queries with the analytic norm bound: |dec_d| <= 127, so
    norm <= 127^2 * ||srow||^2, and clamping qs below bound/vcap keeps the
    norm column from saturating."""
    vcap, _ = _pack_caps(SEG, d)
    return _fold_queries(q, srow, 127.0 ** 2 * torch.sum(srow * srow), vcap)


def _adc_search_fast(q, q_sq, codes, cb_q, srow, k, n_valid, tile_n):
    """Query fold + packed kernel + tile-top2 selection."""
    q2s, qs = _fold_for(q, srow, q.shape[1])
    segpack, tiletop = adc_segmin(q2s, qs, codes, cb_q, srow * srow,
                                  n_valid, tile_n)
    return _select_tiletop(segpack, tiletop, qs, q_sq, q.shape[0], k,
                           tile_n, SEG, n_valid)


def _adc_search_exact(q, q_sq, codes, cb_q, srow, dec_sq, codebooks, k,
                      n_valid, tile_n, slack):
    """Packed kernel, then an f32 re-score of the k+slack best segments
    (packed keys rank exactly like segment minima)."""
    q2s, qs = _fold_for(q, srow, q.shape[1])
    segpack, _ = adc_segmin(q2s, qs, codes, cb_q, srow * srow, n_valid,
                            tile_n)
    n_seg_take = min(k + slack, segpack.shape[0])
    _, seg_ids = top_k_smallest(segpack.T[:q.shape[0]], n_seg_take)
    return _rescore_segments(q, q_sq, seg_ids, codes, dec_sq, codebooks,
                             k, SEG, n_valid)


def fast_tile_n(npad: int) -> int:
    """Tile of the decode scan. The tile fixes which rows share a best-two
    list, so it changes results as well as speed: `cvt_tpu`'s rule."""
    return 2048 if npad % 2048 == 0 else 1024


def cached_tile_n(npad: int) -> int:
    """Tile of the decoded-cache scan (`cvt_tpu`'s rule). Each tile emits
    its top-2 candidates, so the chance that the true winners put three
    into one tile scales ~(tile_n/N)^2: keep the tile at most npad/64
    where that is possible."""
    choices = [t for t in (4096, 2048, 1024) if npad % t == 0]
    fitting = [t for t in choices if t * 64 <= npad]
    return fitting[0] if fitting else (choices[-1] if choices else 1024)


def adc_search(q, q_sq, codes, dec_sq, codebooks, k: int, n_valid: int, *,
               cb_q=None, srow=None, tile_n: int | None = None,
               slack: int = 4, exact: bool = False):
    """Two-phase fused ADC search: packed segment scan + selection.

    q [B, D] rotated-space queries; q_sq [B] their squared norms (or None);
    codes [Npad, M] uint8 and dec_sq [Npad] f32, padded so that Npad is a
    multiple of the tile (rows at or past n_valid never appear in
    results); codebooks [M, K, ds]. cb_q/srow are `_quantize_codebooks`'s
    output, computed here when not given.

    Fast path (default): the top-k packed tile candidates ARE the
    results. exact=True re-scores the k+slack winning segments in f32 for
    exact top-k w.r.t. phase-1 quantized scoring. Any k <= 128.
    """
    npad = codes.shape[0]
    tile_n = fast_tile_n(npad) if tile_n is None else tile_n
    if npad % tile_n:
        raise ValueError(f"npad {npad} must be a multiple of {tile_n}")
    if k > SEG:
        raise ValueError(f"two-phase path requires k <= {SEG}")
    if cb_q is None:
        cb_q, srow = _quantize_codebooks(codebooks)
    q = q.float()
    if q_sq is None:
        q_sq = torch.sum(q * q, dim=-1)
    if not exact:
        return _adc_search_fast(q, q_sq, codes, cb_q, srow, k, n_valid,
                                tile_n)
    return _adc_search_exact(q, q_sq, codes, cb_q, srow, dec_sq, codebooks,
                             k, n_valid, tile_n, slack)


def cached_seg(d: int) -> int:
    """Segment of the decoded-cache scan at width d: SEG, `cvt_tpu`'s,
    whose int32 keys have headroom up to d 346; above that halved until
    they do (64 up to d 693, 32 beyond), where `cvt_tpu` raises."""
    seg = SEG
    while seg > SEGS[-1] and (2 ** 31) // seg - 3 * 127 * 127 * d \
            - 2 * seg <= 0:
        seg //= 2
    return seg


def adc_search_cached(q, dec8_t, norm_col, srow, k: int, n_valid: int,
                      tile_n: int | None = None):
    """Fast search over the int8 decoded cache (decode-free scan).

    q [B, D] rotated space; dec8_t [D, Npad] int8; norm_col [Npad, 1] f32
    quantized-space row norms; srow the per-dim dequant scales. The
    segment is `cached_seg(D)`.
    """
    npad = dec8_t.shape[1]
    tile_n = cached_tile_n(npad) if tile_n is None else tile_n
    seg = cached_seg(dec8_t.shape[0])
    q = q.float()
    q_sq = torch.sum(q * q, dim=-1)
    # the cached path has the norms in hand: clamp qs below max(norm)/vcap
    vcap, _ = _pack_caps(seg, dec8_t.shape[0])
    q2s, qs = _fold_queries(q, srow, torch.amax(norm_col), vcap)
    segpack, tiletop = adc_segmin_cached(q2s, qs, dec8_t, norm_col,
                                         n_valid, tile_n, seg)
    return _select_tiletop(segpack, tiletop, qs, q_sq, q.shape[0], k,
                           tile_n, seg, n_valid)
