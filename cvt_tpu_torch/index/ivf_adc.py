"""IVF-ADC: coarse inverted lists + residual PQ codes, probed ADC search.

Counterpart of `cvt_tpu.index.ivf_adc`. Reference: opq/src/IVFOPQ.cpp —
coarse k-means assignment (:113-129), residual PQ encode (:141-163),
nearest-nprobe selection (:237-260), per-probe LUT build (:279-291) and
inverted-list LUT-sum scan (:300-309). Operating point there: d=128,
coarseK=8192, m=16, k=256 (IVFOPQ.cpp:56-63).

Two engines over one index:
  * `search` (and `search_threshold`, `search_grouped`): the reference
    engine. Inverted lists are padded dense buckets [Kc, L, M] u8, so a
    probe is a gather; residual LUTs are built for every (query, probe)
    pair at once,
        dist(q, n) = sum_m LUT_r[b, p, m, code_n[m]],  r = q - centroid_p.
    Lists longer than the bucket capacity spill into a flat tail scanned
    for every query with  ||q||^2 + ||c_a + d||^2 - 2<q, c_a> - 2<q, d>.
  * `search_fast`: the union-probe page scan of `ops.kernels.ivf_scan`,
    whose phase 1 is a hand-written CUDA kernel for an index on the card
    and its plain twin for one on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.index.flat_adc import _decode_chunk_bf16
from cvt_tpu_torch.ops.kernels.ivf_scan import (build_page_layout,
                                                coarse_probes,
                                                ivf_union_search)
from cvt_tpu_torch.ops.kmeans import kmeans, kmeans_assign
from cvt_tpu_torch.ops.topk import merge_topk, top_k_smallest
from cvt_tpu_torch.quant.pq import ProductQuantizer
from cvt_tpu_torch.utils.device import resolve_device
from cvt_tpu_torch.utils.profile import span


def _probed_scores(q, centroids, cw_sqnorm, codebooks, buckets, bucket_ids,
                   nprobe: int, probe_chunk: int | None = None):
    """Shared probe + residual-LUT + bucket-scoring stage.

    Returns (flat_scores [B, P*L], flat_ids [B, P*L], coarse_ip [B, Kc],
    q_sq [B]). probe_chunk bounds the [B, Pc, L, M] gather working set by
    looping probe chunks instead of materializing all P."""
    b, _ = q.shape
    m, _, ds = codebooks.shape
    L = buckets.shape[1]
    coarse_ip, q_sq, probes = coarse_probes(q, centroids, nprobe)

    pc = min(probe_chunk or nprobe, nprobe)
    parts_s, parts_i = [], []
    for s in range(0, nprobe, pc):
        pr = probes[:, s:s + pc]                                 # [B, Pc]
        npc = pr.shape[1]
        r_sub = (q[:, None, :] - centroids[pr]).reshape(b, npc, m, ds)
        ip_lut = torch.einsum("bpms,mks->bpmk", r_sub, codebooks)
        r_sq_sub = torch.sum(r_sub * r_sub, dim=-1)              # [B, Pc, M]
        lut = (r_sq_sub[..., None] - 2.0 * ip_lut
               + cw_sqnorm[None, None, :, :])                    # [B,Pc,M,K]
        pcodes = buckets[pr].long()                              # [B,Pc,L,M]
        pids = bucket_ids[pr]                                    # [B, Pc, L]
        g = torch.gather(lut, 3, pcodes.permute(0, 1, 3, 2))     # [B,Pc,M,L]
        scores = torch.sum(g, dim=2)                             # [B, Pc, L]
        scores = torch.where(pids >= 0, scores, float("inf"))
        parts_s.append(scores.reshape(b, npc * L))
        parts_i.append(pids.reshape(b, npc * L))
    return (torch.cat(parts_s, 1), torch.cat(parts_i, 1), coarse_ip, q_sq)


def _tail_dists(q, q_sq, coarse_ip, codebooks, tail_codes, tail_coarse,
                tail_dsq, tail_ids):
    """Overflow-tail distances [B, T]: bf16 decode, f32 products, the
    coarse inner products reused from probe selection; inf on padding."""
    dec = _decode_chunk_bf16(tail_codes, codebooks).float()      # [T, D]
    ip_d = (dec @ q.to(torch.bfloat16).float().T).T              # [B, T]
    cip = coarse_ip[:, tail_coarse.long()]                       # [B, T]
    tdist = q_sq[:, None] + tail_dsq[None, :] - 2.0 * cip - 2.0 * ip_d
    return torch.where(tail_ids[None, :] >= 0, tdist, float("inf"))


def _with_tail(flat_scores, flat_ids, q, q_sq, coarse_ip, codebooks, tail):
    """Bucket candidates with every tail entry appended (search_threshold
    and search_grouped scan the whole tail)."""
    tail_codes, tail_coarse, tail_dsq, tail_ids = tail
    if tail_codes.shape[0] == 0:
        return flat_scores, flat_ids
    tdist = _tail_dists(q, q_sq, coarse_ip, codebooks, *tail)
    return (torch.cat([flat_scores, tdist], 1),
            torch.cat([flat_ids, tail_ids[None, :].expand(tdist.shape)], 1))


def _ivf_query(q, centroids, cw_sqnorm, codebooks, buckets, bucket_ids,
               tail, nprobe: int, k: int, probe_chunk: int | None = None):
    """Batched IVF-ADC query: bucket top-k merged with the tail's top-k.
    tail = (codes [T, M] u8, coarse id [T], dsq [T], ids [T] (-1 = pad))."""
    b = q.shape[0]
    L = buckets.shape[1]
    flat_scores, flat_ids, coarse_ip, q_sq = _probed_scores(
        q, centroids, cw_sqnorm, codebooks, buckets, bucket_ids, nprobe,
        probe_chunk)
    kb = min(k, nprobe * L)
    best_d, best_i = merge_topk(flat_scores, flat_ids, kb)
    tail_codes, _, _, tail_ids = tail
    t = tail_codes.shape[0]
    if t > 0:
        tdist = _tail_dists(q, q_sq, coarse_ip, codebooks, *tail)
        kt = min(k, t)
        td, ti = merge_topk(tdist, tail_ids[None, :].expand(b, t), kt)
        best_d, best_i = merge_topk(torch.cat([best_d, td], -1),
                                    torch.cat([best_i, ti], -1),
                                    min(k, kb + kt))
    return best_d, best_i


def _ivf_query_threshold(q, centroids, cw_sqnorm, codebooks, buckets,
                         bucket_ids, tail, radius: float, nprobe: int,
                         max_results: int, probe_chunk: int | None = None):
    """Radius query — the QueryThrehold analogue (IVFOPQ.cpp:213-320):
    every probed entry with dist <= radius, reported as up to max_results
    (nearest first) plus the true total count under the radius.

    Returns (dists [B, R], ids [B, R], valid [B, R] bool, count [B] i32)."""
    flat_scores, flat_ids, coarse_ip, q_sq = _probed_scores(
        q, centroids, cw_sqnorm, codebooks, buckets, bucket_ids, nprobe,
        probe_chunk)
    flat_scores, flat_ids = _with_tail(flat_scores, flat_ids, q, q_sq,
                                       coarse_ip, codebooks, tail)
    r = min(max_results, flat_scores.shape[1])
    dists, ids = merge_topk(flat_scores, flat_ids, r)
    valid = (dists <= radius) & (ids >= 0)
    count = torch.sum((flat_scores <= radius) & (flat_ids >= 0),
                      dim=-1).to(torch.int32)
    return dists, ids, valid, count


def _ivf_query_grouped(q, centroids, cw_sqnorm, codebooks, buckets,
                       bucket_ids, tail, vec_groups, nprobe: int, k: int,
                       n_groups: int, probe_chunk: int | None = None):
    """Per-group min-aggregated query — the per-video min-reduce of the
    reference's inverted-list scan (IVFOPQ.cpp:300-309, IVFelem.videoId).

    vec_groups [N] int32 maps vector id -> group in [0, n_groups). Returns
    (group_dists [B, kg], group_ids [B, kg], member_ids [B, kg]), the
    member being the arg-min vector of each winning group."""
    b = q.shape[0]
    flat_scores, flat_ids, coarse_ip, q_sq = _probed_scores(
        q, centroids, cw_sqnorm, codebooks, buckets, bucket_ids, nprobe,
        probe_chunk)
    flat_scores, flat_ids = _with_tail(flat_scores, flat_ids, q, q_sq,
                                       coarse_ip, codebooks, tail)
    # group per candidate; pad/invalid -> sentinel group n_groups
    safe = flat_ids.clamp(0, vec_groups.shape[0] - 1).long()
    gid = torch.where(flat_ids >= 0, vec_groups[safe].long(), n_groups)
    per_group = torch.full((b, n_groups + 1), float("inf"),
                           device=q.device).scatter_reduce(
        1, gid, flat_scores, "amin")
    kg = min(k, n_groups)
    gdist, gsel = top_k_smallest(per_group[:, :n_groups], kg)
    # arg-min member: the lowest id among candidates at their group's min
    is_min = flat_scores <= torch.gather(per_group, 1, gid)
    imax = torch.iinfo(torch.int32).max
    cand = torch.where(is_min & (flat_ids >= 0), flat_ids, imax)
    member = torch.full((b, n_groups + 1), imax, dtype=torch.int32,
                        device=q.device).scatter_reduce(1, gid, cand, "amin")
    member_sel = torch.gather(member[:, :n_groups], 1, gsel)
    member_sel = torch.where(torch.isfinite(gdist), member_sel, -1)
    return gdist, gsel, member_sel


class IVFADCIndex:
    """Inverted-file index with residual PQ codes and batched ADC probes.

    Its tensors live on `device` (the card when None, see
    `resolve_device`); training, encoding and every search run there."""

    ENC_CHUNK = 131_072          # rows encoded per step (bounds memory)

    def __init__(self, coarse_k: int = 1024, m: int = 8, k: int = 256,
                 bucket_cap: int | None = None, device=None):
        self.coarse_k = coarse_k
        self.m = m
        self.k = k
        self.bucket_cap = bucket_cap
        self.device = resolve_device(device)
        self.centroids: torch.Tensor | None = None   # [Kc, D]
        self.pq: ProductQuantizer | None = None
        self._built = False

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # ---------------------------------------------------------------- train
    def train(self, gen: torch.Generator, x, *, coarse_iters: int = 20,
              pq_iters: int = 25, sample: int | None = 262144) -> None:
        """Coarse k-means + residual PQ, mirroring TrainPQ::{CoarseQuan,
        ProdQuan} (train_PQ_codebook.cpp:150-244). `gen` is a CPU
        `torch.Generator` (the sample and both inits draw from it)."""
        x = self._t(x, torch.float32)
        if sample is not None and x.shape[0] > sample:
            idx = torch.randperm(x.shape[0], generator=gen)[:sample]
            x = x[idx.to(self.device)]
        res = kmeans(gen, x, self.coarse_k, iters=coarse_iters)
        self.centroids = res.centroids
        residuals = x - self.centroids[res.assignments.long()]
        self.pq = ProductQuantizer.train(gen, residuals, self.m, self.k,
                                         iters=pq_iters)

    # ---------------------------------------------------------------- build
    def build(self, x, group_ids=None) -> None:
        """Assign, encode residuals (on the device, ENC_CHUNK rows at a
        time) and lay out buckets, tail and pages on the host.

        group_ids: optional [N] int array mapping each vector to a group
        (the reference's IVFelem.videoId, IVFOPQ.h:24-29) — enables
        search_grouped()."""
        if self.centroids is None:
            raise RuntimeError("train() first")
        n = x.shape[0]
        parts = [self.encode_chunk(x[s:s + self.ENC_CHUNK])
                 for s in range(0, n, self.ENC_CHUNK)]
        self.build_from_codes(
            *[torch.cat([p[j] for p in parts]).cpu().numpy()
              for j in range(3)], group_ids=group_ids)

    def encode_chunk(self, xc):
        """(assign [T] int32, residual codes [T, M] u8, reconstruction
        sqnorm [T] f32) for one chunk, on the device. Full float32: TF32
        flips near-tie cells."""
        xc = self._t(xc, torch.float32)
        a_c, _ = kmeans_assign(xc, self.centroids)
        cent = self.centroids[a_c.long()]
        codes_c = self.pq.encode(xc - cent)
        rec = self.pq.decode(codes_c) + cent
        return a_c, codes_c, torch.sum(rec * rec, dim=-1)

    def build_from_codes(self, assign_np, codes_np, dsq_np,
                         group_ids=None) -> None:
        """Lay out buckets, tail and pages from precomputed per-vector
        (coarse assignment, residual codes, reconstruction sqnorms), host
        numpy as in `cvt_tpu`, so every array matches it bit for bit."""
        assign_np = np.asarray(assign_np)
        codes_np = np.asarray(codes_np, np.uint8)
        dsq_np = np.asarray(dsq_np, np.float32)
        n = assign_np.shape[0]
        counts = np.bincount(assign_np, minlength=self.coarse_k)
        cap = self.bucket_cap
        if cap is None:
            cap = int(min(counts.max(),
                          max(8, 4 * max(1, n // self.coarse_k))))
            cap = -(-cap // 8) * 8
        order = np.argsort(assign_np, kind="stable")
        sorted_assign = assign_np[order]
        starts = np.zeros(self.coarse_k + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        rank = np.arange(n, dtype=np.int64) - starts[sorted_assign]

        in_bucket = rank < cap
        buckets = np.zeros((self.coarse_k, cap, self.m), np.uint8)
        bucket_ids = np.full((self.coarse_k, cap), -1, np.int32)
        bucket_dsq = np.zeros((self.coarse_k, cap), np.float32)
        bi = sorted_assign[in_bucket]
        br = rank[in_bucket].astype(np.int64)
        src = order[in_bucket]
        buckets[bi, br] = codes_np[src]
        bucket_ids[bi, br] = src.astype(np.int32)
        bucket_dsq[bi, br] = dsq_np[src]

        pg = build_page_layout(codes_np, assign_np, dsq_np,
                               self.pq.codebooks.cpu().numpy())
        self._set_pages(pg["dec8_t"], pg["dec16"], pg["srow16"],
                        pg["nrm_col"], pg["seg_cell"], pg["rowids"],
                        pg["srow"], pg["dsq_min"], pg["lp"], pg["seg"])

        tail_src = order[~in_bucket]
        self._buckets = self._t(buckets)
        self._bucket_ids = self._t(bucket_ids)
        self._bucket_dsq = self._t(bucket_dsq)
        # pad the tail to a multiple of 128
        tlen = len(tail_src)
        tpad = -(-tlen // 128) * 128
        tail_codes = np.zeros((tpad, self.m), np.uint8)
        tail_coarse = np.zeros((tpad,), np.int32)
        tail_dsq = np.zeros((tpad,), np.float32)
        tail_ids = np.full((tpad,), -1, np.int32)
        if tlen:
            tail_codes[:tlen] = codes_np[tail_src]
            tail_coarse[:tlen] = assign_np[tail_src]
            tail_dsq[:tlen] = dsq_np[tail_src]
            tail_ids[:tlen] = tail_src.astype(np.int32)
        self._set_tail(tail_codes, tail_coarse, tail_dsq, tail_ids)
        self._set_groups(np.zeros(0, np.int32) if group_ids is None
                         else np.asarray(group_ids, np.int32), n)
        self._ntotal = n
        self._built = True

    def _set_pages(self, dec8_t, dec16, srow16, nrm_col, seg_cell, rowids,
                   srow, dsq_min: float, lp: int, seg: int) -> None:
        self._pg_dec8_t = self._t(dec8_t)
        self._pg_dec16 = self._t(dec16)
        self._pg_srow16 = self._t(srow16)
        self._pg_nrm = self._t(nrm_col)
        self._pg_seg_cell = self._t(seg_cell)
        self._pg_rowids = self._t(rowids)
        self._pg_srow = self._t(srow)
        self._pg_dsq_min = float(dsq_min)
        self._pg_lp, self._pg_seg = int(lp), int(seg)

    def _set_tail(self, codes, coarse, dsq, ids) -> None:
        self._tail = (self._t(codes), self._t(coarse), self._t(dsq),
                      self._t(ids))

    def _set_groups(self, g: np.ndarray, n: int) -> None:
        """g [N] int32 group per vector, or empty for none."""
        if g.size and g.shape != (n,):
            raise ValueError(f"group_ids must be [{n}], got {g.shape}")
        self._vec_groups = self._t(g) if g.size else None
        self.n_groups = int(g.max()) + 1 if g.size else 0

    @property
    def ntotal(self) -> int:
        return getattr(self, "_ntotal", 0)

    @property
    def tail_len(self) -> int:
        """Entries that overflowed their bucket (without padding)."""
        return int((self._tail[3] >= 0).sum()) if self._built else 0

    # --------------------------------------------------------------- search
    def _query(self, q) -> torch.Tensor:
        if not self._built:
            raise RuntimeError("build() first")
        return self._t(q, torch.float32)

    def _engine_args(self):
        return (self.centroids, self.pq.codeword_sqnorms(),
                self.pq.codebooks, self._buckets, self._bucket_ids,
                self._tail)

    def search(self, q, k: int, *, nprobe: int = 16,
               probe_chunk: int | None = None):
        """Reference engine -> (dists [B, k'], ids [B, k'] int32)."""
        q = self._query(q)
        return _ivf_query(q, *self._engine_args(),
                          min(nprobe, self.coarse_k), k, probe_chunk)

    def search_fast(self, q, k: int, *, nprobe: int = 16,
                    max_pages: int | None = None,
                    exact_probe: bool = True):
        """Union-probe page scan (the production query path): the same
        nprobe semantics as search(), scored decode-free by the `ivf_page`
        kernel on the card (its twin on the CPU), phase 2 by the
        `ivf_rescore` kernel there. Returns (dists [B, k], ids [B, k],
        n_dropped_pages).

        Traced, the call is one `ivf.search` span holding `ivf.stage_in`
        (the queries to the index's device) and the stages of
        `ivf_union_search`: `ivf.probe`, `ivf.coarse_terms`, `ivf.fold`,
        `kernel.ivf_page`, `ivf.rescore` and `ivf.select`."""
        with span("ivf.search"):
            with span("ivf.stage_in"):
                q = self._query(q)
            if not hasattr(self, "_pg_dec8_t"):
                raise RuntimeError("no page layout (index saved by an older "
                                   "version) — rebuild with build()")
            b = q.shape[0]
            nprobe = min(nprobe, self.coarse_k)
            n_pages = self._pg_dec8_t.shape[1] // self._pg_lp
            if max_pages is None:
                # union bound: every (query, probe) pair could own up to
                # two distinct pages (a cell list straddling a page
                # boundary)
                max_pages = min(n_pages, 2 * b * nprobe)
            max_pages = max(8, min(max_pages, n_pages))
            return ivf_union_search(
                q, self.centroids, self._pg_dec8_t, self._pg_dec16,
                self._pg_srow16, self._pg_nrm, self._pg_seg_cell,
                self._pg_rowids, self._pg_srow, self._pg_dsq_min, nprobe, k,
                max_pages, lp=self._pg_lp, seg=self._pg_seg,
                exact_probe=exact_probe)

    def cell_pages(self) -> int:
        """The most pages one cell's rows span in the page layout: with
        that many pages for each (query, probe) pair, a `search_fast`
        budget (`max_pages`) drops none. The default budget of two assumes
        every cell within a page or across one page boundary."""
        seg_cell = self._pg_seg_cell.cpu().numpy().astype(np.int64)
        n_pages = self._pg_dec8_t.shape[1] // self._pg_lp
        page = np.arange(len(seg_cell)) // (self._pg_lp // self._pg_seg)
        live = seg_cell >= 0
        pairs = np.unique(seg_cell[live] * n_pages + page[live])
        return int(np.bincount(pairs // n_pages).max())

    def search_threshold(self, q, radius: float, *, nprobe: int = 16,
                         max_results: int = 128,
                         probe_chunk: int | None = None):
        """All probed neighbors within `radius` (squared L2) — the
        QueryThrehold analogue (opq/src/IVFOPQ.cpp:213-320). Returns
        (dists [B, R], ids [B, R], valid [B, R], count [B])."""
        q = self._query(q)
        return _ivf_query_threshold(q, *self._engine_args(), float(radius),
                                    min(nprobe, self.coarse_k), max_results,
                                    probe_chunk)

    def search_grouped(self, q, k: int, *, nprobe: int = 16,
                       probe_chunk: int | None = None):
        """Top-k groups by min member distance — the reference's
        per-video min-aggregation (IVFOPQ.cpp:300-309). Requires
        build(x, group_ids=...). Returns (group_dists [B, kg], group_ids
        [B, kg], member_ids [B, kg])."""
        q = self._query(q)
        if self._vec_groups is None:
            raise RuntimeError("build(x, group_ids=...) first")
        return _ivf_query_grouped(q, *self._engine_args(), self._vec_groups,
                                  min(nprobe, self.coarse_k), k,
                                  self.n_groups, probe_chunk)

    # -- persistence (the .npz layout of cvt_tpu: same keys and dtypes) --
    def save(self, path: str) -> None:
        if not hasattr(self, "_pg_dec8_t"):
            raise RuntimeError(
                "this index was loaded from a pre-page-layout file and "
                "cannot be re-saved losslessly — rebuild with build()")

        def h(t):
            return t.cpu().numpy()
        tail_codes, tail_coarse, tail_dsq, tail_ids = self._tail
        np.savez(path,
                 centroids=h(self.centroids), codebooks=h(self.pq.codebooks),
                 buckets=h(self._buckets), bucket_ids=h(self._bucket_ids),
                 bucket_dsq=h(self._bucket_dsq), tail_codes=h(tail_codes),
                 tail_coarse=h(tail_coarse), tail_dsq=h(tail_dsq),
                 tail_ids=h(tail_ids),
                 vec_groups=(h(self._vec_groups)
                             if self._vec_groups is not None
                             else np.zeros(0, np.int32)),
                 pg_dec8_t=h(self._pg_dec8_t), pg_dec16=h(self._pg_dec16),
                 pg_srow16=h(self._pg_srow16), pg_nrm=h(self._pg_nrm),
                 pg_seg_cell=h(self._pg_seg_cell),
                 pg_rowids=h(self._pg_rowids), pg_srow=h(self._pg_srow),
                 pg_meta=np.asarray([self._pg_dsq_min, self._pg_lp,
                                     self._pg_seg], np.float64),
                 ntotal=self._ntotal)

    @classmethod
    def load(cls, path: str, device=None) -> "IVFADCIndex":
        z = np.load(path, allow_pickle=False)
        cb = z["codebooks"]
        idx = cls(coarse_k=z["centroids"].shape[0], m=cb.shape[0],
                  k=cb.shape[1], device=device)
        idx.centroids = idx._t(z["centroids"])
        idx.pq = ProductQuantizer(cb, device=idx.device)
        idx._buckets = idx._t(z["buckets"])
        idx._bucket_ids = idx._t(z["bucket_ids"])
        idx._bucket_dsq = idx._t(z["bucket_dsq"])
        idx._set_tail(z["tail_codes"], z["tail_coarse"], z["tail_dsq"],
                      z["tail_ids"])
        vg = z["vec_groups"] if "vec_groups" in z.files else np.zeros(
            0, np.int32)
        idx._ntotal = int(z["ntotal"])
        idx._set_groups(vg, idx._ntotal)
        if "pg_dec8_t" in z.files:     # page layout (round-4+ files)
            meta = np.asarray(z["pg_meta"])
            idx._set_pages(z["pg_dec8_t"], z["pg_dec16"], z["pg_srow16"],
                           z["pg_nrm"], z["pg_seg_cell"], z["pg_rowids"],
                           z["pg_srow"], float(meta[0]), int(meta[1]),
                           int(meta[2]))
        idx._built = True
        return idx
