"""Sharded flat ADC search over a device mesh.

Counterpart of `cvt_tpu.parallel.sharded_search`. One process per device
replaces JAX's shard_map over one process's devices:

  * the PQ code matrix [N, M] is split along N over the mesh's 'db' axis:
    each rank holds its own shard [per, M] uint8 on its device (the port's
    row layout, not `cvt_tpu`'s transposed int32);
  * every rank of a 'db' group scans the same query batch;
  * each rank scans its shard and extracts a local top-k with global ids
    (shard offset from its coordinate on 'db');
  * candidates merge by an all_gather over the 'db' group, stacked in
    rank order ([B, S*k], the order of `lax.all_gather(..., axis=1)`),
    then one stable top-k.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from cvt_tpu_torch.index.flat_adc import _adc_scan
from cvt_tpu_torch.ops.kernels.adc_scan import (_fold_queries,
                                                _quantize_codebooks, _unpack,
                                                adc_segmin)
from cvt_tpu_torch.ops.topk import merge_topk, top_k_smallest
from cvt_tpu_torch.parallel.mesh import axis_size, mesh_device
from cvt_tpu_torch.quant.opq import OPQ
from cvt_tpu_torch.quant.pq import ProductQuantizer

_BIG = 3.4e38


def _local_pallas_topk(q, codes_l, cb_q, srow, k: int, n_valid: int,
                       tile_n: int, seg: int):
    """Per-shard packed scan (the `adc_segmin` kernel) + local top-k, ids
    local to the shard. The name is `cvt_tpu`'s, and so is the selection,
    which differs from the flat index's on purpose:
      * queries fold with no norm cap (`_fold_queries(q, srow)`);
      * the flat branch is taken when 2 * n_tiles < kk or spt < 2, over
        ALL tiles, padding tiles included (the flat path counts only the
        tiles that hold real rows).
    When the shard has fewer segments than k, candidates are padded to k
    columns with (BIG, 2^30) so that every shard merges k columns."""
    b = q.shape[0]
    q_sq = torch.sum(q * q, dim=-1)
    q2s, qs = _fold_queries(q, srow)
    segpack, tiletop = adc_segmin(q2s, qs, codes_l, cb_q, srow * srow,
                                  n_valid, tile_n, seg)
    n_tiles = tiletop.shape[0]
    spt = tile_n // seg
    kk = min(k, segpack.shape[0])
    if 2 * n_tiles < kk or spt < 2:
        packed, j = top_k_smallest(segpack.T[:b], kk)
        score, lane = _unpack(packed, seg)
        ids = j * seg + lane
        d = score.float() * qs + q_sq[:, None]
    else:
        packs = torch.cat([tiletop[:, 0, :], tiletop[:, 1, :]], 0)
        rows = torch.cat([tiletop[:, 2, :], tiletop[:, 3, :]], 0)
        # float32 ranking keys, as `cvt_tpu` ranks them
        keys, j = top_k_smallest(packs.float().T[:b], kk)
        tile = torch.where(j < n_tiles, j, j - n_tiles)
        ids = tile * tile_n + torch.gather(rows.T[:b], -1, j)
        d = (keys / seg) * qs + q_sq[:, None]
    ids = ids.to(torch.int32)
    if kk < k:
        d = torch.nn.functional.pad(d, (0, k - kk), value=_BIG)
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=2 ** 30)
    return d, ids


def _place_quantizer(quantizer, device: torch.device):
    """(ProductQuantizer, rotation or None) of a PQ or an OPQ, on
    `device`."""
    if isinstance(quantizer, OPQ):
        quantizer = OPQ(quantizer.rotation, quantizer.pq, device=device)
        return quantizer.pq, quantizer.rotation
    if isinstance(quantizer, ProductQuantizer):
        return ProductQuantizer(quantizer.codebooks, device), None
    raise TypeError(type(quantizer))


def _rotate(x, rotation, device: torch.device) -> torch.Tensor:
    """Raw float queries or vectors -> the quantizer's (rotated) space."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x if rotation is None else x @ rotation


def _segment_plan(per: int, tile_n: int, seg: int, k: int):
    """(tile_n, seg) of a shard of `per` rows: the tile at most the shard,
    the segment halved (down to 8) while the shard holds fewer than k."""
    tile_n = min(tile_n, per)
    seg = min(seg, tile_n)
    while per // seg < k and seg > 8:
        seg //= 2
    return tile_n, seg


def _gather_merge(d, i, group, k: int):
    """all_gather every rank's [B, k] candidates over `group`, stacked in
    group-rank order into [B, S*k], then one stable top-k."""
    s = dist.get_world_size(group)
    ds = [torch.empty_like(d) for _ in range(s)]
    is_ = [torch.empty_like(i) for _ in range(s)]
    dist.all_gather(ds, d.contiguous(), group=group)
    dist.all_gather(is_, i.contiguous(), group=group)
    b = d.shape[0]
    return merge_topk(torch.stack(ds, 1).reshape(b, -1),
                      torch.stack(is_, 1).reshape(b, -1), k)


def _local_scan(q, q_sq, codes, dec_sq, codebooks, *, k: int, chunk: int,
                n_local: int, group):
    """Per-shard body: local ADC scan + id globalization + gather-merge."""
    d, i = _adc_scan(q, q_sq, codes, dec_sq, codebooks, k, chunk, n_local)
    i = i + dist.get_rank(group) * n_local
    return _gather_merge(d, i, group, k)


def sharded_search_2d(mesh: DeviceMesh, q, codes, dec_sq, codebooks, k: int,
                      *, dp_axis: str = "dp", db_axis: str = "db",
                      chunk: int = 2048):
    """2D-parallel ADC search step over a ('dp', 'db') mesh.

    Every argument is THIS rank's piece, as the JAX function's shard_map
    body sees it: q [B/dp, D] its 'dp' slice of the batch, codes
    [n_local, M] and dec_sq [n_local] its 'db' shard (n_local a multiple
    of min(chunk, n_local)), codebooks whole. Candidates merge over
    'db' only; the result is this rank's 'dp' slice of (dists, ids)."""
    del dp_axis                          # the 'dp' split is the caller's
    n_local = codes.shape[0]
    q_sq = torch.sum(q * q, dim=-1)
    return _local_scan(q, q_sq, codes, dec_sq, codebooks, k=k,
                       chunk=min(chunk, n_local), n_local=n_local,
                       group=mesh.get_group(db_axis))


class ShardedADCSearcher:
    """Flat ADC scan sharded over a mesh's 'db' axis.

    Every rank builds one with the same arguments and calls load() and
    search() with the same data; each keeps only its shard, and search()
    returns the merged results on every rank.

    impl: 'kernel' runs the packed `adc_segmin` kernel in every shard (its
    plain twin for a CPU mesh); 'scan' the chunked reference engine;
    'auto' the kernel on a CUDA mesh and the scan on a CPU one.
    """

    def __init__(self, quantizer, mesh: DeviceMesh, *, axis: str = "db",
                 chunk: int = 16384, impl: str = "auto",
                 tile_n: int = 1024, seg: int = 128):
        if impl not in ("auto", "scan", "kernel"):
            raise ValueError(impl)
        self.device = mesh_device(mesh)
        self.pq, self.rotation = _place_quantizer(quantizer, self.device)
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.get_group(axis)
        self.shard = mesh.get_local_rank(axis)
        self.chunk = chunk
        self.tile_n = tile_n
        self.seg = seg
        self.impl = impl
        self._codes_l = None
        self._n = 0

    def _resolve_impl(self) -> str:
        if self.impl != "auto":
            return self.impl
        return "kernel" if self.device.type == "cuda" else "scan"

    @property
    def n_shards(self) -> int:
        return axis_size(self.mesh, self.axis)

    def _rotate(self, x) -> torch.Tensor:
        return _rotate(x, self.rotation, self.device)

    def load(self, x=None, *, codes=None) -> None:
        """Encode (if raw floats) and keep this rank's shard of the codes,
        zero-padded so that every shard holds `per` rows."""
        if codes is None:
            codes = self.pq.encode(self._rotate(x))
        codes = torch.as_tensor(codes, device=self.device).to(torch.uint8)
        n = codes.shape[0]
        per = -(-n // self.n_shards)
        align = self.chunk
        if self._resolve_impl() == "kernel":
            align = max(align, self.tile_n, self.seg)
        per = -(-per // align) * align            # align each shard
        start = self.shard * per
        local = codes[start:start + per]
        local = torch.nn.functional.pad(local, (0, 0, 0, per - local.shape[0]))
        self._codes_l = local.contiguous()
        if self._resolve_impl() == "kernel":
            self._cb_q, self._srow = _quantize_codebooks(self.pq.codebooks)
        else:
            cbn = self.pq.codeword_sqnorms()
            sub = torch.arange(self.pq.m, device=self.device)[None, :]
            dsq = torch.sum(cbn[sub, local.long()], dim=1)
            # padding rows carry an effectively-infinite norm so they can
            # never win a top-k slot on any shard
            rows = start + torch.arange(per, device=self.device)
            self._dec_sq = torch.where(rows < n, dsq, _BIG)
        self._n = n
        self._per_shard = per

    def search(self, q, k: int):
        """q [B, D] raw space -> (dists [B, k], global ids [B, k]), the
        same on every rank. ids past n (padding) become -1."""
        if self._codes_l is None:
            raise RuntimeError("load() first")
        qr = self._rotate(q)
        per, n = self._per_shard, self._n
        if self._resolve_impl() == "kernel":
            tile_n, seg = _segment_plan(per, self.tile_n, self.seg, k)
            start = self.shard * per
            d, i = _local_pallas_topk(qr, self._codes_l, self._cb_q,
                                      self._srow, k,
                                      min(max(n - start, 0), per), tile_n,
                                      seg)
            d, i = _gather_merge(d, i + start, self.group, k)
        else:
            d, i = _local_scan(qr, torch.sum(qr * qr, dim=-1), self._codes_l,
                               self._dec_sq, self.pq.codebooks, k=k,
                               chunk=min(self.chunk, per), n_local=per,
                               group=self.group)
        return d, torch.where(i < n, i, -1)
