"""Flat int8-SQ index: asymmetric distance scan over uint8 codes.

Counterpart of `cvt_tpu.index.flat_sq` (BASELINE config 1: int8 SQ
encode + brute-force L2 top-10). The decode is folded into the scan:

    decode(c) = bias + scale * c
    ||q - decode(c)||^2 = ||r||^2 - 2 <r*scale, c> + ||scale*c||^2
        with r = q - bias,

term3 = ||scale*c||^2 stored per row at add() time. `search` scans in
chunks with a stable top-k per chunk:
  'bf16': the query rounded to bf16 against the codes (exact in bf16),
          products summed in float32: a float32 product of the rounded
          operands, so no bf16 reduction is involved, and both operands
          (8 significant bits each) are exact in TF32 as well;
  'int8': the query rounded to int8 with one scale per query; the int32
          dot product is taken as a float32 product of the int-valued
          operands, exact while |ip| <= 127*128*D < 2^24 (D <= 1024).
`search_fast` is the production path: SQ's affine decode maps exactly onto
the flat ADC decoded-cache kernel (`adc_search_cached`).
"""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.ops.kernels.adc_scan import adc_search_cached
from cvt_tpu_torch.ops.topk import merge_topk, top_k_smallest
from cvt_tpu_torch.quant.sq import ScalarQuantizer


def _quantize_query(r_scaled):
    """[B, D] -> (gamma [B, 1], tq [B, D] int8): one symmetric scale per
    query, rounded half to even as `jnp.round`."""
    gamma = torch.amax(torch.abs(r_scaled), dim=-1, keepdim=True) / 127.0
    gamma = torch.clamp_min(gamma, 1e-30)
    return gamma, torch.round(r_scaled / gamma).to(torch.int8)


def _sq_scan(r_scaled, r_sq, codes_s8, term3, k: int, mode: str, chunk: int,
             n_valid: int):
    """r_scaled = (q - bias) * scale [B, D]; r_sq = ||q - bias||^2 [B];
    codes_s8 [Npad, D] int8 (= code - 128); term3 [Npad] f32; Npad a
    multiple of `chunk`. Returns (dists [B, k], ids [B, k] int32)."""
    b, d = r_scaled.shape
    if mode == "int8":
        if d > 1024:
            raise ValueError(f"D={d} breaks the exact float32 int8 product")
        gamma, tq = _quantize_query(r_scaled)                    # [B, D]
        tq_sum = torch.sum(tq.to(torch.int32), dim=-1)           # [B]
        lhs = tq.float().T                                       # [D, B]
    else:
        lhs = r_scaled.to(torch.bfloat16).float().T
    # the products are copied to [B, chunk] rows: the selection below reads
    # rows, and a strided row costs it ~1.8x (the top-k sweep, CHANGES.md)
    best_d = torch.full((b, k), float("inf"), device=r_sq.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=r_sq.device)
    for base in range(0, codes_s8.shape[0], chunk):
        c = codes_s8[base:base + chunk]
        if mode == "int8":
            ipq = (c.float() @ lhs).T.contiguous()               # [B, chunk]
            # <r_scaled, c> = gamma * (<tq, c-128> + 128 * sum(tq))
            ip = gamma * (ipq + 128.0 * tq_sum[:, None].float())
        else:
            ip = ((c.to(torch.int32) + 128).float() @ lhs).T.contiguous()
        dist = r_sq[:, None] - 2.0 * ip + term3[None, base:base + chunk]
        ids = torch.arange(base, base + chunk, device=r_sq.device,
                           dtype=torch.int32)
        dist = torch.where(ids[None, :] < n_valid, dist, float("inf"))
        v, j = top_k_smallest(dist, min(k, chunk))
        best_d, best_i = merge_topk(torch.cat([best_d, v], -1),
                                    torch.cat([best_i, ids[j]], -1), k)
    return best_d, best_i


class FlatSQIndex:
    """Exact-rank L2 search over int8-SQ compressed vectors."""

    def __init__(self, sq: ScalarQuantizer, mode: str = "bf16",
                 chunk: int = 65536, device=None):
        """`device` defaults to the quantizer's."""
        if mode not in ("bf16", "int8"):
            raise ValueError(f"unknown mode {mode!r}")
        self.sq = (sq if device is None
                   else ScalarQuantizer(sq.vmin, sq.vdiff, sq.rounding,
                                        device=device))
        self.device = self.sq.device
        self.mode = mode
        self.chunk = chunk
        self._codes_s8: torch.Tensor | None = None   # [N, D] int8 (code-128)
        self._term3: torch.Tensor | None = None      # [N] f32 ||scale*c||^2
        self._dec8_n: int | None = None              # rows in search_fast cache

    @property
    def ntotal(self) -> int:
        return 0 if self._codes_s8 is None else self._codes_s8.shape[0]

    @property
    def dim(self) -> int:
        return self.sq.dim

    def add(self, x=None, *, codes=None) -> None:
        """Add float vectors (encoded here) or precomputed uint8 codes."""
        if codes is None:
            codes = self.sq.encode(x)
        codes = torch.as_tensor(codes, device=self.device).to(torch.uint8)
        s8 = (codes.to(torch.int16) - 128).to(torch.int8)
        dec = self.sq.scale[None, :] * codes.float()
        t3 = torch.sum(dec * dec, dim=-1)
        if self._codes_s8 is None:
            self._codes_s8, self._term3 = s8, t3
        else:
            self._codes_s8 = torch.cat([self._codes_s8, s8], 0)
            self._term3 = torch.cat([self._term3, t3], 0)

    def search(self, q, k: int):
        """q [B, D] float (raw; bias/scale handled here) -> (dists, ids)."""
        if self._codes_s8 is None:
            raise RuntimeError("empty index")
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        r = q - self.sq.bias[None, :]
        r_scaled = r * self.sq.scale[None, :]
        r_sq = torch.sum(r * r, dim=-1)
        n = self.ntotal
        chunk = min(self.chunk, n)
        npad = -(-n // chunk) * chunk
        codes = torch.nn.functional.pad(self._codes_s8, (0, 0, 0, npad - n))
        t3 = torch.nn.functional.pad(self._term3, (0, npad - n))
        return _sq_scan(r_scaled, r_sq, codes, t3, min(k, n), self.mode,
                        chunk, n)

    def _build_cache(self) -> None:
        """The decoded cache of search_fast: int8 codes - 128 with code 0
        clipped to -127 (the packed kernel's margins assume |values| <=
        127, a one-step error on the rare per-dim minimum only), padded to
        the 1,024-row tile and transposed on the device, plus the
        quantized-space row norms."""
        n = self.ntotal
        npad = -(-n // 1024) * 1024
        s8 = torch.clamp_min(self._codes_s8, -127)
        f = self.sq.scale[None, :] * s8.float()
        nrm = torch.sum(f * f, dim=-1)
        self._dec8_t = torch.nn.functional.pad(
            s8, (0, 0, 0, npad - n)).T.contiguous()              # [D, Npad]
        self._norm_col = torch.nn.functional.pad(nrm, (0, npad - n))[:, None]
        self._dec8_n = n

    def search_fast(self, q, k: int):
        """The decoded-cache kernel over the SQ codes: dist(q, x) =
        ||(q - b) - scale*c'||^2 with c' = code - 128 and b = bias +
        128*scale folded into the query. ids >= n (padding) become -1.
        The cache is rebuilt when rows were added since it was built."""
        if self._codes_s8 is None:
            raise RuntimeError("empty index")
        n = self.ntotal
        if self._dec8_n != n:
            self._build_cache()
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        b_vec = self.sq.bias + 128.0 * self.sq.scale           # decode offset
        d, i = adc_search_cached(q - b_vec[None, :], self._dec8_t,
                                 self._norm_col, self.sq.scale, min(k, n), n)
        return d, torch.where(i < n, i, -1)

    # -- persistence (the .npz layout of cvt_tpu: same keys and dtypes) --
    def save(self, path: str) -> None:
        np.savez(path, codes_s8=self._codes_s8.cpu().numpy(),
                 term3=self._term3.cpu().numpy(),
                 vmin=self.sq.vmin.cpu().numpy(),
                 vdiff=self.sq.vdiff.cpu().numpy(),
                 rounding=self.sq.rounding, mode=self.mode)

    @classmethod
    def load(cls, path: str, device=None) -> "FlatSQIndex":
        z = np.load(path, allow_pickle=False)
        sq = ScalarQuantizer(z["vmin"], z["vdiff"], str(z["rounding"]),
                             device=device)
        idx = cls(sq, mode=str(z["mode"]))
        idx._codes_s8 = torch.as_tensor(z["codes_s8"], device=idx.device)
        idx._term3 = torch.as_tensor(z["term3"], device=idx.device)
        return idx
