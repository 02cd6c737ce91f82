"""Flat ADC index: asymmetric-distance scan over PQ/OPQ codes.

Counterpart of `cvt_tpu.index.flat_adc`. Scoring (L2): for code row c
with PQ decode d(c) = concat_m CB[m, c_m],

    ||q - d(c)||^2 = ||q||^2 - 2 <q, d(c)> + ||d(c)||^2

with ||d(c)||^2 precomputed per row at add() time.

The engine is chosen by `impl`:
  * "scan": the chunked reference engine `_adc_scan` (bf16 decode, f32
    accumulation), `cvt_tpu`'s "xla" engine;
  * "kernel": the two-phase packed scan of `ops.kernels.adc_scan`
    (`cvt_tpu`'s "pallas"), whose phase 1 is a hand-written CUDA kernel
    for an index on the card and its plain twin for one on the CPU;
  * "auto": "kernel" on CUDA, "scan" on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.ops.kernels.adc_scan import (_quantize_codebooks,
                                                _row_norms, adc_search,
                                                adc_search_cached,
                                                decode_int8)
from cvt_tpu_torch.ops.topk import merge_topk, top_k_smallest
from cvt_tpu_torch.quant.opq import OPQ
from cvt_tpu_torch.quant.pq import ProductQuantizer
from cvt_tpu_torch.utils.profile import span

_PAD = 16384    # kernel arrays are padded to a multiple of the largest tile


def _decode_chunk_bf16(codes: torch.Tensor,
                       codebooks: torch.Tensor) -> torch.Tensor:
    """codes [T, M] -> [T, D] bf16. A gather of bf16-rounded codewords
    equals `cvt_tpu`'s one-hot bf16 product (one non-zero term)."""
    m = codebooks.shape[0]
    sub = torch.arange(m, device=codes.device)[None, :]
    dec = codebooks.to(torch.bfloat16)[sub, codes.long()]        # [T, M, ds]
    return dec.reshape(codes.shape[0], -1)


def _adc_scan(q, q_sq, codes, dec_sq, codebooks, k: int, chunk: int,
              n_valid: int):
    """The chunked reference engine. q [B, D] (already rotated), codes
    [Npad, M] u8, dec_sq [Npad] f32; Npad a multiple of `chunk`.

    bf16 operands, f32 accumulation: a float32 product of bf16-rounded
    operands is exact per term, so it equals bf16 products summed in f32."""
    b = q.shape[0]
    qT = q.to(torch.bfloat16).float().T                          # [D, B]
    best_d = torch.full((b, k), float("inf"), device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    for base in range(0, codes.shape[0], chunk):
        dec = _decode_chunk_bf16(codes[base:base + chunk], codebooks)
        ip = dec.float() @ qT                                    # [T, B]
        dist = (q_sq[None, :] - 2.0 * ip
                + dec_sq[base:base + chunk, None]).T             # [B, T]
        ids = torch.arange(base, base + chunk, device=q.device,
                           dtype=torch.int32)
        dist = torch.where(ids[None, :] < n_valid, dist, float("inf"))
        v, j = top_k_smallest(dist, min(k, chunk))
        best_d, best_i = merge_topk(torch.cat([best_d, v], -1),
                                    torch.cat([best_i, ids[j]], -1), k)
    return best_d, best_i


def _encode_chunk(x, rotation, codebooks):
    """rotate -> nearest-codeword assign -> decode sqnorm.
    Returns (codes [T, M] u8, dec_sq [T] f32).

    Full float32 throughout: reduced precision (TF32) flips near-tie
    cells and makes add() disagree with pq.encode on the same data."""
    if rotation is not None:
        x = x @ rotation
    m, k, ds = codebooks.shape
    t = x.shape[0]
    ip = torch.einsum("tms,mks->tmk", x.reshape(t, m, ds), codebooks)
    c_sq = torch.sum(codebooks * codebooks, dim=-1)              # [M, K]
    codes = torch.argmin(c_sq[None] - 2.0 * ip, dim=-1)          # [T, M]
    sub = torch.arange(m, device=x.device)[None, :]
    dsq = torch.sum(c_sq[sub, codes], dim=1)
    return codes.to(torch.uint8), dsq


class FlatADCIndex:
    """Flat scan over PQ/OPQ codes with asymmetric (query-float) distances."""

    ENC_CHUNK = 131_072          # rows encoded per step (bounds memory)

    def __init__(self, quantizer, chunk: int = 16384, impl: str = "auto",
                 device=None):
        """quantizer: ProductQuantizer or OPQ. impl: 'scan' | 'kernel' |
        'auto' ('kernel' on CUDA, 'scan' on the CPU). device defaults to
        the quantizer's."""
        if impl not in ("scan", "kernel", "auto"):
            raise ValueError(f"unknown impl {impl!r}")
        if isinstance(quantizer, OPQ):
            quantizer = OPQ(quantizer.rotation, quantizer.pq, device=device)
            self.pq = quantizer.pq
            self.rotation = quantizer.rotation
        elif isinstance(quantizer, ProductQuantizer):
            self.pq = (quantizer if device is None
                       else ProductQuantizer(quantizer.codebooks, device))
            self.rotation = None
        else:
            raise TypeError(type(quantizer))
        self.device = self.pq.device
        self.chunk = chunk
        self.impl = impl
        self._codes: torch.Tensor | None = None      # [N, M] u8 (rotated)
        self._dec_sq: torch.Tensor | None = None     # [N] f32
        self._pending: list = []                     # unmaterialized adds
        self._pending_n = 0
        self._kernel_n: int | None = None            # rows in _kernel_arrays
        self._dec8_n: int | None = None              # rows in decoded cache

    @property
    def ntotal(self) -> int:
        base = 0 if self._codes is None else self._codes.shape[0]
        return base + self._pending_n

    @property
    def dim(self) -> int:
        return self.pq.dim

    def _materialize(self) -> None:
        """Concatenate pending chunks once (amortized O(N), vs the O(N^2)
        of concatenating inside every add)."""
        if not self._pending:
            return
        cs = [c for c, _ in self._pending]
        ds = [d for _, d in self._pending]
        if self._codes is not None:
            cs.insert(0, self._codes)
            ds.insert(0, self._dec_sq)
        self._codes = torch.cat(cs, 0)
        self._dec_sq = torch.cat(ds, 0)
        self._pending, self._pending_n = [], 0

    def _rotate(self, x) -> torch.Tensor:
        with span("flat.stage_in"):
            x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return x if self.rotation is None else x @ self.rotation

    def add(self, x=None, *, codes=None) -> None:
        """Add raw float vectors (rotated+encoded here, ENC_CHUNK rows at a
        time, host arrays moved to the device chunk by chunk) or
        precomputed codes (already in rotated space). Chunks are
        concatenated lazily, on first search."""
        if codes is None:
            n = x.shape[0]
            for s in range(0, n, self.ENC_CHUNK):
                chunk = torch.as_tensor(x[s:s + self.ENC_CHUNK],
                                        dtype=torch.float32,
                                        device=self.device)
                self._pending.append(_encode_chunk(chunk, self.rotation,
                                                   self.pq.codebooks))
                self._pending_n += chunk.shape[0]
        else:
            codes = torch.as_tensor(codes, device=self.device)
            codes = codes.to(torch.uint8)
            cbn = self.pq.codeword_sqnorms()                     # [M, K]
            sub = torch.arange(self.pq.m, device=self.device)[None, :]
            self._pending.append((codes, torch.sum(cbn[sub, codes.long()],
                                                   dim=1)))
            self._pending_n += codes.shape[0]

    def _resolve_impl(self) -> str:
        if self.impl != "auto":
            return self.impl
        return "kernel" if self.device.type == "cuda" else "scan"

    def search(self, q, k: int, *, exact: bool = False):
        """q [B, D] raw-space float -> (dists [B, k], ids [B, k] int32).

        exact=True (kernel engine) re-scores the winning segments in f32,
        giving exact top-k w.r.t. full-precision ADC; the default fast
        path scores with the int8-decode kernel only (top-1 exact by the
        segment lemma up to int8 quantization of the codebooks). After
        build_decoded_cache(), the fast path scans the cache instead.

        Traced, the call is one `flat.search` span holding `flat.stage_in`
        (the queries to the index's device), `flat.prep` (rotation and
        norms), then the kernel search's `adc.prep` (the query fold), its
        kernel's span and `adc.select` (ops/kernels/adc_scan.py)."""
        with span("flat.search"):
            self._materialize()
            if self._codes is None:
                raise RuntimeError("empty index")
            with span("flat.prep"):
                qr = self._rotate(q)
                q_sq = torch.sum(qr * qr, dim=-1)
            n = self.ntotal
            if self._resolve_impl() == "kernel" and k <= 128:
                if not exact and self._dec8_n == n:
                    return adc_search_cached(qr, self._dec8_t,
                                             self._norm_col,
                                             self._srow_cache, min(k, n), n)
                codes, dec_sq, cb_q, srow = self._kernel_arrays()
                return adc_search(qr, q_sq, codes, dec_sq, self.pq.codebooks,
                                  min(k, n), n, cb_q=cb_q, srow=srow,
                                  exact=exact)
            chunk = min(self.chunk, n)
            codes, dsq = self._padded(-(-n // chunk) * chunk)
            return _adc_scan(qr, q_sq, codes, dsq, self.pq.codebooks,
                             min(k, n), chunk, n)

    def _padded(self, npad: int):
        """(codes, dec_sq) zero-padded to npad rows."""
        extra = npad - self._codes.shape[0]
        return (torch.nn.functional.pad(self._codes, (0, 0, 0, extra)),
                torch.nn.functional.pad(self._dec_sq, (0, extra)))

    def build_decoded_cache(self) -> None:
        """Materialize the int8-DECODED transposed database [D, Npad]
        plus quantized-space row norms for the decode-free scan
        (adc_search_cached). A memory/speed trade: 16x the code bytes
        (int8 D per row vs M u8 codes). The codes stay the index ground
        truth (the cache IS the kernel's decode output, precomputed);
        rebuild after add()s."""
        self._materialize()
        if self._codes is None:
            raise RuntimeError("empty index")
        cb_q, srow = _quantize_codebooks(self.pq.codebooks)
        n = self._codes.shape[0]
        npad = -(-n // _PAD) * _PAD
        dec = decode_int8(self._codes, cb_q)                     # [N, D]
        # summed exactly as the decode kernel sums it in-kernel, so the
        # cached scan gives the fast path's keys bit for bit
        norm = _row_norms(dec, srow * srow)
        self._dec8_t = torch.nn.functional.pad(
            dec, (0, 0, 0, npad - n)).T.contiguous()             # [D, Npad]
        self._norm_col = torch.nn.functional.pad(norm, (0, npad - n))[:, None]
        self._srow_cache = srow
        self._dec8_n = n

    def _kernel_arrays(self):
        """Codes and norms padded to a multiple of the largest tile, plus
        the int8 codebooks, laid out once for the kernel."""
        n = self.ntotal
        if self._kernel_n != n:
            self._kernel_codes, self._kernel_dsq = self._padded(
                -(-n // _PAD) * _PAD)
            self._cb_q, self._srow = _quantize_codebooks(self.pq.codebooks)
            self._kernel_n = n
        return self._kernel_codes, self._kernel_dsq, self._cb_q, self._srow

    # -- persistence (the .npz layout of cvt_tpu: same keys and dtypes) --
    def save(self, path: str) -> None:
        self._materialize()
        np.savez(path, codes=self._codes.cpu().numpy(),
                 dec_sq=self._dec_sq.cpu().numpy(),
                 codebooks=self.pq.codebooks.cpu().numpy(),
                 rotation=(self.rotation.cpu().numpy()
                           if self.rotation is not None else np.zeros(0)))

    @classmethod
    def load(cls, path: str, device=None) -> "FlatADCIndex":
        z = np.load(path, allow_pickle=False)
        pq = ProductQuantizer(z["codebooks"], device=device)
        rot = z["rotation"]
        quant = OPQ(rot, pq) if rot.size else pq
        idx = cls(quant)
        idx._codes = torch.as_tensor(z["codes"], device=pq.device)
        idx._dec_sq = torch.as_tensor(z["dec_sq"], device=pq.device)
        return idx
