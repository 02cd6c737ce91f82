"""Product quantizer: train / encode / decode / ADC LUTs.

Counterpart of `cvt_tpu.quant.pq`. The M subspace k-means runs, which
`cvt_tpu` writes as `jax.vmap` over the subspace axis, are one batched
Lloyd over an explicit leading M dimension here.
"""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.ops.kmeans import _init_random, _lloyd, kmeans_assign


class ProductQuantizer:
    """PQ with M subspaces x K codewords (K <= 256, codes stored uint8)."""

    def __init__(self, codebooks, device=None):
        """codebooks [M, K, ds] float32 (array or tensor); `device`
        defaults to the codebooks' own (the CPU for numpy)."""
        self.codebooks = torch.as_tensor(codebooks, dtype=torch.float32,
                                         device=device)

    @property
    def device(self) -> torch.device:
        return self.codebooks.device

    @property
    def m(self) -> int:
        return self.codebooks.shape[0]

    @property
    def k(self) -> int:
        return self.codebooks.shape[1]

    @property
    def ds(self) -> int:
        return self.codebooks.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.ds

    # ---------------------------------------------------------------- train
    @classmethod
    def train(cls, gen: torch.Generator, x, m: int, k: int = 256, *,
              iters: int = 25, init_codebooks=None,
              device=None) -> "ProductQuantizer":
        """Train M independent k-means codebooks on x [N, D], D = m*ds.

        `gen` is a CPU `torch.Generator` for the random init;
        `init_codebooks` [M, K, ds] warm-starts Lloyd instead (OPQ's
        alternating optimization)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        n, d = x.shape
        if d % m:
            raise ValueError(f"dim {d} not divisible by m={m}")
        xs = x.reshape(n, m, d // m).permute(1, 0, 2).contiguous()  # [M,N,ds]
        if init_codebooks is None:
            c0 = torch.stack([_init_random(gen, xs[mm], k)
                              for mm in range(m)])
        else:
            c0 = torch.as_tensor(init_codebooks, dtype=torch.float32,
                                 device=x.device)
        c, _, _ = _lloyd(xs, c0, k, iters, None)
        return cls(c)

    # --------------------------------------------------------------- encode
    def encode(self, x) -> torch.Tensor:
        """x [N, D] -> codes [N, M] uint8 (nearest codeword per subspace)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        n = x.shape[0]
        xs = x.reshape(n, self.m, self.ds).permute(1, 0, 2)     # [M, N, ds]
        assign, _ = kmeans_assign(xs, self.codebooks)           # [M, N]
        return assign.T.to(torch.uint8)

    def decode(self, codes) -> torch.Tensor:
        """codes [N, M] uint8 -> reconstruction [N, D]."""
        codes = torch.as_tensor(codes, device=self.device).long()
        sub = torch.arange(self.m, device=self.device)[None, :]
        return self.codebooks[sub, codes].reshape(codes.shape[0], self.dim)

    # ------------------------------------------------------------------ ADC
    def lut(self, q, metric: str = "l2") -> torch.Tensor:
        """Per-query ADC tables. q [B, D] -> [B, M, K].

        l2: ||q_m - cb[m,k]||^2 ; ip: -<q_m, cb[m,k]> (smaller = closer)."""
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        qs = q.reshape(q.shape[0], self.m, self.ds)             # [B, M, ds]
        ip = torch.einsum("bms,mks->bmk", qs, self.codebooks)
        if metric == "ip":
            return -ip
        q_sq = torch.sum(qs * qs, dim=-1)                       # [B, M]
        return q_sq[:, :, None] - 2.0 * ip + self.codeword_sqnorms()[None]

    def adc_scores(self, lut: torch.Tensor, codes) -> torch.Tensor:
        """Sum LUT entries for given codes. lut [B, M, K], codes [C, M]
        -> [B, C]."""
        codes = torch.as_tensor(codes, device=lut.device).long()
        idx = codes.T[None, :, :].expand(lut.shape[0], -1, -1)  # [B, M, C]
        return torch.sum(torch.gather(lut, 2, idx), dim=1)

    def codeword_sqnorms(self) -> torch.Tensor:
        """[M, K] squared norms of codewords (for ||decode||^2 terms)."""
        return torch.sum(self.codebooks * self.codebooks, dim=-1)

    def reconstruction_mse(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        rec = self.decode(self.encode(x))
        return torch.mean(torch.sum((x - rec) ** 2, dim=-1))

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(path, codebooks=self.codebooks.cpu().numpy())

    @classmethod
    def load(cls, path: str, device=None) -> "ProductQuantizer":
        z = np.load(path, allow_pickle=False)
        return cls(z["codebooks"], device=device)
