"""Optimized Product Quantization: learned rotation + PQ codebooks.

Counterpart of `cvt_tpu.quant.opq` (Ge et al., CVPR'13). Alternate

    1. Y = X @ R                 (rotate)
    2. fit PQ codebooks on Y     (warm-started Lloyd, batched over M)
    3. Yhat = decode(encode(Y))
    4. R <- Procrustes: U, _, Vt = svd(X^T Yhat); R = U @ Vt
"""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.quant.pq import ProductQuantizer


def _procrustes(x: torch.Tensor, yhat: torch.Tensor) -> torch.Tensor:
    """argmin_R ||x @ R - yhat||_F over orthogonal R: R = U @ Vt of
    X^T Yhat (unique when X^T Yhat has full rank)."""
    u, _, vt = torch.linalg.svd(x.T @ yhat, full_matrices=False)
    return u @ vt


class OPQ:
    """Rotation R [D, D] + product quantizer over the rotated space."""

    def __init__(self, rotation, pq: ProductQuantizer, device=None):
        """`device` defaults to the quantizer's."""
        device = pq.device if device is None else torch.device(device)
        self.rotation = torch.as_tensor(rotation, dtype=torch.float32,
                                        device=device)
        self.pq = (pq if pq.device == device
                   else ProductQuantizer(pq.codebooks, device=device))

    @property
    def device(self) -> torch.device:
        return self.rotation.device

    @property
    def dim(self) -> int:
        return self.rotation.shape[0]

    @classmethod
    def train(cls, gen: torch.Generator, x, m: int, k: int = 256, *,
              opq_iters: int = 10, kmeans_iters: int = 10,
              final_kmeans_iters: int = 25, init: str = "random",
              device=None) -> "OPQ":
        """Alternating OPQ training on x [N, D].

        gen: a CPU `torch.Generator` (random rotation, then the PQ init).
        init: 'random' (QR of a Gaussian — a random rotation) or
        'identity' (plain PQ as the starting point)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        d = x.shape[1]
        if init == "random":
            g = torch.randn((d, d), generator=gen).to(x.device)
            r, _ = torch.linalg.qr(g)
        elif init == "identity":
            r = torch.eye(d, device=x.device)
        else:
            raise ValueError(f"unknown init {init!r}")

        pq = None
        for _ in range(opq_iters):
            y = x @ r
            pq = ProductQuantizer.train(
                gen, y, m, k, iters=kmeans_iters,
                init_codebooks=None if pq is None else pq.codebooks)
            yhat = pq.decode(pq.encode(y))
            r = _procrustes(x, yhat)
        # final refinement of the codebooks at the converged rotation
        y = x @ r
        pq = ProductQuantizer.train(
            gen, y, m, k, iters=final_kmeans_iters,
            init_codebooks=pq.codebooks if pq is not None else None)
        return cls(r, pq)

    def rotate(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32,
                               device=self.device) @ self.rotation

    def encode(self, x) -> torch.Tensor:
        """x [N, D] raw space -> codes [N, M] uint8."""
        return self.pq.encode(self.rotate(x))

    def decode(self, codes) -> torch.Tensor:
        """codes -> reconstruction in the ORIGINAL space (R is orthogonal,
        so decode(c) @ R^T inverts the rotation)."""
        return self.pq.decode(codes) @ self.rotation.T

    def lut(self, q, metric: str = "l2") -> torch.Tensor:
        """ADC tables for raw-space queries (rotation folded into q)."""
        return self.pq.lut(self.rotate(q), metric)

    def reconstruction_mse(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        rec = self.decode(self.encode(x))
        return torch.mean(torch.sum((x - rec) ** 2, dim=-1))

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(path, rotation=self.rotation.cpu().numpy(),
                 codebooks=self.pq.codebooks.cpu().numpy())

    @classmethod
    def load(cls, path: str, device=None) -> "OPQ":
        z = np.load(path, allow_pickle=False)
        return cls(z["rotation"], ProductQuantizer(z["codebooks"],
                                                   device=device))
