"""PCA dimensionality reduction (train + project).

Counterpart of `cvt_tpu.quant.pca` (OpenCV `cv::PCA` training of
pca_train_project/, projection + L2 norm of its Python path): covariance
as one [D, N] x [N, D] product, `torch.linalg.eigh` for the eigenbasis,
projection as one product, optional whitening. Eigenvector signs are
arbitrary, so two trainings agree per component only up to sign.
"""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.ops.linalg import l2_normalize
from cvt_tpu_torch.utils.device import resolve_device


class PCA:
    def __init__(self, mean, components, eigenvalues, whiten: bool = False,
                 device=None):
        """mean [D]; components [out_dim, D], rows the top eigenvectors;
        eigenvalues [out_dim]. `device` defaults to mean's own for a
        tensor, else the card (`resolve_device`)."""
        self.mean = torch.as_tensor(mean, dtype=torch.float32,
                                    device=resolve_device(device, like=mean))
        dev = self.mean.device
        self.components = torch.as_tensor(components, dtype=torch.float32,
                                          device=dev)
        self.eigenvalues = torch.as_tensor(eigenvalues, dtype=torch.float32,
                                           device=dev)
        self.whiten = whiten

    @property
    def device(self) -> torch.device:
        return self.mean.device

    @property
    def in_dim(self) -> int:
        return self.components.shape[1]

    @property
    def out_dim(self) -> int:
        return self.components.shape[0]

    @classmethod
    def train(cls, x, out_dim: int, *, whiten: bool = False,
              device=None) -> "PCA":
        """Fit on x [N, D], keeping the top `out_dim` principal axes
        (descending eigenvalues, ties in eigh's order)."""
        x = torch.as_tensor(x, dtype=torch.float32,
                            device=resolve_device(device, like=x))
        mean = torch.mean(x, dim=0)
        xc = x - mean[None, :]
        cov = (xc.T @ xc) / max(x.shape[0] - 1, 1)
        evals, evecs = torch.linalg.eigh(cov)                    # ascending
        order = torch.argsort(-evals, stable=True)[:out_dim]
        return cls(mean, evecs[:, order].T,
                   torch.clamp_min(evals[order], 0.0), whiten)

    def _as(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.mean.device)

    def project(self, x, *, l2norm: bool = False) -> torch.Tensor:
        """x [..., D] -> [..., out_dim]; l2norm is the reference's
        post-projection normalization."""
        y = (self._as(x) - self.mean) @ self.components.T
        if self.whiten:
            y = y * torch.rsqrt(self.eigenvalues + 1e-12)
        return l2_normalize(y) if l2norm else y

    def reconstruct(self, y) -> torch.Tensor:
        """Back-project [..., out_dim] -> [..., D]."""
        y = self._as(y)
        if self.whiten:
            y = y * torch.sqrt(self.eigenvalues + 1e-12)
        return y @ self.components + self.mean

    # -- persistence (the .npz layout of cvt_tpu) --------------------------
    def save(self, path: str) -> None:
        np.savez(path, mean=self.mean.cpu().numpy(),
                 components=self.components.cpu().numpy(),
                 eigenvalues=self.eigenvalues.cpu().numpy(),
                 whiten=self.whiten)

    @classmethod
    def load(cls, path: str, device=None) -> "PCA":
        z = np.load(path, allow_pickle=False)
        return cls(z["mean"], z["components"], z["eigenvalues"],
                   bool(z["whiten"]), device=device)
