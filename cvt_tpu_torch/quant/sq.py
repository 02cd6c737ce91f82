"""int8 scalar quantizer with cvt/faiss-compatible semantics.

Counterpart of `cvt_tpu.quant.sq` (faiss `IndexScalarQuantizer(d,
QT_8bit)` training and the codec of scalar_quantization/int8_quan.cc):
  train : per-dim vmin_i = min_n x[n,i], vdiff_i = max_n x[n,i] - vmin_i
          on L2-normalized inputs;
  encode: code_i = int(255 * clip((x_i - vmin_i)/vdiff_i, 0, 1)),
          truncating (rounding='round' gives faiss compute_codes);
  decode: x_i = vmin_i + vdiff_i * (code_i + 0.5) / 255.

encode takes the same float32 operations in the same order as
`cvt_tpu`'s, so the codes agree bit for bit on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.ops.linalg import l2_normalize
from cvt_tpu_torch.utils.device import resolve_device


def _encode(x, vmin, vdiff, rounding: str) -> torch.Tensor:
    safe = torch.where(vdiff == 0, torch.ones_like(vdiff), vdiff)
    xi = torch.where(vdiff != 0, (x - vmin) / safe, torch.zeros_like(x))
    xi = torch.clamp(xi, 0.0, 1.0)
    if rounding == "truncate":       # cvt Int8Encode: bytes[i] = (int)(255*xi)
        code = torch.floor(255.0 * xi)
    elif rounding == "round":        # faiss compute_codes: int(255*x + 0.5)
        code = torch.floor(255.0 * xi + 0.5)
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    return torch.clamp(code, 0, 255).to(torch.uint8)


class ScalarQuantizer:
    """Per-dimension 8-bit scalar quantizer (QT_8bit minmax)."""

    def __init__(self, vmin, vdiff, rounding: str = "truncate", device=None):
        """vmin, vdiff [D] (arrays or tensors); `device` defaults to
        vmin's own for a tensor, else the card (`resolve_device`)."""
        self.vmin = torch.as_tensor(vmin, dtype=torch.float32,
                                    device=resolve_device(device, like=vmin))
        self.vdiff = torch.as_tensor(vdiff, dtype=torch.float32,
                                     device=self.vmin.device)
        self.rounding = rounding

    @property
    def device(self) -> torch.device:
        return self.vmin.device

    @property
    def dim(self) -> int:
        return self.vmin.shape[0]

    @classmethod
    def train(cls, x, *, l2norm: bool = True, rounding: str = "truncate",
              device=None) -> "ScalarQuantizer":
        """Train per-dim (vmin, vdiff) on x [N, D]. l2norm=True matches the
        reference trainer, which L2-normalizes every vector first."""
        x = torch.as_tensor(x, dtype=torch.float32,
                            device=resolve_device(device, like=x))
        if l2norm:
            x = l2_normalize(x)
        vmin = torch.amin(x, dim=0)
        vmax = torch.amax(x, dim=0)
        return cls(vmin, vmax - vmin, rounding)

    def _as(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def encode(self, x, *, l2norm: bool = False) -> torch.Tensor:
        """x [..., D] float -> uint8 codes [..., D]."""
        x = self._as(x)
        if l2norm:
            x = l2_normalize(x)
        return _encode(x, self.vmin, self.vdiff, self.rounding)

    def decode(self, codes) -> torch.Tensor:
        """uint8 codes [..., D] -> float32 [..., D]."""
        c = torch.as_tensor(codes, device=self.device).float()
        return self.vmin + self.vdiff * (c + 0.5) / 255.0

    # Affine decode form used by the asymmetric distance scan:
    # decode(c) = bias + scale * c, elementwise per dim.
    @property
    def scale(self) -> torch.Tensor:    # [D]
        return self.vdiff / 255.0

    @property
    def bias(self) -> torch.Tensor:     # [D]
        return self.vmin + 0.5 * self.vdiff / 255.0

    def reconstruction_loss(self, x, *, l2norm: bool = True):
        """Mean L2 loss and mean IP of decode(encode(x)) vs x, the
        self-check the reference trainer prints."""
        x = self._as(x)
        if l2norm:
            x = l2_normalize(x)
        rec = self.decode(self.encode(x))
        l2 = torch.mean(torch.sqrt(torch.sum((x - rec) ** 2, dim=-1)))
        ip = torch.mean(torch.sum(x * rec, dim=-1))
        return l2, ip

    # -- persistence (the .npz layout of cvt_tpu) --------------------------
    def save(self, path: str) -> None:
        np.savez(path, vmin=self.vmin.cpu().numpy(),
                 vdiff=self.vdiff.cpu().numpy(), rounding=self.rounding)

    @classmethod
    def load(cls, path: str, device=None) -> "ScalarQuantizer":
        z = np.load(path, allow_pickle=False)
        return cls(z["vmin"], z["vdiff"], str(z["rounding"]), device=device)
