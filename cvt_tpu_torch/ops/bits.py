"""64-bit binary codes as one int64 word, and their Hamming distances.

`cvt_tpu` keeps a 64-bit code as two uint32 words [..., 2] (JAX runs with
32-bit integers). torch has no popcount and little uint32 support, so the
port keeps one int64 word: bits 0-31 are `cvt_tpu`'s word 0, bits 32-63
its word 1 (`sigs_to_u32` / `sigs_from_u32` convert at the API edge).
Bits are counted with a 256-entry byte table, masking after every shift.
Used by the Hamming embedding (`index/vocab_he.py`) and the perceptual
hash (`apps/phash.py`).
"""

from __future__ import annotations

import numpy as np
import torch

_BYTE_BITS = torch.tensor([bin(i).count("1") for i in range(256)],
                          dtype=torch.int32)
# bit i of a signature; bit 63 is the int64 sign bit
_BIT_WEIGHTS = torch.tensor([1 << i for i in range(63)] + [-(1 << 63)],
                            dtype=torch.int64)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bits [..., 64] bool -> [..., ] int64 (bit i = bits[..., i])."""
    w = _BIT_WEIGHTS.to(bits.device)
    # distinct powers of two: the sum is the bitwise or (bit 63 wraps into
    # the sign, as two's complement does)
    return torch.sum(torch.where(bits, w, 0), -1)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 -> int32, one byte-table lookup per byte."""
    table = _BYTE_BITS.to(x.device)
    count = table[x & 255]
    for s in range(8, 64, 8):
        count = count + table[(x >> s) & 255]
    return count


def _hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance of int64 signatures (broadcastable) -> int32."""
    return _popcount(torch.bitwise_xor(a, b))


def sigs_to_u32(sigs: np.ndarray) -> np.ndarray:
    """int64 signatures [...] -> `cvt_tpu`'s [..., 2] uint32 words."""
    u = np.asarray(sigs, np.int64).view(np.uint64)
    return np.stack([(u & 0xFFFFFFFF).astype(np.uint32),
                     (u >> np.uint64(32)).astype(np.uint32)], -1)


def sigs_from_u32(words: np.ndarray) -> np.ndarray:
    """`cvt_tpu`'s [..., 2] uint32 words -> int64 signatures [...]."""
    w = np.asarray(words, np.uint32).astype(np.uint64)
    return (w[..., 0] | (w[..., 1] << np.uint64(32))).view(np.int64)
