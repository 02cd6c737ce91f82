"""The controls: the reference put in the program's place, computed one
precision below the one the configuration states.

  * flat (the program scores int8 codebooks against int8-folded queries):
    the same search with int4 codebooks (per dimension, [-7, 7]) and
    int4-folded queries (one scale for the batch), its top k under the
    configuration's selection (`adc.candidates`), as the reference's;
  * IVF (the program rescores its candidates from an int16 decode in
    float32): the same search scored at int8, the precision of its first
    phase, with no rescoring.

Each returns (dists [S, k] float64, ids [S, k] int64) for the queries,
which `compare.numbers` then judges as it judges the program's answers.
"""

from __future__ import annotations

import torch

from benchmark.reference import adc


def quantize_dims(cb: torch.Tensor, levels: int) -> torch.Tensor:
    """Codebooks [M, K, ds] rounded per dimension to a symmetric grid of
    +-levels steps (scale: the dimension's largest magnitude)."""
    scale = torch.clamp_min(cb.abs().amax(dim=1, keepdim=True) / levels,
                            1e-12)
    return torch.clamp(torch.round(cb / scale), -levels, levels) * scale


def fold(y: torch.Tensor, levels: int) -> torch.Tensor:
    """Queries rounded to one symmetric grid for the whole batch."""
    scale = torch.clamp_min(y.abs().amax() / levels, 1e-12)
    return torch.clamp(torch.round(y / scale), -levels, levels) * scale


def flat_int4(ref: adc.FlatADC, q: torch.Tensor, k: int):
    cb4 = quantize_dims(ref.cb, 7)
    y = ref.query(q)
    y4 = fold(y, 7)
    y_sq = torch.sum(y * y, 1)
    best = (torch.zeros((q.shape[0], 0), dtype=torch.float64,
                        device=q.device),
            torch.zeros((q.shape[0], 0), dtype=torch.int64, device=q.device))
    for s in range(0, ref.n, adc.BLOCK):
        rows = torch.arange(s, min(s + adc.BLOCK, ref.n), device=q.device)
        rec = adc.decode(ref.codes[rows], cb4)
        d = y_sq[:, None] - 2.0 * y4 @ rec.T + torch.sum(rec * rec, 1)
        best = adc.keep_best(*best, d, rows, k, ref.sel, ref.n)
    return best


def ivf_int8(ref: adc.IVFADC, q: torch.Tensor, k: int, nprobe: int):
    cb8 = quantize_dims(ref.cb, 127)
    qd = q.double()
    q8 = fold(qd, 127)
    q_sq = torch.sum(qd * qd, 1)
    probed = torch.zeros((q.shape[0], ref.cent.shape[0]), dtype=torch.bool,
                         device=q.device)
    probed.scatter_(1, ref.probes(q, nprobe), True)
    best = (torch.zeros((q.shape[0], 0), dtype=torch.float64,
                        device=q.device),
            torch.zeros((q.shape[0], 0), dtype=torch.int64, device=q.device))
    for s in range(0, ref.n, adc.BLOCK):
        rows = torch.arange(s, min(s + adc.BLOCK, ref.n), device=q.device)
        cent = ref.cent[ref.cell[rows]]
        res = adc.decode(ref.codes[rows], cb8)
        rec = cent + res
        d = (q_sq[:, None] - 2.0 * qd @ cent.T - 2.0 * q8 @ res.T
             + torch.sum(rec * rec, 1))
        d = torch.where(probed[:, ref.cell[rows]], d, float("inf"))
        best = adc.keep_best(*best, d, rows, k, None, ref.n)
    return best
