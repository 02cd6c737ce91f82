"""The numbers that decide `correct`, from a sample of answered queries.

For each sampled query the program returned k ids and k distances. The
reference (`adc.FlatADC` or `adc.IVFADC`) works out, for the same query:

  * the distance of every returned id, d_ref(id), and
  * its own k best distances d_best[1..k]: over every row (flat), or over
    the rows of the query's own nprobe cells (IVF).

From those:

  * bad_ids: returned ids out of range, or repeated within one answer;
  * top1_gap: the widest relative gap by which the program's first answer
    lies above the reference's best, (d_ref(id_1) - d_best[1]) / d_best[1];
  * rank_gap: the widest relative gap by which the j-th nearest of the
    returned ids lies above the reference's j-th best, over j = 1..k,
    (sorted d_ref[j] - d_best[j]) / d_best[j]: nought where the answer is
    the top k, large where any rank holds a row that is not near;
  * dist_err: the widest relative gap between a returned distance and
    the reference's distance of the same id.

Rows whose encoding is a float32 near-tie (`adc` TIE) are left out: of
dist_err where they are returned, of top1_gap where one is the program's
first answer or the reference's best, of rank_gap where one is among the
returned ids or the reference's k best. `ambiguous` counts the answers
left out of dist_err and `rank_left_out` the queries left out of
rank_gap; dist_err_all is dist_err over every answer (all three are
printed, none is compared).
"""

from __future__ import annotations

import torch


def bad_ids(ids: torch.Tensor, n: int) -> int:
    out = (ids < 0) | (ids >= n)
    srt = torch.sort(ids, dim=1).values
    dup = srt[:, 1:] == srt[:, :-1]
    return int(out.sum()) + int(dup.sum())


def numbers(ref, q: torch.Tensor, ids: torch.Tensor, dists: torch.Tensor,
            nprobe: int | None = None, block: int = 512) -> dict:
    """q [S, D] float32, ids [S, k] int64 and dists [S, k] on one device."""
    gap = rank = err = err_all = 0.0
    left_out = rank_left_out = 0
    k = ids.shape[1]
    for s in range(0, q.shape[0], block):
        qb, ib, db = q[s:s + block], ids[s:s + block], dists[s:s + block]
        d_ref = ref.dists(qb, ib)
        d_best, i_best = (ref.best(qb, k) if nprobe is None
                          else ref.best(qb, k, nprobe))
        ok = torch.isfinite(d_ref)
        amb = torch.zeros_like(ok)
        amb[ok] = ref.ambiguous(ib[ok])
        amb_best = ref.ambiguous(i_best.reshape(-1)).reshape(i_best.shape)
        first = ~amb[:, 0] & ~amb_best[:, 0]
        g = (d_ref[:, 0] - d_best[:, 0]) / d_best[:, 0]
        gap = max(gap, float(torch.max(torch.where(first, g, 0.0))))
        # out-of-range ids are bad_ids' to count
        whole = ok.all(1) & ~amb.any(1) & ~amb_best.any(1)
        r = torch.max((torch.sort(torch.where(ok, d_ref, 0.0), 1).values
                       - d_best) / d_best, dim=1).values
        rank = max(rank, float(torch.max(torch.where(whole, r, 0.0))))
        rank_left_out += int((~whole).sum())
        rel = torch.abs(db.double() - d_ref) / d_ref
        err = max(err, float(torch.max(torch.where(ok & ~amb, rel, 0.0))))
        err_all = max(err_all, float(torch.max(torch.where(ok, rel, 0.0))))
        left_out += int(amb.sum())
    return {"bad_ids": bad_ids(ids, ref.n), "top1_gap": max(gap, 0.0),
            "rank_gap": max(rank, 0.0), "dist_err": err,
            "ambiguous": left_out, "rank_left_out": rank_left_out,
            "dist_err_all": err_all}


def exact_recall(base: torch.Tensor, q: torch.Tensor, ids: torch.Tensor,
                 block: int = 65_536) -> dict:
    """recall@1 and @k of the answers against the exact L2 nearest row of
    the raw base (informative: not a number that decides `correct`)."""
    qd = q.double()
    best_d = torch.full((q.shape[0],), float("inf"), dtype=torch.float64,
                        device=q.device)
    best_i = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    q_sq = torch.sum(qd * qd, 1)
    for s in range(0, base.shape[0], block):
        x = base[s:s + block].double()
        d = q_sq[:, None] - 2.0 * qd @ x.T + torch.sum(x * x, 1)[None]
        v, j = torch.min(d, dim=1)
        better = v < best_d
        best_d = torch.where(better, v, best_d)
        best_i = torch.where(better, j + s, best_i)
    hit = ids == best_i[:, None]
    return {"recall_at_1": float(hit[:, 0].double().mean()),
            "recall_at_k": float(hit.any(1).double().mean())}
