"""Plain reference of the searches the benchmark drives: asymmetric
distances (ADC) over product-quantizer codes, flat and inverted-file.

Float64 throughout, plain PyTorch, in blocks of rows. It takes the run's
inputs (the base vectors, the rotation or the coarse centroids, the
codebooks) and works out everything the program derives from them again:
the codes, the coarse cells, the distances. Nothing here imports the
program.

Flat (OPQ): y = x R, code_m(x) = argmin_k ||y_m - C[m, k]||^2, and
    d(q, n) = ||q R - decode(code(x_n))||^2.
    Where the configuration states a selection (`selection`), its top k
    is taken over candidates alone: the nearest row of each aligned
    segment of `segment_rows` rows, and of those the `per_tile` nearest
    of each aligned tile of `tile_rows` rows (the tile rule only where
    the tiles offer k candidates or more).
IVF: a(x) = argmin_c ||x - c||^2, residual codes of x - cent[a(x)], and
    d(q, n) = ||q - cent[a(x_n)] - decode(code(x_n))||^2,
searched over the rows of each query's nprobe nearest cells.

A row is ambiguous where its encoding is a near-tie that float32 can
decide either way: its two nearest cells, or its two nearest codewords in
some subspace, lie within TIE * ||y||^2 of each other (y: the vector
being encoded). The program, which encodes in float32, may then hold
another cell or code for that row than the reference does; `compare`
leaves such rows out by this rule on the reference, not by name.
"""

from __future__ import annotations

import torch

BLOCK = 65_536
TIE = 1e-5


def _close(d: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Rows whose two smallest entries of d [..., K] lie within TIE *
    scale of each other."""
    two = torch.topk(d, 2, dim=-1, largest=False).values
    return (two[..., 1] - two[..., 0]) < TIE * scale


def code_ties(y: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """[n] bool: some subspace of y [n, D] has a near-tie codeword pair."""
    cb = codebooks.double()
    m, k, ds = cb.shape
    ys = y.double().reshape(-1, m, ds)
    d = torch.sum((ys[:, :, None, :] - cb[None]) ** 2, dim=-1)   # [n, M, K]
    return _close(d, torch.sum(ys * ys, -1) + 1.0).any(dim=1)


def encode(y: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Nearest codeword per subspace: y [n, D] -> codes [n, M] int64."""
    cb = codebooks.double()
    m, k, ds = cb.shape
    out = torch.empty((y.shape[0], m), dtype=torch.int64, device=y.device)
    c_sq = torch.sum(cb * cb, dim=-1)                            # [M, K]
    for s in range(0, y.shape[0], BLOCK):
        ys = y[s:s + BLOCK].double().reshape(-1, m, ds)
        d = c_sq[None] - 2.0 * torch.einsum("nms,mks->nmk", ys, cb)
        out[s:s + BLOCK] = torch.argmin(d, dim=-1)
    return out


def decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """codes [n, M] -> [n, D] float64."""
    cb = codebooks.double()
    sub = torch.arange(cb.shape[0], device=codes.device)[None, :]
    return cb[sub, codes].reshape(codes.shape[0], -1)


def assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest coarse centroid of each row: [n] int64."""
    c = centroids.double()
    c_sq = torch.sum(c * c, dim=1)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], BLOCK // 4):
        xb = x[s:s + BLOCK // 4].double()
        out[s:s + BLOCK // 4] = torch.argmin(c_sq[None] - 2.0 * xb @ c.T, 1)
    return out


def candidates(d: torch.Tensor, start: int, sel: dict, n: int, k: int):
    """The candidates for a top k of a block of distances d [S, L], whose
    first row is row `start` (a multiple of the tile) of an index of n
    rows, under the selection `sel`: (their distances [S, C], their rows
    [S, C])."""
    segment, tile = sel["segment_rows"], sel["tile_rows"]
    use_tiles = sel["per_tile"] * -(-n // tile) >= k
    width = tile if use_tiles else segment
    pad = -d.shape[1] % width
    d = torch.nn.functional.pad(d, (0, pad), value=float("inf"))
    s = d.shape[0]
    seg_d, lane = torch.min(d.reshape(s, -1, segment), dim=-1)  # [S, nseg]
    seg = torch.arange(seg_d.shape[1], device=d.device).expand(s, -1)
    if use_tiles:
        per = tile // segment
        seg_d, j = torch.topk(seg_d.reshape(s, -1, per), sel["per_tile"],
                              dim=-1, largest=False)
        seg = (j + per * torch.arange(j.shape[1], device=d.device)[:, None]
               ).reshape(s, -1)
        seg_d = seg_d.reshape(s, -1)
        lane = torch.gather(lane, 1, seg)
    return seg_d, start + seg * segment + lane


class FlatADC:
    """The flat OPQ index worked out again from the inputs."""

    def __init__(self, base, rotation, codebooks, selection=None):
        self.sel = selection
        self.rot = rotation.double()
        self.cb = codebooks.double()
        self.codes = torch.cat([encode(base[s:s + BLOCK].double() @ self.rot,
                                       self.cb)
                                for s in range(0, base.shape[0], BLOCK)])
        self.n = base.shape[0]
        self.base = base

    def ambiguous(self, rows: torch.Tensor) -> torch.Tensor:
        return code_ties(self.base[rows].double() @ self.rot, self.cb)

    def recon(self, rows: torch.Tensor) -> torch.Tensor:
        """Decoded rows [len, D] in the rotated space."""
        return decode(self.codes[rows], self.cb)

    def query(self, q) -> torch.Tensor:
        return q.double() @ self.rot

    def dists(self, q, ids) -> torch.Tensor:
        """d(q_s, ids[s, j]) [S, k]; +inf where an id is out of range."""
        y = self.query(q)
        ok = (ids >= 0) & (ids < self.n)
        rec = self.recon(torch.where(ok, ids, 0).reshape(-1))
        rec = rec.reshape(ids.shape[0], ids.shape[1], -1)
        d = torch.sum((y[:, None, :] - rec) ** 2, dim=-1)
        return torch.where(ok, d, float("inf"))

    def best(self, q, k: int):
        """The exact ADC top-k over every row: (dists [S, k], ids)."""
        y = self.query(q)
        y_sq = torch.sum(y * y, dim=1)
        best_d = torch.full((y.shape[0], 0), 0.0, dtype=torch.float64,
                            device=y.device)
        best_i = torch.zeros((y.shape[0], 0), dtype=torch.int64,
                             device=y.device)
        for s in range(0, self.n, BLOCK):
            rows = torch.arange(s, min(s + BLOCK, self.n), device=y.device)
            rec = self.recon(rows)
            d = y_sq[:, None] - 2.0 * y @ rec.T + torch.sum(rec * rec, 1)
            best_d, best_i = keep_best(best_d, best_i, d, rows, k, self.sel,
                                       self.n)
        return best_d, best_i


def keep_best(best_d, best_i, d, rows, k: int, sel, n: int):
    """The k best of a running (best_d, best_i) [S, k'] and a block of
    distances d [S, L] over `rows` [L], under the selection `sel` (None:
    every row is a candidate)."""
    if sel is None:
        cand_i = rows.expand(d.shape[0], -1)
    else:
        d, cand_i = candidates(d, int(rows[0]), sel, n, k)
    best_d, j = torch.topk(torch.cat([best_d, d], 1), k, dim=1,
                           largest=False)
    return best_d, torch.gather(torch.cat([best_i, cand_i], 1), 1, j)


class IVFADC:
    """The IVF index (coarse cells, residual codes) worked out again."""

    def __init__(self, base, centroids, codebooks):
        self.cent = centroids.double()
        self.cb = codebooks.double()
        self.n = base.shape[0]
        self.cell = torch.cat([assign(base[s:s + BLOCK], centroids)
                               for s in range(0, self.n, BLOCK)])
        self.codes = torch.cat([
            encode(base[s:s + BLOCK].double()
                   - self.cent[self.cell[s:s + BLOCK]], self.cb)
            for s in range(0, self.n, BLOCK)])
        self.base = base

    def ambiguous(self, rows: torch.Tensor) -> torch.Tensor:
        x = self.base[rows].double()
        d = (torch.sum(x * x, 1)[:, None] - 2.0 * x @ self.cent.T
             + torch.sum(self.cent * self.cent, 1)[None, :])
        return _close(d, torch.sum(x * x, 1) + 1.0) | code_ties(
            x - self.cent[self.cell[rows]], self.cb)

    def recon(self, rows: torch.Tensor) -> torch.Tensor:
        return self.cent[self.cell[rows]] + decode(self.codes[rows], self.cb)

    def probes(self, q, nprobe: int) -> torch.Tensor:
        """Each query's nprobe nearest cells [S, nprobe]."""
        qd = q.double()
        d = (torch.sum(qd * qd, 1)[:, None] - 2.0 * qd @ self.cent.T
             + torch.sum(self.cent * self.cent, 1)[None, :])
        return torch.topk(d, nprobe, dim=1, largest=False).indices

    def dists(self, q, ids) -> torch.Tensor:
        ok = (ids >= 0) & (ids < self.n)
        rec = self.recon(torch.where(ok, ids, 0).reshape(-1))
        rec = rec.reshape(ids.shape[0], ids.shape[1], -1)
        d = torch.sum((q.double()[:, None, :] - rec) ** 2, dim=-1)
        return torch.where(ok, d, float("inf"))

    def best(self, q, k: int, nprobe: int):
        """The exact ADC top-k over the rows of each query's probed cells."""
        qd = q.double()
        q_sq = torch.sum(qd * qd, 1)
        probed = torch.zeros((q.shape[0], self.cent.shape[0]),
                             dtype=torch.bool, device=q.device)
        probed.scatter_(1, self.probes(q, nprobe), True)
        best_d = torch.full((q.shape[0], 0), 0.0, dtype=torch.float64,
                            device=q.device)
        best_i = torch.zeros((q.shape[0], 0), dtype=torch.int64,
                             device=q.device)
        for s in range(0, self.n, BLOCK):
            rows = torch.arange(s, min(s + BLOCK, self.n), device=q.device)
            rec = self.recon(rows)
            d = q_sq[:, None] - 2.0 * qd @ rec.T + torch.sum(rec * rec, 1)
            d = torch.where(probed[:, self.cell[rows]], d, float("inf"))
            best_d, best_i = keep_best(best_d, best_i, d, rows, k, None,
                                       self.n)
        return best_d, best_i

    def cell_sizes(self) -> torch.Tensor:
        return torch.bincount(self.cell, minlength=self.cent.shape[0])
