"""Seeded arguments of `ivf_rescore` (phase 2 of the IVF page scan) for
tests on the CPU and on the card; imports no JAX.

`rescore_args` lays out n_pages pages of spt segments of seg rows and
hands phase 2 what phase 1 would: segpack keys for the n_slots selected
page slots (INT32_MAX past n_live), sel (page 0 in the fill slots, as
`_select_pages` fills them), and the probe stage's q, q_sq, coarse_ip and
probed_bk. Keys are drawn in a band above 2^25, where float32 holds every
4th integer, so most segments tie in float32 with others; a share of them
lies far below. Pad rows (rowids -1, nrm BIG), dead cells (seg_cell -1)
and cells a query did not probe are mixed in. Row norms spread over three
decades, so the rows' distances rarely lie within a float32 summation's
error of each other."""

import numpy as np
import torch

BIG = 3.4e38
I32_MAX = 2 ** 31 - 1
TIE_BAND = 2 ** 25          # keys here tie in float32 in groups of ~4
KEYS = ("segpack", "n_live", "sel", "rowids", "seg_cell", "dec16_rm",
        "srow16", "nrm_col", "dsq_min", "q", "q_sq", "coarse_ip",
        "probed_bk")


def rescore_args(b: int, n_slots: int, spt: int, seg: int, d: int,
                 n_live: int, kc: int = 64, nprobe: int = 8, seed: int = 0,
                 device="cpu") -> dict:
    """Keyword arguments of ivf_rescore but seg, k, slack, exact_probe."""
    rng = np.random.default_rng(seed)
    n_pages = n_slots + 3
    n_rows = n_pages * spt * seg
    n_segs = n_rows // seg
    bpad = -(-b // 128) * 128
    seg_cell = rng.integers(0, kc, n_segs).astype(np.int32)
    seg_cell[rng.random(n_segs) < 0.05] = -1                  # dead cells
    rowids = rng.permutation(n_rows).astype(np.int32)
    pad = rng.random(n_rows) < 0.05
    rowids[pad] = -1
    nrm = (10.0 ** rng.uniform(3, 6, n_rows)).astype(np.float32)
    nrm[pad] = BIG
    nrm[rng.random(n_rows) < 0.01] = BIG                      # BIG, id kept
    dec16 = rng.integers(-32767, 32768, (n_rows, d)).astype(np.int16)
    srow16 = rng.uniform(1e-4, 3e-4, d).astype(np.float32)
    q = (rng.standard_normal((b, d)) * 30).astype(np.float32)
    coarse_ip = (rng.standard_normal((b, kc)) * 100).astype(np.float32)
    probed = np.zeros((b, kc), bool)
    for i in range(b):
        probed[i, rng.choice(kc, min(nprobe, kc), replace=False)] = True
    live = min(n_live, n_slots)
    sel = np.zeros(n_slots, np.int32)
    sel[:live] = np.sort(rng.choice(n_pages, live, replace=False))
    keys = rng.integers(TIE_BAND, TIE_BAND + 4096,
                        (n_slots * spt, bpad)).astype(np.int64)
    low = rng.random(keys.shape) < 0.02
    keys[low] = rng.integers(-2 ** 20, 2 ** 24, int(low.sum()))
    keys[live * spt:] = I32_MAX
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    qt = t(q)
    return dict(segpack=t(keys.astype(np.int32)),
                n_live=torch.tensor([n_live], dtype=torch.int32,
                                    device=device),
                sel=t(sel), rowids=t(rowids), seg_cell=t(seg_cell),
                dec16_rm=t(dec16), srow16=t(srow16), nrm_col=t(nrm[:, None]),
                dsq_min=50.0, q=qt, q_sq=torch.sum(qt * qt, dim=-1),
                coarse_ip=t(coarse_ip), probed_bk=t(probed))


def positional(a: dict, seg: int, k: int, slack: int,
               exact_probe: bool) -> tuple:
    """The arguments in ivf_rescore's order."""
    return tuple(a[key] for key in KEYS) + (seg, k, slack, exact_probe)
