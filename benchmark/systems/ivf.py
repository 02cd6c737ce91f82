"""The port's IVF-ADC index, driven as a caller drives it:
`IVFADCIndex.search_fast(q_host, k, nprobe=, max_pages=)`, its ids,
distances and count of dropped pages copied to the host.

The page budget holds every batch's union (the most pages a cell spans,
for every query and probe), so no page is ever dropped for want of room:
a dropped page is a wrong answer, not a faster one."""

from __future__ import annotations

import numpy as np

SCAN_KERNEL = "ivf_page_kernel"


class System:
    def __init__(self, cfg: dict, inputs: dict, traffic: dict, device):
        from cvt_tpu_torch.index.ivf_adc import IVFADCIndex
        from cvt_tpu_torch.quant.pq import ProductQuantizer

        q = cfg["quantizer"]
        self.index = IVFADCIndex(coarse_k=q["coarse_k"], m=q["m"], k=q["k"],
                                 device=device)
        self.index.centroids = inputs["centroids"]
        self.index.pq = ProductQuantizer(inputs["codebooks"])
        self.index.build(inputs["base"])
        self.k = traffic["k"]
        self.nprobe = traffic["nprobe"]
        self.max_pages = (traffic["batch"] * self.nprobe
                          * self.index.cell_pages())

    def search(self, q: np.ndarray):
        """-> (dists [b, k], ids [b, k], pages dropped) on the host."""
        d, i, dropped = self.index.search_fast(
            q, self.k, nprobe=self.nprobe, max_pages=self.max_pages)
        return d.cpu().numpy(), i.cpu().numpy(), int(dropped.cpu())
