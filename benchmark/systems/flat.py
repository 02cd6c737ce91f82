"""The flat OPQ index of the port, driven as a caller drives it:
`FlatADCIndex.search(q_host, k)` with impl="kernel", its ids and distances
copied to the host."""

from __future__ import annotations

import numpy as np

SCAN_KERNEL = "adc_segmin_kernel"


class System:
    def __init__(self, cfg: dict, inputs: dict, traffic: dict, device):
        from cvt_tpu_torch.index.flat_adc import FlatADCIndex
        from cvt_tpu_torch.quant.opq import OPQ
        from cvt_tpu_torch.quant.pq import ProductQuantizer

        quant = OPQ(inputs["rotation"], ProductQuantizer(inputs["codebooks"]))
        self.index = FlatADCIndex(quant, impl="kernel", device=device)
        self.index.add(inputs["base"])
        self.k = traffic["k"]

    def search(self, q: np.ndarray):
        """-> (dists [b, k], ids [b, k], pages dropped) on the host."""
        d, i = self.index.search(q, self.k)
        return d.cpu().numpy(), i.cpu().numpy(), 0
