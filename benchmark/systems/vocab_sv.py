"""The port's vocabulary tree with Hamming embedding and spatial
re-ranking, driven as a caller of its size drives it: the vocab system's
index, with the collection staged with its keypoint frames by one
`add_images(..., geometries=)` call; each batch of query images sent as
ragged uint8 rows with their frames by `query_batch(rows, counts=,
geometries=, verify=, topk=)`, its ids and scores on the host."""

from __future__ import annotations

SCAN_KERNEL = "vocab_score_kernel"


class System:
    def __init__(self, cfg: dict, inputs: dict, traffic: dict, device):
        from cvt_tpu_torch.index import vocab_he
        from cvt_tpu_torch.index.vocab_he import VocabHEIndex

        t, he = cfg["tree"], cfg["he"]
        if (he["bits"], he["max_dist"], he["sigma"]) != (
                vocab_he.HE_BITS, vocab_he.HE_MAX_DIST, vocab_he.HE_SIGMA):
            raise ValueError("the port's Hamming embedding is not the "
                             "configuration's")
        idx = VocabHEIndex(n_words=t["coarse"] * t["fine"], dim=cfg["dim"],
                           hierarchical=True, probes=t["probes"],
                           device=device)
        idx.coarse, idx.fine = inputs["coarse"], inputs["fine"]
        idx.words = idx.fine.reshape(-1, cfg["dim"])
        idx.he_proj, idx.he_thresh = inputs["he_proj"], inputs["he_thresh"]
        idx.add_images(inputs["descriptors"], inputs["counts"],
                       geometries=inputs["frames"])
        idx.prepare()
        self.index = idx
        self.k = traffic["k"]
        self.verify = cfg["verify"]
        self.extent = cfg["image_extent"]

    def search(self, batch):
        """-> (scores [b, k], ids [b, k], 0) on the host."""
        ids, scores, _ = self.index.query_batch(
            batch.rows, counts=batch.counts, geometries=batch.frames,
            verify=self.verify, topk=self.k, image_extent=self.extent)
        return scores, ids, 0
