"""Text embeddings: fastText-style word + subword n-gram lookup
(counterpart of `cvt_tpu.features.text`).

Reference: fasttext_embedding/fasttext_model.cc:5-37 —
cvtk::nlp::FasttextModel wraps a trained fastText model: Init(model),
GetEmbedd(word) = word/subword vector lookup, L2Norm. The model itself
is an external artifact there; the framework capability is embedding
lookup + normalization as a search front-end.

The tables live on the device. Tokenisation stays on the host, as in
`cvt_tpu`: each word becomes its vocabulary row, or, out of the
vocabulary, the rows of its hashed character n-grams (FNV-1a into
`n_buckets`, fastText's scheme). Where `cvt_tpu` gathers and averages
word by word, the port gathers every word of a call at once: one
`embedding_bag` mean per table, then one more over the words of each
sentence. The sums are float32 in another order, so embeddings agree
with `cvt_tpu`'s to rounding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cvt_tpu_torch.ops.linalg import l2_normalize
from cvt_tpu_torch.utils.device import resolve_device


def _fnv1a(data: bytes) -> int:
    h = 2166136261
    for byte in data:
        h = ((h ^ byte) * 16777619) & 0xFFFFFFFF
    return h


def char_ngrams(word: str, n_min: int = 3, n_max: int = 6) -> list[str]:
    """fastText-style boundary-marked character n-grams of '<word>'."""
    w = f"<{word}>"
    out = []
    for n in range(n_min, n_max + 1):
        out.extend(w[i:i + n] for i in range(len(w) - n + 1))
    return out


def _table(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def _bag_mean(table: torch.Tensor, bags: list[list[int]]) -> torch.Tensor:
    """Mean of table rows per bag -> [len(bags), D]; an empty bag gives
    zeros."""
    dev = table.device
    flat = [r for rows in bags for r in rows]
    offsets = np.cumsum([0] + [len(rows) for rows in bags[:-1]])
    return F.embedding_bag(
        torch.tensor(flat, dtype=torch.int64, device=dev), table,
        torch.as_tensor(offsets, dtype=torch.int64, device=dev),
        mode="mean")


class TextEmbedder:
    """Word + subword embedding lookup with L2-normalized outputs."""

    def __init__(self, vocab: dict[str, int], vectors,
                 ngram_vectors=None, *, n_min: int = 3, n_max: int = 6,
                 device=None):
        """vocab: word -> row in `vectors` [V, D]. ngram_vectors
        [n_buckets, D] enables subword fallback for OOV words. The tables
        go to `device` (default: the card; a tensor keeps its own)."""
        dev = resolve_device(device, like=vectors)
        self.device = dev
        self.vocab = dict(vocab)
        self.vectors = _table(vectors, dev)
        self.dim = int(self.vectors.shape[1])
        self.ngrams = (None if ngram_vectors is None
                       else _table(ngram_vectors, dev))
        self.n_min, self.n_max = n_min, n_max

    @classmethod
    def random(cls, words: list[str], dim: int = 64,
               n_buckets: int = 4096, seed: int = 0,
               device=None) -> "TextEmbedder":
        """Randomly initialized model (tests / training from scratch):
        numpy's default_rng(seed), the same tables as `cvt_tpu`'s."""
        rng = np.random.default_rng(seed)
        vecs = rng.normal(size=(len(words), dim)).astype(np.float32)
        ng = rng.normal(size=(n_buckets, dim)).astype(np.float32)
        return cls({w: i for i, w in enumerate(words)}, vecs, ng,
                   device=device)

    # -- host-side tokenization ------------------------------------------
    def _word_vec_rows(self, word: str):
        """(table, rows) for one word: vocab row or hashed n-gram rows."""
        i = self.vocab.get(word)
        if i is not None:
            return "word", [i]
        if self.ngrams is None:
            return "word", []                       # silent OOV -> zero
        nb = int(self.ngrams.shape[0])
        rows = [_fnv1a(g.encode("utf-8")) % nb
                for g in char_ngrams(word, self.n_min, self.n_max)]
        return "ngram", rows

    def _raw(self, words: list[str]) -> torch.Tensor:
        """[len(words), D] unnormalized mean vectors."""
        out = torch.zeros((len(words), self.dim), dtype=torch.float32,
                          device=self.device)
        rows = [self._word_vec_rows(w) for w in words]
        for kind, table in (("word", self.vectors), ("ngram", self.ngrams)):
            at = [j for j, (k, r) in enumerate(rows) if k == kind and r]
            if at:
                out[torch.tensor(at, device=self.device)] = _bag_mean(
                    table, [rows[j][1] for j in at])
        return out

    def embed_words(self, words: list[str]) -> torch.Tensor:
        """[len(words), D] L2-normalized embeddings (GetEmbedd batch)."""
        return l2_normalize(self._raw(words))

    def embed_sentences(self, sentences: list[str]) -> torch.Tensor:
        """Mean-of-words sentence embeddings, L2-normalized [S, D]."""
        toks = [s.split() for s in sentences]
        words = l2_normalize(self._raw([w for t in toks for w in t]))
        starts = np.cumsum([0] + [len(t) for t in toks])
        bags = [list(range(a, b)) for a, b in zip(starts[:-1], starts[1:])]
        return l2_normalize(_bag_mean(words, bags))


def embed_ids(table, ids, mask, *, device=None) -> torch.Tensor:
    """Pure-device path: [B, L] token ids + mask -> [B, D] normalized
    mean-pooled embeddings (the core for serving). Runs on table's
    device (numpy: `device`, default the card)."""
    dev = resolve_device(device, like=table)
    table = _table(table, dev)
    ids = torch.as_tensor(ids, device=dev).long()
    v = table[ids]                                           # [B, L, D]
    m = torch.as_tensor(mask, device=dev).to(torch.float32)[..., None]
    pooled = torch.sum(v * m, 1) / torch.clamp_min(torch.sum(m, 1), 1.0)
    return l2_normalize(pooled)
