"""Global image embeddings: pluggable encoders + pipeline helpers
(counterpart of `cvt_tpu.features.embedding`).

Reference components #18-22 (tf_extract_feat, libtorch_extract_feat,
opencv_dnn_feature, opencv_caffe_sim, caffe_feature) are five C++
wrappers around frozen CNN graphs exposing the same surface:
`initModel(model) / computeFeat(image) / computeFeatsBatch(images)` with
L2 normalization (e.g. tf_extract_feat/include/tfExtractFeature.hpp:36-63).
Here that surface is "any callable [B, H, W, C] -> [B, D]" on the card;
this module provides the harness (preprocessing, batching, L2 norm; the
vectors then go to PCA / SQ compression) plus a self-contained
convolutional encoder for pipelines that need a deterministic built-in
model (no pretrained weights are bundled — plug in any torch model via
`fn`).

What differs from `cvt_tpu`:
  * the resize is JAX's antialiased linear resize rebuilt as two products
    (`ops/resize.py`), and `compute` preprocesses batch by batch (the
    same values; it keeps one batch of full-size float images in memory,
    not all of them);
  * `_conv` pads as XLA's "SAME" does: at stride 2 an even input gets
    0 rows before and 1 after, where `F.conv2d(padding=1)` would pad 1 on
    each side and shift every output;
  * `simple_cnn(seed)` draws its He-init weights from a `torch.Generator`,
    whose bits cannot equal `jax.random`'s; `convert.embedding_from_numpy`
    carries `cvt_tpu`'s HWIO weights across.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cvt_tpu_torch.ops.linalg import full_precision_conv, l2_normalize
from cvt_tpu_torch.ops.resize import resize_linear
from cvt_tpu_torch.utils.device import resolve_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
CHANNELS = (32, 64, 128, 256)


def preprocess(images, *, size: int = 224, mean=IMAGENET_MEAN,
               std=IMAGENET_STD, device=None) -> torch.Tensor:
    """uint8/float [B, H, W, 3] -> normalized float32 [B, size, size, 3]
    (the mean-subtract + resize path of caffe_feature/test.cpp:37-81).
    A tensor keeps its device; numpy goes to `device` (default the card)."""
    dev = resolve_device(device, like=images)
    x = torch.as_tensor(images, device=dev)
    x = (x.to(torch.float32) / 255.0 if x.dtype == torch.uint8
         else x.to(torch.float32))
    x = resize_linear(x, (x.shape[0], size, size, x.shape[-1]))
    return ((x - torch.as_tensor(mean, device=dev))
            / torch.as_tensor(std, device=dev))


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one axis: (before, after)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x [B, C, H, W], w [O, I, kh, kw] -> "SAME" convolution (NCHW)."""
    top, bottom = _same_pad(x.shape[2], w.shape[2], stride)
    left, right = _same_pad(x.shape[3], w.shape[3], stride)
    with full_precision_conv():
        return F.conv2d(F.pad(x, (left, right, top, bottom)), w,
                        stride=stride)


def _init_simple_cnn(gen: torch.Generator, dim: int, channels=CHANNELS):
    """Deterministic small conv encoder (He-init), HWIO weights and a
    [C, dim] head on the CPU. Not pretrained — a structural stand-in so
    embedding pipelines run end-to-end; swap in a real model via
    EmbeddingExtractor(fn=...)."""
    params = []
    cin = 3
    for cout in channels:
        w = torch.randn((3, 3, cin, cout), generator=gen) * float(
            np.sqrt(2.0 / (9 * cin)))
        params.append(w)
        cin = cout
    head = torch.randn((cin, dim), generator=gen) * float(np.sqrt(1.0 / cin))
    return params, head


class SimpleCNN(nn.Module):
    """The simple encoder: stride-2 "SAME" 3x3 convolutions with ReLU,
    global average pool, a linear head. Takes NHWC input, as `cvt_tpu`'s
    `_simple_cnn_forward` does; weights are given in HWIO."""

    def __init__(self, conv_ws, head):
        super().__init__()
        self.convs = nn.ParameterList(
            nn.Parameter(torch.as_tensor(w, dtype=torch.float32)
                         .permute(3, 2, 0, 1).contiguous(),
                         requires_grad=False) for w in conv_ws)
        self.head = nn.Parameter(torch.as_tensor(head, dtype=torch.float32),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)                          # NHWC -> NCHW
        for w in self.convs:
            x = F.relu(_conv(x, w, stride=2))
        return torch.mean(x, dim=(2, 3)) @ self.head       # global pool


def _simple_cnn_forward(params, head, x: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, 3] -> [B, dim] with HWIO `params` and `head`."""
    return SimpleCNN(params, head).to(x.device)(x)


@dataclass
class EmbeddingExtractor:
    """Batched image -> embedding with L2 norm; the counterpart of the
    reference's five CNN wrapper classes."""

    fn: object                   # callable [B, H, W, C] -> [B, D]
    dim: int
    input_size: int = 224
    device: torch.device | None = None

    @classmethod
    def simple_cnn(cls, dim: int = 128, seed: int = 0,
                   input_size: int = 224,
                   device=None) -> "EmbeddingExtractor":
        """The built-in encoder with weights drawn from
        `torch.Generator().manual_seed(seed)`, on `device` (default the
        card)."""
        params, head = _init_simple_cnn(torch.Generator().manual_seed(seed),
                                        dim)
        return cls._from_weights(params, head, input_size=input_size,
                                device=device)

    @classmethod
    def _from_weights(cls, conv_ws, head, *, input_size: int = 224,
                     device=None) -> "EmbeddingExtractor":
        dev = resolve_device(device)
        model = SimpleCNN(conv_ws, head).to(dev).eval()
        return cls(fn=model, dim=int(model.head.shape[1]),
                   input_size=input_size, device=dev)

    def compute(self, images, *, l2norm: bool = True,
                batch_size: int = 64) -> torch.Tensor:
        """images [B, H, W, 3] (uint8 or float) -> [B, dim] float32."""
        dev = self.device if self.device is not None else resolve_device(
            None, like=images)
        outs = []
        with torch.no_grad():
            for s in range(0, images.shape[0], batch_size):
                x = preprocess(images[s:s + batch_size],
                               size=self.input_size, device=dev)
                e = self.fn(x)
                outs.append(l2_normalize(e) if l2norm else e)
        return torch.cat(outs, 0)


class TextEmbedding:
    """Word-vector lookup + L2 norm (fasttext_embedding equivalent,
    fasttext_model.cc:5-37): a host-side vocab dict + a device embedding
    table; OOV words return zeros."""

    def __init__(self, vocab: dict, vectors, device=None):
        """vocab: {word: row}; vectors [V, D] float."""
        dev = resolve_device(device, like=vectors)
        self.device = dev
        self.vocab = dict(vocab)
        self.table = torch.as_tensor(vectors, dtype=torch.float32,
                                     device=dev)

    @classmethod
    def from_txt(cls, path: str, device=None) -> "TextEmbedding":
        """Load fasttext .vec text format (word v1 v2 ... per line)."""
        vocab, rows = {}, []
        with open(path) as f:
            first = f.readline().split()
            if len(first) != 2:     # no header: rewind via reopen
                f.seek(0)
            for line in f:
                parts = line.rstrip().split(" ")
                if len(parts) < 3:
                    continue
                vocab[parts[0]] = len(rows)
                rows.append(np.asarray(parts[1:], np.float32))
        return cls(vocab, np.stack(rows), device=device)

    def embed(self, words, *, l2norm: bool = True) -> torch.Tensor:
        ids = torch.as_tensor([self.vocab.get(w, -1) for w in words],
                              dtype=torch.int64, device=self.device)
        emb = torch.where((ids >= 0)[:, None],
                          self.table[torch.clamp_min(ids, 0)], 0.0)
        return l2_normalize(emb) if l2norm else emb
