"""Carry `cvt_tpu` objects across to the port.

Each function takes the JAX package's parameters as numpy arrays (for
example `np.asarray(opq.rotation)`, read-only views are copied) and
returns the port's object on `device`: the card unless the caller passes
`device="cpu"` (`utils.device.resolve_device`). The port imports nothing
of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.features.embedding import EmbeddingExtractor
from cvt_tpu_torch.index.flat_adc import FlatADCIndex
from cvt_tpu_torch.index.flat_sq import FlatSQIndex
from cvt_tpu_torch.index.ivf_adc import IVFADCIndex
from cvt_tpu_torch.index.vocab_he import VocabHEIndex
from cvt_tpu_torch.match.bundle import BAProblem
from cvt_tpu_torch.quant.opq import OPQ
from cvt_tpu_torch.quant.pca import PCA
from cvt_tpu_torch.quant.pq import ProductQuantizer
from cvt_tpu_torch.quant.sq import ScalarQuantizer
from cvt_tpu_torch.utils.device import resolve_device


def pq_from_numpy(codebooks, device=None) -> ProductQuantizer:
    """codebooks [M, K, ds] -> ProductQuantizer."""
    return ProductQuantizer(np.array(codebooks, np.float32), device=device)


def opq_from_numpy(rotation, codebooks, device=None) -> OPQ:
    """rotation [D, D] + codebooks [M, K, ds] -> OPQ."""
    return OPQ(np.array(rotation, np.float32),
               pq_from_numpy(codebooks, device))


def flat_adc_from_numpy(codes, dec_sq, codebooks, rotation=None,
                        device=None, impl: str = "auto") -> FlatADCIndex:
    """A `cvt_tpu` FlatADCIndex's arrays -> the port's FlatADCIndex.
    rotation None (or empty, as in a saved index) means plain PQ."""
    if rotation is None or np.asarray(rotation).size == 0:
        quant = pq_from_numpy(codebooks, device)
    else:
        quant = opq_from_numpy(rotation, codebooks, device)
    idx = FlatADCIndex(quant, impl=impl)
    idx._codes = torch.as_tensor(np.array(codes, np.uint8),
                                 device=idx.device)
    idx._dec_sq = torch.as_tensor(np.array(dec_sq, np.float32),
                                  device=idx.device)
    return idx


def ivf_adc_from_numpy(centroids, codebooks, bucket_cap=None,
                       device=None) -> IVFADCIndex:
    """A `cvt_tpu` IVFADCIndex's trained coarse quantizer (centroids
    [Kc, D]) and residual PQ (codebooks [M, K, ds]) -> the port's
    IVFADCIndex, trained and ready for build()/build_from_codes()."""
    cb = np.array(codebooks, np.float32)
    idx = IVFADCIndex(coarse_k=np.shape(centroids)[0], m=cb.shape[0],
                      k=cb.shape[1], bucket_cap=bucket_cap, device=device)
    idx.centroids = torch.as_tensor(np.array(centroids, np.float32),
                                    device=idx.device)
    idx.pq = pq_from_numpy(cb, idx.device)
    return idx


def sq_from_numpy(vmin, vdiff, rounding: str = "truncate",
                  device=None) -> ScalarQuantizer:
    """vmin, vdiff [D] -> ScalarQuantizer."""
    return ScalarQuantizer(np.array(vmin, np.float32),
                           np.array(vdiff, np.float32), rounding,
                           device=device)


def pca_from_numpy(mean, components, eigenvalues, whiten: bool = False,
                   device=None) -> PCA:
    """mean [D], components [out_dim, D], eigenvalues [out_dim] -> PCA."""
    return PCA(np.array(mean, np.float32), np.array(components, np.float32),
               np.array(eigenvalues, np.float32), whiten, device=device)


def flat_sq_from_numpy(codes_s8, term3, vmin, vdiff,
                       rounding: str = "truncate", mode: str = "bf16",
                       dec8_t=None, norm_col=None,
                       device=None) -> FlatSQIndex:
    """A `cvt_tpu` FlatSQIndex's arrays -> the port's FlatSQIndex. With
    the decoded cache of its search_fast (dec8_t [D, Npad] int8, norm_col
    [Npad, 1] f32) the port scans those arrays instead of building its
    own."""
    idx = FlatSQIndex(sq_from_numpy(vmin, vdiff, rounding, device),
                      mode=mode)
    idx._codes_s8 = torch.as_tensor(np.array(codes_s8, np.int8),
                                    device=idx.device)
    idx._term3 = torch.as_tensor(np.array(term3, np.float32),
                                 device=idx.device)
    if dec8_t is not None:
        idx._dec8_t = torch.as_tensor(np.array(dec8_t, np.int8),
                                      device=idx.device)
        idx._norm_col = torch.as_tensor(np.array(norm_col, np.float32),
                                        device=idx.device)
        idx._dec8_n = idx.ntotal
    return idx


def vocab_he_from_numpy(arrays, device=None) -> VocabHEIndex:
    """The arrays a `cvt_tpu` VocabHEIndex.save writes (a dict, or the
    NpzFile of the saved file) -> the port's VocabHEIndex: vocabulary
    (words, coarse/fine when hierarchical, he_proj, he_thresh), and, when
    given, the prepared layout (buckets, tail, entries, idf, self_norm)
    and names, signatures converted from [..., 2] uint32 to int64. With
    the vocabulary alone the index is trained and empty: add_image and
    prepare build its layout. Set `probes` and `bucket_cap` on the result
    where the source index used other values than the defaults."""
    return VocabHEIndex._from_arrays(arrays, device)


def ba_problem_from_numpy(poses, points, cam_idx, pt_idx, uv, mask,
                          device=None) -> BAProblem:
    """A `cvt_tpu` BAProblem's arrays (poses [C, 6], points [P, 3],
    cam_idx / pt_idx [O], uv [O, 2], mask [O]) -> the port's BAProblem:
    float32 coordinates and int64 indices on `device`. A whole scene
    crosses through `Reconstruction.save` / `load`, whose .npz both
    packages share."""
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)
    return BAProblem(put(poses, torch.float32), put(points, torch.float32),
                     put(cam_idx, torch.int64), put(pt_idx, torch.int64),
                     put(uv, torch.float32), put(mask, torch.float32))


def embedding_from_numpy(conv_ws, head, input_size: int = 224,
                         device=None) -> EmbeddingExtractor:
    """`cvt_tpu`'s simple encoder (`features.embedding._init_simple_cnn`:
    a list of HWIO conv weights [3, 3, Cin, Cout] and a head [C, dim]) ->
    the port's EmbeddingExtractor with the same weights on `device`."""
    return EmbeddingExtractor._from_weights(
        [np.array(w, np.float32) for w in conv_ws],
        np.array(head, np.float32), input_size=input_size, device=device)


def arcface_from_numpy(params, device=None) -> dict:
    """`cvt_tpu`'s ArcFace parameters ({'layers': [{'w': [din, dout],
    'b': [dout]}, ...], 'head': [E, C]}, e.g. `jax.tree.map(np.asarray,
    state.params)`) -> the port's parameter dict, the same layout (used as
    `x @ w + b`), float32 on `device`. `train.state_from_params` makes a
    training state of it."""
    dev = resolve_device(device)

    def put(a):
        return torch.tensor(np.array(a, np.float32), device=dev)
    return {"layers": [{"w": put(lyr["w"]), "b": put(lyr["b"])}
                       for lyr in params["layers"]],
            "head": put(params["head"])}
