"""The segment-size-generic ADC twins held against cvt_tpu's Pallas
kernels (interpret=True on the CPU) at seg 128, 64, 32, 16 and 8.

The sharded searcher and the server halve the segment size while a shard
holds fewer than k segments, so every seg must give `cvt_tpu`'s keys.
Tolerance: bitwise for segpack and tiletop rows 0-3 (rows 4-7 are padding
the TPU kernel never writes). s2 comes from {1/4, 1/2, 1, 2}, where every
partial sum of the float32 norm is exact in any order, and the test first
asserts that no row's norm/qs lies within 1e-4 of a half-integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.ops.pallas import adc_scan as J
from cvt_tpu_torch.ops.kernels import adc_scan as T

t = torch.from_numpy
M, K, DS = 8, 32, 8
D = M * DS
NPAD = 2048


def _half_gap(norm, qs) -> float:
    x = np.asarray(norm, np.float64) / float(qs)
    return float(np.min(np.abs(x - np.floor(x) - 0.5)))


@pytest.fixture(scope="module")
def inputs():
    for seed in range(100):
        rng = np.random.default_rng(seed)
        cb = rng.normal(0, 20, size=(M, K, DS)).astype(np.float32)
        q = rng.normal(0, 50, size=(40, D)).astype(np.float32)
        codes = rng.integers(0, K, size=(NPAD, M)).astype(np.uint8)
        s2 = rng.choice(np.array([0.25, 0.5, 1.0, 2.0], np.float32), size=D)
        cb_q, srow = T._quantize_codebooks(t(cb))
        tq2s, tqs = T._fold_queries(t(q), srow)
        dec = T.decode_int8(t(codes), cb_q).numpy().astype(np.float64)
        if _half_gap(dec ** 2 @ s2, tqs) > 1e-4:
            break
    q2s, qs = J._fold_queries(jnp.asarray(q), jnp.asarray(srow.numpy()))
    np.testing.assert_array_equal(tq2s.numpy(), np.asarray(q2s))
    cbt, _, group = J._group_codebooks(cb)
    return dict(codes=codes, s2=s2, cb_q=cb_q, cbt=cbt, group=group,
                q2s=q2s, qs=qs, tq2s=tq2s, tqs=tqs)


@pytest.mark.parametrize("seg", [128, 64, 32, 16, 8])
@pytest.mark.parametrize("tile_n,n_valid", [(256, 1900), (128, 2048)])
def test_segmin_twin_matches_pallas_at_each_seg(inputs, seg, tile_n,
                                                n_valid):
    x = inputs
    sp, tt = J._adc_segmin(x["q2s"], x["qs"],
                           jnp.asarray(x["codes"].astype(np.int32).T),
                           x["cbt"], jnp.asarray(x["s2"][:, None]), n_valid,
                           tile_n, seg, x["group"], True)
    tsp, ttt = T.adc_segmin(x["tq2s"], x["tqs"], t(x["codes"]), x["cb_q"],
                            t(x["s2"]), n_valid, tile_n, seg)
    assert tsp.shape == (NPAD // seg, 128)
    np.testing.assert_array_equal(tsp.numpy(), np.asarray(sp))
    np.testing.assert_array_equal(ttt[:, :4].numpy(), np.asarray(tt)[:, :4])


@pytest.mark.parametrize("seg", [32, 8])
def test_segmin_cached_twin_matches_pallas_at_seg(inputs, seg):
    x = inputs
    dec = T.decode_int8(t(x["codes"]), x["cb_q"])
    norm = (dec.double() ** 2 @ t(x["s2"]).double()).float()[:, None]
    sp, tt = J._adc_segmin_cached(x["q2s"], x["qs"],
                                  jnp.asarray(dec.T.contiguous().numpy()),
                                  jnp.asarray(norm.numpy()), 1500, 256, seg,
                                  True)
    tsp, ttt = T.adc_segmin_cached(x["tq2s"], x["tqs"], dec.T.contiguous(),
                                   norm, 1500, 256, seg)
    np.testing.assert_array_equal(tsp.numpy(), np.asarray(sp))
    np.testing.assert_array_equal(ttt[:, :4].numpy(), np.asarray(tt)[:, :4])


def test_seg_outside_the_built_set_is_refused(inputs):
    x = inputs
    with pytest.raises(ValueError):
        T.adc_segmin(x["tq2s"], x["tqs"], t(x["codes"]), x["cb_q"],
                     t(x["s2"]), 2048, 256, 4)
    with pytest.raises(ValueError):
        T.adc_segmin(x["tq2s"], x["tqs"], t(x["codes"]), x["cb_q"],
                     t(x["s2"]), 2048, 64, 128)
