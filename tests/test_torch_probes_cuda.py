"""The ADC probe's new kernel shapes on the card (marker `cuda`, skipped
without one): `adc_segmin` at B 16,384 and at tile 4,096, with the probe's
own data (`probes.adc.data`, seed 0) at Npad 65,536 (N 64,536, so the last
tile is partly valid), bitwise against its plain twin on the arguments the
probe's phase 1 hands the wrapper. The file imports no JAX, so it runs
with --noconftest where JAX is not installed."""

import pytest
import torch

from cvt_tpu_torch.ops.kernels import adc_scan as T
from cvt_tpu_torch.ops.kernels import recorded_args
from cvt_tpu_torch.probes import adc

N = 65_536 - 1000


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,tile,fold", [
    (16384, None, adc.search_fold),      # the search's tile, 2,048
    (4096, 4096, T._fold_queries),
    (16384, 4096, T._fold_queries)])
def test_adc_segmin_bitwise_at_the_probe_shapes(card, b, tile, fold):
    x = adc.data(N, adc.D, (b,), 1, card)
    assert x["npad"] == 65_536
    fn, tile_n = adc.phase1(x, N, tile, fold)
    args = recorded_args("adc_segmin", lambda: fn(x["stacks"][0][0]))
    assert args[0].shape == (b, adc.D) and args[6] == tile_n
    got, want = T.adc_segmin(*args), T.adc_segmin_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
