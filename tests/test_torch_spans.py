"""The port's stage spans (`utils.profile.span`) on the CPU at small
shapes: the kind of range a span records and how it nests, the shared
no-op with no profiler running, the span names of the flat search's three
lanes and of `search_fast`, nested under their outermost span, the kernel
layer's own names under another caller, and answers bitwise equal with
and without a profiler."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cvt_tpu_torch.index.flat_adc import FlatADCIndex
from cvt_tpu_torch.index.flat_sq import FlatSQIndex
from cvt_tpu_torch.index.ivf_adc import IVFADCIndex
from cvt_tpu_torch.quant.opq import OPQ
from cvt_tpu_torch.quant.pq import ProductQuantizer
from cvt_tpu_torch.quant.sq import ScalarQuantizer
from cvt_tpu_torch.utils import profile as uprofile
from cvt_tpu_torch.utils import span

PORT = ("flat.", "ivf.", "adc.", "kernel.")
FLAT = {"flat.search", "flat.stage_in", "flat.prep", "adc.prep",
        "adc.select"}
IVF = {"ivf.search", "ivf.stage_in", "ivf.probe", "ivf.coarse_terms",
       "ivf.fold", "kernel.ivf_page", "ivf.rescore", "ivf.select"}


def _events(prof):
    return list(prof.profiler.kineto_results.events())


def _spans(prof):
    """Port spans as (name, start_ns, end_ns), in order of start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in _events(prof) if e.name().startswith(PORT)]
    return sorted(out, key=lambda s: s[1])


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _data(n, d, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, d), generator=g) * 255.0


def _flat(n=4096, d=32, m=8, k=16):
    g = torch.Generator().manual_seed(1)
    rot, _ = torch.linalg.qr(torch.randn((d, d), generator=g))
    cb = torch.rand((m, k, d // m), generator=g) * 255.0
    idx = FlatADCIndex(OPQ(rot, ProductQuantizer(cb)), impl="kernel",
                       device="cpu")
    idx.add(_data(n, d, 2))
    return idx


def _ivf(n=4096, d=32, m=8, k=16, coarse_k=16):
    g = torch.Generator().manual_seed(3)
    base = _data(n, d, 4)
    idx = IVFADCIndex(coarse_k=coarse_k, m=m, k=k, device="cpu")
    idx.centroids = base[torch.randperm(n, generator=g)[:coarse_k]].clone()
    idx.pq = ProductQuantizer(torch.randn((m, k, d // m), generator=g) * 8.0)
    idx.build(base)
    return idx


def test_span_is_a_function_scope_host_range_that_nests():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("t.outer"):
            torch.ones(4).sum()
            with span("t.inner"):
                torch.ones(4).mul(2)
    got = {e.name(): e for e in _events(prof)
           if e.name() in ("t.outer", "t.inner")}
    assert set(got) == {"t.outer", "t.inner"}
    for e in got.values():
        # scope 0 is an aten operator's; record_function's is 7
        assert e.scope() == 0 and not e.is_user_annotation()
        assert e.device_type() == torch.autograd.DeviceType.CPU
    outer, inner = got["t.outer"], got["t.inner"]
    assert outer.start_ns() <= inner.start_ns()
    assert (inner.start_ns() + inner.duration_ns()
            <= outer.start_ns() + outer.duration_ns())


def test_span_without_a_profiler_is_the_shared_noop():
    off = span("t.off")
    assert off is span("t.other") is uprofile._OFF
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with off:              # made while no profiler ran: records nothing
            torch.ones(4).sum()
        assert span("t.on") is not off
    names = {e.name() for e in _events(prof)}
    assert "t.off" not in names and "aten::sum" in names
    assert span("t.after") is off


def _nested_under(spans, outer):
    (top,) = [s for s in spans if s[0] == outer]
    for name, s, e in spans:
        assert top[1] <= s and e <= top[2], (name, outer)


@pytest.mark.parametrize("lane", ["fast", "exact", "cached"])
def test_flat_search_spans(lane):
    idx = _flat()
    if lane == "cached":
        idx.build_decoded_cache()
    q = _data(64, 32, 5).numpy()
    _, spans = _traced(lambda: idx.search(q, 10, exact=lane == "exact"))
    kernel = ("kernel.adc_segmin_cached" if lane == "cached"
              else "kernel.adc_segmin")
    assert {s[0] for s in spans} == FLAT | {kernel}
    assert sum(s[0] == "flat.search" for s in spans) == 1
    _nested_under(spans, "flat.search")
    order = [s[0] for s in spans]
    assert order.index("flat.stage_in") < order.index("adc.prep") \
        < order.index(kernel) < order.index("adc.select")


def test_search_fast_spans():
    idx = _ivf()
    q = _data(64, 32, 6).numpy()
    _, spans = _traced(lambda: idx.search_fast(q, 10, nprobe=4))
    assert {s[0] for s in spans} == IVF
    assert len(spans) == len(IVF)
    _nested_under(spans, "ivf.search")
    assert [s[0] for s in spans] == [
        "ivf.search", "ivf.stage_in", "ivf.probe", "ivf.coarse_terms",
        "ivf.fold", "kernel.ivf_page", "ivf.rescore", "ivf.select"]


def test_answers_equal_with_and_without_a_profiler():
    flat, ivf = _flat(), _ivf()
    q = _data(64, 32, 7).numpy()
    runs = [lambda: flat.search(q, 10),
            lambda: flat.search(q, 10, exact=True),
            lambda: ivf.search_fast(q, 10, nprobe=4)]
    for run in runs:
        plain = run()
        traced, spans = _traced(run)
        assert spans
        for a, b in zip(plain, traced):
            assert torch.equal(a, b)
    flat.build_decoded_cache()
    plain = flat.search(q, 10)
    traced, _ = _traced(lambda: flat.search(q, 10))
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


def test_kernel_search_spans_under_another_index():
    """`FlatSQIndex.search_fast` runs the same kernel search: its stages
    carry the kernel layer's names, and no flat index's."""
    g = torch.Generator().manual_seed(8)
    base = torch.randn((2048, 32), generator=g)
    idx = FlatSQIndex(ScalarQuantizer.train(base, device="cpu"))
    idx.add(base)
    q = torch.randn((16, 32), generator=g)
    plain = idx.search_fast(q, 5)
    traced, spans = _traced(lambda: idx.search_fast(q, 5))
    assert [s[0] for s in spans] == [
        "adc.prep", "kernel.adc_segmin_cached", "adc.select"]
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
