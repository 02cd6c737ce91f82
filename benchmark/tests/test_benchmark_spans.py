"""The readers of the port's spans (benchmark/spans.py and the five
metrics on it) on synthetic traces: launch calls paired with device
operations in order, each operation given to the innermost port span
around its call, the caller's operations left out, a count mismatch read
as nothing, idle time inside and outside the search spans, the division
by batches; then a traced run on the CPU in which every new reader gives
a number or nothing."""

from types import SimpleNamespace

import pytest

from conftest import ROOT, TINY
from benchmark import harness, spans
from benchmark.trace import Event, idle_pct

REG = harness.Registry(ROOT)
NEW = ("search_host_ms.batch", "search_idle_pct.batch",
       "search_launches.batch", "select_ms.batch", "probe_ms.batch")


def _host(name, s, e):
    return Event(name, False, float(s), float(e))


def _dev(name, s, e):
    return Event(name, True, float(s), float(e))


def _flat_batch(t):
    """One flat batch at time t: the search span [t, t+30) and, after it,
    the caller's copy of the answers to the host."""
    return [
        _host("flat.search", t, t + 30),
        _host("flat.prep", t + 1, t + 10),
        _host("flat.stage_in", t + 1, t + 3),
        _host("cudaMemcpyAsync", t + 2, t + 2.5),
        _dev("Memcpy HtoD (Pageable -> Device)", t + 4, t + 6),
        _host("aten::mul", t + 4, t + 6),
        _host("cudaLaunchKernel", t + 5, t + 5.5),
        _dev("elementwise_kernel<mul>", t + 7, t + 9),
        _host("kernel.adc_segmin", t + 10, t + 15),
        _host("cudaLaunchKernel", t + 11, t + 11.5),
        _dev("adc_segmin_kernel<128, 3>", t + 12, t + 20),
        _host("cudaLaunchKernel", t + 13, t + 13.5),
        _dev("tiletop_kernel", t + 20, t + 21),
        _host("adc.select", t + 16, t + 29),
        _host("cudaLaunchKernel", t + 17, t + 17.5),
        _dev("radixSortKVInPlace", t + 21, t + 23),
        _host("cudaStreamSynchronize", t + 25, t + 28),
        _host("cudaMemcpyAsync", t + 31, t + 31.5),
        _dev("Memcpy DtoH (Device -> Pageable)", t + 32, t + 33),
    ]


def _ctx(events, calls=2, bounds=(0.0, 100.0)):
    return SimpleNamespace(events=events, slice=bounds, traced_calls=calls)


def _trace():
    return ([_host("bench.slice", 0, 100)] + _flat_batch(10)
            + _flat_batch(50))


def test_operations_go_to_the_innermost_span_around_their_call():
    got = spans.split(_trace(), (0.0, 100.0))
    assert got.ops == 12 and got.batches == 2
    assert got.device_s == pytest.approx({
        "flat.stage_in": 4.0,           # the copy in, under flat.prep too
        "flat.prep": 4.0,
        "kernel.adc_segmin": 18.0,      # both of the wrapper's kernels
        "adc.select": 4.0,
        None: 2.0})                     # the caller's copies out
    assert "flat.search" not in got.device_s
    assert got.names == {"flat.search", "flat.prep", "flat.stage_in",
                         "kernel.adc_segmin", "adc.select"}


def test_the_callers_operations_stay_unattributed():
    ev = _trace() + [_host("cudaLaunchKernel", 90, 90.5),
                     _dev("elementwise_kernel<add>", 91, 92)]
    got = spans.split(ev, (0.0, 100.0))
    assert got.device_s[None] == pytest.approx(3.0)
    # the caller's launches are not the search's
    assert got.launches == 2 * 5
    assert REG.reader("search_launches.batch").read(_ctx(ev)) == 5.0


def test_attributed_and_callers_time_make_the_slices_device_time():
    from benchmark.trace import op_seconds
    ev = _trace()
    got = spans.split(ev, (0.0, 100.0))
    assert sum(got.device_s.values()) == pytest.approx(
        sum(op_seconds(ev, 0.0, 100.0).values()))


def test_operations_the_profiler_lost_at_the_start_stay_unpaired():
    # the first batch's copy in and first kernel have no device record
    lost = {("Memcpy HtoD (Pageable -> Device)", 14.0),
            ("elementwise_kernel<mul>", 17.0)}
    ev = [e for e in _trace() if (e.name, e.start) not in lost]
    got = spans.split(ev, (0.0, 100.0))
    assert got.unpaired == 2 and got.ops == 10
    assert got.device_s == pytest.approx({
        "flat.stage_in": 2.0, "flat.prep": 2.0, "kernel.adc_segmin": 18.0,
        "adc.select": 4.0, None: 2.0})
    assert got.launches == 10                # calls are counted, not ops
    assert REG.reader("search_launches.batch").read(_ctx(ev)) == 5.0


def test_a_pairing_out_of_kind_reads_as_nothing():
    # a copy lost in the middle shifts every earlier pair out of kind
    ev = [e for e in _trace() if (e.name, e.start) !=
          ("Memcpy HtoD (Pageable -> Device)", 54.0)]
    assert spans.split(ev, (0.0, 100.0)) is None


@pytest.mark.parametrize("drift", [-7.0, 5.0])
def test_device_clock_drift_moves_no_reading(drift):
    """The second batch's device stamps run `drift` off the host's (an
    operation may then seem to start before its call): each batch is
    moved back by its least call-to-start delay, so the idle time inside
    the search spans, like every other reading, stays as without drift."""
    ev = [Event(e.name, True, e.start + drift, e.end + drift)
          if e.device and e.start >= 50 else e for e in _trace()]
    got, want = spans.split(ev, (0.0, 100.0)), spans.split(_trace(),
                                                           (0.0, 100.0))
    assert got.idle_s == pytest.approx(want.idle_s) == pytest.approx(30.0)
    assert got.caller_idle_s == pytest.approx(want.caller_idle_s) \
        == pytest.approx(38.0)
    assert got.device_s == pytest.approx(want.device_s)
    assert (got.launches, got.host_s) == (want.launches, want.host_s)


@pytest.mark.parametrize("extra", [
    _host("cudaLaunchKernel", 95, 95.5),          # a call without its op
    _dev("elementwise_kernel<add>", 95, 96)])     # an op without its call
def test_a_count_mismatch_reads_as_nothing(extra):
    ev = _trace() + [extra]
    assert spans.split(ev, (0.0, 100.0)) is None
    for name in NEW:
        assert REG.reader(name).read(_ctx(ev)) is None, name


def test_idle_time_inside_and_outside_the_search_spans():
    ev = _trace()
    # per batch, inside [t, t+30): idle [t, t+4), [t+6, t+7), [t+9, t+12),
    # [t+23, t+30) = 15; outside it the caller's copy takes 1 of 10
    got = spans.split(ev, (0.0, 100.0))
    assert got.idle_s == pytest.approx(30.0)
    inside = REG.reader("search_idle_pct.batch").read(_ctx(ev))
    assert inside == pytest.approx(30.0)
    assert got.caller_idle_s == pytest.approx(38.0)
    # with no drift, the host clock's idle share is the device stamps'
    assert 100.0 * got.idle_all_s / got.window_s == pytest.approx(
        idle_pct(ev, (0.0, 100.0))) == pytest.approx(100.0 - 2 * 16.0)


def test_per_batch_readings():
    ev = _trace()
    read = {n: REG.reader(n).read(_ctx(ev)) for n in NEW}
    assert read["search_host_ms.batch"] == pytest.approx(1e3 * 30.0)
    assert read["search_launches.batch"] == 5.0
    assert read["select_ms.batch"] == pytest.approx(1e3 * 2.0)
    assert read["probe_ms.batch"] is None          # no IVF span ran
    # three batches' worth of calls against two search spans: nothing
    for name in NEW:
        assert REG.reader(name).read(_ctx(ev, calls=3)) is None, name


def test_ivf_stages_and_nested_searches():
    t = 10
    ev = [_host("bench.slice", 0, 100),
          _host("ivf.search", t, t + 40),
          _host("ivf.probe", t + 1, t + 5),
          _host("cudaLaunchKernel", t + 2, t + 2.1),
          _dev("gemm", t + 3, t + 6),
          _host("ivf.coarse_terms", t + 5, t + 8),
          _host("cudaLaunchKernel", t + 6, t + 6.1),
          _dev("gather", t + 6, t + 7),
          _host("kernel.ivf_page", t + 8, t + 10),
          _host("cudaLaunchKernel", t + 9, t + 9.1),
          _dev("ivf_page_kernel<32, 3>", t + 9, t + 20),
          _host("ivf.rescore", t + 10, t + 30),
          _host("cudaLaunchKernel", t + 11, t + 11.1),
          _dev("computeBlockDigitCounts", t + 20, t + 25),
          _host("ivf.select", t + 30, t + 39),
          _host("cudaLaunchKernel", t + 31, t + 31.1),
          _dev("sort", t + 31, t + 32),
          # a search inside a search is not another batch
          _host("flat.search", t + 33, t + 34)]
    ctx = _ctx(ev, calls=1)
    assert REG.reader("probe_ms.batch").read(ctx) == pytest.approx(4e3)
    assert REG.reader("select_ms.batch").read(ctx) == pytest.approx(6e3)
    assert REG.reader("search_host_ms.batch").read(ctx) == \
        pytest.approx(40e3)


def test_readers_report_nothing_without_spans():
    # an older program: the same trace with no port span in it
    ev = [e for e in _trace() if not e.name.startswith(spans.PREFIXES)]
    for name in NEW:
        assert REG.reader(name).read(_ctx(ev)) is None, name
    for name in NEW:
        assert REG.reader(name).read(_ctx(ev, bounds=None)) is None, name


def test_the_readers_of_a_run_share_one_split(monkeypatch):
    made = []
    plain = spans.split

    def counted(events, bounds):
        made.append(bounds)
        return plain(events, bounds)

    monkeypatch.setattr(spans, "split", counted)
    ctx = _ctx(_trace())
    read = [REG.reader(n).read(ctx) for n in NEW]
    assert len(made) == 1 and read[0] == pytest.approx(1e3 * 30.0)
    # a count that does not match is kept too, as nothing
    ctx = _ctx(_trace(), calls=3)
    assert [REG.reader(n).read(ctx) for n in NEW] == [None] * len(NEW)
    assert len(made) == 2


@pytest.mark.parametrize("cell", ["sift1m-opq8.b256",
                                  "sift1m-ivf8192-pq16.b4096-np16"])
def test_a_traced_cpu_run_reads_each_new_metric_or_nothing(cell):
    result, _ = harness.run_cell(cell, 2 ** 31 + 7, 2.0, True,
                                 device="cpu", overrides=TINY)
    assert result["correct"], result["checks"]
    listed = {m["name"] for m in REG.metrics(cell, "per_layer")}
    for name in NEW:
        if name in listed and name in result["metrics"]:
            value = result["metrics"][name]["value"]
            assert isinstance(value, float) and value >= 0.0, name
    # where a slice was traced, its spans are found: each search is one
    # traced call
    if "device_idle_pct.batch" in result["metrics"]:
        assert "search_launches.batch" in result["metrics"]


def test_stage_table_of_a_traced_cpu_run():
    from benchmark import stages
    result, tracer = stages.traced_run("sift1m-ivf8192-pq16.b4096-np16",
                                       2 ** 31 + 11, 2.0, device="cpu",
                                       overrides=TINY)
    events = tracer.events()
    from benchmark.trace import window
    rows = stages.table(events, window(events), tracer.calls)
    assert set(rows) == {"ivf.search", "ivf.stage_in", "ivf.probe",
                         "ivf.coarse_terms", "ivf.fold", "kernel.ivf_page",
                         "ivf.rescore", "ivf.select", "(caller)"}
    top = rows["ivf.search"]
    inner = sum(r["host_ms"] for n, r in rows.items()
                if n not in ("ivf.search", "(caller)"))
    # the outermost span's own time is what its stages leave
    assert top["self_ms"] == pytest.approx(top["host_ms"] - inner)
    assert all(r["self_ms"] >= 0 for n, r in rows.items() if n[0] != "(")
    assert stages.table(events, window(events), tracer.calls + 1) is None


def test_stage_table_by_hand():
    from benchmark import stages
    rows = stages.table(_trace(), (0.0, 100.0), 2)
    assert rows["flat.search"] == pytest.approx(
        {"device_ms": 0.0, "host_ms": 30e3, "self_ms": 30e3 - 9e3 - 5e3
         - 13e3, "idle_pct": 30.0})
    assert rows["flat.prep"] == pytest.approx(
        {"device_ms": 2e3, "host_ms": 9e3, "self_ms": 7e3})
    assert rows["(caller)"] == pytest.approx({"device_ms": 1e3,
                                              "idle_pct": 38.0})
