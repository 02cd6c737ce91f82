"""The kernel layer's one dispatch (`ops.kernels.Kernel`), for each of the
hand-written kernels, on the CPU with no card and no nvcc:

(a) `wrappers()` holds exactly the kernels' names;
(b) each kernel's declared C arguments are those of its `extern "C"`
    definition in csrc/*.cu, read from the source text;
(c) a call on the CPU runs the twin and equals it, counts no launch,
    moves its other counters by the call's own, and appends its
    arguments (defaults filled in) while `.recorded` is a list;
(d) a tensor on any other device raises ValueError and counts nothing;
(e) `twin_check` runs the kernel's own comparison and leaves every counter
    as it was.

Adding a kernel adds its name to NAMES and its arguments to ARGS."""

import glob
import importlib
import inspect
import os
import re

import numpy as np
import pytest
import torch

from cvt_tpu_torch.ops.kernels import CTYPES, _build, twin_check, wrappers
from _ivf_rescore_inputs import positional, rescore_args

K = importlib.import_module("cvt_tpu_torch.ops.kmeans")

NAMES = ["adc_segmin", "adc_segmin_cached", "ivf_page", "ivf_rescore",
         "vocab_score", "vocab_descend", "vocab_coarse", "vocab_match"]


def _ints(g, lo, hi, shape, dtype):
    return torch.randint(lo, hi, shape, generator=g, dtype=dtype)


def _adc_segmin(g):
    return (_ints(g, -127, 128, (128, 128), torch.int8), torch.ones(1),
            _ints(g, 0, 16, (1024, 16), torch.uint8),
            _ints(g, -127, 128, (16, 16, 8), torch.int8),
            torch.rand(128, generator=g), 1000, 512, 64)


def _adc_segmin_cached(g):
    return (_ints(g, -127, 128, (128, 64), torch.int8), torch.ones(1),
            _ints(g, -127, 128, (64, 2048), torch.int8),
            torch.rand((2048, 1), generator=g) * 1e5, 2000, 1024, 128)


def _ivf_page(g):
    lp, seg, bpad, d, n_pages, sel = 512, 32, 128, 64, 4, [2, 0, 3]
    return (_ints(g, -127, 128, (bpad, d), torch.int8), torch.ones(1),
            _ints(g, -127, 128, (d, n_pages * lp), torch.int8),
            torch.rand((n_pages * lp, 1), generator=g) * 1e5,
            torch.rand((len(sel) * lp // seg, bpad), generator=g) * 1e5,
            torch.tensor(sel, dtype=torch.int32), lp, seg,
            torch.tensor([2], dtype=torch.int32))


def _ivf_rescore(g):
    return positional(rescore_args(4, 3, 4, 16, 8, 2, kc=6, seed=6), 16, 10,
                      6, True)


def _vocab_score(g):
    n_words, n_entries, n_feat, max_dist = 8, 40, 12, 24
    e_word = _ints(g, 0, n_words, (n_entries,), torch.int64).sort().values
    offsets = torch.searchsorted(e_word, torch.arange(n_words + 1))
    f_word = _ints(g, -1, n_words, (n_feat,), torch.int32)
    sig = lambda n: _ints(g, 0, 16, (n,), torch.int64)   # few bits apart
    h = torch.arange(max_dist + 1, dtype=torch.float32)
    return (f_word, sig(n_feat), _ints(g, 0, 3, (n_feat,), torch.int32),
            offsets, _ints(g, 0, 5, (n_entries,), torch.int32),
            sig(n_entries), torch.rand(n_entries, generator=g),
            torch.rand(n_words, generator=g), torch.exp(-h * h / 256.0), 3, 5)


def _vocab_descend(g):
    k1, k2, d, t, probes = 4, 128, 16, 40, 2
    words = _ints(g, 0, 256, (k1, k2, d), torch.uint8)
    cells = _ints(g, 0, k1, (t, probes), torch.int64)
    order, tc, r0, cnt = K._pair_tiles(cells, k1)
    tiles = torch.from_numpy(np.stack([tc, r0, cnt], 1).astype(np.int32))
    return (_ints(g, 0, 256, (t, d), torch.uint8), order, tiles, words,
            (words.int() ** 2).sum(-1).int(), probes)


def _vocab_coarse(g):
    return (torch.randn((40, 16), generator=g) * 10,
            torch.randn((20, 16), generator=g) * 10, 3)


def _vocab_match(g):
    n_words, n_entries, n_feat, n_images = 8, 40, 12, 5
    e_word = _ints(g, 0, n_words, (n_entries,), torch.int64).sort().values
    offsets = torch.searchsorted(e_word, torch.arange(n_words + 1))
    sig = lambda n: _ints(g, 0, 16, (n,), torch.int64)   # few bits apart
    cand = torch.full((3, n_images), -1, dtype=torch.int32)
    cand[:, 1:4] = torch.arange(9, dtype=torch.int32).reshape(3, 3)
    return (_ints(g, -1, n_words, (n_feat,), torch.int32), sig(n_feat),
            _ints(g, 0, 3, (n_feat,), torch.int32), offsets,
            _ints(g, 0, n_images, (n_entries,), torch.int32),
            sig(n_entries), torch.randperm(n_entries, generator=g).int(),
            cand, 2, 64)


ARGS = {"adc_segmin": _adc_segmin, "adc_segmin_cached": _adc_segmin_cached,
        "ivf_page": _ivf_page, "ivf_rescore": _ivf_rescore,
        "vocab_score": _vocab_score, "vocab_descend": _vocab_descend,
        "vocab_coarse": _vocab_coarse, "vocab_match": _vocab_match}


def _args(name):
    return ARGS[name](torch.Generator().manual_seed(NAMES.index(name)))


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def test_wrappers_name_exactly_the_kernels():
    assert sorted(wrappers()) == sorted(NAMES)
    assert all(w.name == name for name, w in wrappers().items())


def _c_parameters(symbol: str) -> list[str]:
    """The parameters of `symbol`'s one definition inside an `extern "C"`
    block of csrc/*.cu."""
    found = []
    for path in glob.glob(os.path.join(_build.SRC_DIR, "*.cu")):
        with open(path) as f:
            text = f.read()
        for block in re.findall(r'extern "C" \{(.*?)\}  // extern "C"', text,
                                re.S):
            found += re.findall(rf"\bint\s+{symbol}\s*\(([^)]*)\)\s*\{{",
                                block)
    assert len(found) == 1, (symbol, len(found))
    return [" ".join(p.split()) for p in found[0].split(",")]


@pytest.mark.parametrize("name", NAMES)
def test_declared_c_arguments_match_the_source(name):
    """As many arguments as the C definition takes, each of its kind: a
    pointer as c_void_p, an int as c_int, a float as c_float."""
    w = wrappers()[name]
    kinds = []
    for p in _c_parameters(w.symbol):
        kinds.append("p" if "*" in p else p.split()[0][0])
    declared = [next(c for c, t in CTYPES.items() if t is a)
                for a in w.argtypes]
    assert declared == kinds, (w.symbol, "".join(declared), "".join(kinds))


@pytest.mark.parametrize("name", NAMES)
def test_cpu_call_runs_the_twin_and_records_its_arguments(name,
                                                          monkeypatch):
    """Positional, by keyword and with the last default left out: each
    call's record is every argument in order, the call's own objects."""
    def refuse():
        raise AssertionError("the CPU path must not load the kernels")
    monkeypatch.setattr(_build, "load", refuse)
    w = wrappers()[name]
    args = _args(name)
    sig = inspect.signature(w)
    assert list(sig.parameters) == list(inspect.signature(w.twin).parameters)
    default = list(sig.parameters.values())[-1].default
    want = [args, args]
    before = w.counters()
    w.recorded = []
    try:
        got = w(*args)
        w(**dict(zip(sig.parameters, args)))
        if default is not inspect.Parameter.empty:
            w(*args[:-1])
            want.append(args[:-1] + (default,))
        seen = w.recorded
    finally:
        w.recorded = None
    for a, b in zip(_outputs(got), _outputs(w.twin(*args)), strict=True):
        assert torch.equal(a, b)
    assert len(seen) == len(want)
    for s, x in zip(seen, want):
        assert len(s) == len(x)
        assert all(a is b or (not torch.is_tensor(a) and a == b)
                   for a, b in zip(s, x))
    moved = {c: before[c] + int(sum(n(w.twin(*x), *x) for x in want))
             for c, n in w.counts.items()}
    assert w.counters() == dict(before, **moved)


@pytest.mark.parametrize("name", NAMES)
def test_another_device_raises(name):
    w = wrappers()[name]
    args = tuple(a.to("meta") if torch.is_tensor(a) else a
                 for a in _args(name))
    before = w.counters()
    with pytest.raises(ValueError, match=f"no {name} kernel for meta"):
        w(*args)
    assert w.counters() == before


@pytest.mark.parametrize("name", NAMES)
def test_twin_check_leaves_every_counter(name, monkeypatch):
    w = wrappers()[name]
    for c in w.counters():
        monkeypatch.setattr(w, c, 7)
    out = twin_check(name, _args(name))
    assert out["max_abs_err"] == 0
    assert w.counters() == {c: 7 for c in w.counters()}
