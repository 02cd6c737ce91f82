"""Hand-written CUDA kernels (sources in `cvt_tpu_torch/csrc/`), their
wrappers and their plain PyTorch twins.

Each kernel is one `Kernel`, declared once in its module by `kernel(...)`
over its launch on the card: its name, its C symbol and that symbol's
argument types, its twin and its comparison against the twin. A call
keeps the port's rule in one place: tensors on the CPU run the twin,
tensors on the card launch the kernel, any other device raises
ValueError, and nothing falls back from one to the other.

Here too: each kernel's launch count (`launch_counts`), the arguments a
call hands a kernel (`recorded_args`), and a kernel held against its twin
on them (`twin_check`)."""

import contextlib
import ctypes
import functools
import inspect

import torch

from cvt_tpu_torch.ops.kernels import _build
from cvt_tpu_torch.utils.profile import span

# the letters of a C signature in a kernel's declaration
CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
_NO_SPAN = contextlib.nullcontext()


class Kernel:
    """A hand-written kernel behind its wrapper: `kernel(...)` makes one of
    the function it decorates, the kernel's launch on the card.

    A call binds its arguments to the twin's parameters (defaults filled
    in), appends them to `.recorded` while that is a list, runs `check`
    where one is given, then the twin when the `device` argument lies on
    the CPU or the launch body, in that card's device context, when it
    lies on the card; any other device raises ValueError. With a `span`
    name, the whole call is one span of that name. The body ends in
    `launch`, which calls the C symbol with the current stream last,
    raises on a CUDA error and counts one launch in `.launches`. Each of
    `counts` is a further counter, moved on every call that returns by
    its function of the call's output and arguments, `n(out, *args)`: an
    int, or a 0-d tensor summed where it lies, so that a count the card
    holds costs no host sync until `counters()` reads it."""

    def __init__(self, body, name: str, *, symbol: str, args: str, twin,
                 compare, span: str | None = None, device: str | None = None,
                 check=None, counts: dict | None = None):
        functools.update_wrapper(self, body)
        self.name, self.symbol, self.twin, self.compare = (name, symbol,
                                                           twin, compare)
        self.argtypes = [CTYPES[c] for c in args.replace(" ", "")]
        self.body, self.span, self.check = body, span, check
        self.counts = counts or {}
        self._sig = inspect.signature(twin)
        self._device = list(self._sig.parameters).index(device) \
            if device else 0
        self.launches = 0
        self.recorded = None
        for c in self.counts:
            setattr(self, c, 0)

    def counters(self) -> dict:
        """Every counter of the kernel and its value, an int."""
        return {c: int(getattr(self, c)) for c in ("launches",
                                                   *self.counts)}

    def __call__(self, *args, **kwargs):
        call = self._sig.bind(*args, **kwargs)
        call.apply_defaults()
        args = call.args
        with span(self.span) if self.span else _NO_SPAN:
            if self.recorded is not None:
                self.recorded.append(args)
            if self.check is not None:
                self.check(*args)
            dev = args[self._device].device
            if dev.type == "cpu":
                out = self.twin(*args)
            elif dev.type == "cuda":
                with torch.cuda.device(dev):
                    out = self.body(*args)
            else:
                raise ValueError(f"no {self.name} kernel for {dev}")
        for c, n in self.counts.items():
            setattr(self, c, getattr(self, c) + n(out, *args))
        return out

    def launch(self, *args) -> None:
        """Call the C symbol on `args` and the current stream; the argument
        types are set on the loaded function the first time it is used."""
        lib = _build.load()
        fn = getattr(lib, self.symbol)
        if fn.argtypes is None:
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        _build.check(lib, fn(*args, torch.cuda.current_stream().cuda_stream),
                     self.__name__)
        self.launches += 1


def kernel(name: str, **declared):
    """Decorator: the function below is kernel `name`'s launch on the card
    (`Kernel` takes the rest of the declaration)."""
    return lambda body: Kernel(body, name, **declared)


def wrappers() -> dict:
    """Each kernel's name and its wrapper."""
    from cvt_tpu_torch.ops.kernels import (adc_scan, ivf_scan, vocab_coarse,
                                           vocab_descend, vocab_match,
                                           vocab_score)
    return {k.name: k for k in (
        adc_scan.adc_segmin, adc_scan.adc_segmin_cached,
        ivf_scan.ivf_pages_segmin, ivf_scan.ivf_rescore,
        vocab_score.vocab_score, vocab_descend.vocab_descend,
        vocab_coarse.vocab_coarse, vocab_match.vocab_match)}


def launch_counts() -> dict:
    """The launches each kernel wrapper has counted (`.launches`) since its
    count was last set to 0."""
    return {name: w.launches for name, w in wrappers().items()}


def zero_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for w in wrappers().values():
        w.launches = 0


def recorded_args(name: str, call) -> tuple:
    """The positional arguments of the first call of kernel `name`'s
    wrapper inside call(), which runs as it would (the wrapper itself runs
    and counts its launches)."""
    w = wrappers()[name]
    w.recorded = []
    try:
        call()
        seen = w.recorded
    finally:
        w.recorded = None
    if not seen:
        raise RuntimeError(f"the call never reached the {name} wrapper")
    return seen[0]


def twin_check(name: str, args: tuple) -> dict:
    """Kernel `name` against its twin on `args` (a call's own, as
    `recorded_args` gives them), by the kernel's own comparison; raises on
    a difference. The comparison's calls are not the path's, so every
    counter of the kernel is left as it was."""
    w = wrappers()[name]
    counters = w.counters()
    try:
        return w.compare(args)
    finally:
        for c, n in counters.items():
            setattr(w, c, n)
