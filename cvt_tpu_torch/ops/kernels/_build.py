"""Build the CUDA sources under `csrc/` with nvcc and load them by ctypes.

The library has a plain C interface (no PyTorch headers), so nvcc builds
it in seconds: one compiler process per source, all started together,
then one link. It is built for sm_90a (Hopper) on first use
into `cvt_tpu_torch/_build/` (git-ignored), under a name that carries a
hash of the sources, so an edited source is never served by a stale
library. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures of csrc/*.cu, declared so that ctypes never passes a
# pointer as a 32-bit int
_SIGNATURES = {
    # codes, cb_q, q2s, s2, qs, npad, m, k_sub, ds, bpad, n_valid,
    # tile_n, seg, vcap, ibase, segpack, tiletop, stream
    "cvt_adc_segmin": [_P, _P, _P, _P, _P] + [_I] * 10 + [_P, _P, _P],
    # dec8_t, norm_col, q2s, qs, npad, d, bpad, n_valid, tile_n, seg,
    # vcap, ibase, segpack, tiletop, stream
    "cvt_adc_segmin_cached": [_P, _P, _P, _P] + [_I] * 8 + [_P, _P, _P],
    # sel, qs, dec8_t, nrm_col, cip, q2s, n_sel, n_rows, d, bpad, lp, seg,
    # marker, segpack, stream
    "cvt_ivf_pages_segmin": [_P] * 6 + [_I] * 7 + [_P, _P],
}


def _sources() -> list[str]:
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    nvcc = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path() -> str:
    h = hashlib.sha1()
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libcvt_kernels_{h.hexdigest()[:12]}.so")


def _run_all(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; raise on the first that fails.
    Returns each command's line and output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        logs.append(" ".join(cmd) + "\n" + out)
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    return logs


def build() -> str:
    """Compile csrc/*.cu into the build directory unless this exact
    source set is already built: each source to an object file, all at
    once, then one shared library. Returns the library's path; the
    compiler's register/shared-memory report is kept beside it (`.log`)."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        srcs = [s for s in _sources() if s.endswith(".cu")]
        objs = [os.path.join(tmp_dir, os.path.basename(s)[:-3] + ".o")
                for s in srcs]
        logs = _run_all([[nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c",
                          "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", o, s]
                         for s, o in zip(srcs, objs)])
        tmp = os.path.join(tmp_dir, "lib.so")
        logs += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        with open(out[:-3] + ".log", "w") as f:
            f.write("".join(logs))
        os.replace(tmp, out)     # atomic: concurrent builds race safely
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C
    function's argument types declared."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cvt_error_string.argtypes = [ctypes.c_int]
    lib.cvt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        msg = lib.cvt_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
