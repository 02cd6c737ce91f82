"""Host-side native (C++) components of the port, built by path.

The device work is PyTorch and the CUDA kernels of `csrc/`; this package
holds the host-side C++ pieces the reference implements natively, each
a copy of `cvt_tpu`'s: the in-memory video decoder (`ffdecode.cc`,
libav*), the HNSW graph index (`hnsw.cc`, OpenMP) and the cvt record
stream reader / writer (`vecs_io.cc`). `load_library(name)` compiles
`<name>.cc` from this directory with $CXX (default g++), or with g++
where a $CXX that exists fails, into `cvt_tpu_torch/_build/lib<name>.so`
(git-ignored) on first use, again whenever the source is newer than the
library, and loads it with ctypes. A missing compiler, header or library raises
`NativeBuildError`; callers decide what to do without the component
(`io/video.VideoReader` then tries cv2, `io/vecs` the Python loop,
`index/hnsw` raises).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

# `cvt_tpu`'s flags (cvt_tpu/native/__init__.py)
CXXFLAGS = ("-O3", "-march=native", "-funroll-loops", "-std=c++17",
            "-fopenmp", "-shared", "-fPIC", "-Wall")
# per-library link flags (system libraries a component needs)
EXTRA_FLAGS = {
    "ffdecode": ("-lavformat", "-lavcodec", "-lavutil", "-lswscale"),
}


class NativeBuildError(RuntimeError):
    """A native component cannot be built or loaded on this machine."""


def build(name: str) -> str:
    """Compile `<name>.cc` into BUILD_DIR when the library is missing or
    older than its source; returns the library's path."""
    src = os.path.join(_DIR, f"{name}.cc")
    if not os.path.exists(src):
        raise NativeBuildError(f"no native source {src}")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    # $CXX first, then g++: a $CXX set for other builds may lack what
    # these flags need (OpenMP's spec file, for one)
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        raise NativeBuildError(f"C++ compiler {cxx!r} not found: cannot "
                               f"build {name}")
    compilers = [c for c in dict.fromkeys((cxx, "g++")) if shutil.which(c)]
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    errors = []
    for cxx in compilers:
        cmd = [cxx, *CXXFLAGS, "-o", tmp, src, *EXTRA_FLAGS.get(name, ())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, out)
            return out
        errors.append(f"{' '.join(cmd)}\n{proc.stderr[-2000:]}")
    raise NativeBuildError(f"native build of {name} failed (missing "
                           f"headers or libraries?): " + "\n".join(errors))


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and dlopen the named native library."""
    with _LOCK:
        if name not in _LIBS:
            path = build(name)
            try:
                _LIBS[name] = ctypes.CDLL(path)
            except OSError as e:
                raise NativeBuildError(f"cannot load {path}: {e}") from e
        return _LIBS[name]


def available(name: str) -> bool:
    """True if the native library can be built and loaded here."""
    try:
        load_library(name)
        return True
    except NativeBuildError:
        return False
