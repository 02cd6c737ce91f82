"""Host-side video decoding: filename or in-memory buffer -> frame
batches for the card (counterpart of `cvt_tpu.io.video`).

Reference: ffmpeg_read_memory/include/ffdecoder.h:18-59 and
video_object_match's FFDecoder/VideoCapture pair — libav* decode of a
file path OR a raw `unsigned char*` memory buffer via a custom
AVIOContext, exposing open/grab/retrieve/read.

Decode is host work (no FLOPs worth a card); the framework's job is to
hand the device fixed-shape [T, H, W] gray or [T, H, W, 3] RGB batches.
The backends come in `cvt_tpu`'s order: gray decoding tries the native
in-memory AVIO decoder first (`native/ffdecode.cc`, built by path with
`cvt_tpu_torch.native`), then OpenCV's VideoCapture (in-memory buffers
staged through a temp file). Both are gated — importing this module
never hard-fails on a machine without a decoder. This module imports no
torch: frames are numpy.

One repair against `cvt_tpu`: its `fps` and `frame_count` read the cv2
capture, which the native path does not open, and raise
AttributeError there (`cvt_tpu/io/video.py:169`), so its `match_video`
fails wherever libav builds. Here the native path reports 0 for both
(the native decoder reads no frame rate).
"""

from __future__ import annotations

import os
import tempfile
from typing import Iterator, Optional

import numpy as np


def _cv2():
    try:
        import cv2
        return cv2
    except Exception:
        return None


def _native_lib():
    """The true in-memory AVIO decoder (native/ffdecode.cc) — the
    reference FFDecoder's custom-AVIOContext memory path, no temp file.
    None when libav* is unavailable on this machine."""
    import ctypes
    from cvt_tpu_torch.native import NativeBuildError, load_library
    try:
        lib = load_library("ffdecode")
        lib.ffdec_open_buffer.restype = ctypes.c_void_p
        lib.ffdec_open_buffer.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.ffdec_open_file.restype = ctypes.c_void_p
        lib.ffdec_open_file.argtypes = [ctypes.c_char_p]
        lib.ffdec_width.argtypes = [ctypes.c_void_p]
        lib.ffdec_height.argtypes = [ctypes.c_void_p]
        lib.ffdec_read_gray.restype = ctypes.c_int
        lib.ffdec_read_gray.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ffdec_close.argtypes = [ctypes.c_void_p]
        return lib
    except NativeBuildError:
        return None


class _NativeGrayDecoder:
    """ctypes wrapper over ffdecode.cc: gray frames from memory/file."""

    def __init__(self, lib, source):
        import ctypes
        self._lib = lib
        if isinstance(source, (bytes, bytearray, memoryview)):
            data = bytes(source)
            self._h = lib.ffdec_open_buffer(data, len(data))
        else:
            self._h = lib.ffdec_open_file(str(source).encode())
        if not self._h:
            raise RuntimeError("ffdecode open failed")
        self.w = lib.ffdec_width(self._h)
        self.h = lib.ffdec_height(self._h)
        self._buf = ctypes.create_string_buffer(self.w * self.h)
        self._pending = None

    def read_gray(self):
        """Next frame as [H, W] uint8, or None at EOF."""
        if self._pending is not None:
            f, self._pending = self._pending, None
            return f
        r = self._lib.ffdec_read_gray(self._h, self._buf)
        if r != 1:
            return None
        return np.frombuffer(self._buf.raw, np.uint8).reshape(
            self.h, self.w).copy()

    def grab(self):
        if self._pending is not None:
            return True
        self._pending = self.read_gray()
        return self._pending is not None

    def close(self):
        if self._h:
            self._lib.ffdec_close(self._h)
            self._h = None


class VideoReader:
    """open(path | bytes) / grab / retrieve / read — FFDecoder surface.

    Iterates decoded frames as float32 arrays; `gray=True` yields
    [H, W] in [0, 1], else [H, W, 3] RGB in [0, 1].
    """

    def __init__(self, source, *, gray: bool = True,
                 target_size: Optional[tuple[int, int]] = None,
                 frame_stride: int = 1):
        self.gray = gray
        self.target_size = target_size          # (H, W) or None
        self.frame_stride = max(int(frame_stride), 1)
        self._tmp = None
        self._cap = None
        self._native = None
        self.open(source)

    # -- lifecycle ------------------------------------------------------
    def open(self, source) -> bool:
        self.release()
        # gray decoding prefers the NATIVE in-memory AVIO decoder
        # (ffdecode.cc): true FFDecoder memory semantics, no temp file
        if self.gray:
            lib = _native_lib()
            if lib is not None:
                try:
                    self._native = _NativeGrayDecoder(lib, source)
                    return True
                except RuntimeError:
                    self._native = None   # fall through to cv2
        cv2 = _cv2()
        if cv2 is None:
            raise RuntimeError("no video backend available"
                               " (native ffdecode + cv2 both missing)")
        if isinstance(source, (bytes, bytearray, memoryview)):
            # memory-buffer open via temp file (cv2 fallback only)
            fd, self._tmp = tempfile.mkstemp(suffix=".video")
            with os.fdopen(fd, "wb") as f:
                f.write(bytes(source))
            self._cap = cv2.VideoCapture(self._tmp)
        else:
            self._cap = cv2.VideoCapture(str(source))
        return bool(self._cap.isOpened())

    def release(self) -> None:
        if getattr(self, "_native", None) is not None:
            self._native.close()
            self._native = None
        if self._cap is not None:
            self._cap.release()
            self._cap = None
        if self._tmp is not None:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass
            self._tmp = None

    def __del__(self):
        self.release()

    @property
    def is_open(self) -> bool:
        if self._native is not None:
            return True
        return self._cap is not None and self._cap.isOpened()

    @property
    def fps(self) -> float:
        if self._cap is None or not self._cap.isOpened():
            return 0.0                  # closed, or the native decoder
        return float(self._cap.get(_cv2().CAP_PROP_FPS))

    @property
    def frame_count(self) -> int:
        if self._cap is None or not self._cap.isOpened():
            return 0
        return int(self._cap.get(_cv2().CAP_PROP_FRAME_COUNT))

    # -- decoding ---------------------------------------------------------
    def grab(self) -> bool:
        if self._native is not None:
            return self._native.grab()
        return self.is_open and self._cap.grab()

    def retrieve(self):
        if self._native is not None:
            f = self._native.read_gray()
            return self._convert_gray(f) if f is not None else None
        ok, frame = self._cap.retrieve()
        return self._convert(frame) if ok else None

    def read(self):
        """Decode the next frame (honoring frame_stride) or None at EOF."""
        if self._native is not None:
            for _ in range(self.frame_stride - 1):
                if self._native.read_gray() is None:
                    return None
            f = self._native.read_gray()
            return self._convert_gray(f) if f is not None else None
        for _ in range(self.frame_stride - 1):
            if not self.grab():
                return None
        ok, frame = self._cap.read() if self.is_open else (False, None)
        return self._convert(frame) if ok else None

    def _convert_gray(self, g: np.ndarray) -> np.ndarray:
        if self.target_size is not None:
            cv2 = _cv2()
            h, w = self.target_size
            if cv2 is not None:
                g = cv2.resize(g, (w, h), interpolation=cv2.INTER_AREA)
            else:  # nearest-neighbor fallback without cv2
                ys = (np.arange(h) * g.shape[0] // h)
                xs = (np.arange(w) * g.shape[1] // w)
                g = g[ys][:, xs]
        return g.astype(np.float32) / 255.0

    def _convert(self, bgr: np.ndarray) -> np.ndarray:
        cv2 = _cv2()
        if self.target_size is not None:
            h, w = self.target_size
            bgr = cv2.resize(bgr, (w, h), interpolation=cv2.INTER_AREA)
        if self.gray:
            out = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
        else:
            out = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        return out.astype(np.float32) / 255.0

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            f = self.read()
            if f is None:
                return
            yield f

    def batches(self, batch_size: int) -> Iterator[np.ndarray]:
        """Yield fixed-size [batch_size, ...] frame stacks (last batch is
        padded by repeating the final frame, with the true length in
        .shape metadata callers get via the second tuple element)."""
        buf: list[np.ndarray] = []
        for f in self:
            buf.append(f)
            if len(buf) == batch_size:
                yield np.stack(buf), batch_size
                buf = []
        if buf:
            n = len(buf)
            while len(buf) < batch_size:
                buf.append(buf[-1])
            yield np.stack(buf), n


def write_video(path: str, frames: np.ndarray, fps: float = 25.0) -> None:
    """Minimal encoder (tests/demos): frames [T, H, W] in [0,1] or
    [T, H, W, 3] RGB in [0,1]."""
    cv2 = _cv2()
    if cv2 is None:
        raise RuntimeError("no video backend available (cv2 missing)")
    fr = np.asarray(frames)
    if fr.ndim == 3:
        fr = np.repeat(fr[..., None], 3, axis=-1)
    h, w = fr.shape[1:3]
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    vw = cv2.VideoWriter(path, fourcc, fps, (w, h))
    if not vw.isOpened():
        raise IOError(f"cannot open video writer: {path}")
    for f in fr:
        bgr = cv2.cvtColor((np.clip(f, 0, 1) * 255).astype(np.uint8),
                           cv2.COLOR_RGB2BGR)
        vw.write(bgr)
    vw.release()
