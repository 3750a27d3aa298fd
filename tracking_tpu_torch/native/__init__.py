"""Native (C++) video I/O, counterpart of ``tracking_tpu/native``.

``videoio.cpp`` is a threaded FFmpeg decode with a prefetch ring
(``vio_open`` / ``vio_info`` / ``vio_read_batch`` / ``vio_close``) and an
MJPEG / AVI encoder (``vio_writer_open`` / ``vio_writer_write`` /
``vio_writer_close``), loaded with ``ctypes``. :func:`build` compiles it
with ``g++`` and the JAX package's Makefile flags into
``build/tracking_tpu_torch/`` beside the package (the file name carries a
hash of the source and flags, and the library moves into place in one
rename, so processes building at once never load a partial file). Nothing
is built at import: :func:`load` builds at first use and returns None
where ``g++`` or FFmpeg's development files are missing, keeping the
reason in :data:`last_error`; the readers and writers then use cv2.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().with_name("videoio.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tracking_tpu_torch"
CXX = "g++"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]
LIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale", "-lpthread"]

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_double
_U8P = ctypes.POINTER(ctypes.c_ubyte)
# (restype, argtypes) of the C entry points
_SIGNATURES = {
    "vio_open": (_P, [ctypes.c_char_p, _I, _I, _I]),
    "vio_info": (_I, [_P, ctypes.POINTER(_I), ctypes.POINTER(_I), ctypes.POINTER(_D)]),
    "vio_read_batch": (_L, [_P, _U8P, _L]),
    "vio_close": (None, [_P]),
    "vio_writer_open": (_P, [ctypes.c_char_p, _I, _I, _D]),
    "vio_writer_write": (_I, [_P, _U8P, _L]),
    "vio_writer_close": (_I, [_P]),
}

_lib = None
last_error: str | None = None  # why the library could not be built or loaded


def build(force: bool = False) -> Path | None:
    """Compile ``videoio.cpp`` into the shared library (once per source and
    flags, or anew with ``force``); its path, or None with the reason in
    :data:`last_error`."""
    global last_error
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libvideoio_{digest}.so"
    if out.exists() and not force:
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        last_error = f"{CXX} not found"
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libvideoio_{digest}.{os.getpid()}.tmp"
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS], capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        last_error = f"{CXX} failed ({res.returncode}):\n{res.stderr.strip()}"
        return None
    os.replace(tmp, out)
    return out


def load():
    """The ctypes handle of the library (built at first use), or None where
    it cannot be built or loaded (:data:`last_error` says why; a failure is
    not retried in this process)."""
    global _lib, last_error
    if _lib is not None or last_error is not None:
        return _lib
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:  # FFmpeg's shared libraries missing at run time
        last_error = str(e)
        return None
    for name, (res, args) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    _lib = lib
    return lib


class VideoWriter:
    """Native MJPEG / AVI writer (the container and codec of the reference's
    fgavi / btavi outputs, ``trackingMain.cpp:168-215``) with
    ``cv2.VideoWriter``'s surface: ``write(bgr_u8_hwc)`` (a gray frame is
    written as BGR), ``release()``, ``isOpened()``. Raises RuntimeError
    where the library is unavailable; ``runner/cli._writer`` then uses cv2."""

    def __init__(self, path: str, fps: float, size):  # size = (w, h)
        lib = load()
        if lib is None:
            raise RuntimeError(f"native video I/O unavailable: {last_error}")
        self._lib = lib
        self.w, self.h = int(size[0]), int(size[1])
        self._h = lib.vio_writer_open(str(path).encode(), self.w, self.h, float(fps))
        if not self._h:
            raise RuntimeError(f"vio_writer_open failed for {path}")

    def write(self, frame) -> None:
        import numpy as np

        arr = np.ascontiguousarray(frame, dtype=np.uint8)
        if arr.ndim == 2:  # gray -> BGR, as cv2.VideoWriter(isColor=True) expects
            arr = np.ascontiguousarray(np.repeat(arr[:, :, None], 3, axis=2))
        if arr.shape != (self.h, self.w, 3):
            raise ValueError(f"frame of shape {arr.shape}, writer opened for {(self.h, self.w, 3)}")
        if self._lib.vio_writer_write(self._h, arr.ctypes.data_as(_U8P), 1) != 0:
            raise RuntimeError("vio_writer_write failed")

    def release(self) -> None:
        if self._h:
            rc = self._lib.vio_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise RuntimeError("vio_writer_close failed")

    def isOpened(self) -> bool:  # cv2.VideoWriter's name
        return self._h is not None
