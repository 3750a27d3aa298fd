"""Host-side video decode and frame batching, counterpart of
``tracking_tpu/io/video.py``.

``VideoSource`` reads a file or a camera, applies the reference's resize,
horizontal flip and static ROI (``VideoCapture.cpp:93-278``) and yields
``[T, H, W, 3]`` u8 BGR chunks for the frame loop. As in the JAX package, a
file goes through the native FFmpeg reader (``tracking_tpu_torch/native``:
decode and flip on a background thread, the same frames as cv2) where its
library builds, and through OpenCV (``cv2``) otherwise; a camera always
goes through cv2. ``cv2`` is imported by the functions that decode, so the
package imports where it is missing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass
class VideoSource:
    """Config mirroring config/VideoCapture.xml (``VideoCapture.cpp:244-278``)."""

    input_file: Optional[str] = None
    camera_index: Optional[int] = None
    resize_factor: float = 1.0  # reference: input_resize_percent / 100
    enable_flip: bool = False
    roi: Optional[Tuple[int, int, int, int]] = None  # x0, y0, x1, y1

    def _prep(self, frame: np.ndarray) -> np.ndarray:
        import cv2

        if self.resize_factor != 1.0:
            w = int(frame.shape[1] * self.resize_factor)
            h = int(frame.shape[0] * self.resize_factor)
            frame = cv2.resize(frame, (w, h), interpolation=cv2.INTER_LINEAR)
        if self.enable_flip:
            frame = cv2.flip(frame, 1)
        if self.roi is not None:
            x0, y0, x1, y1 = self.roi
            frame = frame[y0:y1, x0:x1]
        return frame

    def chunks(self, chunk_size: int = 64, max_frames: int = 0) -> Iterator[np.ndarray]:
        """Yield [T <= chunk_size, H, W, 3] u8 BGR chunks, at most
        ``max_frames`` frames in all (0: no limit). A file goes through the
        native reader where it loads and opens the file, else through cv2."""
        if self.input_file:
            it = self._native_chunks(chunk_size, max_frames)
            if it is not None:
                yield from it
                return
        import cv2

        cap = cv2.VideoCapture(self.input_file) if self.input_file else cv2.VideoCapture(self.camera_index or 0)
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video source {self.input_file!r}")
        buf, n = [], 0
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                buf.append(self._prep(frame))
                n += 1
                if len(buf) == chunk_size:
                    yield np.stack(buf)
                    buf = []
                if max_frames and n >= max_frames:
                    break
            if buf:
                yield np.stack(buf)
        finally:
            cap.release()

    def _native_chunks(self, chunk_size: int, max_frames: int):
        """Iterator over the native reader's chunks, or None where its
        library does not load or the file does not open."""
        import ctypes

        from tracking_tpu_torch import native

        lib = native.load()
        if lib is None:
            return None
        handle = lib.vio_open(self.input_file.encode(), 0, 0, 1 if self.enable_flip else 0)
        if not handle:
            return None

        def gen():
            w, h, fps = ctypes.c_int(), ctypes.c_int(), ctypes.c_double()
            lib.vio_info(handle, ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps))
            n = 0
            try:
                while True:
                    want = chunk_size
                    if max_frames:
                        want = min(want, max_frames - n)
                        if want <= 0:
                            break
                    buf = np.empty((want, h.value, w.value, 3), np.uint8)
                    got = lib.vio_read_batch(handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), want)
                    if got <= 0:
                        break
                    n += got
                    chunk = buf[:got]
                    if self.resize_factor != 1.0 or self.roi is not None:
                        chunk = np.stack([self._prep_no_flip(f) for f in chunk])
                    yield chunk
                    if got < want:
                        break
            finally:
                lib.vio_close(handle)

        return gen()

    def _prep_no_flip(self, frame: np.ndarray) -> np.ndarray:
        """Resize and ROI only (the native reader flipped the frame)."""
        import cv2

        if self.resize_factor != 1.0:
            w = int(frame.shape[1] * self.resize_factor)
            h = int(frame.shape[0] * self.resize_factor)
            frame = cv2.resize(frame, (w, h), interpolation=cv2.INTER_LINEAR)
        if self.roi is not None:
            x0, y0, x1, y1 = self.roi
            frame = frame[y0:y1, x0:x1]
        return frame


def read_video(path: str, max_frames: int = 0, gray: bool = False) -> np.ndarray:
    """Decode a whole video into [T, H, W, 3] u8 BGR (or [T, H, W] if gray)."""
    chunks = list(VideoSource(input_file=path).chunks(256, max_frames=max_frames))
    vid = np.concatenate(chunks) if chunks else np.zeros((0, 0, 0, 3), np.uint8)
    if gray and vid.size:
        import cv2

        vid = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in vid])
    return vid


def read_frame_dir(path: str, pattern: str = "{}.png", start: int = 1) -> np.ndarray:
    """Read a numbered frame sequence (Demo2's ``frames/%d.png``,
    ``Demo2.cpp:146-151``) into [T, H, W, 3] u8 BGR."""
    import cv2

    frames = []
    i = start
    while True:
        p = os.path.join(path, pattern.format(i))
        if not os.path.exists(p):
            break
        frames.append(cv2.imread(p, cv2.IMREAD_COLOR))
        i += 1
    if not frames:
        raise FileNotFoundError(f"no frames matching {pattern!r} under {path}")
    return np.stack(frames)


def read_cdnet_dir(path: str, start: int, stop: int) -> np.ndarray:
    """Read a CDnet-style ``in%06d.jpg`` sequence over [start, stop]
    inclusive (``ustc_src/shrinkBGS/main.cpp:24-37,55-69``) into
    [T, H, W, 3] u8 BGR; stops at the first missing frame."""
    import cv2

    frames = []
    for i in range(start, stop + 1):
        p = os.path.join(path, f"in{i:06d}.jpg")
        if not os.path.exists(p):
            break
        frames.append(cv2.imread(p, cv2.IMREAD_COLOR))
    if not frames:
        raise FileNotFoundError(f"no in%06d.jpg frames in [{start}, {stop}] under {path}")
    return np.stack(frames)
