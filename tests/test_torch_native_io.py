"""The port's native video I/O (``tracking_tpu_torch/native``: the FFmpeg
reader with its prefetch ring and the MJPEG / AVI writer) against cv2 and
the JAX package's native library, on a seeded 16-frame FFV1 clip: the
library builds into ``build/tracking_tpu_torch/``; ``VideoSource`` reads a
file through it (its calls counted) with the frames of cv2 and of the JAX
reader, for several chunk sizes, ``max_frames``, flip, ROI and resize; it
reads through cv2 when the build fails; both packages' writers write files
that decode alike; and ``tracking-run --fgavi`` writes through it with the
JAX app's stdout."""

import numpy as np
import pytest

from test_torch_cli import jax_video_reader_ready, run_apps, write_ffv1
from torch_parity import count_calls
from tracking_tpu_torch import native
from tracking_tpu_torch.io import video as tvideo
from tracking_tpu_torch.synth import make_clip

T, H, W = 16, 48, 80


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    if lib is None:
        reason = native.last_error or ""
        if "not found" in reason or "No such file or directory" in reason:  # no g++, no FFmpeg headers
            pytest.skip(f"the port's video library cannot build here: {reason}")
        pytest.fail(f"the port's video library does not build: {reason}")
    return lib


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("native_clip") / "clip.avi"
    frames = make_clip(T, H, W, 3, seed=3)
    write_ffv1(path, frames)
    return path, frames


def _cv2_frames(path, resize=1.0, flip=False, roi=None, max_frames=0):
    """A video decoded by cv2 and prepared as the reference's VideoCapture
    prepares it (resize, flip, ROI)."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    out = []
    while not max_frames or len(out) < max_frames:
        ok, f = cap.read()
        if not ok:
            break
        if resize != 1.0:
            f = cv2.resize(f, (int(f.shape[1] * resize), int(f.shape[0] * resize)), interpolation=cv2.INTER_LINEAR)
        if flip:
            f = cv2.flip(f, 1)
        if roi is not None:
            f = f[roi[1]:roi[3], roi[0]:roi[2]]
        out.append(f)
    cap.release()
    return np.stack(out)


def test_library_builds_into_build_dir(lib):
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.parent.parts[-2:] == ("build", "tracking_tpu_torch")
    assert path.exists() and native.build() == path  # built once per source hash


READS = {
    "chunk5": dict(chunk=5),
    "chunk32": dict(chunk=32),
    "max_frames": dict(chunk=5, max_frames=7),
    "flip": dict(chunk=5, flip=True),
    "roi": dict(chunk=4, roi=(10, 5, 70, 40), max_frames=9),
    "resize": dict(chunk=32, resize=0.5),
    "flip_roi": dict(chunk=6, flip=True, roi=(3, 7, 61, 44), max_frames=11),
}


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_matches_cv2_and_jax(monkeypatch, lib, clip, name):
    from tracking_tpu.io.video import VideoSource as JSource

    cfg = READS[name]
    path, _ = clip
    kw = dict(resize_factor=cfg.get("resize", 1.0), enable_flip=cfg.get("flip", False), roi=cfg.get("roi"))
    chunk, max_frames = cfg["chunk"], cfg.get("max_frames", 0)
    jax_video_reader_ready()
    want = list(JSource(input_file=str(path), **kw).chunks(chunk, max_frames=max_frames))
    native_calls = count_calls(monkeypatch, tvideo.VideoSource, "_native_chunks")
    reads = count_calls(monkeypatch, lib, "vio_read_batch")
    got = list(tvideo.VideoSource(input_file=str(path), **kw).chunks(chunk, max_frames=max_frames))
    assert len(native_calls) == 1 and len(reads) == len(got)
    n = max_frames or T
    assert [len(g) for g in got] == [min(chunk, n - i) for i in range(0, n, chunk)]
    assert [g.shape for g in got] == [w.shape for w in want]
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(np.concatenate(got), _cv2_frames(path, kw["resize_factor"], kw["enable_flip"],
                                                                   kw["roi"], max_frames))


def test_reader_falls_back_to_cv2(monkeypatch, tmp_path, clip):
    """With the compiler missing, ``load`` returns None with the reason,
    and ``VideoSource`` reads the file through cv2 (its per-frame ``_prep``)."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "last_error", None)
    assert native.load() is None and "not found" in native.last_error
    preps = count_calls(monkeypatch, tvideo.VideoSource, "_prep")
    path, frames = clip
    got = np.concatenate(list(tvideo.VideoSource(input_file=str(path)).chunks(5)))
    assert len(preps) == T
    np.testing.assert_array_equal(got, frames)
    with pytest.raises(RuntimeError):
        native.VideoWriter(str(tmp_path / "x.avi"), 30.0, (W, H))


def test_writers_agree(tmp_path, lib, clip):
    """The port's and the JAX package's native writers: BGR frames and gray
    masks decode (through cv2) to the same frames at the written shape."""
    from tracking_tpu.native import VideoWriter as JWriter

    if jax_video_reader_ready() is None:
        pytest.skip("the JAX package's video library does not build here")
    _, frames = clip
    masks = (frames[..., 1] > 100).astype(np.uint8) * 255
    decoded = {}
    for name, cls in (("jax", JWriter), ("torch", native.VideoWriter)):
        for kind, data in (("bgr", frames), ("gray", masks)):
            path = tmp_path / f"{name}_{kind}.avi"
            w = cls(str(path), 30.0, (W, H))
            assert w.isOpened()
            for f in data:
                w.write(f)
            w.release()
            assert not w.isOpened()
            decoded[name, kind] = _cv2_frames(path)
    for kind in ("bgr", "gray"):
        assert decoded["torch", kind].shape == (T, H, W, 3)
        np.testing.assert_array_equal(decoded["torch", kind], decoded["jax", kind])
    assert np.abs(decoded["torch", "bgr"].astype(int) - frames.astype(int)).mean() < 8.0


def test_app_writes_fgavi_natively(monkeypatch, tmp_path, lib, clip):
    """``tracking-run --fgavi`` writes its masks through the native writer
    (one ``write`` a frame) and prints the JAX app's lines; both apps' mask
    videos decode alike."""
    if jax_video_reader_ready() is None:
        pytest.skip("the JAX package's video library does not build here")
    writes = count_calls(monkeypatch, native.VideoWriter, "write")
    run_apps(monkeypatch, tmp_path, clip[0], ["--fgavi", "fg.avi", "--chunk", "8"])
    assert len(writes) == T
    want, got = (_cv2_frames(tmp_path / name / "fg.avi") for name in ("jax", "torch"))
    assert got.shape == (T, H, W, 3)
    np.testing.assert_array_equal(got, want)
