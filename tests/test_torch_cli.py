"""The tracking app (``tracking-run``) of the port against the JAX
package's on a 12-frame FFV1 clip at 64x96 from ``synth.make_clip``: the
JAX ``tracking_run`` and the port's ``tracking_run --device cpu`` on the
same file, with stdout compared line for line (but the timing line), the
track file text (CSV and YML) and the ``--bta_data`` arrays, bit for bit.

This file: the default app (SuBSENSE, BD_CC, CCMSPF, HistPVS, Kalman),
``--btpp None`` with YML tracks, ``--FGTrainFrames 4`` and a saved and
resumed run. ``test_torch_cli_modules.py`` holds ``--fg`` FG_0 / FG_1 and
``--bt`` MS / MSFG / MSPF, on this file's helpers (``write_ffv1``,
``run_apps``, ``jax_video_reader_ready``). Each JAX run compiles its chunk
for ~12 s.
"""

import numpy as np
import pytest

from tracking_tpu_torch.synth import make_clip

T, H, W = 12, 64, 96


def write_ffv1(path, frames) -> None:
    """Write u8 [T, H, W, 3] BGR frames as an FFV1 AVI: lossless, so the JAX
    package's reader and cv2 decode it to these frames exactly (MJPG and
    raw AVIs do not round-trip exactly)."""
    import cv2

    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"FFV1"), 30.0, (frames.shape[2], frames.shape[1]))
    for f in frames:
        vw.write(np.ascontiguousarray(f))
    vw.release()


def run_apps(monkeypatch, tmp_path, video, argv, files=()):
    """Run the JAX package's ``tracking_run`` and the port's (``--device
    cpu``) on ``video`` with ``argv``, each in its own directory so relative
    output paths print alike, and compare: stdout line for line but the
    final ``tracking: ... fps`` line, and each output file in ``files``
    (text files byte for byte, ``.npz`` files array by array). Returns the
    port's stdout."""
    import contextlib
    import io

    from tracking_tpu.runner import cli as jcli
    from tracking_tpu_torch.runner import cli as tcli

    outs = {}
    for name, run, extra in (("jax", jcli.tracking_run, []), ("torch", tcli.tracking_run, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert run([str(video)] + list(argv) + extra) == 0
        outs[name] = buf.getvalue().splitlines()
    j, t = outs["jax"], outs["torch"]
    assert j[-1].startswith("tracking: ") and t[-1].startswith("tracking: ")
    assert t[:-1] == j[:-1]
    for f in files:
        a, b = tmp_path / "jax" / f, tmp_path / "torch" / f
        if f.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files), f
                for k in za.files:
                    np.testing.assert_array_equal(zb[k], za[k], err_msg=f"{f}:{k}")
        else:
            assert b.read_text() == a.read_text(), f
    return t


def jax_video_reader_ready():
    """Make the JAX package's FFmpeg reader (``tracking_tpu.native``) ready
    in this process without racing other test processes: where the library
    is missing or stale, build it with its Makefile in a scratch copy of its
    directory and move it into place in one rename (the package's own build
    links in place, and a process loading the library meanwhile would read a
    partial file), then load it, retrying while another process may be
    linking it. Returns the library, or None where it cannot be built (the
    JAX reader then falls back to cv2)."""
    import os
    import shutil
    import subprocess
    import tempfile
    import time

    from tracking_tpu import native

    src = os.path.join(native._DIR, "videoio.cpp")
    if not (os.path.exists(native._LIB) and os.path.getmtime(native._LIB) >= os.path.getmtime(src)):
        with tempfile.TemporaryDirectory() as d:
            for name in ("Makefile", "videoio.cpp"):
                shutil.copy(os.path.join(native._DIR, name), d)
            done = subprocess.run(["make", "-C", d, "libvideoio.so"], capture_output=True, text=True)
            if done.returncode != 0:
                return None
            os.replace(os.path.join(d, "libvideoio.so"), native._LIB)
    for _ in range(30):
        try:
            return native.load()
        except OSError:  # another process is linking it in place
            time.sleep(1.0)
    return native.load()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    jax_video_reader_ready()
    path = tmp_path_factory.mktemp("clip") / "clip.avi"
    frames = make_clip(T, H, W, 3, seed=0)
    write_ffv1(path, frames)
    return path, frames


def test_both_readers_decode_the_clip(clip):
    """The JAX package's reader (its FFmpeg library where it loads, else
    cv2) and the port's cv2 reader yield the written frames, chunk for
    chunk."""
    from tracking_tpu.io.video import VideoSource as JSource
    from tracking_tpu_torch.io.video import VideoSource as TSource

    path, frames = clip
    for chunk, max_frames in ((5, 0), (32, 7)):
        want = list(JSource(input_file=str(path)).chunks(chunk, max_frames=max_frames))
        got = list(TSource(input_file=str(path)).chunks(chunk, max_frames=max_frames))
        assert [g.shape for g in got] == [w.shape for w in want]
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(np.concatenate(got), frames[: max_frames or T])


def test_default_app(monkeypatch, tmp_path, clip):
    out = run_apps(monkeypatch, tmp_path, clip[0], ["--track", "tracks.csv", "--bta_data", "bta.npz", "--chunk", "5"],
                   files=("tracks.csv", "bta.npz"))
    assert sum(line.startswith("frame ") for line in out) >= 4  # tracks are born and followed
    assert any(line.startswith("track ") for line in out)


@pytest.mark.parametrize("argv", [
    ["--btpp", "None", "--track", "tracks.yml", "--bta", "IOR", "--bta_data", "bta.npz"],
    ["--FGTrainFrames", "4", "--track", "tracks.csv", "--bta", "TrackDist"],
], ids=["raw-yml-ior", "fg-train"])
def test_app_options(monkeypatch, tmp_path, clip, argv):
    files = [a for a in argv if "." in a]
    out = run_apps(monkeypatch, tmp_path, clip[0], argv, files=files)
    frames = [int(line.split(":")[0].split()[1]) for line in out if line.startswith("frame ")]
    assert frames
    if "--FGTrainFrames" in argv:
        assert min(frames) >= 4


def test_saved_and_resumed_app(monkeypatch, tmp_path, clip):
    """``--savestate`` after 6 frames, then ``--loadstate`` over the clip:
    the resumed run (its BGS and tracker states from the checkpoint, no warm
    start) matches the JAX package's resumed run."""
    run_apps(monkeypatch, tmp_path, clip[0], ["--max_frames", "6", "--savestate", "state.ckpt", "--quiet",
                                               "--track", "first.csv"], files=("first.csv",))
    out = run_apps(monkeypatch, tmp_path, clip[0], ["--loadstate", "state.ckpt", "--track", "tracks.csv"],
                   files=("tracks.csv",))
    assert any(line.startswith("frame 0: ") for line in out)  # tracks carried over from the first run
