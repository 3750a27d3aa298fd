"""The tracking app's module choices in the port against the JAX
package's (``test_torch_cli.py`` holds the default app): ``--fg FG_1``
(MOG1) and ``--fg FG_0`` (FGD, on a quiet clip: FGD's change test floods at
the default sensor noise), ``--bgs_type 5`` (MOG2), ``26``
(LBFuzzyGaussian) and ``33`` (IMBS, given a sample every frame and a
2-sample model by ``fg:`` module parameters so that it detects inside the
clip; its components come from the CC kernel's plain version here), ``34``
(MultiCue, with 4 training frames, capacities of 4 and 3 codewords and a
48x32 reduced map, enlarged 2x), and the MS, MSFG and MSPF trackers, each on a 12-frame FFV1 clip at 64x96;
stdout but the timing line, the track CSV and the ``--bta_data`` arrays
bit for bit. MSPF's particle jitter draws JAX's normals bit for bit
(``ops/xla_math.py``)."""

import pytest

from test_torch_cli import jax_video_reader_ready, run_apps, write_ffv1
from tracking_tpu_torch.synth import make_clip

T, H, W = 12, 64, 96


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    jax_video_reader_ready()
    d = tmp_path_factory.mktemp("clips")
    paths = {}
    for name, noise in (("main", 2.5), ("quiet", 0.5)):
        paths[name] = d / f"{name}.avi"
        write_ffv1(paths[name], make_clip(T, H, W, 3, seed=0, noise=noise))
    return paths


@pytest.mark.parametrize("argv,clip", [
    (["--fg", "FG_1"], "main"),
    (["--fg", "FG_0"], "quiet"),
    (["--bt", "MS"], "main"),
    (["--bt", "MSFG", "--bta", "HistSS"], "main"),
    (["--bt", "MSPF", "--bd", "BD_Simple"], "main"),
    (["--bgs_type", "5"], "main"),
    (["--bgs_type", "26"], "main"),
    (["--bgs_type", "33", "fg:fps=2", "fg:numSamples=2"], "main"),
    (["--bgs_type", "34", "fg:trainingPeriod=3", "fg:modelCapacity=4", "fg:cacheCapacity=3", "fg:reducedWidth=48",
      "fg:reducedHeight=32"], "main"),
], ids=["fg1", "fg0", "ms", "msfg", "mspf", "mog2", "lb-fuzzy-gauss", "imbs", "multicue"])
def test_app_modules(monkeypatch, tmp_path, clips, argv, clip):
    out = run_apps(monkeypatch, tmp_path, clips[clip], argv + ["--track", "tracks.csv", "--bta_data", "bta.npz"],
                   files=("tracks.csv", "bta.npz"))
    assert sum(line.startswith("frame ") for line in out) >= 2  # tracks are born and followed
