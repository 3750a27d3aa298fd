"""The BGS apps of the port against the JAX package's, on seeded clips from
``synth.make_clip`` written as PNG sequences (``--frames_dir``; both
packages decode them with cv2) and CDnet JPEG directories:

- ``bgs_run`` with ``-a``, with the default config directory (every XML it
  writes byte for byte) and with a 3-algorithm fan-out, its PreProcessor
  blur on, tictoc and ``--compare/--imgref/--stopAt``: stdout line for
  line but the timing line and the tictoc seconds;
- ``_reload_fanout``: an unchanged tree keeps the fan-out and its states, a
  new algorithm is warm-started and the others keep their states;
- an enabled algorithm the registry lacks raises an error naming its flag;
- ``cdnet_run``: the same ``bin%06d.png`` names and pixels, with shrinkBGS
  and with MOG2;
- ``FrameProcessor`` with SuBSENSE and GMG in the fan-out: masks and states
  bit for bit after each chunk;
- the Gaussian-mixture, dp, lb and VuMeter algorithms: ``-a`` runs, and a
  fan-out of MOG2, DPWrenGA, LBSimpleGaussian and VuMeter (XMLs, stdout,
  masks and states);
- a fan-out of FuzzyChoquetIntegral, T2FGMM_UV, KDE, IMBS and
  Eigenbackground, three of them from edited XMLs that detect inside the
  clip (XMLs, stdout, masks and states);
- every FrameProcessor flag builds its algorithm.

LbpMrf and MultiCue's app cases are in ``test_torch_bgs_app_s16.py``.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal, run_jax_child
from test_torch_cli import jax_video_reader_ready
from tracking_tpu_torch.synth import make_clip

T, H, W = 12, 48, 64


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("frames")
    frames = make_clip(T, H, W, 3, seed=4)
    for i, f in enumerate(frames):
        cv2.imwrite(str(d / f"{i + 1}.png"), f)
    # a reference mask for --compare: the objects of frame 6 against frame 0
    ref = (np.abs(frames[6].astype(int) - frames[0].astype(int)).max(-1) > 20).astype(np.uint8) * 255
    cv2.imwrite(str(d / "ref.png"), ref)
    return d, frames


def _timing_free(lines):
    """stdout without the timing line's numbers and tictoc's seconds."""
    out = []
    for line in lines:
        if line.startswith("tictoc: "):
            line = line.split(" = ")[0]
        elif " frames in " in line and line.endswith(" fps)"):
            line = line.split(" frames in ")[0]
        out.append(line)
    return out


# a JAX app run in a process of its own (``torch_parity.run_jax_child``):
# the JAX package's exact LbpMrf step may be compiled only once a process
JAX_APP = """
import contextlib, io, os
from tracking_tpu.runner import cli
os.chdir(str(inp["cwd"]))
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = getattr(cli, str(inp["app"]))([str(a) for a in inp["argv"]])
out["rc"], out["stdout"] = np.array(rc), np.array(buf.getvalue())
"""


def jax_app_in_child(tmp_path, app: str, argv, cwd) -> str:
    """stdout of the JAX package's ``cli.<app>(argv)`` run in ``cwd`` by a
    child process (it must return 0)."""
    d = tmp_path / f"child_{app}"
    d.mkdir(exist_ok=True)
    res = run_jax_child(JAX_APP, d, app=np.array(app), argv=np.array([str(a) for a in argv]), cwd=np.array(str(cwd)))
    assert int(res["rc"]) == 0
    return str(res["stdout"])


def run_bgs_apps(monkeypatch, tmp_path, argv, setup=None, files=(), jax_child=False):
    """Run the JAX ``bgs_run`` and the port's (``--device cpu``) with
    ``argv``, each in its own directory (``setup(dir)`` prepares it), and
    compare stdout but the timing numbers, and each file of ``files`` byte
    for byte. ``jax_child`` runs the JAX app in a process of its own.
    Returns the port's stdout lines."""
    from tracking_tpu.runner import cli as jcli
    from tracking_tpu_torch.runner import cli as tcli

    outs = {}
    for name, run, extra in (("jax", jcli.bgs_run, []), ("torch", tcli.bgs_run, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        if setup is not None:
            setup(d)
        if name == "jax" and jax_child:
            outs[name] = jax_app_in_child(tmp_path, "bgs_run", argv, d).splitlines()
            continue
        monkeypatch.chdir(d)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert run(list(argv) + extra) == 0
        outs[name] = buf.getvalue().splitlines()
    assert _timing_free(outs["torch"]) == _timing_free(outs["jax"])
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    return outs["torch"]


def test_one_algorithm(monkeypatch, tmp_path, frames_dir):
    d, _ = frames_dir
    out = run_bgs_apps(monkeypatch, tmp_path, ["-a", "FrameDifferenceBGS", "--frames_dir", str(d), "--chunk", "5",
                                                "--compare", "--imgref", str(d / "ref.png"), "--stopAt", "6"])
    assert out[0].startswith("FrameDifferenceBGS frame 6: similarity = ")
    assert out[-1].startswith(f"FrameDifferenceBGS: {T} frames in ")


def test_default_config_dir(monkeypatch, tmp_path, frames_dir):
    """No ``-a``: the self-documenting config directory, FrameDifference
    with the PreProcessor, XML files byte for byte."""
    d, _ = frames_dir
    out = run_bgs_apps(monkeypatch, tmp_path, ["--frames_dir", str(d), "--chunk", "4", "--max_frames", "7"],
                       files=[f"config/{n}.xml" for n in ("FrameProcessor", "PreProcessor", "FrameDifferenceBGS")])
    assert out == [out[-1]] and out[-1].startswith("FrameDifferenceBGS: 8 frames in ")  # chunks of 4 from below 7
    assert sorted(os.listdir(tmp_path / "torch" / "config")) == ["FrameDifferenceBGS.xml", "FrameProcessor.xml",
                                                                 "PreProcessor.xml"]


def _fanout_config(d, flags, tictoc="", blur=True):
    """A config directory enabling ``flags`` (FrameDifference's default
    flag off unless listed), with the PreProcessor's blur."""
    from tracking_tpu_torch.core.config import config_to_xml
    from tracking_tpu_torch.runner.pipeline import FrameProcessorConfig, PreProcessorConfig

    fields = {f: True for f in flags}
    fields.setdefault("enableFrameDifferenceBGS", False)
    config_to_xml(FrameProcessorConfig(tictoc=tictoc, **fields), os.path.join(d, "config", "FrameProcessor.xml"))
    config_to_xml(PreProcessorConfig(gaussianBlur=blur), os.path.join(d, "config", "PreProcessor.xml"))


def test_fanout(monkeypatch, tmp_path, frames_dir):
    """Three algorithms with the blur on, tictoc on one, every algorithm
    scored at ``--stopAt``, and a mask video per algorithm."""
    jax_video_reader_ready()
    d, _ = frames_dir
    flags = ("enableFrameDifferenceBGS", "enableWeightedMovingMeanBGS", "enableSigmaDeltaBGS")
    out = run_bgs_apps(
        monkeypatch, tmp_path,
        ["--frames_dir", str(d), "--chunk", "5", "--compare", "--imgref", str(d / "ref.png"), "--stopAt", "7",
         "-o", "masks.avi"],
        setup=lambda p: _fanout_config(p, flags, tictoc="SigmaDeltaBGS"),
        files=[f"config/{n}.xml" for n in ("FrameProcessor", "PreProcessor", "FrameDifferenceBGS",
                                           "WeightedMovingMeanBGS", "SigmaDeltaBGS")],
    )
    names = ["FrameDifferenceBGS", "WeightedMovingMeanBGS", "SigmaDeltaBGS"]
    assert out[0].startswith("tictoc: SigmaDeltaBGS = ") and out[0].endswith("s / 5 frames")
    assert [line.split(" frame ")[0] for line in out[1:4]] == sorted(names)  # scored by name
    assert out[-1].startswith("+".join(names) + f": {T} frames in ")  # the flags' order
    for n in names:
        assert os.path.getsize(tmp_path / "torch" / f"masks.{n}.avi") > 0


def test_reload_fanout(tmp_path):
    """As ``tests/test_aux.py``'s live reload: an unchanged tree keeps the
    fan-out and its states; enabling SigmaDelta keeps FrameDifference's
    state object and warm-starts the new one; then both equal the JAX
    package's after the next chunk."""
    import jax
    import jax.numpy as jnp

    from tracking_tpu.runner import cli as jcli
    from tracking_tpu.runner.pipeline import FrameProcessor as JFP
    from tracking_tpu_torch.runner.cli import _reload_fanout
    from tracking_tpu_torch.runner.pipeline import FrameProcessor

    cfgdir = str(tmp_path / "config")
    fp = FrameProcessor.from_config_dir(cfgdir)
    assert list(fp.algorithms) == ["FrameDifferenceBGS"]
    chunks = make_clip(8, 24, 32, 3, seed=2).reshape(2, 4, 24, 32, 3)
    c0 = torch.from_numpy(chunks[0])
    states, _ = fp.run(c0)
    fp2, states2 = _reload_fanout(fp, states, cfgdir, c0)
    assert fp2 is fp and states2 is states

    fp_xml = os.path.join(cfgdir, "FrameProcessor.xml")
    txt = open(fp_xml).read().replace("<enableSigmaDeltaBGS>0", "<enableSigmaDeltaBGS>1")
    open(fp_xml, "w").write(txt)
    jfp = JFP.from_config_dir(cfgdir.replace("config", "unused"))  # FrameDifference alone, as before the edit
    jstates, _ = jfp.run(jnp.asarray(chunks[0]))
    fp3, states3 = _reload_fanout(fp, states, cfgdir, c0)
    jfp3, jstates3 = jcli._reload_fanout(jfp, jstates, cfgdir, jnp.asarray(chunks[0]))
    assert list(fp3.algorithms) == list(jfp3.algorithms) == ["FrameDifferenceBGS", "SigmaDeltaBGS"]
    assert states3["FrameDifferenceBGS"] is states["FrameDifferenceBGS"]
    assert_tree_equal(jax.device_get(jstates3), states3)
    states4, masks = fp3.run(torch.from_numpy(chunks[1]), states3)
    jstates4, jmasks = jfp3.run(jnp.asarray(chunks[1]), jstates3)
    assert_tree_equal(jax.device_get(jstates4), states4)
    assert_tree_equal(jax.device_get(jmasks), masks)


def _flags():
    from tracking_tpu_torch.runner.pipeline import _ENABLE_FLAGS

    return _ENABLE_FLAGS


@pytest.mark.parametrize("flag,name", _flags(), ids=[f for f, _ in _flags()])
def test_every_flag_builds(tmp_path, flag, name):
    """Each FrameProcessor flag alone builds its algorithm, as the JAX
    package's fan-out does, and writes its default XML."""
    from tracking_tpu.runner.pipeline import FrameProcessor as JFP
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.runner.pipeline import FrameProcessor

    _fanout_config(str(tmp_path), (flag,))
    cfgdir = str(tmp_path / "config")
    fp = FrameProcessor.from_config_dir(cfgdir)
    assert list(fp.algorithms) == list(JFP.from_config_dir(cfgdir).algorithms) == [name]
    assert type(fp.algorithms[name]) is get_algorithm(name)
    assert os.path.exists(os.path.join(cfgdir, f"{name}.xml"))


def cdnet_both(tmp_path, bgs=None, jax_child=False, max_share=0.5):
    """``cdnet_run`` of both packages (``--bgs bgs``, or its default) on
    JPEGs 0-13 with ROI 5-13 and a bootstrap of 4: the same bin%06d.png
    files, pixel for pixel, and the same line, and some foreground below
    ``max_share``. ``jax_child`` runs the JAX app in a process of its own."""
    import cv2

    from tracking_tpu.runner import cli as jcli
    from tracking_tpu_torch.runner import cli as tcli

    src = tmp_path / "in"
    src.mkdir()
    for i, f in enumerate(make_clip(14, H, W, 3, seed=6)):
        cv2.imwrite(str(src / f"in{i:06d}.jpg"), f)
    lines = {}
    for name, run, extra in (("jax", jcli.cdnet_run, []), ("torch", tcli.cdnet_run, ["--device", "cpu"])):
        argv = [str(src), "--out", str(tmp_path / name), "--roi", "5", "13", "--bootstrap", "4", "--chunk",
                "4"] + (["--bgs", bgs] if bgs else []) + extra
        if name == "jax" and jax_child:
            text = jax_app_in_child(tmp_path, "cdnet_run", argv, tmp_path)
        else:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert run(argv) == 0
            text = buf.getvalue()
        lines[name] = text.split(" in ")[0].replace(str(tmp_path / name), "OUT")
    assert lines["torch"] == lines["jax"] == "cdnet: 13 frames (9 masks written to OUT)"
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) == [f"bin{i:06d}.png" for i in range(5, 14)]
    shares = []
    for n in names:
        a = cv2.imread(str(tmp_path / "jax" / n), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "torch" / n), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(b, a, err_msg=n)
        shares.append((a > 0).mean())
    assert 0.0 < max(shares) < max_share


def test_cdnet(monkeypatch, tmp_path):
    """``cdnet_run`` with its default, shrinkBGS."""
    cdnet_both(tmp_path)


def test_cdnet_mog2(tmp_path):
    """``cdnet_run --bgs mog2``."""
    cdnet_both(tmp_path, "mog2")


def test_fanout_with_kernel_algorithms(tmp_path):
    """SuBSENSE and GMG (the consensus, hole-fill and GMG kernels' plain
    versions on the CPU) beside FrameDifference in one fan-out, the blur
    on, in chunks of 6 and 8: masks and states equal the JAX fan-out's
    after each chunk."""
    import jax
    import jax.numpy as jnp

    from tracking_tpu.runner.pipeline import FrameProcessor as JFP
    from tracking_tpu_torch.runner.pipeline import FrameProcessor

    _fanout_config(str(tmp_path), ("enableFrameDifferenceBGS", "enableGMG", "enableSuBSENSEBGS"))
    cfgdir = str(tmp_path / "config")
    fp, jfp = FrameProcessor.from_config_dir(cfgdir), JFP.from_config_dir(cfgdir)
    assert list(fp.algorithms) == list(jfp.algorithms) == ["FrameDifferenceBGS", "GMG", "SuBSENSEBGS"]
    frames = make_clip(14, H, W, 3, seed=8)
    st = jst = None
    for a, b in ((0, 6), (6, 14)):
        st, masks = fp.run(torch.from_numpy(frames[a:b]), st)
        jst, jmasks = jfp.run(jnp.asarray(frames[a:b]), jst)
        assert_tree_equal(jax.device_get(jmasks), masks, f"masks {a}-{b}")
        assert_tree_equal(jax.device_get(jst), st, f"states {a}-{b}")
    assert 0.0 < float((masks["SuBSENSEBGS"] > 0).float().mean()) < 0.5


def test_fanout_on_grey_frames():
    """Grey frames through the PreProcessor's equalisation and blur into
    FrameDifference, AdaptiveBackgroundLearning and SigmaDelta: masks and
    states equal the JAX fan-out's."""
    import jax
    import jax.numpy as jnp

    from tracking_tpu.core.registry import get_algorithm as jget
    from tracking_tpu.runner.pipeline import FrameProcessor as JFP
    from tracking_tpu.runner.pipeline import PreProcessorConfig as JPC
    from tracking_tpu_torch import get_algorithm as tget
    from tracking_tpu_torch.runner.pipeline import FrameProcessor, PreProcessorConfig

    names = ("FrameDifferenceBGS", "AdaptiveBackgroundLearning", "SigmaDeltaBGS")
    fp = FrameProcessor({n: tget(n)() for n in names}, PreProcessorConfig(equalizeHist=True, gaussianBlur=True))
    jfp = JFP({n: jget(n)() for n in names}, JPC(equalizeHist=True, gaussianBlur=True))
    frames = make_clip(10, H, W, 1, seed=9)
    st, masks = fp.run(torch.from_numpy(frames))
    jst, jmasks = jfp.run(jnp.asarray(frames))
    assert_tree_equal(jax.device_get(jmasks), masks)
    assert_tree_equal(jax.device_get(jst), st)
    assert float((masks["SigmaDeltaBGS"] > 0).float().mean()) > 0.0


@pytest.mark.parametrize("name", ["MixtureOfGaussianV2BGS", "DPPratiMediodBGS", "LBFuzzyAdaptiveSOM"])
def test_one_new_algorithm(monkeypatch, tmp_path, frames_dir, name):
    """``-a`` with algorithms of the Gaussian-mixture, dp and lb families:
    stdout (the similarity at ``--stopAt`` included) line for line."""
    d, _ = frames_dir
    out = run_bgs_apps(monkeypatch, tmp_path, ["-a", name, "--frames_dir", str(d), "--chunk", "5", "--compare",
                                                "--imgref", str(d / "ref.png"), "--stopAt", "8"])
    assert out[0].startswith(f"{name} frame 8: similarity = ") and out[-1].startswith(f"{name}: {T} frames in ")


def test_fanout_new_algorithms(monkeypatch, tmp_path, frames_dir):
    """A fan-out of MOG2, DPWrenGA, LBSimpleGaussian and VuMeter with the
    blur on: the apps' XMLs byte for byte and stdout line for line (each
    algorithm scored at ``--stopAt``); then the fan-out that those XMLs
    build, in both packages, in chunks of 5: masks and states bit for bit
    after each chunk."""
    import jax
    import jax.numpy as jnp

    from tracking_tpu.runner.pipeline import FrameProcessor as JFP
    from tracking_tpu_torch.runner.pipeline import FrameProcessor

    d, frames = frames_dir
    names = ["MixtureOfGaussianV2BGS", "DPWrenGABGS", "LBSimpleGaussian", "VuMeter"]
    flags = ("enableMixtureOfGaussianV2BGS", "enableDPWrenGABGS", "enableLBSimpleGaussian", "enableVuMeter")
    out = run_bgs_apps(
        monkeypatch, tmp_path,
        ["--frames_dir", str(d), "--chunk", "5", "--compare", "--imgref", str(d / "ref.png"), "--stopAt", "9"],
        setup=lambda p: _fanout_config(p, flags, tictoc="VuMeter"),
        files=[f"config/{n}.xml" for n in ["FrameProcessor", "PreProcessor"] + names],
    )
    assert out[0].startswith("tictoc: VuMeter = ")
    assert [line.split(" frame ")[0] for line in out[1:5]] == sorted(names)
    assert out[-1].startswith("+".join(names) + f": {T} frames in ")  # the flags' order

    cfgdir = str(tmp_path / "torch" / "config")
    fp, jfp = FrameProcessor.from_config_dir(cfgdir), JFP.from_config_dir(cfgdir)
    assert list(fp.algorithms) == list(jfp.algorithms) == names
    st = jst = None
    for a, b in ((0, 5), (5, 10), (10, T)):
        st, masks = fp.run(torch.from_numpy(frames[a:b]), st)
        jst, jmasks = jfp.run(jnp.asarray(frames[a:b]), jst)
        assert_tree_equal(jax.device_get(jmasks), masks, f"masks {a}-{b}")
        assert_tree_equal(jax.device_get(jst), st, f"states {a}-{b}")
    assert all(float((masks[n] > 0).float().mean()) > 0.0 for n in names)


def test_fanout_slice15_algorithms(monkeypatch, tmp_path, frames_dir):
    """A fan-out of FuzzyChoquetIntegral (its XML edited to 4 learning
    frames), T2FGMM_UV, KDE, IMBS (a sample every frame and a 4-sample
    model) and Eigenbackground (a 6-frame history) with the blur on: the
    apps' XMLs byte for byte, stdout line for line (each algorithm scored at
    ``--stopAt``); then the fan-out that those XMLs build, in both
    packages, in chunks of 6 (one compiled shape in the JAX package):
    masks and states bit for bit after each chunk, Eigenbackground's basis
    included (the 6-frame history's Gram product and lift in MKL-DNN's
    orders for S = 6, ``ops/contract.py``)."""
    import jax
    import jax.numpy as jnp

    from tracking_tpu.runner.pipeline import FrameProcessor as JFP
    from tracking_tpu_torch.bgs.eigenbackground import EigenbackgroundConfig
    from tracking_tpu_torch.bgs.fuzzy import FuzzyIntegralConfig
    from tracking_tpu_torch.bgs.imbs import IMBSConfig
    from tracking_tpu_torch.core.config import config_to_xml
    from tracking_tpu_torch.runner.pipeline import FrameProcessor

    d, frames = frames_dir
    names = ["DPEigenbackgroundBGS", "T2FGMM_UV", "FuzzyChoquetIntegral", "KDE", "IndependentMultimodalBGS"]
    flags = ("enableDPEigenbackgroundBGS", "enableT2FGMM_UV", "enableFuzzyChoquetIntegral", "enableKDE",
             "enableIMBS")

    def setup(p):
        _fanout_config(p, flags, tictoc="KDE")
        config_to_xml(IMBSConfig(fps=2.0, numSamples=4), os.path.join(p, "config", "IndependentMultimodalBGS.xml"))
        config_to_xml(FuzzyIntegralConfig(framesToLearn=4), os.path.join(p, "config", "FuzzyChoquetIntegral.xml"))
        config_to_xml(EigenbackgroundConfig(historySize=6, embeddedDim=3),
                      os.path.join(p, "config", "DPEigenbackgroundBGS.xml"))

    out = run_bgs_apps(
        monkeypatch, tmp_path,
        ["--frames_dir", str(d), "--chunk", "6", "--compare", "--imgref", str(d / "ref.png"), "--stopAt", "11"],
        setup=setup, files=[f"config/{n}.xml" for n in ["FrameProcessor", "PreProcessor"] + names],
    )
    assert out[0].startswith("tictoc: KDE = ")
    assert [line.split(" frame ")[0] for line in out[1:6]] == sorted(names)
    assert out[-1].startswith("+".join(names) + f": {T} frames in ")  # the flags' order

    cfgdir = str(tmp_path / "torch" / "config")
    fp, jfp = FrameProcessor.from_config_dir(cfgdir), JFP.from_config_dir(cfgdir)
    assert list(fp.algorithms) == list(jfp.algorithms) == names
    st = jst = None
    fired = set()
    for a, b in ((0, 6), (6, T)):
        st, masks = fp.run(torch.from_numpy(frames[a:b]), st)
        jst, jmasks = jfp.run(jnp.asarray(frames[a:b]), jst)
        fired |= {n for n in names if bool((masks[n] > 0).any())}
        assert_tree_equal(jax.device_get(jmasks), masks, f"masks {a}-{b}")
        assert_tree_equal(jax.device_get(jst), st, f"states {a}-{b}")
    assert fired == set(names), sorted(set(names) - fired)
