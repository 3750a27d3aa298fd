"""Package-level checks of the PyTorch port: it imports without JAX or the
JAX package, its configs and states mirror the reference's, and its kernel
wrappers never fall back silently."""

import ast
import ctypes
import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal
from tracking_tpu.bgs import dp as JDP
from tracking_tpu.bgs import eigenbackground as JEB
from tracking_tpu.bgs import fgd as JF
from tracking_tpu.bgs import fuzzy as JFZ
from tracking_tpu.bgs import gmg as JG
from tracking_tpu.bgs import gmm as JGM
from tracking_tpu.bgs import imbs as JIM
from tracking_tpu.bgs import kde as JKD
from tracking_tpu.bgs import lb as JLB
from tracking_tpu.bgs import lbp_mrf as JLM
from tracking_tpu.bgs import lbsp_family as JLF
from tracking_tpu.bgs import multicue as JMC
from tracking_tpu.bgs import multilayer as JM
from tracking_tpu.bgs import prati_mediod as JPM
from tracking_tpu.bgs import subsense_shrink as JS
from tracking_tpu.bgs import t2f as JT2
from tracking_tpu.bgs import texture as JT
from tracking_tpu.bgs import vumeter as JVU
from tracking_tpu.core.registry import list_algorithms as j_list_algorithms
from tracking_tpu.track import tracker as JTR
from tracking_tpu_torch import convert, get_algorithm, list_algorithms
from tracking_tpu_torch.bgs import dp as TDP
from tracking_tpu_torch.bgs import eigenbackground as TEB
from tracking_tpu_torch.bgs import fgd as TF
from tracking_tpu_torch.bgs import fuzzy as TFZ
from tracking_tpu_torch.bgs import gmg as TG
from tracking_tpu_torch.bgs import gmm as TGM
from tracking_tpu_torch.bgs import imbs as TIM
from tracking_tpu_torch.bgs import kde as TKD
from tracking_tpu_torch.bgs import lb as TLB
from tracking_tpu_torch.bgs import lbp_mrf as TLM
from tracking_tpu_torch.bgs import lbsp_family as TLF
from tracking_tpu_torch.bgs import multicue as TMC
from tracking_tpu_torch.bgs import multilayer as TM
from tracking_tpu_torch.bgs import prati_mediod as TPM
from tracking_tpu_torch.bgs import subsense_shrink as TS
from tracking_tpu_torch.bgs import t2f as TT2
from tracking_tpu_torch.bgs import texture as TT
from tracking_tpu_torch.bgs import vumeter as TVU
from tracking_tpu_torch.ops import _native, assoc, cc, consensus, fgd, fill, gmg, multilayer, texture
from tracking_tpu_torch.synth import make_clip
from tracking_tpu_torch.track import tracker as TTR

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "tracking_tpu_torch"


def test_imports_with_jax_blocked():
    """Every module of the port imports in a process where ``jax`` and
    ``tracking_tpu`` cannot be imported (the card's machine has no JAX)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['tracking_tpu'] = None\n"
        "import tracking_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'tracking_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules if sys.modules[k] is not None)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_reference_imports():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tracking_tpu"), f"{f.relative_to(REPO)} imports {mod}"


@pytest.mark.parametrize(
    "ref,port",
    [
        (JLF.SuBSENSEConfig, TLF.SuBSENSEConfig), (JTR.TrackerConfig, TTR.TrackerConfig),
        (JLF.LOBSTERConfig, TLF.LOBSTERConfig), (JG.GMGConfig, TG.GMGConfig),
        (JT.DPTextureConfig, TT.DPTextureConfig), (JM.MultiLayerConfig, TM.MultiLayerConfig),
        (JS.SuBSENSEShrinkConfig, TS.SuBSENSEShrinkConfig), (JF.FGDConfig, TF.FGDConfig),
        (JF.FGDSimple.Config, TF.FGDSimple.Config), (JGM.MOG1Config, TGM.MOG1Config),
        (JGM.MOG2Config, TGM.MOG2Config), (JGM.GrimsonGMMConfig, TGM.GrimsonGMMConfig),
        (JGM.ZivkovicAGMMConfig, TGM.ZivkovicAGMMConfig), (JDP.DPAdaptiveMedianConfig, TDP.DPAdaptiveMedianConfig),
        (JDP.DPMeanConfig, TDP.DPMeanConfig), (JDP.DPWrenGAConfig, TDP.DPWrenGAConfig),
        (JPM.PratiMediodConfig, TPM.PratiMediodConfig), (JVU.VuMeterConfig, TVU.VuMeterConfig),
        (JLB.LBSimpleGaussianConfig, TLB.LBSimpleGaussianConfig),
        (JLB.LBFuzzyGaussianConfig, TLB.LBFuzzyGaussianConfig),
        (JLB.LBMixtureOfGaussiansConfig, TLB.LBMixtureOfGaussiansConfig),
        (JLB.LBAdaptiveSOMConfig, TLB.LBAdaptiveSOMConfig),
        (JLB.LBFuzzyAdaptiveSOMConfig, TLB.LBFuzzyAdaptiveSOMConfig),
        (JFZ.FuzzyIntegralConfig, TFZ.FuzzyIntegralConfig), (JT2.T2FGMMConfig, TT2.T2FGMMConfig),
        (JT2.T2FMRFConfig, TT2.T2FMRFConfig), (JKD.KDEConfig, TKD.KDEConfig), (JIM.IMBSConfig, TIM.IMBSConfig),
        (JEB.EigenbackgroundConfig, TEB.EigenbackgroundConfig),
    ],
)
def test_config_fields_and_defaults_match(ref, port):
    def spec(cls):
        return [(f.name, f.default, f.init) for f in dataclasses.fields(cls)]

    assert spec(port) == spec(ref)
    assert port() == port().replace()


@pytest.mark.parametrize(
    "name,type_id,aliases,cls",
    [
        ("SuBSENSEBGS", 36, ("subsense",), TLF.SuBSENSE),
        ("LOBSTERBGS", 37, ("lobster",), TLF.LOBSTER),
        ("GMG", 8, ("gmg",), TG.GMG),
        ("DPTextureBGS", 16, ("texture-lbp", "dp-texture"), TT.DPTextureBGS),
        ("MultiLayerBGS", 23, ("multilayer",), TM.MultiLayerBGS),
        ("subsenseShrink", None, ("subsense-shrink", "yzbx"), TS.SuBSENSEShrink),
        ("FGD", None, ("FG_0", "fgd"), TF.FGD),
        ("FGDSimple", None, ("FG_0S", "fgd-simple"), TF.FGDSimple),
        ("MixtureOfGaussianV1BGS", 4, ("mog1", "mog"), TGM.MixtureOfGaussianV1),
        ("MixtureOfGaussianV2BGS", 5, ("mog2",), TGM.MixtureOfGaussianV2),
        ("DPAdaptiveMedianBGS", 9, ("adaptive-median",), TDP.DPAdaptiveMedian),
        ("DPGrimsonGMMBGS", 10, ("grimson-gmm",), TGM.DPGrimsonGMM),
        ("DPZivkovicAGMMBGS", 11, ("zivkovic-agmm",), TGM.DPZivkovicAGMM),
        ("DPMeanBGS", 12, ("dp-mean",), TDP.DPMean),
        ("DPWrenGABGS", 13, ("wren-ga",), TDP.DPWrenGA),
        ("DPPratiMediodBGS", 14, ("prati-mediod",), TPM.DPPratiMediod),
        ("LBSimpleGaussian", 25, ("lb-gauss",), TLB.LBSimpleGaussian),
        ("LBFuzzyGaussian", 26, ("lb-fuzzy-gauss",), TLB.LBFuzzyGaussian),
        ("LBMixtureOfGaussians", 27, ("lb-mog",), TLB.LBMixtureOfGaussians),
        ("LBAdaptiveSOM", 28, ("lb-som",), TLB.LBAdaptiveSOM),
        ("LBFuzzyAdaptiveSOM", 29, ("lb-fuzzy-som",), TLB.LBFuzzyAdaptiveSOM),
        ("VuMeter", 31, ("vumeter",), TVU.VuMeter),
        ("DPEigenbackgroundBGS", 15, ("eigenbackground",), TEB.DPEigenbackground),
        ("T2FGMM_UM", 17, ("t2fgmm-um",), TT2.T2FGMM_UM),
        ("T2FGMM_UV", 18, ("t2fgmm-uv",), TT2.T2FGMM_UV),
        ("T2FMRF_UM", 19, ("t2fmrf-um",), TT2.T2FMRF_UM),
        ("T2FMRF_UV", 20, ("t2fmrf-uv",), TT2.T2FMRF_UV),
        ("FuzzySugenoIntegral", 21, ("fuzzy-sugeno",), TFZ.FuzzySugenoIntegral),
        ("FuzzyChoquetIntegral", 22, ("fuzzy-choquet",), TFZ.FuzzyChoquetIntegral),
        ("KDE", 32, ("kde",), TKD.KDE),
        ("IndependentMultimodalBGS", 33, ("imbs",), TIM.IMBS),
        ("SJN_MultiCueBGS", 34, ("multicue",), TMC.MultiCue),
        ("LbpMrf", 30, ("lbp-mrf",), TLM.LbpMrf),
    ],
)
def test_registry(name, type_id, aliases, cls):
    assert get_algorithm(name) is cls
    assert type_id is None or get_algorithm(type_id) is cls
    assert all(get_algorithm(a) is cls for a in aliases)
    assert cls.name == name and cls.type_id == type_id
    ref = j_list_algorithms()[name]
    assert (ref.type_id, ref.Config.__name__) == (type_id, cls.Config.__name__)
    assert set(list_algorithms()) == set(j_list_algorithms()) and len(list_algorithms()) == 42
    with pytest.raises(KeyError):
        get_algorithm("NoSuchBGS")  # registered in neither package


@pytest.mark.parametrize("c", [1, 3])
def test_init_state_mirrors_reference(c):
    """Same leaf names, shapes, dtypes and values as the JAX pytree, and the
    converter round-trips it."""
    h, w = 24, 40
    want = jax.device_get(JLF.SuBSENSE().init(h, w, c))
    got = TLF.SuBSENSE().init(h, w, c, device="cpu")
    assert_tree_equal(want, got)
    assert_tree_equal(want, convert.state_from_numpy(want, device="cpu"))
    assert_tree_equal(got, convert.state_from_numpy(convert.state_to_numpy(got), device="cpu"))


@pytest.mark.parametrize(
    "ref,port,c",
    [(JFZ.FuzzySugenoIntegral, TFZ.FuzzySugenoIntegral, 1), (JT2.T2FGMM_UV, TT2.T2FGMM_UV, 3),
     (JT2.T2FMRF_UM, TT2.T2FMRF_UM, 1), (JKD.KDE, TKD.KDE, 3), (JKD.KDE, TKD.KDE, 1), (JIM.IMBS, TIM.IMBS, 3),
     (JEB.DPEigenbackground, TEB.DPEigenbackground, 3)],
    ids=["fuzzy", "t2fgmm", "t2fmrf", "kde", "kde-grey", "imbs", "eigen"],
)
def test_slice15_init_states_mirror_reference(ref, port, c):
    """The fuzzy, T2F, KDE, IMBS and Eigenbackground init states: the JAX
    pytree's leaves (KDE's per-channel tuples included), through
    ``convert`` both ways unchanged."""
    h, w = 24, 40
    want = jax.device_get(ref().init(h, w, c))
    got = port().init(h, w, c, device="cpu")
    assert_tree_equal(want, got)
    assert_tree_equal(want, convert.state_from_numpy(want, device="cpu"))
    assert_tree_equal(got, convert.state_from_numpy(convert.state_to_numpy(got), device="cpu"))
    if port is TKD.KDE:
        assert all(isinstance(got[k], tuple) and len(got[k]) == c for k in ("seq", "hist", "c1n_px", "c2_px", "tb"))


@pytest.mark.parametrize("ref,port,c", [(JMC.MultiCue, TMC.MultiCue, 3), (JMC.MultiCue, TMC.MultiCue, 1),
                                        (JLM.LbpMrf, TLM.LbpMrf, 3)], ids=["multicue", "multicue-grey", "lbp-mrf"])
def test_slice16_init_states_mirror_reference(ref, port, c):
    """MultiCue's nested codebook tree (the four books with their fixed
    capacities) and LbpMrf's model grid: the JAX pytree's leaves, through
    ``convert`` both ways unchanged."""
    h, w = 24, 40
    want = jax.device_get(ref().init(h, w, c))
    got = port().init(h, w, c, device="cpu")
    assert_tree_equal(want, got)
    assert_tree_equal(want, convert.state_from_numpy(want, device="cpu"))
    assert_tree_equal(got, convert.state_from_numpy(convert.state_to_numpy(got), device="cpu"))


@pytest.mark.parametrize(
    "ref,port,c",
    [
        (JLF.LOBSTER, TLF.LOBSTER, 3), (JLF.LOBSTER, TLF.LOBSTER, 1), (JG.GMG, TG.GMG, 3),
        (JT.DPTextureBGS, TT.DPTextureBGS, 3), (JM.MultiLayerBGS, TM.MultiLayerBGS, 3),
    ],
)
def test_slice2_init_states_mirror_reference(ref, port, c):
    h, w = 24, 40
    want = jax.device_get(ref().init(h, w, c))
    got = port().init(h, w, c, device="cpu")
    assert_tree_equal(want, got)
    assert_tree_equal(want, convert.state_from_numpy(want, device="cpu"))
    assert_tree_equal(got, convert.state_from_numpy(convert.state_to_numpy(got), device="cpu"))


@pytest.mark.parametrize(
    "ref,port,c,mode",
    [
        (JLF.SuBSENSE, TLF.SuBSENSE, 3, "v3"), (JLF.SuBSENSE, TLF.SuBSENSE, 1, "v3"),
        (JS.SuBSENSEShrink, TS.SuBSENSEShrink, 3, "v1"), (JS.SuBSENSEShrink, TS.SuBSENSEShrink, 1, "v3"),
    ],
)
def test_slice3_states_mirror_reference(monkeypatch, ref, port, c, mode):
    """Consensus v3's ``bg_sum`` (in place of the pending log) and
    subsenseShrink's box leaves: the same leaves as the JAX pytree at init,
    and a stepped state crosses ``convert`` both ways unchanged."""
    from tracking_tpu_torch.synth import make_clip

    monkeypatch.setenv("TRACKING_TPU_CONSENSUS", mode)
    h, w = 24, 40
    want = jax.device_get(ref().init(h, w, c))
    got = port().init(h, w, c, device="cpu")
    assert ("bg_sum" in got) == (mode == "v3") and ("pend_ctrl" in got) == (mode == "v1")
    assert ("box_up" in got) == (port is TS.SuBSENSEShrink)
    assert_tree_equal(want, got)
    algo = port()
    frames = torch.from_numpy(make_clip(3, h, w, c, seed=4))
    st = algo.warm_start(got, frames[0])
    for t in (1, 2):
        st, _, _ = algo.step(st, frames[t])
    assert_tree_equal(st, convert.state_from_numpy(convert.state_to_numpy(st), device="cpu"))
    assert_tree_equal(jax.device_get(want), convert.state_to_numpy(convert.state_from_numpy(want, device="cpu")))


@pytest.mark.parametrize(
    "make",
    [
        lambda: TLF.SuBSENSE().init(8, 8, 3), lambda: TLF.LOBSTER().init(8, 8, 3), lambda: TG.GMG().init(8, 8, 3),
        lambda: TT.DPTextureBGS().init(8, 8, 3), lambda: TM.MultiLayerBGS().init(8, 8, 3),
        lambda: TTR.BlobTracker().init(), lambda: convert.state_from_numpy({"t": np.zeros((), np.int32)}),
        lambda: TS.SuBSENSEShrink().init(8, 8, 3), lambda: TF.FGD().init(8, 8, 3),
        lambda: TGM.MixtureOfGaussianV1().init(8, 8, 3), lambda: TGM.MixtureOfGaussianV2().init(8, 8, 3),
        lambda: TDP.DPWrenGA().init(8, 8, 3), lambda: TPM.DPPratiMediod().init(8, 8, 3),
        lambda: TVU.VuMeter().init(8, 8, 3), lambda: TLB.LBAdaptiveSOM().init(8, 8, 3),
        lambda: TFZ.FuzzyChoquetIntegral().init(8, 8, 3), lambda: TT2.T2FMRF_UV().init(8, 8, 3),
        lambda: TKD.KDE().init(8, 8, 3), lambda: TIM.IMBS().init(8, 8, 3),
        lambda: TEB.DPEigenbackground().init(8, 8, 3),
    ],
    ids=["subsense", "lobster", "gmg", "dptexture", "multilayer", "tracker", "convert", "subsense-shrink", "fgd",
         "mog1", "mog2", "wren-ga", "prati", "vumeter", "lb-som", "fuzzy", "t2fmrf", "kde", "imbs", "eigen"],
)
def test_entry_points_default_to_the_card(make):
    """With no device given, states are made on the card: on a host without
    CUDA that is PyTorch's own error, never a silent CPU state."""
    if torch.cuda.is_available():
        state = make()
        assert state["t"].is_cuda if "t" in state else state["ids"].is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            make()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# IMBS builds its model inside the clip (its promotion and association
# write the bins in place)
CONSUMING_CFG = {"IndependentMultimodalBGS": {"fps": 2.0, "numSamples": 6}}


@pytest.mark.parametrize(
    "name,env",
    [("SuBSENSEBGS", {}), ("LOBSTERBGS", {}), ("GMG", {}), ("DPTextureBGS", {}), ("MultiLayerBGS", {}),
     ("subsenseShrink", {}), ("SuBSENSEBGS", {"TRACKING_TPU_CONSENSUS": "v3"}),
     ("SuBSENSEBGS", {"TRACKING_TPU_FUSED": "1"}), ("FGD", {}), ("FGDSimple", {}), ("KDE", {}),
     ("IndependentMultimodalBGS", {}), ("DPEigenbackgroundBGS", {})],
    ids=["SuBSENSEBGS", "LOBSTERBGS", "GMG", "DPTextureBGS", "MultiLayerBGS", "subsenseShrink", "SuBSENSE-v3",
         "SuBSENSE-fused", "FGD", "FGDSimple", "KDE", "IMBS", "Eigenbackground"],
)
def test_run_video_uses_only_the_returned_state(monkeypatch, name, env):
    """``step`` consumes its state (kernels may update it in place), while
    the masks and bg images it returned stay valid. Here a step that
    overwrites every other input tensor it did not return gives the same run
    as the plain one, so the frame loop reads only returned states."""
    from tracking_tpu_torch.runner.scan import run_video
    from tracking_tpu_torch.synth import make_clip

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cls = get_algorithm(name)
    images = set()  # storages of the masks and bg images returned so far

    class Consuming(cls):
        def step(self, state, frame, **kw):
            out = super().step(state, frame, **kw)
            images.update(x.untyped_storage().data_ptr() for x in out[1:])
            kept = images | {x.untyped_storage().data_ptr() for x in _leaves(out[0])}
            for x in _leaves(state):
                if x.untyped_storage().data_ptr() not in kept and x.dtype != torch.uint32:
                    x.fill_(float("nan") if x.is_floating_point() else 7)
            return out

    frames = torch.from_numpy(make_clip(24, 16, 24, 3, seed=3))
    cfg = CONSUMING_CFG.get(name, {})
    want_state, want = run_video(cls(**cfg), frames)
    got_state, got = run_video(Consuming(**cfg), frames)
    assert torch.equal(got, want)
    assert_tree_equal(want_state, got_state)


@pytest.mark.parametrize(
    "ref,port,dtype",
    [(JF.FGD, TF.FGD, "float16"), (JF.FGD, TF.FGD, "float32"), (JF.FGDSimple, TF.FGDSimple, "float16"),
     (JF.FGDSimple, TF.FGDSimple, "float32")],
)
def test_fgd_states_mirror_reference(monkeypatch, ref, port, dtype):
    """FGD's and FGDSimple's init states have the JAX pytree's leaves, with
    f16 or f32 statistics (``STAT_DTYPE``), and a stepped state crosses
    ``convert`` both ways unchanged, its f16 leaves included."""
    from tracking_tpu_torch.synth import make_clip

    monkeypatch.setattr(JF.FGD, "STAT_DTYPE", getattr(jax.numpy, dtype))
    monkeypatch.setattr(TF.FGD, "STAT_DTYPE", getattr(torch, dtype))
    h, w = 24, 40
    want = jax.device_get(ref().init(h, w, 3))
    got = port().init(h, w, 3, device="cpu")
    assert_tree_equal(want, got)
    assert got["ct_P"].dtype == getattr(torch, dtype) and got["cc_key"].shape == (40, 6, h, w)
    algo = port()
    frames = torch.from_numpy(make_clip(3, h, w, 3, seed=4))
    st = algo.warm_start(got, frames[0])
    for t in range(3):
        st, _, _ = algo.step(st, frames[t])
    assert float(st["cc_P"].float().max()) > 0.0
    back = convert.state_from_numpy(convert.state_to_numpy(st), device="cpu")
    assert_tree_equal(st, back)
    assert back["ct_Pb"].dtype == getattr(torch, dtype)


def test_multilayer_checkpoints_not_ported(tmp_path, capsys):
    """MultiLayer's model persistence (once refused here) through the app's
    frame loop: a LEARN run with ``saveModel`` writes its final state to
    ``bg_model_preload``; a second run with that preload starts from it in
    place of the warm start. 6 + 6 frames equal 12 frames of a run that
    never saved (masks' foreground and the state, leaf by leaf)."""
    from tracking_tpu_torch.runner import cli

    frames = make_clip(12, 24, 40, 3, seed=4)
    args, _ = cli.parse_tracking_args(["clip", "--quiet", "--bta", "None", "--device", "cpu"])
    path = str(tmp_path / "models" / "ml.ckpt")
    tracker = TTR.BlobTracker()
    first = cli.run_tracking([frames[:6]], args, TM.MultiLayerBGS(saveModel=True, bg_model_preload=path), tracker)
    second = cli.run_tracking([frames[6:]], args, TM.MultiLayerBGS(bg_model_preload=path), tracker, start=6)
    whole = cli.run_tracking([frames[:3], frames[3:]], args, TM.MultiLayerBGS(), tracker)
    out = capsys.readouterr().out
    assert f"bg model: saved MultiLayerBGS model to {path}" in out
    assert f"bg model: loaded MultiLayerBGS model from {path}" in out
    assert int(first.bgs_state["t"]) == 6 and int(second.bgs_state["t"]) == 12
    assert_tree_equal(whole.bgs_state, second.bgs_state)
    assert float(whole.bgs_state["weight"].max()) > 0.0


def test_imports_without_cv2():
    """cv2 is imported only by the functions that read or write video or
    YML: every module of the port imports without it."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['cv2'] = None\n"
        "import tracking_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'tracking_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_app_refuses_a_missing_card():
    """The app runs on the card unless ``--device cpu`` asks for the CPU; it
    never falls back to the CPU by itself."""
    from tracking_tpu_torch.runner import cli

    args, _ = cli.parse_tracking_args(["clip", "--quiet"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            cli.run_tracking([make_clip(2, 24, 40, 3)], args)
        for app in (["bgs-run", "-a", "FrameDifferenceBGS"], ["cdnet-run", "in", "--out", "out", "--roi", "1", "2"]):
            with pytest.raises(SystemExit, match=f"{app[0]}: no CUDA device; pass --device cpu"):
                cli.main(app)
    assert cli.main(["no-such-app"]) == 2


def test_tracker_state_mirrors_reference():
    want = jax.device_get(JTR.BlobTracker().init())
    got = TTR.BlobTracker().init(device="cpu")
    assert list(got) == list(JTR.TrackTable._fields)
    assert_tree_equal(want._asdict(), got)
    assert_tree_equal(want._asdict(), convert.state_from_numpy(want, device="cpu"))


def test_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors; anything else
    must launch the kernel or raise (here: a meta tensor raises before any
    build)."""
    meta = dict(device="meta")
    m = torch.empty((8, 12), dtype=torch.bool, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        fill.flood_reach(m, m)
    with pytest.raises(ValueError, match="CUDA"):
        cc.label_components(torch.empty((8, 12), dtype=torch.uint8, **meta))
    with pytest.raises(ValueError, match="CUDA"):
        assoc.greedy_assign(torch.empty((4, 6), dtype=torch.float32, **meta))
    planes = (torch.empty((8, 12), dtype=torch.uint8, **meta),)
    banks = (torch.empty((5, 8, 12), dtype=torch.uint8, **meta),)
    descs = (torch.empty((5, 8, 12), dtype=torch.uint16, **meta),)
    i32 = torch.empty((8, 12), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        consensus.consensus(planes, banks, descs, i32, (i32,), torch.empty((), dtype=torch.int32, **meta),
                            torch.empty((8, 12), **meta), m, i32, rel=0.333, div=3.0, hi_const=85.0,
                            min_cd=30, desc_off=3)
    with pytest.raises(ValueError, match="1 or 3 channels"):
        consensus.consensus_ref(planes * 2, banks * 2, descs * 2, i32, (i32, i32), None, None, None, None,
                                rel=0.333, div=1.0, hi_const=85.0, min_cd=30, desc_off=3)
    with pytest.raises(ValueError, match="CUDA"):
        consensus.consensus_lobster(planes, banks, descs, i32, (i32,), **TLF.LOBSTER()._kernel_kw(1))
    f32 = torch.empty((8, 12), **meta)
    d0 = torch.empty((), dtype=torch.int32, **meta)
    kw = TLF.SuBSENSE()._kernel_kw(1)
    with pytest.raises(ValueError, match="CUDA"):
        consensus.consensus_read(planes, banks, descs, d0, f32, m, i32, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        consensus.consensus_feedback(
            planes, banks, descs, i32, (i32,), d0, f32, m, i32, planes, (torch.empty((8, 12), dtype=torch.uint16, **meta),),
            torch.empty((4, 8, 12), dtype=torch.int32, **meta), (m,) * 5, (f32,) * 9, (d0,) * 6, **kw,
            use3x3_global=True, k=None,
        )
    k64 = dict(dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        gmg.gmg_step(i32, i32, torch.empty((64, 8, 12), **k64), torch.empty((64, 8, 12), **meta),
                     torch.empty((), **k64), lr=0.025, prior=0.8, thr=0.7, init_frames=20)
    with pytest.raises(ValueError, match="CUDA"):
        texture.texture_prox_cur(torch.empty((3, 8, 12), dtype=torch.uint8, **meta),
                                 torch.empty((3, 64, 8, 12), dtype=torch.uint8, **meta))
    ml = TM.MultiLayerBGS()
    state = {k: v.to("meta") for k, v in ml.init(8, 12, 3, device="cpu").items()}
    with pytest.raises(ValueError, match="CUDA"):
        multilayer.multilayer_step(ml.config, state, torch.empty((3, 8, 12), **meta),
                                   torch.empty((6, 8, 12), **meta), torch.empty((4,), **meta),
                                   torch.empty((), **k64), True)
    fg_state = {k: v.to("meta") for k, v in TF.FGD().init(8, 12, 3, device="cpu").items()}
    u8 = dict(dtype=torch.uint8, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        fgd.fgd_tables(TF.FGDConfig(), fg_state, torch.empty((3, 8, 12), **u8), torch.empty((6, 8, 12), **u8), m,
                       torch.empty((), dtype=torch.bool, **meta))


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.build()
    assert not (tmp_path / "build").exists()
    assert {p.name for p in _native.sources()} >= {
        "consensus.cu", "fill.cu", "cc.cu", "assoc.cu", "gmg.cu", "texture.cu", "multilayer.cu", "feedback.cuh",
        "fgd.cu", "kalman.cu", "contract.cu", "pca.cu",
    }
    assert set(_native.LAUNCHES) == {
        "consensus", "flood_reach", "label_components", "greedy_assign",
        "consensus_lobster", "gmg_step", "texture_prox_cur", "multilayer_step",
        "consensus_read", "consensus_feedback", "fgd_tables", "label_fixpoint",
        "kalman_predict", "kalman_update", "contract", "pca_project", "syevd_small",
    }
    assert {"tt_consensus_read", "tt_consensus_feedback", "tt_fgd_tables", "tt_label_fixpoint", "tt_kalman_predict",
            "tt_kalman_update", "tt_contract", "tt_pca_project", "tt_syevd_small"} <= set(_native._SIGNATURES)


def test_kalman_and_resize_refuse_other_devices():
    """The Kalman, resize (contraction) and PCA wrappers take the plain
    versions only for CPU tensors: on another device they launch their
    kernel or raise."""
    from tracking_tpu_torch.ops.resize import resize_bilinear
    from tracking_tpu_torch.track import kalman

    kp = kalman.KalmanParams(*(t.to("meta") for t in kalman.default_params(device="cpu")))
    x, P = torch.empty((32, 8), device="meta"), torch.empty((32, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kalman.kalman_predict(x, P, kp)
    with pytest.raises(ValueError, match="CUDA"):
        kalman.kalman_update(x, P, torch.empty((32, 4), device="meta"),
                             torch.empty((32,), dtype=torch.bool, device="meta"), kp)
    with pytest.raises(ValueError, match="CUDA"):
        resize_bilinear(torch.empty((48, 64), device="meta"), (24, 32))
    from tracking_tpu_torch.ops import eigh, pca
    with pytest.raises(ValueError, match="CUDA"):
        pca.project(torch.empty((10, 96), device="meta"), torch.empty(96, device="meta"), torch.empty(96, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        eigh.syevd(torch.empty((1, 20, 20), device="meta"))
    # consensus takes the C plane pointers (no stacked copy); flood_reach no mark array
    P = ctypes.c_void_p
    assert _native._SIGNATURES["tt_consensus"][:3] == [P, P, P] and len(_native._SIGNATURES["tt_consensus"]) == 33
    assert _native._SIGNATURES["tt_flood_reach"] == [P] * 4 + [ctypes.c_int] * 2 + [P]
    assert "-fmad=false" in _native.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _native.NVCC_FLAGS
    assert not any("fast" in f for f in _native.NVCC_FLAGS)


def test_convert_round_trips_a_stepped_state():
    from tracking_tpu_torch.synth import make_clip

    frames = torch.from_numpy(make_clip(3, 24, 32, 3, seed=1))
    algo = TLF.SuBSENSE()
    st = algo.warm_start(algo.init(24, 32, 3, device="cpu"), frames[0])
    st, fg, bg = algo.step(st, frames[1])
    assert fg.dtype == torch.uint8 and bg.shape == (24, 32, 3)
    back = convert.state_from_numpy(convert.state_to_numpy(st), device="cpu")
    assert_tree_equal(st, back)
    assert isinstance(back["colors"], tuple) and back["key"].dtype == torch.uint32
    assert np.asarray(convert.state_to_numpy(st)["t"]).shape == ()
