"""Package-level checks of the PyTorch port: it imports without JAX or the
JAX package, its configs and states mirror the reference's, and its kernel
wrappers never fall back silently."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal
from tracking_tpu.bgs import lbsp_family as JLF
from tracking_tpu.core.registry import list_algorithms as j_list_algorithms
from tracking_tpu.track import tracker as JTR
from tracking_tpu_torch import convert, get_algorithm, list_algorithms
from tracking_tpu_torch.bgs import lbsp_family as TLF
from tracking_tpu_torch.ops import _native, assoc, cc, consensus, fill
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


@pytest.mark.parametrize("ref,port", [(JLF.SuBSENSEConfig, TLF.SuBSENSEConfig), (JTR.TrackerConfig, TTR.TrackerConfig)])
def test_config_fields_and_defaults_match(ref, port):
    def spec(cls):
        return [(f.name, f.default, f.init) for f in dataclasses.fields(cls)]

    assert spec(port) == spec(ref)
    assert port() == port().replace()


def test_registry():
    cls = get_algorithm("subsense")
    assert cls is get_algorithm(36) is get_algorithm("SuBSENSEBGS") is TLF.SuBSENSE
    assert cls.type_id == 36
    assert set(list_algorithms()) <= set(j_list_algorithms())
    with pytest.raises(KeyError):
        get_algorithm("LOBSTERBGS")


@pytest.mark.parametrize("c", [1, 3])
def test_init_state_mirrors_reference(c):
    """Same leaf names, shapes, dtypes and values as the JAX pytree, and the
    converter round-trips it."""
    h, w = 24, 40
    want = jax.device_get(JLF.SuBSENSE().init(h, w, c))
    got = TLF.SuBSENSE().init(h, w, c)
    assert_tree_equal(want, got)
    assert_tree_equal(want, convert.state_from_numpy(want))
    assert_tree_equal(got, convert.state_from_numpy(convert.state_to_numpy(got)))


def test_tracker_state_mirrors_reference():
    want = jax.device_get(JTR.BlobTracker().init())
    got = TTR.BlobTracker().init()
    assert list(got) == list(JTR.TrackTable._fields)
    assert_tree_equal(want._asdict(), got)
    assert_tree_equal(want._asdict(), convert.state_from_numpy(want))


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


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.build()
    assert not (tmp_path / "build").exists()
    assert {p.name for p in _native.sources()} >= {"consensus.cu", "fill.cu", "cc.cu", "assoc.cu"}
    assert "-fmad=false" in _native.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _native.NVCC_FLAGS
    assert not any("fast" in f for f in _native.NVCC_FLAGS)


def test_convert_round_trips_a_stepped_state():
    from tracking_tpu_torch.synth import make_clip

    frames = torch.from_numpy(make_clip(3, 24, 32, 3, seed=1))
    algo = TLF.SuBSENSE()
    st = algo.warm_start(algo.init(24, 32, 3), frames[0])
    st, fg, bg = algo.step(st, frames[1])
    assert fg.dtype == torch.uint8 and bg.shape == (24, 32, 3)
    back = convert.state_from_numpy(convert.state_to_numpy(st))
    assert_tree_equal(st, back)
    assert isinstance(back["colors"], tuple) and back["key"].dtype == torch.uint32
    assert np.asarray(convert.state_to_numpy(st)["t"]).shape == ()
