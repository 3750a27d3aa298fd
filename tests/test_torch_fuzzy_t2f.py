"""The fuzzy-integral (FuzzySugenoIntegral, FuzzyChoquetIntegral) and
type-2 fuzzy GMM / MRF algorithms (T2FGMM_UM/UV, T2FMRF_UM/UV) in the port
against the JAX package: both packages' ``run_video`` over seeded frames
at 24x32, with the mask, the background image and every state leaf
compared bit for bit after every frame, at the defaults and at configs
that reach the other branches (colour spaces 2-4, option 1, no smoothing,
grey frames; the MRF smoothing on, past t >= 10); and the ops they are
built of (``ops/fuzzy``, ``ops/mrf.icm_relax``) on random inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import count_calls, run_both
from tracking_tpu.core.registry import get_algorithm as jget
from tracking_tpu.ops import fuzzy as JFZ
from tracking_tpu.ops import mrf as JMRF
from tracking_tpu_torch import get_algorithm as tget
from tracking_tpu_torch.bgs import t2f as TT2F
from tracking_tpu_torch.ops import fuzzy as TFZ
from tracking_tpu_torch.ops import mrf as TMRF
from tracking_tpu_torch.synth import make_clip

H, W = 24, 32
FUZZY_T = 18  # 10 learning frames, then detection
FUZZY_CASES = [{}, {"colorSpace": 2}, {"colorSpace": 3}, {"colorSpace": 4}, {"option": 1}, {"smooth": False}]


def _ids(cases):
    return ["-".join(f"{k}{v}" for k, v in c.items()) or "default" for c in cases]


@pytest.mark.parametrize("cfg", FUZZY_CASES, ids=_ids(FUZZY_CASES))
@pytest.mark.parametrize("name", ["FuzzySugenoIntegral", "FuzzyChoquetIntegral"])
def test_fuzzy_matches_reference(name, cfg):
    frames = make_clip(FUZZY_T, H, W, 3, seed=1)
    shares, st = run_both(jget(name)(**cfg), tget(name)(**cfg), frames)
    learn = jget(name).Config().framesToLearn
    assert not any(shares[:learn]) and max(shares[learn:]) > 0.0  # empty while learning, then FG
    assert int(st["t"]) == FUZZY_T - 1


@pytest.mark.parametrize("name", ["FuzzySugenoIntegral", "FuzzyChoquetIntegral"])
def test_fuzzy_grey(name):
    frames = make_clip(FUZZY_T, H, W, 1, seed=2)
    shares, _ = run_both(jget(name)(), tget(name)(), frames)
    assert max(shares) > 0.0


@pytest.mark.parametrize("space", [1, 2, 3, 4])
def test_color_convert(space):
    """Every colour space on random unit floats, grey pixels (HSV's
    diff = 0) and saturated ones included."""
    rng = np.random.default_rng(space)
    x = rng.integers(0, 256, (20, 30, 3)).astype(np.float32) / np.float32(255)
    x[:4] = x[:4, :, :1]  # grey
    x[4:6, :, 1:] = 0.0
    want = jax.jit(JFZ.color_convert_f32, static_argnums=1)(jnp.asarray(x), space)
    got = TFZ.color_convert_f32(torch.from_numpy(x), space)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("integral", ["sugeno_integral", "choquet_integral"])
@pytest.mark.parametrize("g", [(0.4, 0.3, 0.3), (0.6, 0.3, 0.1)])
def test_integrals(integral, g):
    """Random criteria with ties (the network swaps on strict < only), and
    the fuzzy LBP and ratio that feed them."""
    rng = np.random.default_rng(len(integral))
    hi = rng.choice(np.float32([0.0, 0.25, 0.5, 0.7, 1.0]), (16, 24, 3))
    hi[8:] = rng.uniform(size=(8, 24, 3)).astype(np.float32)
    want = jax.jit(getattr(JFZ, integral), static_argnums=1)(jnp.asarray(hi), g)
    np.testing.assert_array_equal(getattr(TFZ, integral)(torch.from_numpy(hi), g).numpy(), np.asarray(want))
    a, b = hi[..., 0], hi[..., 1]
    np.testing.assert_array_equal(TFZ.fuzzy_lbp(torch.from_numpy(a)).numpy(),
                                  np.asarray(jax.jit(JFZ.fuzzy_lbp)(jnp.asarray(a))))
    np.testing.assert_array_equal(TFZ.similarity_ratio(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                  np.asarray(jax.jit(JFZ.similarity_ratio)(jnp.asarray(a), jnp.asarray(b))))


T2F_T = 16


# UM's membership bound is lenient: at the defaults every pixel of the
# clip matches its first mode, so a tighter threshold reaches new modes
T2F_CASES = [(n, {}) for n in ("T2FGMM_UM", "T2FGMM_UV", "T2FMRF_UM", "T2FMRF_UV")] + [
    (n, {"threshold": 2.0}) for n in ("T2FGMM_UM", "T2FMRF_UM")]


@pytest.mark.parametrize("c", [3, 1])
@pytest.mark.parametrize("name,cfg", T2F_CASES, ids=[n + "-" + _ids([c])[0] for n, c in T2F_CASES])
def test_t2f_matches_reference(name, cfg, c):
    frames = make_clip(T2F_T, H, W, c, seed=3 + c)
    shares, st = run_both(jget(name)(**cfg), tget(name)(**cfg), frames)
    assert shares[0] == 1.0  # the first frame has no model
    if cfg or name.endswith("UV"):  # new modes joined, and the mask fires after the first frame
        assert int(st["n"].max()) >= 2 and max(shares[1:]) > 0.0


@pytest.mark.parametrize("c", [3, 1])
@pytest.mark.parametrize("name", ["T2FMRF_UM", "T2FMRF_UV"])
def test_t2fmrf_with_mrf(monkeypatch, name, c):
    """``applyMRF=True``: the ICM smoothing runs every frame in the port
    and changes the mask from t = 10 on (frames 11 and later), in both
    packages alike (UM at the tighter threshold, where its mask fires)."""
    cfg = {"threshold": 2.0} if name.endswith("UM") else {}
    j_calls = count_calls(monkeypatch, JMRF, "icm_relax")
    t_calls = count_calls(monkeypatch, TT2F, "icm_relax")
    frames = make_clip(T2F_T, H, W, c, seed=5 + c)
    plain, _ = run_both(jget(name)(**cfg), tget(name)(**cfg), frames)
    smoothed, _ = run_both(jget(name)(applyMRF=True, **cfg), tget(name)(applyMRF=True, **cfg), frames)
    assert len(t_calls) == T2F_T - 1 and len(j_calls) >= 1
    assert smoothed[:10] == plain[:10] and smoothed[10:] != plain[10:]


@pytest.mark.parametrize("enabled", [True, False])
def test_icm_relax(enabled):
    rng = np.random.default_rng(7)
    mask = (rng.uniform(size=(20, 28)) < 0.4).astype(np.uint8) * 255
    old = (rng.uniform(size=(20, 28)) < 0.4).astype(np.uint8) * 255
    gray = rng.uniform(0, 255, (20, 28)).astype(np.float32)
    mu0 = rng.uniform(0, 255, (20, 28)).astype(np.float32)
    var0 = rng.choice(np.float32([0.0, 1.0, 7.5, 36.0, 180.0]), (20, 28))
    args = (mask, gray, mu0, var0, old)
    want = jax.jit(lambda *a: JMRF.icm_relax(*a, enabled=enabled))(*map(jnp.asarray, args))
    got = TMRF.icm_relax(*map(torch.from_numpy, args), enabled=enabled)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert enabled == (not np.array_equal(got.numpy(), mask))
