"""LbpMrf in the port against the JAX package: seeded 48x64 clips of 8
frames, one frame at a time, the mask and every state leaf (histograms,
weights, background flags, life, the scene-cut grid) compared bit for bit
after every frame, with the exact min cut (the default) and with
``mrf_solver="icm"``; a clip with a scene cut (a strong colour cast from
frame 4: the u plane changes everywhere and the models reset). The JAX
package runs in a process of its own (``torch_parity.run_jax_child``). Then the front end over all 2^24
colours (Luv bit for bit) and ``ops/resize.resize_bilinear`` against
``jax.image.resize`` at the shapes both LbpMrf and MultiCue use, bit for
bit: the tests' sizes, the scene-cut grid at 720p and 1080p (720x1280 and
1080x1920 -> 24x32, XLA:CPU's dot summing in blocks of 240 and 272 rows),
at 240x320, 360x640, 480x640 and 576x720 (Eigen shards the rows over its
threads in blocks of 96, summed in its tree) and MultiCue's enlarges of a 0/255 map (120x160 -> 720x1280, and
576x720, a non-integer scale), whose einsum contracts the columns first;
with XLA:CPU's fusion on, the non-integer enlarge within 1 level on at
most 0.1 % of the pixels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_tree_equal, run_jax_child
from tracking_tpu.bgs import lbp_mrf as JLM
from tracking_tpu_torch import get_algorithm as tget
from tracking_tpu_torch.bgs import lbp_mrf as TLM
from tracking_tpu_torch.ops import mincut
from tracking_tpu_torch.ops.resize import resize_bilinear
from tracking_tpu_torch.synth import make_clip

H, W, T = 48, 64, 8


# the JAX reference's runs, one JAX LbpMrf instance in a process of its
# own (``torch_parity.run_jax_child``): per frame the mask, the background
# and every state leaf, keyed "clip/frame/name"
JAX_RUNS = """
import jax.numpy as jnp
from tracking_tpu.core.registry import get_algorithm
from tracking_tpu.runner.scan import run_video
algo = get_algorithm("LbpMrf")(mrf_solver=str(inp["solver"]))
for name in str(inp["clips"]).split(","):
    frames = inp[name]
    st = jax.jit(algo.warm_start)(algo.init(*frames.shape[1:]), jnp.asarray(frames[0]))
    for t in range(1, frames.shape[0]):
        st, (m, b) = run_video(algo, jnp.asarray(frames[t : t + 1]), state=st, with_background=True)
        out[f"{name}/{t}/mask"], out[f"{name}/{t}/bg"] = np.asarray(m[0]), np.asarray(b[0])
        for k, v in jax.device_get(st).items():
            out[f"{name}/{t}/{k}"] = np.asarray(v)
"""


def scene_cut_clip():
    """A strong colour cast from frame 4: the u plane changes everywhere."""
    frames = make_clip(T, H, W, 3, seed=8)
    frames[4:, ..., 0], frames[4:, ..., 2] = 255, frames[4:, ..., 2] // 4
    return frames


def run_port(ref: dict, name: str, frames, solver: str):
    """The port over ``frames``, every frame held to the reference's;
    returns the per-frame foreground shares and lives (of the first model
    column: the last one is visited twice)."""
    algo = tget("LbpMrf")(mrf_solver=solver)
    st = algo.warm_start(algo.init(H, W, 3, device="cpu"), torch.from_numpy(frames[0]))
    shares, lives = [], []
    for t in range(1, frames.shape[0]):
        st, m, b = algo.step(st, torch.from_numpy(frames[t]))
        np.testing.assert_array_equal(m.numpy(), ref[f"{name}/{t}/mask"], err_msg=f"{name} mask, frame {t}")
        np.testing.assert_array_equal(b.numpy(), ref[f"{name}/{t}/bg"], err_msg=f"{name} bg, frame {t}")
        assert_tree_equal({k: ref[f"{name}/{t}/{k}"] for k in st}, st, f"{name} frame {t}")
        shares.append(float((m > 0).float().mean()))
        lives.append(int(st["life"][:, 0].max()))
    return shares, lives


@pytest.mark.parametrize("solver", ["exact", "icm"])
def test_lbp_mrf_matches_reference(tmp_path, solver):
    """Per frame bit for bit; with the exact solver also the scene cut."""
    clips = {"plain": make_clip(T, H, W, 3, seed=4)}
    if solver == "exact":
        clips["cut"] = scene_cut_clip()
    ref = run_jax_child(JAX_RUNS, tmp_path, solver=np.array(solver), clips=np.array(",".join(clips)), **clips)
    mincut.reset_stats()
    shares, _ = run_port(ref, "plain", clips["plain"], solver)
    assert shares[0] == 0.0 and min(shares[1:3]) > 0.5, shares  # frames 1-2: the short-memcpy near all-FG masks
    assert min(shares[3:]) < max(shares[1:3])
    if solver == "exact":
        assert mincut.STATS["drain_rounds"] > 0
        _, lives = run_port(ref, "cut", clips["cut"], solver)
        assert lives[:5] == [0, 1, 2, 0, 1], lives  # the models reset at frame 4
    else:
        assert mincut.STATS["drain_rounds"] == 0


def test_luv_all_colours():
    jf = jax.jit(JLM._rgb2luv_u8)
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    for r in range(0, 4096, 512):
        img = rgb[r : r + 512]
        np.testing.assert_array_equal(TLM._rgb2luv_u8(torch.from_numpy(img)).numpy(), np.asarray(jf(jnp.asarray(img))))


# MultiCue's enlarge at a non-integer scale (120x160 -> PAL's 576x720, 4.8x
# and 4.5x) against XLA:CPU with its fusion on: after rounding at most 1
# level, on at most this share of pixels
ENLARGE_SHARE = 1e-3
RESIZE_CASES = [((48, 64), (24, 32), "u8"), ((24, 32), (48, 64), "mask"),
                ((120, 160), (240, 320), "mask"), ((720, 1280), (24, 32), "u8"), ((120, 160), (720, 1280), "mask"),
                ((120, 160), (576, 720), "mask"), ((1080, 1920), (24, 32), "u8"),
                # CDnet's and PAL's sizes, where XLA:CPU shards the row contraction over its threads
                ((240, 320), (24, 32), "u8"), ((360, 640), (24, 32), "u8"), ((480, 640), (24, 32), "u8"),
                ((576, 720), (24, 32), "u8")]


def check_enlarge(got, want, how):
    """A non-integer enlarge of a 0/255 map, rounded as MultiCue rounds it:
    at most 1 level, on at most ``ENLARGE_SHARE`` of the pixels."""
    d = np.abs(np.clip(np.rint(got), 0, 255) - np.clip(np.rint(want), 0, 255))
    share = float((d > 0).mean())
    print(f"{got.shape} enlarge against {how}: {int((d > 0).sum())} of {d.size} rounded pixels differ "
          f"({share:.4%}), by at most {d.max():g}; max |err| before rounding {float(np.abs(got - want).max()):.3g}")
    assert d.max() <= 1.0 and share <= ENLARGE_SHARE


@pytest.mark.parametrize("src,dst,kind", RESIZE_CASES, ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}" for a, b, _ in RESIZE_CASES])
def test_resize_bilinear(src, dst, kind):
    rng = np.random.default_rng(src[0] + dst[0])
    if kind == "u8":  # a u plane
        x = rng.integers(0, 256, src).astype(np.float32)
    else:  # MultiCue's 0/255 candidate map
        x = np.where(rng.uniform(size=src) < 0.3, 255.0, 0.0).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jax.image.resize(a, dst, "bilinear"))(jnp.asarray(x)))
    got = resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_array_equal(got, want)


# XLA:CPU with its default passes: the fusion that the tests turn off
# (``tests/conftest.py``) sums the enlarge in another order
FUSED_RESIZE = """
import os
os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "").replace("--xla_disable_hlo_passes=fusion", "")
import jax.numpy as jnp
dst = tuple(int(v) for v in inp["dst"])
out["y"] = np.asarray(jax.jit(lambda a: jax.image.resize(a, dst, "bilinear"))(jnp.asarray(inp["x"])))
"""


@pytest.mark.parametrize("seed", [0, 1])
def test_resize_enlarge_fusion_on(tmp_path, seed):
    """MultiCue's 120x160 -> 576x720 enlarge against ``jax.image.resize``
    compiled with XLA:CPU's fusion on, within the stated 1 level on 0.1 %."""
    x = np.where(np.random.default_rng(seed).uniform(size=(120, 160)) < 0.3, 255.0, 0.0).astype(np.float32)
    want = run_jax_child(FUSED_RESIZE, tmp_path, x=x, dst=np.array([576, 720]))["y"]
    check_enlarge(resize_bilinear(torch.from_numpy(x), (576, 720)).numpy(), want, "XLA:CPU's fusion on")
