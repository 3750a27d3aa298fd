"""Shared helpers of the port's parity tests (tests/test_torch_*.py): feed
numpy inputs to the JAX reference and to ``tracking_tpu_torch`` and compare
the results leaf by leaf."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tracking_tpu.runner.scan import run_video as jrun
from tracking_tpu_torch.convert import state_from_numpy
from tracking_tpu_torch.runner.scan import run_video as trun

# The torch side of these tests works on small arrays: one intra-op thread
# keeps xdist's parallel workers from oversubscribing the cores.
torch.set_num_threads(1)

def to_torch(tree):
    """numpy / JAX pytree of arrays (tuples, dicts) -> the same of CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True))


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return {k: to_numpy(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, (tuple, list)):
        return tuple(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def assert_tree_equal(ref, got, path: str = "", tol: dict | None = None) -> None:
    """Leaf by leaf: same structure, dtype and shape, and bit-exact values
    unless ``tol`` maps a leaf name to (rtol, atol)."""
    ref, got = to_numpy(ref), to_numpy(got)
    if isinstance(ref, dict):
        assert set(ref) == set(got), (path, sorted(set(ref) ^ set(got)))
        for k in ref:
            assert_tree_equal(ref[k], got[k], f"{path}/{k}", tol)
        return
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(ref) == len(got), path
        for i, (a, b) in enumerate(zip(ref, got)):
            assert_tree_equal(a, b, f"{path}[{i}]", tol)
        return
    assert ref.dtype == got.dtype, (path, ref.dtype, got.dtype)
    assert ref.shape == got.shape, (path, ref.shape, got.shape)
    leaf = path.rsplit("/", 1)[-1]
    if tol and leaf in tol:
        rtol, atol = tol[leaf]
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=path)
    else:
        np.testing.assert_array_equal(got, ref, err_msg=path)


def assert_step_equal(t, ref, got):
    """Default per-frame check of :func:`run_both`: mask, bg image and every
    state leaf bit-exact. ``ref`` = (mask, bg, state) of the JAX package as
    numpy, ``got`` the port's as tensors."""
    np.testing.assert_array_equal(got[0].numpy(), ref[0], err_msg=f"mask, frame {t}")
    np.testing.assert_array_equal(got[1].numpy(), ref[1], err_msg=f"bg, frame {t}")
    assert_tree_equal(ref[2], got[2], f"frame {t}")


def run_both(ja, ta, frames, jstate=None, check=assert_step_equal):
    """Warm-start the JAX algorithm ``ja`` and its port ``ta`` on frame 0
    (or start both from the JAX state ``jstate``) and step frames 1.. one at
    a time through both packages' ``run_video``, calling ``check(t, ref,
    got)`` after each frame. Returns the per-frame foreground shares and the
    port's final state."""
    h, w = frames.shape[1:3]
    c = frames.shape[3] if frames.ndim == 4 else 1
    if jstate is None:
        js = jax.jit(ja.warm_start)(ja.init(h, w, c), jnp.asarray(frames[0]))
        ts = ta.warm_start(ta.init(h, w, c, device="cpu"), torch.from_numpy(frames[0]))
        assert_tree_equal(jax.device_get(js), ts, "warm_start")
    else:
        js = jstate
        ts = state_from_numpy(jax.device_get(js), device="cpu")
    shares = []
    for t in range(1, frames.shape[0]):
        js, (jm, jb) = jrun(ja, jnp.asarray(frames[t : t + 1]), state=js, with_background=True)
        ts, (tm, tb) = trun(ta, torch.from_numpy(frames[t : t + 1]), state=ts, with_background=True)
        check(t, (np.asarray(jm), np.asarray(jb), jax.device_get(js)), (tm, tb, ts))
        shares.append(float((tm.numpy() > 0).mean()))
    return shares, ts


def count_calls(monkeypatch, module, name):
    """Replace ``module.name`` for the test with a wrapper that records each
    call; returns the record (a list that grows by one per call). Shows
    which branch a step took: a JAX step calls a function it imports from a
    module while it is traced, the port's at every step."""
    calls = []
    fn = getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


def step_both(jstep, tt, js, ts, mask):
    """One step of both trackers (``jstep`` = the jitted JAX step), compared."""
    js, jtr = jstep(js, jnp.asarray(mask))
    ts, ttr = tt.step(ts, torch.from_numpy(np.array(mask)))
    assert_tree_equal(jax.device_get(js)._asdict(), ts)
    assert_tree_equal(jax.device_get(jtr)._asdict(), ttr._asdict())
    return js, ts, jtr


EDGE_CASES = ("checkerboard", "comb33", "row", "column", "pixel_bg", "pixel_fg")
CC_CASES = EDGE_CASES + ("teeth33", "serpentine", "random_odd")


def edge_mask(case):
    """Masks that union-find designs over 32-px tiles have to get right,
    True = the set the kernel joins (background for the fill, foreground
    for CC): a checkerboard (one set 8-connected, all singletons
    4-connected), the gaps of a comb of period 33 whose teeth straddle the
    tiles (every other gap closed at the top; ``teeth33`` is the comb
    itself), 1 x W, H x 1 and 1 x 1 masks, a serpentine corridor turning in
    every other row (one set through every tile row) and a random mask at
    an odd width."""
    y, x = np.mgrid[:40, :100]
    if case == "teeth33":
        return ~edge_mask("comb33")
    if case == "serpentine":
        gap = np.where((y // 2) % 2 == 0, x == 99, x == 0)
        return ~((y % 2 == 1) & ~gap)
    if case == "random_odd":
        return np.random.default_rng(11).uniform(size=(37, 99)) < 0.45
    rng = np.random.default_rng(5)
    return {
        "checkerboard": (y + x) % 2 == 0,
        "comb33": ~(((x % 33 == 32) & (y >= 1)) | ((y == 1) & ((x // 33) % 2 == 1))),
        "row": rng.uniform(size=(1, 70)) > 0.3,
        "column": rng.uniform(size=(40, 1)) > 0.3,
        "pixel_bg": np.ones((1, 1), bool),
        "pixel_fg": np.zeros((1, 1), bool),
    }[case]


def component_min(fg, lab0, big, conn):
    """Independent oracle: BFS per component of ``fg`` (8- or 4-connected),
    the minimum of ``lab0`` on each component's pixels, ``big`` elsewhere."""
    h, w = fg.shape
    out = np.full((h, w), big, np.int32)
    seen = np.zeros((h, w), bool)
    nbrs = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy or dx) and (conn == 8 or dy == 0 or dx == 0)]
    for y0, x0 in zip(*np.nonzero(fg)):
        if seen[y0, x0]:
            continue
        comp, stack = [], [(y0, x0)]
        seen[y0, x0] = True
        while stack:
            y, x = stack.pop()
            comp.append((y, x))
            for dy, dx in nbrs:
                yy, xx = y + dy, x + dx
                if 0 <= yy < h and 0 <= xx < w and fg[yy, xx] and not seen[yy, xx]:
                    seen[yy, xx] = True
                    stack.append((yy, xx))
        m = min(lab0[p] for p in comp)
        for p in comp:
            out[p] = m
    return out


CHILD_PRELUDE = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
inp = dict(np.load(sys.argv[1]))
out = {}
"""


def run_jax_child(code: str, tmp_path, **arrays) -> dict:
    """Run ``code`` in a fresh Python process with JAX on the CPU as the
    tests set it up (the inherited ``XLA_FLAGS``, fusion off): ``inp`` holds
    ``arrays``, and the numpy arrays the code puts into the dict ``out``
    come back. For JAX code that must be compiled once per process: the
    JAX package's exact LbpMrf step, lowered a second time in one process,
    runs its first call and then fails on the cached executable (jax 0.9:
    "Execution supplied 8 buffers but compiled program expected 19")."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src, dst = str(tmp_path / "child_in.npz"), str(tmp_path / "child_out.npz")
    np.savez(src, **arrays)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.path.join(root, "tests")] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    prog = CHILD_PRELUDE + code + "\nnp.savez(sys.argv[2], **out)\n"
    res = subprocess.run([sys.executable, "-c", prog, src, dst], env=env, cwd=str(tmp_path), capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(dst))
