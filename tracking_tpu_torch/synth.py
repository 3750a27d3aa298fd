"""Seeded synthetic surveillance video for tests and on-card checks.

A textured, noisy static background (smooth stripes plus fixed per-pixel
texture) with a few solid-coloured rectangles and ellipses that move in
straight lines, enter, cross and leave; per-frame sensor noise on top. Plain
numpy, so the JAX reference and the port are fed identical frames. Uniform
noise frames are no substitute: they drive SuBSENSE's masks to 80-94 %
foreground.
"""

from __future__ import annotations

import numpy as np


def _objects(h: int, w: int, n: int, t_len: int, rng: np.random.Generator):
    """n moving objects: (shape, half-height, half-width, colour, start, velocity).
    Velocities alternate in sign so the objects cross; they start just
    outside or inside the frame and leave it before the clip ends."""
    objs = []
    for i in range(n):
        hh = int(rng.integers(max(h // 12, 3), max(h // 7, 4) + 1))
        hw = int(rng.integers(max(w // 14, 3), max(w // 8, 4) + 1))
        colour = rng.integers(20, 236, 3)
        y = float(rng.uniform(0.25, 0.75) * h)
        span = w + 2 * hw
        speed = span / max(t_len * 0.8, 1.0) * float(rng.uniform(0.6, 1.0))
        if i % 2 == 0:
            x0, vx = -hw + 0.15 * w * i / max(n, 1), speed
        else:
            x0, vx = w + hw - 0.15 * w * i / max(n, 1), -speed
        vy = float(rng.uniform(-0.15, 0.15)) * speed
        objs.append(("ellipse" if i % 2 else "rect", hh, hw, colour, (y, x0), (vy, vx)))
    return objs


def make_clip(t_len: int, h: int, w: int, c: int = 3, seed: int = 0, n_objects: int = 3,
              brightness_jump: tuple[int, int] | None = None, noise: float = 2.5) -> np.ndarray:
    """u8 [T, H, W, C] (or [T, H, W] for c=1). ``brightness_jump=(frame,
    delta)`` adds ``delta`` to every pixel from that frame on (a global
    illumination change). ``noise`` is the per-frame sensor noise's standard
    deviation in levels: FGD's change test (a channel moving more than 2
    levels) fires on most pixels at the default 2.5, so its clips use 0.5."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 110.0 + 35.0 * np.sin(xx / 9.0 + 0.5)[..., None] * np.cos(yy / 13.0)[..., None]
    base = base + np.array([0.0, 12.0, -12.0], np.float32)[:c]
    base = base + 8.0 * rng.standard_normal((h, w, c), dtype=np.float32)
    objs = _objects(h, w, n_objects, t_len, rng)
    frames = np.empty((t_len, h, w, c), np.uint8)
    for t in range(t_len):
        f = base + noise * rng.standard_normal((h, w, c), dtype=np.float32)
        for shape, hh, hw, colour, (y0, x0), (vy, vx) in objs:
            cy, cx = y0 + vy * t, x0 + vx * t
            ya, yb = max(int(cy) - hh - 1, 0), min(int(cy) + hh + 2, h)
            xa, xb = max(int(cx) - hw - 1, 0), min(int(cx) + hw + 2, w)
            if ya >= yb or xa >= xb:
                continue
            sy, sx = yy[ya:yb, xa:xb], xx[ya:yb, xa:xb]
            if shape == "rect":
                inside = (np.abs(sy - cy) <= hh) & (np.abs(sx - cx) <= hw)
            else:
                inside = ((sy - cy) / hh) ** 2 + ((sx - cx) / hw) ** 2 <= 1.0
            f[ya:yb, xa:xb][inside] = colour[:c]
        if brightness_jump is not None and t >= brightness_jump[0]:
            f = f + brightness_jump[1]
        frames[t] = np.clip(f, 0, 255).astype(np.uint8)
    return frames[..., 0] if c == 1 else frames


def crossing_masks(t_len: int, h: int, w: int) -> np.ndarray:
    """u8 [T, H, W] 0/255 masks of two boxes crossing head-on (their
    predicted boxes overlap mid-clip), plus a speck below the area gate."""
    masks = np.zeros((t_len, h, w), np.uint8)
    bh, bw = max(h // 6, 4), max(w // 9, 4)
    for t in range(t_len):
        xa = 8 + 4 * t
        xb = w - 8 - bw - 4 * t
        ya, yb = h // 2 - bh // 2 - 4, h // 2 - bh // 2 + 4
        masks[t, ya : ya + bh, max(xa, 0) : max(xa + bw, 0)] = 255
        masks[t, yb : yb + bh, max(xb, 0) : max(xb + bw, 0)] = 255
        masks[t, 4:7, w - 10 : w - 7] = 255
    return masks


def multilayer_adversarial(h: int, w: int, seed: int = 0):
    """A MultiLayer state (5 modes, 3 colours, 6 pattern values) and a
    frame's features that drive every branch of the update on one call, as
    numpy arrays: (state with ``n``, ``bg_num`` and the mode leaves; cf f32
    [3, H, W]; pat f32 [6, H, W]). ``n`` is uniform in 0..5 and the live
    modes are weight-sorted, as the update keeps them; tail modes (m >= n)
    hold random words, which the update must keep or move as the reference
    does. About a fifth of the non-empty pixels have a faded layered last
    mode (a removal; with n = 1 the list then empties); about half see a
    frame that matches one live mode exactly in texture and within a level
    in colour (a match), a third of those on an unlayered mode with a max
    weight above 0.9 (a promotion); random layers and weight ratios make
    displacements; the rest see a random colour and pattern (no match:
    append, or overwrite the tail at n = 5); n = 0 seeds."""
    rng = np.random.default_rng(seed)
    M, C, L = 5, 3, 6
    shape = (h, w)
    f32, i32 = np.float32, np.int32
    n = rng.integers(0, M + 1, shape).astype(i32)
    live = np.arange(M)[:, None, None] < n[None]
    weight = -np.sort(-rng.uniform(0.001, 1.0, (M, *shape)), axis=0)
    max_weight = np.minimum(weight / rng.uniform(0.3, 1.0, (M, *shape)), 1.0)
    layer = rng.integers(0, 4, (M, *shape))
    bg_int = rng.uniform(0.0, 255.0, (M, C, *shape))
    min_int = bg_int - rng.uniform(0.0, 30.0, (M, C, *shape)) * (rng.random((M, C, *shape)) < 0.7)
    max_int = bg_int + rng.uniform(0.0, 30.0, (M, C, *shape)) * (rng.random((M, C, *shape)) < 0.7)
    bg_pattern = rng.uniform(0.0, 1.0, (M, L, *shape))
    ii, jj = np.indices(shape)

    # removal: the last live mode faded below min_bg_layer_weight, layered
    removal = (n > 0) & (rng.random(shape) < 0.2)
    last = np.maximum(n - 1, 0)
    weight[last[removal], ii[removal], jj[removal]] = 5e-5
    layer[last[removal], ii[removal], jj[removal]] = rng.integers(1, 4, int(removal.sum()))

    # match: the frame copies one live mode that the removal keeps
    n_keep = n - removal
    match = (n_keep > 0) & (rng.random(shape) < 0.5)
    target = np.minimum((rng.random(shape) * np.maximum(n_keep, 1)).astype(i32), np.maximum(n_keep - 1, 0))
    promote = match & (rng.random(shape) < 0.35)
    t_i, t_j, t_m = ii[promote], jj[promote], target[promote]
    layer[t_m, t_i, t_j] = 0
    max_weight[t_m, t_i, t_j] = np.maximum(weight[t_m, t_i, t_j], rng.uniform(0.92, 1.0, t_m.shape))
    cf = rng.uniform(0.0, 255.0, (C, *shape))
    pat = (rng.random((L, *shape)) < 0.5).astype(f32)
    near = np.take_along_axis(bg_int, target[None, None], axis=0)[0] + rng.uniform(-1.0, 1.0, (C, *shape))
    cf = np.where(match[None], np.clip(near, 0.0, 255.0), cf)
    pat = np.where(match[None], np.round(np.take_along_axis(bg_pattern, target[None, None], axis=0)[0]), pat)

    def tail(a, junk):
        keep_live = live.reshape(live.shape[:1] + (1,) * (a.ndim - 3) + live.shape[1:])
        return np.where(keep_live, a, junk)

    state = {
        "n": n,
        "bg_num": (rng.random(shape) * (n + 1)).astype(i32),
        "weight": tail(weight, rng.uniform(0.0, 1.0, weight.shape)).astype(f32),
        "max_weight": tail(max_weight, rng.uniform(0.0, 1.0, weight.shape)).astype(f32),
        "bg_int": tail(bg_int, rng.uniform(0.0, 255.0, bg_int.shape)).astype(f32),
        "min_int": tail(min_int, rng.uniform(0.0, 255.0, bg_int.shape)).astype(f32),
        "max_int": tail(max_int, rng.uniform(0.0, 255.0, bg_int.shape)).astype(f32),
        "bg_pattern": tail(bg_pattern, rng.uniform(0.0, 1.0, bg_pattern.shape)).astype(f32),
        "bg_layer": tail(layer, rng.integers(0, 4, layer.shape)).astype(i32),
        "layer_time": rng.integers(-1, 100, (M, *shape)).astype(i32),
        "first_time": rng.integers(-1, 100, (M, *shape)).astype(i32),
        "last_time": rng.integers(-1, 100, (M, *shape)).astype(i32),
        "freq": rng.integers(-1, 100, (M, *shape)).astype(i32),
    }
    return state, cf.astype(f32), pat.astype(f32)
