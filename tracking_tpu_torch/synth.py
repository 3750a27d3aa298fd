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
