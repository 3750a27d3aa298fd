"""Frame-loop runner, counterpart of ``tracking_tpu/runner/scan.py``.

The JAX runner scans a compiled step over a ``[T, H, W, C]`` chunk; PyTorch
runs eagerly, so here the scan is a Python loop over frames."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State


def make_step_fn(algo: BGSAlgorithm, with_background: bool = False):
    """Return a (state, frame) -> (state, outputs) body."""

    def body(state, frame):
        state, fg, bg = algo.step(state, frame)
        if with_background:
            return state, (fg, bg)
        return state, fg

    return body


def run_video(
    algo: BGSAlgorithm,
    frames: torch.Tensor,
    state: Optional[State] = None,
    with_background: bool = False,
) -> Tuple[State, torch.Tensor]:
    """Run ``algo`` over frames [T, H, W(, C)] u8. Returns (final_state,
    masks [T, H, W]) or, with ``with_background``, (state, (masks, bgs)).
    A fresh state is made on the frames' device and warm-started from frame
    0; pass the returned state back in to continue a stream."""
    if state is None:
        h, w = frames.shape[1], frames.shape[2]
        c = frames.shape[3] if frames.ndim == 4 else 1
        state = algo.init(h, w, c, device=frames.device)
        state = algo.warm_start(state, frames[0])
    body = make_step_fn(algo, with_background)
    outs = []
    for t in range(frames.shape[0]):
        state, out = body(state, frames[t])
        outs.append(out)
    if with_background:
        return state, (torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]))
    return state, torch.stack(outs)
