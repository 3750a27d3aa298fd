"""Hole-fill reachability: the CUDA kernel ``flood_reach`` and its plain
version, counterpart of ``tracking_tpu/ops/pallas_fill.py:flood_reach_pallas``
and the XLA fixed point in ``tracking_tpu/ops/morphology.py:reach_fixpoint``.

reach = reach0 ∪ {background pixels 4-connected through background pixels
to a background pixel of reach0}. The kernel (``csrc/fill.cu``) is a
union-find over background pixels in which the seeds are one more set,
in three launches; the plain version grows reach0 along whole rows and
columns of background runs until nothing changes.
"""

from __future__ import annotations

import torch

from tracking_tpu_torch.ops import _native


def _run_any(hit: torch.Tensor, bg: torch.Tensor) -> torch.Tensor:
    """Per row: True on every background pixel of a maximal background run
    that holds a ``hit`` pixel."""
    H, W = bg.shape
    seg = torch.cumsum((~bg).to(torch.int32), dim=1)  # run id within the row
    key = (torch.arange(H, device=bg.device, dtype=torch.int32)[:, None] * (W + 1) + seg).reshape(-1)
    acc = torch.zeros(H * (W + 1), dtype=torch.int32, device=bg.device)
    acc.index_add_(0, key, (hit & bg).to(torch.int32).reshape(-1))
    return bg & (acc[key].reshape(H, W) > 0)


def flood_reach_ref(bg: torch.Tensor, reach0: torch.Tensor) -> torch.Tensor:
    """Plain torch: exact fixed point of the reachability (no sweep cap)."""
    r = reach0.clone()
    while True:
        new = r | _run_any(r, bg)
        new = new | _run_any(new.t(), bg.t()).t()
        if torch.equal(new, r):
            return r
        r = new


def flood_reach(bg: torch.Tensor, reach0: torch.Tensor) -> torch.Tensor:
    """bg, reach0: [H, W] bool -> reach [H, W] bool. CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if bg.device.type == "cpu":
        return flood_reach_ref(bg, reach0)
    H, W = bg.shape
    _native.require(bg, "bg", torch.bool, (H, W))
    _native.require(reach0, "reach0", torch.bool, (H, W))
    parent = torch.empty((H, W), dtype=torch.int32, device=bg.device)
    out = torch.empty((H, W), dtype=torch.bool, device=bg.device)
    rc = _native.library().tt_flood_reach(
        bg.data_ptr(), reach0.data_ptr(), parent.data_ptr(), out.data_ptr(), H, W, _native.stream_ptr(),
    )
    _native.check(rc, "flood_reach")
    _native.count_launch("flood_reach")
    return out
