"""Functional BGS algorithm contract, counterpart of ``tracking_tpu/bgs/base.py``.

    state0         = algo.init(h, w, c, device="cuda")
    state0         = algo.warm_start(state0, frame0)
    state1, fg, bg = algo.step(state0, frame)      # one frame, [H, W, C] u8

A state is a dict of tensors with the JAX pytree's leaf names, shapes and
dtypes (colour channels as tuples of [H, W] / [N, H, W] tensors), so a
state converts to and from the JAX package's (``tracking_tpu_torch.convert``)
and compares leaf by leaf. ``fg`` is a u8 [H, W] mask (0/255), ``bg`` the u8
background image. ``init`` makes the state on the card unless ``device``
says otherwise; no entry point falls back to the CPU by itself.
"""

from __future__ import annotations

from typing import Any, ClassVar, Optional, Tuple

import torch

from tracking_tpu_torch.core.config import BGSConfig

State = Any  # a dict of tensors
StepResult = Tuple[State, torch.Tensor, torch.Tensor]


class BGSAlgorithm:
    """Base class. Subclasses set ``Config`` and implement ``init`` / ``step``."""

    name: ClassVar[str] = "?"
    type_id: ClassVar[Optional[int]] = None
    Config: ClassVar[type] = BGSConfig

    def __init__(self, config: Optional[BGSConfig] = None, **overrides: Any):
        cfg = config if config is not None else self.Config()
        if overrides:
            cfg = cfg.replace(**overrides)
        self.config = cfg

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        raise NotImplementedError

    def warm_start(self, state: State, frame: torch.Tensor) -> State:
        """One-time model seeding from the first frame. Default: no-op."""
        return state

    def step(self, state: State, frame: torch.Tensor) -> StepResult:
        """One frame: (new state, fg, bg). ``step`` consumes ``state``: a
        kernel may update its model tensors in place (GMG's, MultiLayer's
        and the consensus banks do on the card), so after the call only the
        returned state is valid, on every path; returned masks and bg images
        stay valid. A caller that needs the old state keeps a clone."""
        raise NotImplementedError

    @staticmethod
    def _first_frame_select(t: torch.Tensor, stored: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
        """On frame 0 adopt ``frame`` as the stored model image (the
        reference's ``if (img.empty()) input.copyTo(img)``); ``t`` stays on
        the device."""
        return torch.where(t == 0, frame, stored)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.config})"
