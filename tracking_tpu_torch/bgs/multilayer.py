"""MultiLayerBGS (type 23), counterpart of ``tracking_tpu/bgs/multilayer.py``
(Yao and Odobez 2007, ``jmo/CMultiLayerBGS``).

Per pixel ≤ 5 modes, each an LBP pattern (6 points, radius 2, on grey), an
RGB mean with running minimum and maximum, a weight and its maximum, and a
background-layer number. Per frame: the LBP pattern of the frame, the
per-pixel model update (``ops/multilayer.py``: the CUDA kernel
``multilayer_step`` on CUDA tensors, which updates the state in place, or
its plain version with ``step(..., use_kernels=False)``), then the distance
map Gaussian-smoothed (9×9, σ = 3) and thresholded at 0.2. The first frame's
mask is empty. The wrapper's status machine is kept: LEARN or DETECT rates,
and ``detectAfter`` flipping LEARN to DETECT at that frame.

The model's persistence is the tracking app's, as in the reference
(``runner/cli.py``): with ``bg_model_preload`` set to an existing file the
app loads the state from it in place of the warm start, and in LEARN mode
with ``saveModel`` it writes the final state there
(``MultiLayerBGS.cpp:36-48,94-98``; ``core/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm, State, StepResult
from tracking_tpu_torch.core.config import BGSConfig
from tracking_tpu_torch.core.registry import register
from tracking_tpu_torch.ops.color import bgr2gray_u8
from tracking_tpu_torch.ops.filters import gaussian_blur
from tracking_tpu_torch.ops.multilayer import PI, multilayer_step, multilayer_step_ref

# 6-point radius-2 LBP offsets: (dx, dy) = (round(2cosθ), round(−2sinθ))
_ML_OFFSETS = ((2, 0), (1, -2), (-1, -2), (-2, 0), (-1, 2), (1, 2))
L = len(_ML_OFFSETS)


def shift_zero(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """dst(y, x) = img(y + dy, x + dx), zero outside (CalShiftedImage)."""
    h, w = img.shape
    out = torch.zeros_like(img)
    ys0, ys1 = max(dy, 0), min(h + dy, h)
    xs0, xs1 = max(dx, 0), min(w + dx, w)
    yd0, xd0 = max(-dy, 0), max(-dx, 0)
    out[yd0 : yd0 + ys1 - ys0, xd0 : xd0 + xs1 - xs0] = img[ys0:ys1, xs0:xs1]
    return out


@dataclasses.dataclass(frozen=True)
class MultiLayerConfig(BGSConfig):
    # wrapper defaults (loadDefaultParams path, MultiLayerBGS.cpp:111-160)
    max_mode_num: int = 5
    weight_updating_constant: float = 5.0
    texture_weight: float = 0.5
    bg_mode_percent: float = 0.6
    pattern_neig_half_size: int = 4
    pattern_neig_gaus_sigma: float = 3.0
    bg_prob_threshold: float = 0.2
    bg_prob_updating_threshold: float = 0.2
    robust_LBP_constant: float = 3.0
    min_noised_angle: float = 10.0 / 180.0 * PI
    shadow_rate: float = 0.6
    highlight_rate: float = 1.2
    frame_duration: float = 0.1
    mode_learn_rate_per_second: float = 0.5
    weight_learn_rate_per_second: float = 0.5
    init_mode_weight: float = 0.05
    # wrapper status machine (MultiLayerBGS.cpp:44-216)
    status: str = "MLBGS_LEARN"
    detectAfter: int = 0
    detect_mode_learn_rate_per_second: float = 0.01
    detect_weight_learn_rate_per_second: float = 0.01
    detect_init_mode_weight: float = 0.001
    bg_model_preload: str = ""
    saveModel: bool = False
    disableLearning: bool = False
    showOutput: bool = True
    # constants (BGS.h / ctor)
    reliable_bg_mode_weight: float = 0.9
    min_bg_layer_weight: float = 1e-4
    min_lbp_binary_prob: float = 0.1


@register("MultiLayerBGS", type_id=23, aliases=("multilayer",))
class MultiLayerBGS(BGSAlgorithm):
    Config = MultiLayerConfig

    def __init__(self, config=None, **overrides):
        super().__init__(config, **overrides)
        cfg = self.config
        if cfg.detectAfter > 0 and not self._detect() and cfg.disableLearning:
            raise ValueError(
                "disableLearning applies in DETECT mode; combined with detectAfter set "
                "status='MLBGS_DETECT' for the detect phase instead"
            )

    def _detect(self) -> bool:
        return self.config.status.upper().endswith("DETECT")

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> State:
        M = self.config.max_mode_num
        c = max(c, 1)

        def full(shape, v, dtype):
            return torch.full(shape, v, dtype=dtype, device=device)

        f32, i32 = torch.float32, torch.int32
        return {
            "t": full((), 0, i32),
            "n": full((h, w), 0, i32),
            "bg_num": full((h, w), 0, i32),
            "weight": full((M, h, w), 0.0, f32),
            "max_weight": full((M, h, w), 0.0, f32),
            "bg_int": full((M, c, h, w), 0.0, f32),
            "min_int": full((M, c, h, w), 0.0, f32),
            "max_int": full((M, c, h, w), 0.0, f32),
            "bg_pattern": full((M, L, h, w), 0.0, f32),
            "bg_layer": full((M, h, w), 0, i32),
            "layer_time": full((M, h, w), -1, i32),
            "first_time": full((M, h, w), -1, i32),
            "last_time": full((M, h, w), -1, i32),
            "freq": full((M, h, w), -1, i32),
        }

    def rates(self, frame_idx: torch.Tensor) -> torch.Tensor:
        """f32 [4] = (lr, wlr, imw, 1 − lr) on the frame's device
        (``multilayer.py:176-205``). Under ``detectAfter`` the detect rates
        start after that frame (0.01/s and 0.001, as the reference
        hard-codes them), chosen on the card without a host sync."""
        cfg = self.config
        dev = frame_idx.device
        detect = self._detect()
        learn_r = (cfg.mode_learn_rate_per_second * cfg.frame_duration,
                   cfg.weight_learn_rate_per_second * cfg.frame_duration, cfg.init_mode_weight)
        if cfg.detectAfter > 0 and not detect:
            det_r = (0.01 * cfg.frame_duration, 0.01 * cfg.frame_duration, 0.001)
            r = torch.where(
                frame_idx > cfg.detectAfter,
                torch.tensor(det_r, dtype=torch.float32, device=dev),
                torch.tensor(learn_r, dtype=torch.float32, device=dev),
            )
            return torch.cat([r, 1.0 - r[:1]])  # 1 − lr in f32, as on a traced rate
        if detect:
            learn_r = (cfg.detect_mode_learn_rate_per_second * cfg.frame_duration,
                       cfg.detect_weight_learn_rate_per_second * cfg.frame_duration, cfg.detect_init_mode_weight)
        return torch.tensor((*learn_r, 1 - learn_r[0]), dtype=torch.float32, device=dev)

    def features(self, frame: torch.Tensor):
        """The frame as the update takes it: colour planes cf f32 [3, H, W]
        and the LBP pattern of its grey image, f32 0/1 [6, H, W]."""
        f3 = frame if frame.ndim == 3 else frame[..., None].expand(*frame.shape, 3)
        gray = bgr2gray_u8(f3).to(torch.float32)
        cur_pat = torch.stack(
            [
                (gray - shift_zero(gray, dx, dy) + self.config.robust_LBP_constant > 0).to(torch.float32)
                for dx, dy in _ML_OFFSETS
            ]
        )
        return f3.permute(2, 0, 1).to(torch.float32).contiguous(), cur_pat

    def step(self, state: State, frame: torch.Tensor, use_kernels: bool = True) -> StepResult:
        cfg = self.config
        frame_idx = state["t"] + 1  # SetNewImage pre-increments the frame index
        learn = not (self._detect() and cfg.disableLearning)
        cf, cur_pat = self.features(frame)
        first_frame = state["n"][0, 0] == 0  # read before the kernel updates n in place

        fn = multilayer_step if use_kernels else multilayer_step_ref
        maps, out_dist = fn(cfg, state, cf, cur_pat, self.rates(frame_idx), frame_idx, learn)
        new_state = {"t": frame_idx, **maps}

        ksize = 2 * cfg.pattern_neig_half_size + 1
        dist_s = gaussian_blur(out_dist, ksize, cfg.pattern_neig_gaus_sigma)
        fg = torch.where(dist_s > cfg.bg_prob_threshold, 255, 0).to(torch.uint8)
        fg = torch.where(first_frame, torch.zeros_like(fg), fg)
        bg = torch.clamp(torch.round(new_state["bg_int"][0]), 0, 255).to(torch.uint8).permute(1, 2, 0)
        if frame.ndim == 2:
            bg = bg[..., 0]
        return new_state, fg, bg.contiguous()
