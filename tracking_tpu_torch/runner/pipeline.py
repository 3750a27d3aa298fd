"""PreProcessor and FrameProcessor, counterpart of ``tracking_tpu/runner/pipeline.py``.

The reference's ``FrameProcessor`` owns one optional instance of every BGS
algorithm behind ``enableX`` flags and runs the PreProcessor, then each
enabled algorithm in turn, on the same prepped frame
(``FrameProcessor.cpp:169-340``, ``FrameProcessor.h:80-242``). The JAX
package scans all of them in one compiled pass; here :meth:`FrameProcessor.run`
is a Python loop over frames, one step of each enabled algorithm a frame,
on the frames' device.

tictoc (``FrameProcessor.cpp:157-167,484-494``) is :meth:`FrameProcessor.profile`:
each algorithm's seconds over a chunk, timed with CUDA events on the card
(host clocks on the CPU).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tracking_tpu_torch.bgs.base import BGSAlgorithm
from tracking_tpu_torch.core.config import BGSConfig, config_from_xml, config_to_xml
from tracking_tpu_torch.ops.filters import gaussian_blur
from tracking_tpu_torch.ops.hist import equalize_hist


@dataclasses.dataclass(frozen=True)
class PreProcessorConfig(BGSConfig):
    """config/PreProcessor.xml (``PreProcessor.cpp:128-150``)."""

    equalizeHist: bool = False
    gaussianBlur: bool = False
    enableShow: bool = True


class PreProcessor:
    """BGR -> (optional equalisation) -> (optional 7×7 σ = 1.5 blur). The
    output stays colour, as the reference's (``PreProcessor.cpp:56``);
    ``equalizeHist`` applies to grey input only, the one configuration the
    reference runs."""

    Config = PreProcessorConfig

    def __init__(self, config: Optional[PreProcessorConfig] = None, **kw):
        cfg = config or PreProcessorConfig()
        self.config = cfg.replace(**kw) if kw else cfg

    def process(self, frame: torch.Tensor) -> torch.Tensor:
        out = frame
        if self.config.equalizeHist and frame.ndim == 2:
            out = equalize_hist(out)
        if self.config.gaussianBlur:
            out = gaussian_blur(out, 7, 1.5)
        return out

    @staticmethod
    def rotate(frame: torch.Tensor, angle_deg: float) -> torch.Tensor:
        """The reference's (unused) ``PreProcessor::rotate``
        (``PreProcessor.cpp:79-104``, cvWarpAffine about the centre):
        bilinear, zero outside, in f32 with the rotation's cosine and sine
        rounded to f32, as the JAX package computes it."""
        h, w = frame.shape[0], frame.shape[1]
        dev = frame.device
        th = np.deg2rad(-angle_deg)  # cv2DRotationMatrix's angle convention
        c, s = float(np.float32(np.cos(th))), float(np.float32(np.sin(th)))
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
        xr, yr = xx.to(torch.float32) - cx, yy.to(torch.float32) - cy
        # destination -> source
        sx = c * xr + s * yr + cx
        sy = -s * xr + c * yr + cy
        x0 = torch.floor(sx).to(torch.int32).clamp(0, w - 1)
        y0 = torch.floor(sy).to(torch.int32).clamp(0, h - 1)
        x1, y1 = (x0 + 1).clamp(0, w - 1), (y0 + 1).clamp(0, h - 1)
        fx, fy = (sx - x0).clamp(0.0, 1.0), (sy - y0).clamp(0.0, 1.0)
        f = frame.to(torch.float32)
        if frame.ndim == 3:
            fx, fy = fx[..., None], fy[..., None]
        y0, y1, x0, x1 = (i.long() for i in (y0, y1, x0, x1))
        v = (f[y0, x0] * (1 - fx) * (1 - fy) + f[y0, x1] * fx * (1 - fy)
             + f[y1, x0] * (1 - fx) * fy + f[y1, x1] * fx * fy)
        inside = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
        if frame.ndim == 3:
            inside = inside[..., None]
        return torch.where(inside, torch.round(v), 0.0).to(frame.dtype)


_ENABLE_FLAGS = (
    # verbatim flag order of config/FrameProcessor.xml (FrameProcessor.h:80-242);
    # values are the registry names the flags enable
    ("enableFrameDifferenceBGS", "FrameDifferenceBGS"),
    ("enableStaticFrameDifferenceBGS", "StaticFrameDifferenceBGS"),
    ("enableWeightedMovingMeanBGS", "WeightedMovingMeanBGS"),
    ("enableWeightedMovingVarianceBGS", "WeightedMovingVarianceBGS"),
    ("enableMixtureOfGaussianV1BGS", "MixtureOfGaussianV1BGS"),
    ("enableMixtureOfGaussianV2BGS", "MixtureOfGaussianV2BGS"),
    ("enableAdaptiveBackgroundLearning", "AdaptiveBackgroundLearning"),
    ("enableGMG", "GMG"),
    ("enableDPAdaptiveMedianBGS", "DPAdaptiveMedianBGS"),
    ("enableDPGrimsonGMMBGS", "DPGrimsonGMMBGS"),
    ("enableDPZivkovicAGMMBGS", "DPZivkovicAGMMBGS"),
    ("enableDPMeanBGS", "DPMeanBGS"),
    ("enableDPWrenGABGS", "DPWrenGABGS"),
    ("enableDPPratiMediodBGS", "DPPratiMediodBGS"),
    ("enableDPEigenbackgroundBGS", "DPEigenbackgroundBGS"),
    ("enableDPTextureBGS", "DPTextureBGS"),
    ("enableT2FGMM_UM", "T2FGMM_UM"),
    ("enableT2FGMM_UV", "T2FGMM_UV"),
    ("enableT2FMRF_UM", "T2FMRF_UM"),
    ("enableT2FMRF_UV", "T2FMRF_UV"),
    ("enableFuzzySugenoIntegral", "FuzzySugenoIntegral"),
    ("enableFuzzyChoquetIntegral", "FuzzyChoquetIntegral"),
    ("enableLBSimpleGaussian", "LBSimpleGaussian"),
    ("enableLBFuzzyGaussian", "LBFuzzyGaussian"),
    ("enableLBMixtureOfGaussians", "LBMixtureOfGaussians"),
    ("enableLBAdaptiveSOM", "LBAdaptiveSOM"),
    ("enableLBFuzzyAdaptiveSOM", "LBFuzzyAdaptiveSOM"),
    ("enableLbpMrf", "LbpMrf"),
    ("enableMultiLayerBGS", "MultiLayerBGS"),
    ("enableVuMeter", "VuMeter"),
    ("enableKDE", "KDE"),
    ("enableIMBS", "IndependentMultimodalBGS"),
    ("enableMultiCueBGS", "SJN_MultiCueBGS"),
    ("enableSigmaDeltaBGS", "SigmaDeltaBGS"),
    ("enableSuBSENSEBGS", "SuBSENSEBGS"),
    ("enableLOBSTERBGS", "LOBSTERBGS"),
)

FrameProcessorConfig = dataclasses.make_dataclass(
    "FrameProcessorConfig",
    [("tictoc", str, dataclasses.field(default=""))]
    + [("enablePreProcessor", bool, dataclasses.field(default=True))]
    + [("enableForegroundMaskAnalysis", bool, dataclasses.field(default=False))]
    + [(flag, bool, dataclasses.field(default=(flag == "enableFrameDifferenceBGS"))) for flag, _ in _ENABLE_FLAGS],
    bases=(BGSConfig,),
    frozen=True,
)
FrameProcessorConfig.__doc__ = (
    "config/FrameProcessor.xml master switches (FrameProcessor.h:80-242): "
    "one enableX flag per BGS algorithm, PreProcessor/mask-analysis toggles, "
    "and the tictoc algorithm name. Defaults match the reference's checked-in "
    "build/config/FrameProcessor.xml (PreProcessor + FrameDifference on)."
)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class FrameProcessor:
    """Fan-out of the enabled BGS algorithms over one pass of the video
    (``FrameProcessor::init/process/finish``, ``FrameProcessor.h:251-253``):

        fp = FrameProcessor({"FrameDifferenceBGS": algo1, "GMG": algo2}, pre_cfg)
        states = fp.init(h, w, c, device="cuda")
        states, masks = fp.step(states, frame)     # masks: name -> [H, W] u8

    :meth:`from_config_dir` builds it from an XML directory as the
    reference does, writing the XMLs that are missing with defaults."""

    def __init__(self, algorithms: Mapping[str, BGSAlgorithm], pre: Optional[PreProcessorConfig] = None):
        self.algorithms = dict(algorithms)
        self.pre = PreProcessor(pre)

    @classmethod
    def from_config_dir(cls, config_dir: str) -> "FrameProcessor":
        """The fan-out from ``config_dir/FrameProcessor.xml``'s enable flags
        and each algorithm's ``config_dir/<Name>.xml`` (``FrameProcessor::
        init``, ``FrameProcessor.cpp:35-155``); missing XMLs are written with
        defaults."""
        from tracking_tpu_torch.core.registry import get_algorithm

        fp_path = os.path.join(config_dir, "FrameProcessor.xml")
        fp_cfg = config_from_xml(FrameProcessorConfig, fp_path)
        if not os.path.exists(fp_path):
            config_to_xml(fp_cfg, fp_path)
        pre_path = os.path.join(config_dir, "PreProcessor.xml")
        pre_cfg = config_from_xml(PreProcessorConfig, pre_path)
        if not os.path.exists(pre_path):
            config_to_xml(pre_cfg, pre_path)
        if not fp_cfg.enablePreProcessor:
            pre_cfg = PreProcessorConfig()  # pass-through defaults
        algos = {}
        for flag, name in _ENABLE_FLAGS:
            if not getattr(fp_cfg, flag):
                continue
            algo_cls = get_algorithm(name)
            a_path = os.path.join(config_dir, f"{name}.xml")
            a_cfg = config_from_xml(algo_cls.Config, a_path)
            if not os.path.exists(a_path):
                config_to_xml(a_cfg, a_path)
            algos[name] = algo_cls(a_cfg)
        fp = cls(algos, pre_cfg)
        fp.config = fp_cfg
        return fp

    def init(self, h: int, w: int, c: int = 3, device="cuda") -> Dict[str, object]:
        return {name: a.init(h, w, c, device=device) for name, a in self.algorithms.items()}

    def warm_start(self, states, frame: torch.Tensor):
        prepped = self.pre.process(frame)
        return {name: a.warm_start(states[name], prepped) for name, a in self.algorithms.items()}

    def step(self, states, frame: torch.Tensor, use_kernels: bool = True) -> Tuple[Dict[str, object], Dict[str, torch.Tensor]]:
        """One frame through the PreProcessor and every enabled algorithm,
        in ``_ENABLE_FLAGS`` order. Consumes ``states`` (see
        ``BGSAlgorithm.step``); ``use_kernels=False`` takes the plain
        versions of the kernels."""
        prepped = self.pre.process(frame)
        new_states, masks = {}, {}
        for name, algo in self.algorithms.items():
            new_states[name], masks[name], _ = algo.step(states[name], prepped, use_kernels=use_kernels)
        return new_states, masks

    def run(self, frames: torch.Tensor, states=None, use_kernels: bool = True):
        """All enabled algorithms over frames [T, H, W(, C)] u8, a frame at a
        time. A fresh fan-out is made on the frames' device and warm-started
        from frame 0. Returns (states, {name: masks [T, H, W]})."""
        if states is None:
            h, w = frames.shape[1], frames.shape[2]
            c = frames.shape[3] if frames.ndim == 4 else 1
            states = self.warm_start(self.init(h, w, c, device=frames.device), frames[0])
        outs = {name: [] for name in self.algorithms}
        for t in range(frames.shape[0]):
            states, masks = self.step(states, frames[t], use_kernels=use_kernels)
            for name, m in masks.items():
                outs[name].append(m)
        return states, {name: torch.stack(ms) for name, ms in outs.items()}

    def profile(self, frames: torch.Tensor, repeats: int = 3) -> Dict[str, float]:
        """tictoc: seconds of the PreProcessor and of each algorithm over the
        chunk (the least of ``repeats`` runs after one untimed run), each
        algorithm from a fresh state on the prepped frames. On the card the
        seconds are CUDA-event times between synchronised ends."""
        from tracking_tpu_torch.runner.scan import run_video

        dev = frames.device
        on_card = dev.type == "cuda"

        def seconds(fn) -> float:
            fn()
            best = math.inf
            for _ in range(repeats):
                _sync(dev)
                if on_card:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                    fn()
                    end.record()
                    end.synchronize()
                    best = min(best, start.elapsed_time(end) / 1e3)
                else:
                    t0 = time.perf_counter()
                    fn()
                    best = min(best, time.perf_counter() - t0)
            return best

        def prep():
            return torch.stack([self.pre.process(f) for f in frames])

        timings = {"PreProcessor": seconds(prep)}
        prepped = prep()
        for name, algo in self.algorithms.items():
            timings[name] = seconds(lambda algo=algo: run_video(algo, prepped))
        return timings
