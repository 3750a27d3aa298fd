#!/usr/bin/env python3
"""On-card check of the PyTorch / CUDA port (``tracking_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--ptxas]

It drives the port's main path - 720×1280×3 SuBSENSE followed by the default
CCMSPF blob tracker - on a seeded synthetic clip, and fails (non-zero exit,
no result line) on any broken phase:

1. device: the card's name and power limit; no CUDA device is an error;
2. build: compiles the four CUDA kernels from ``tracking_tpu_torch/csrc``
   (``--ptxas`` prints each kernel's registers and spills);
3. each kernel against its plain PyTorch version on the card at the main
   path's shapes, exactly (consensus C=3 and C=1, hole-fill reachability,
   CC labelling 8- and 4-connected, greedy assignment);
4. the main path: warm start, then 64 frames of ``SuBSENSE.step`` and
   ``BlobTracker.step``; every kernel's launch count must be > 0, the mean
   foreground share in (0.1 %, 50 %), and a track active at the end;
5. the first 16 frames again through the plain versions: masks, track ids
   and positions must equal the kernel run's;
6. timing with CUDA events: each kernel beside its plain version, and
   ms/frame for the BGS step alone and for the full path.

The last two lines are a JSON object of the per-kernel results and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

H, W, C = 720, 1280, 3
MAIN_FRAMES = 64
PATH_FRAMES = 16
TIMED_FRAMES = 32
SOURCES = {
    "consensus": ("tracking_tpu_torch/csrc/consensus.cu", "tracking_tpu/ops/pallas_consensus.py:640"),
    "flood_reach": ("tracking_tpu_torch/csrc/fill.cu", "tracking_tpu/ops/pallas_fill.py:185"),
    "label_components": ("tracking_tpu_torch/csrc/cc.cu", "tracking_tpu/ops/pallas_cc.py:196"),
    "greedy_assign": ("tracking_tpu_torch/csrc/assoc.cu", "tracking_tpu/ops/pallas_assoc.py:74"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(clone(v) for v in tree)
    return tree.clone()


def max_err(a, b) -> float:
    """Largest |a − b| over matching tensors (tuples compared leaf by leaf)."""
    if isinstance(a, (tuple, list)):
        return max((max_err(x, y) for x, y in zip(a, b)), default=0.0)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype mismatch {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) if a.numel() else 0.0


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call of ``fn`` on the card (CUDA events around ``reps`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def profile_full_path(algo, tracker, state0, frames, dev, tag, n_frames: int = 8, top: int = 14) -> None:
    """Where the time goes: torch.profiler over ``n_frames`` of the full path
    after a warm-up; device time by kernel and the device's busy share of
    the wall time."""
    from torch.profiler import ProfilerActivity, profile

    s, tr = clone(state0), tracker.init(device=dev)
    for t in range(1, 17):
        s, fg, _ = algo.step(s, frames[t])
        tr, _ = tracker.step(tr, fg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(17, 17 + n_frames):
            s, fg, _ = algo.step(s, frames[t])
            tr, _ = tracker.step(tr, fg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    busy = sum(dev_us(e) for e in events)
    if busy == 0.0:
        print(f"  {tag} profile: the profiler saw no device time", flush=True)
        return
    print(f"  {tag} profile over {n_frames} full-path frames (profiler on): device busy "
          f"{busy / n_frames / 1e3:.3f} ms/frame of {wall_us / n_frames / 1e3:.3f} ms wall "
          f"= {busy / wall_us:.1%} busy; {sum(e.count for e in events) / n_frames:.0f} kernels/frame", flush=True)
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        print(f"    {dev_us(e) / n_frames / 1e3:8.4f} ms/frame  {e.count / n_frames:6.1f}x  {e.key[:90]}", flush=True)


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check runs only on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.bgs.lbsp_family import _roi_mask
    from tracking_tpu_torch.ops import _native
    from tracking_tpu_torch.ops.assoc import greedy_assign, greedy_assign_ref
    from tracking_tpu_torch.ops.cc import label_components, label_components_ref
    from tracking_tpu_torch.ops.consensus import consensus, consensus_ref
    from tracking_tpu_torch.ops.fill import flood_reach, flood_reach_ref
    from tracking_tpu_torch.ops.morphology import morph_close
    from tracking_tpu_torch.synth import make_clip
    from tracking_tpu_torch.track import kalman
    from tracking_tpu_torch.ops.cc import extract_blobs
    from tracking_tpu_torch.track.tracker import BlobTracker, _blob_xywh

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device ---------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    tag = f"[{card}]"

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    if "--ptxas" in argv:
        _native.build(verbose=True)
    _native.library()
    print(f"[2] build {tag}: {time.perf_counter() - t0:.1f} s ({len(_native.sources())} sources, "
          f"nvcc {' '.join(_native.NVCC_FLAGS)})", flush=True)

    t0 = time.perf_counter()
    clip = make_clip(1 + MAIN_FRAMES, H, W, C, seed=0)
    frames = torch.from_numpy(clip).to(dev)
    print(f"  synthetic clip {tuple(frames.shape)} in {time.perf_counter() - t0:.1f} s", flush=True)
    algo = get_algorithm("subsense")()
    tracker = BlobTracker()
    state0 = algo.warm_start(algo.init(H, W, C, device=dev), frames[0])
    results = {k: {"name": k, "route": "cuda", "source": SOURCES[k][0], "replaces": SOURCES[k][1]} for k in SOURCES}
    errs = {k: 0.0 for k in SOURCES}

    # -- 3. kernels against their plain versions at the main path's shapes --
    print("[3] kernels vs plain versions (exact)", flush=True)
    timing_inputs = {}
    for c in (3, 1):
        fr = frames if c == 3 else frames[..., 0].contiguous()
        st = algo.warm_start(algo.init(H, W, c, device=dev), fr[0])
        for t in range(1, 4):
            st, _, _ = algo.step(st, fr[t])
        planes = tuple(fr[4][..., i].contiguous() for i in range(c)) if c == 3 else (fr[4],)
        req = torch.where(_roi_mask(H, W, dev), algo.config.nRequiredBGSamples, 0).to(torch.int32)
        kw = algo._kernel_kw(c)

        def cons_args(s):
            return (planes, s["colors"], s["descs"], s["pend_ctrl"], s["pend_vals"], s["lut_delta"],
                    s["R"], s["unstable"], req)

        k_out = consensus(*cons_args(clone(st)), **kw)
        p_out = consensus_ref(*cons_args(clone(st)), **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(("count", "min_desc", "min_sum", "intra", "bg_sum", "colors", "descs"), k_out, p_out):
            e = max_err(a, b)
            errs["consensus"] = max(errs["consensus"], e)
            check(e == 0.0, f"consensus C={c} {name} equal (max |err| {e})")
        check(int((k_out[0] < req).sum()) > 0, f"consensus C={c} has pixels short of the required samples")
        if c == 3:
            timing_inputs["consensus"] = (cons_args(clone(st)), kw)
            state_for_masks = st

    raw = state_for_masks["last_raw"]
    pre_flood = morph_close(raw, 3)
    bg = pre_flood == 0
    seeds = torch.zeros_like(bg)
    seeds[0, 0] = True
    border = torch.zeros_like(bg)
    border[0, :] = border[-1, :] = border[:, 0] = border[:, -1] = True
    for name, sd in (("corner", seeds), ("border", border)):
        a, b = flood_reach(bg, sd & bg), flood_reach_ref(bg, sd & bg)
        e = max_err(a, b)
        errs["flood_reach"] = max(errs["flood_reach"], e)
        check(e == 0.0, f"flood_reach ({name} seed) equal on a real post-close mask, {int((~b & bg).sum())} hole px")
    timing_inputs["flood_reach"] = (bg, seeds & bg)

    final = state_for_masks["last_final"]
    for conn in (8, 4):
        a, b = label_components(final, conn), label_components_ref(final, conn)
        e = max_err(a, b)
        errs["label_components"] = max(errs["label_components"], e)
        n_comp = int(((b >= 0) & (b == torch.arange(H * W, device=dev).reshape(H, W))).sum())
        check(e == 0.0, f"label_components ({conn}-conn) equal on a real final mask, {n_comp} components")
    timing_inputs["label_components"] = (final,)

    # random masks around the percolation thresholds: huge, ragged components
    gen = torch.Generator(device="cpu").manual_seed(0)
    for p in (0.0, 0.3, 0.45, 0.6, 1.0):
        fg = (torch.rand((H, W), generator=gen) < p).to(dev)
        e = max(max_err(label_components(fg, conn), label_components_ref(fg, conn)) for conn in (8, 4))
        e = max(e, max_err(flood_reach(~fg, border & ~fg), flood_reach_ref(~fg, border & ~fg)))
        errs["label_components"] = max(errs["label_components"], e)
        errs["flood_reach"] = max(errs["flood_reach"], e)
        if e != 0.0:
            raise AssertionError(f"label_components / flood_reach differ on a random mask of density {p}")
    check(True, "label_components (8, 4) and flood_reach equal on random masks of density 0 to 1")

    gen.manual_seed(1)
    for i in range(20):
        K, B = 32, 64
        q = torch.randint(0, 9, (K, B), generator=gen).to(torch.float32) * 0.25  # many ties
        gated = torch.rand((K, B), generator=gen) < 0.5
        gated[torch.randint(0, K, (4,), generator=gen)] = True  # whole rows gated
        cost = torch.where(gated, torch.tensor(1e9), q).to(dev).contiguous()
        a, b = greedy_assign(cost), greedy_assign_ref(cost)
        e = max(max_err(a[0], b[0]), max_err(a[1], b[1]))
        errs["greedy_assign"] = max(errs["greedy_assign"], e)
        if e != 0.0:
            raise AssertionError(f"greedy_assign differs on random matrix {i}")
    check(True, "greedy_assign equal on 20 random gated 32x64 matrices with ties")

    # -- 4. the main path --------------------------------------------------
    print(f"[4] main path: warm start + {MAIN_FRAMES} frames of SuBSENSE + CCMSPF at {H}x{W}x{C}", flush=True)
    st = clone(state0)
    trk = tracker.init(device=dev)
    masks, ids, xs, ys, shares = [], [], [], [], []
    _native.reset_launches()
    for t in range(1, MAIN_FRAMES + 1):
        st, fg, _ = algo.step(st, frames[t])
        trk, tracks = tracker.step(trk, fg)
        masks.append(fg)
        ids.append(tracks.ids)
        xs.append(tracks.x)
        ys.append(tracks.y)
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    print(f"  launches: {launches}", flush=True)
    for k, n in launches.items():
        check(n > 0, f"{k} launched {n} times on the main path")
        results[k]["launches"] = n
    share = float(torch.stack(masks).gt(0).to(torch.float32).mean())
    check(0.001 < share < 0.5, f"mean foreground share {share:.4f} in (0.001, 0.5)")
    n_active = int(trk["active"].sum())
    check(n_active >= 1, f"{n_active} tracks active at the end (ids {trk['ids'][trk['active']].tolist()})")
    check(bool(torch.isfinite(trk["kx"]).all()), "Kalman states finite")

    # greedy assignment on the tracker's own cost matrix at the end of the run
    kp = kalman.default_params(device=dev)
    pred, _ = kalman.kalman_predict(trk["kx"], trk["kP"], kp)
    blobs = extract_blobs(masks[-1], max_blobs=tracker.config.maxBlobs)
    cost = tracker.cost_matrix(pred[:, :4], trk["active"], _blob_xywh(blobs), blobs.area >= tracker.config.minBlobArea)
    a, b = greedy_assign(cost), greedy_assign_ref(cost)
    e = max(max_err(a[0], b[0]), max_err(a[1], b[1]))
    errs["greedy_assign"] = max(errs["greedy_assign"], e)
    check(e == 0.0 and int((b[0] >= 0).sum()) >= 1, f"greedy_assign equal on the tracker's cost matrix ({int((b[0] >= 0).sum())} pairs)")
    timing_inputs["greedy_assign"] = (cost,)

    # -- 5. path against path ----------------------------------------------
    print(f"[5] the first {PATH_FRAMES} frames through the plain versions", flush=True)
    st_p = clone(state0)
    trk_p = tracker.init(device=dev)
    for t in range(1, PATH_FRAMES + 1):
        st_p, fg_p, _ = algo.step(st_p, frames[t], use_kernels=False)
        trk_p, tr_p = tracker.step(trk_p, fg_p, use_kernels=False)
        i = t - 1
        if not (torch.equal(fg_p, masks[i]) and torch.equal(tr_p.ids, ids[i])
                and torch.equal(tr_p.x, xs[i]) and torch.equal(tr_p.y, ys[i])):
            raise AssertionError(f"plain path differs from the kernel path at frame {t}")
    check(True, f"masks, track ids and positions equal over {PATH_FRAMES} frames")

    # -- 6. timing ---------------------------------------------------------
    print(f"[6] timing {tag}", flush=True)
    args, kw = timing_inputs["consensus"]
    plain_fns = {
        "consensus": (lambda: consensus(*args, **kw), lambda: consensus_ref(*args, **kw), 20, 3),
        "flood_reach": (lambda: flood_reach(*timing_inputs["flood_reach"]),
                        lambda: flood_reach_ref(*timing_inputs["flood_reach"]), 50, 5),
        "label_components": (lambda: label_components(*timing_inputs["label_components"]),
                             lambda: label_components_ref(*timing_inputs["label_components"]), 50, 5),
        "greedy_assign": (lambda: greedy_assign(*timing_inputs["greedy_assign"]),
                          lambda: greedy_assign_ref(*timing_inputs["greedy_assign"]), 200, 20),
    }
    for k, (fk, fp, rk, rp) in plain_fns.items():
        ms_p1 = cuda_ms(fp, rp)
        ms_k1 = cuda_ms(fk, rk)
        ms_k2 = cuda_ms(fk, rk)
        ms_p2 = cuda_ms(fp, rp)
        results[k]["ms"] = min(ms_k1, ms_k2)
        results[k]["plain_ms"] = min(ms_p1, ms_p2)
        results[k]["max_abs_err"] = errs[k]
        print(f"  {tag} {k}: kernel {ms_k1:.4f} / {ms_k2:.4f} ms, plain {ms_p1:.4f} / {ms_p2:.4f} ms", flush=True)

    def run(frames_range, with_tracker: bool):
        s = clone(state0)
        tr = tracker.init(device=dev)
        for t in range(1, 17):  # warm-up
            s, fg, _ = algo.step(s, frames[t])
            if with_tracker:
                tr, _ = tracker.step(tr, fg)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for t in frames_range:
            s, fg, _ = algo.step(s, frames[t])
            if with_tracker:
                tr, _ = tracker.step(tr, fg)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / len(frames_range)

    span = range(17, 17 + TIMED_FRAMES)
    bgs_ms = [run(span, False), run(span, False)]
    full_ms = [run(span, True), run(span, True)]
    for name, v in (("BGS step", bgs_ms), ("full path (BGS + tracking)", full_ms)):
        print(f"  {tag} {name}: {v[0]:.3f} / {v[1]:.3f} ms/frame = {1000 / min(v):.1f} fps "
              f"({TIMED_FRAMES} frames, {H}x{W}x{C})", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {tag} peak device memory {peak:.2f} GiB", flush=True)
    profile_full_path(algo, tracker, state0, frames, dev, tag)

    print(json.dumps({"kernels": [results[k] for k in SOURCES]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
