"""The apps, counterpart of ``tracking_tpu/runner/cli.py``:

- ``bgs-run`` (the reference's ``bgs`` executable, ``Main.cpp:29-85`` ->
  ``VideoAnalysis``): BGS masks from a video, a camera or a PNG sequence,
  one algorithm with ``-a`` or, without it, the FrameProcessor fan-out of
  an XML config directory (self-documenting: missing XMLs are written with
  defaults; re-read between chunks), with ``--compare/--stopAt/--imgref``
  scoring, tictoc profiling and per-algorithm mask videos;
- ``tracking-run`` (``ustc_src/trackingMain.cpp:382-773``): BGS (default
  SuBSENSE, type 36) -> blob detection -> tracking -> trajectory files ->
  online trajectory analysis, with annotated fg / track videos and a line
  per frame of track positions;
- ``cdnet-run``: the USTC CDnet batch driver, ``in%06d.jpg`` in,
  ``bin%06d.png`` out (default shrinkBGS).

    bgs-run-torch --frames_dir frames/ -a FrameDifferenceBGS   # on the card
    tracking-run-torch video.avi --track tracks.csv
    python -m tracking_tpu_torch.runner.cli cdnet-run in/ --out out/ --roi 100 400 --device cpu

Each takes every flag of the JAX app, and ``tracking-run`` the reference's
``name=value`` and ``prefix:Param=value`` tokens, plus ``--device``
(default ``cuda``; an app runs on the CPU only when asked to). Video is
read (``io/video.py``) and mask videos are written (MJPG) through the
native FFmpeg library where it builds, else through cv2; checkpoints
(``--savestate`` / ``--loadstate``, and MultiLayer's ``bg_model_preload``
/ ``saveModel``) are ``torch.save`` files
(``core/checkpoint.py``), not the JAX package's orbax directories.

The frame loops (:func:`run_bgs`, :func:`run_tracking`) take any iterator
of [T, H, W, 3] u8 chunks. ``bgs-run`` copies chunk k+1 to the card from
pinned memory on a side stream while chunk k runs. In ``tracking-run``
each frame runs the BGS step and the tracker step on the device; each
chunk's tracks stay there and come to the host in one copy, where the
recorder, the analysis, the writers and the printed lines take them frame
by frame (the JAX app fetches a chunk's outputs once too).
``FGTrainFrames`` is a host branch on the frame's index: no device value is
read for it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch


def _writer(path, fps, size):
    """MJPG / AVI writer (the container and codec of the reference's fgavi /
    btavi outputs): the native FFmpeg encoder where its library loads, else
    cv2's, as the JAX app chooses."""
    from tracking_tpu_torch.native import VideoWriter

    try:
        return VideoWriter(path, fps, size)
    except RuntimeError:
        import cv2

        return cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, size)


def bgs_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="BGS runner (bgs -uf/-uc parity), PyTorch / CUDA")
    p.add_argument("--use_file", "-uf", action="store_true")
    p.add_argument("--filename", "-fn", default=None)
    p.add_argument("--use_cam", "-uc", action="store_true")
    p.add_argument("--camera", "-ca", type=int, default=0)
    p.add_argument(
        "--algorithm", "-a", default=None,
        help="run ONE algorithm by name/alias/type-id; omitted = the "
             "reference behavior: config_dir/FrameProcessor.xml enable flags "
             "pick the fan-out (FrameProcessor.h:80-242), per-algorithm XMLs "
             "configure each, missing XMLs are written with defaults, and "
             "the XMLs are re-read between chunks (loadConfig-every-frame "
             "parity, FrameDifferenceBGS.cpp:35-40)",
    )
    p.add_argument("--config_dir", default="./config", help="OpenCV-XML config directory (reference ./config layout)")
    p.add_argument("--compare", "-co", action="store_true")
    p.add_argument("--stopAt", "-st", type=int, default=0)
    p.add_argument("--imgref", "-im", default=None)
    p.add_argument("--output", "-o", default=None, help="write fg mask video")
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--frames_dir", default=None,
                   help="Demo2 parity: read a '<n>.png' image sequence instead of a video")
    p.add_argument("--device", default="cuda",
                   help="torch device the app runs on (default the card; 'cpu' only when asked)")
    return p


def _staged(chunks, dev: torch.device):
    """Chunks as tensors on ``dev``, one chunk ahead: chunk k+1 is read and
    its copy to the card started (from pinned memory, on a side stream)
    before chunk k is handed out, so the copy runs while chunk k computes
    (the JAX app's asynchronous ``device_put``). The caller's stream waits
    for the copy before it uses the chunk."""
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def stage(chunk):
        host = torch.from_numpy(np.ascontiguousarray(chunk))
        if side is None:
            return host.to(dev), None
        host = host.pin_memory()
        with torch.cuda.stream(side):
            t = host.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return t, done

    def ready(staged):
        t, done = staged
        if done is not None:
            torch.cuda.current_stream(dev).wait_event(done)
            t.record_stream(torch.cuda.current_stream(dev))
        return t

    pending = None
    for chunk in chunks:
        staged = stage(chunk)
        if pending is not None:
            yield ready(pending)
        pending = staged
    if pending is not None:
        yield ready(pending)


def _reload_fanout(fp, states, config_dir, chunk):
    """loadConfig-every-frame parity at chunk granularity
    (``FrameDifferenceBGS.cpp:35-40``: configs are live-editable). Re-reads
    the XML tree: an unchanged tree keeps the fan-out and its states; a
    change rebuilds it, keeping the state of each algorithm whose own config
    is unchanged and warm-starting new or reconfigured ones on the chunk's
    last (prepped) frame."""
    from tracking_tpu_torch.runner.pipeline import FrameProcessor

    new_fp = FrameProcessor.from_config_dir(config_dir)
    changed = (
        new_fp.config != fp.config
        or new_fp.pre.config != fp.pre.config
        or {k: a.config for k, a in new_fp.algorithms.items()} != {k: a.config for k, a in fp.algorithms.items()}
    )
    if not changed:
        return fp, states
    h, w = chunk.shape[1], chunk.shape[2]
    c = chunk.shape[3] if chunk.ndim == 4 else 1
    kept = {}
    for name, a in new_fp.algorithms.items():
        old = fp.algorithms.get(name)
        if old is not None and old.config == a.config and states:
            kept[name] = states[name]
        else:
            kept[name] = a.warm_start(a.init(h, w, c, device=chunk.device), new_fp.pre.process(chunk[-1]))
    return new_fp, kept


def run_bgs(chunks, args, on_masks=None):
    """``bgs-run``'s loop over ``chunks``, any iterator of [T, H, W(, 3)] u8
    numpy chunks; ``args`` from :func:`bgs_parser`. With ``-a``: that
    algorithm's ``run_video`` chunk after chunk; without: the fan-out of
    ``args.config_dir`` (an algorithm it enables that this package does not
    port raises), its tictoc on the first chunk, and the XMLs re-read after
    every chunk (:func:`_reload_fanout`). Per chunk: ``on_masks(first_index,
    {name: masks [T, H, W] on the device})``, the mask videos (``--output``;
    ``<root>.<Name>.<ext>`` each when the fan-out has several algorithms)
    and the ``--compare`` score at ``--stopAt``. Prints the timing line and
    returns the fan-out (or None), the states, the frame count and the
    seconds."""
    from tracking_tpu_torch.analysis.metrics import mask_similarity
    from tracking_tpu_torch.core.registry import get_algorithm
    from tracking_tpu_torch.runner.pipeline import FrameProcessor, _sync
    from tracking_tpu_torch.runner.scan import run_video

    dev = _device(args.device, "bgs-run")
    if args.output or args.compare:
        import cv2
    fp = algo = None
    if args.algorithm is not None:
        algo = get_algorithm(args.algorithm)()
    else:
        fp = FrameProcessor.from_config_dir(args.config_dir)
        if not fp.algorithms:
            print("no BGS algorithm enabled in FrameProcessor.xml")
            return None
    state = None
    outs = {}
    ref = None
    n = 0
    t0 = time.perf_counter()
    for chunk in _staged(chunks, dev):
        if fp is None:
            state, masks = run_video(algo, chunk, state=state)
            out = {args.algorithm: masks}
        else:
            state, out = fp.run(chunk, state)
            if n == 0 and getattr(fp.config, "tictoc", "") in fp.algorithms:
                name = fp.config.tictoc
                secs = fp.profile(chunk)[name]
                print(f"tictoc: {name} = {secs:.4f}s / {len(chunk)} frames")
        if on_masks is not None:
            on_masks(n, out)
        many = fp is not None and len(fp.algorithms) > 1
        # by name: the JAX app's scan returns the masks as a dict pytree,
        # whose keys come back sorted
        for name, masks in sorted(out.items()):
            if args.output:
                path = args.output
                if many:
                    root, ext = (path.rsplit(".", 1) + ["avi"])[:2]
                    path = f"{root}.{name}.{ext}"
                host = masks.cpu().numpy()
                if name not in outs:
                    outs[name] = _writer(path, 30.0, (host.shape[2], host.shape[1]))
                for m in host:
                    outs[name].write(cv2.cvtColor(m, cv2.COLOR_GRAY2BGR))
            i = args.stopAt - n
            if args.compare and args.imgref and 0 <= i < len(masks):
                if ref is None:
                    ref = torch.from_numpy(cv2.imread(args.imgref, 0)).to(dev)
                print(f"{name} frame {n + i}: similarity = {float(mask_similarity(masks[i], ref)):.4f}")
        n += chunk.shape[0]
        if fp is not None:
            fp, state = _reload_fanout(fp, state, args.config_dir, chunk)
    _sync(dev)
    dt = time.perf_counter() - t0
    for o in outs.values():
        o.release()
    label = args.algorithm if fp is None else "+".join(fp.algorithms)
    print(f"{label}: {n} frames in {dt:.2f}s ({n / max(dt, 1e-9):.1f} fps)")
    return SimpleNamespace(fp=fp, state=state, frames=n, seconds=dt)


def bgs_run(argv=None):
    """``bgs-run``: parse the arguments, read the frames (a PNG sequence,
    a video file or a camera, ``io/video.py``) and run :func:`run_bgs`."""
    from tracking_tpu_torch.io.video import VideoSource, read_frame_dir

    args = bgs_parser().parse_args(argv)
    _device(args.device, "bgs-run")
    if args.frames_dir:
        seq = read_frame_dir(args.frames_dir)
        # as the JAX app: the chunks start below the limit, the last one is not cut to it
        lim = min(len(seq), args.max_frames or len(seq))
        chunks = (seq[i : i + args.chunk] for i in range(0, lim, args.chunk))
    else:
        src = VideoSource(input_file=args.filename if (args.use_file or args.filename) else None,
                          camera_index=args.camera if args.use_cam else None)
        chunks = src.chunks(args.chunk, max_frames=args.max_frames)
    return 0 if run_bgs(chunks, args) is not None else 1


_REF_TOKENS = (
    "fg", "fgavi", "btavi", "bd", "bt", "bt_corr", "btpp", "bta",
    "bta_data", "btgen", "track", "FGTrainFrames", "log",
    "savestate", "loadstate",
)


def _convert_ref_tokens(argv):
    """Reference-style arguments (``trackingMain.cpp:461-496``): ``name=value``
    tokens (``btavi=btout.avi fgavi=fgout.avi video.avi``) become ``--name
    value``; ``prefix:Param=value`` module-parameter tokens (``set_params``,
    ``trackingMain.cpp:308-345``) are returned apart for
    :func:`_apply_module_params`."""
    out, params = [], []
    for a in argv:
        name = a.split("=", 1)[0]
        if "=" in a and ":" in name:
            params.append(a)
        elif "=" in a and name in _REF_TOKENS:
            out.extend([f"--{name}", a.split("=", 1)[1]])
        else:
            out.append(a)
    return out, params


def _apply_module_params(tokens, modules):
    """Each ``prefix:Param=value`` token sets the case-insensitively matching
    config field of the module registered under ``prefix`` and prints the
    reference's confirmation line (``set_params``,
    ``trackingMain.cpp:308-345``). Returns {prefix: {field: value}}."""
    applied = {}
    for tok in tokens:
        prefix, rest = tok.split(":", 1)
        if "=" not in rest:
            continue
        pname, value = rest.split("=", 1)
        mod = modules.get(prefix)
        if mod is None:
            continue
        nickname, cfg = mod
        for f in dataclasses.fields(cfg):
            if f.name.lower() != pname.lower():
                continue
            typ = type(getattr(cfg, f.name))
            if typ is bool:
                val = value.lower() in ("1", "true", "yes")
            elif typ is int:
                val = int(float(value))
            elif typ is float:
                val = float(value)
            else:
                val = value
            applied.setdefault(prefix, {})[f.name] = val
            try:
                shown = float(val)
            except (TypeError, ValueError):
                shown = val
            print(f"{nickname}:{f.name} param set to {shown}")
    return applied


def tracking_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="blob tracking pipeline (tracking parity), PyTorch / CUDA")
    p.add_argument("video")
    p.add_argument("--fgavi", default=None, help="fg mask video out")
    p.add_argument("--btavi", default=None, help="annotated tracking video out")
    p.add_argument("--track", default=None, help="track file out (.csv or .yml)")
    p.add_argument("--bgs_type", type=int, default=36, help="ustc type id (default SuBSENSE)")
    p.add_argument(
        "--fg", default=None, choices=["FG_0", "FG_0S", "FG_1"],
        help="stock FGDetector module instead of the USTC_BGS override "
             "(trackingMain.cpp:37-41): FG_0=FGD, FG_0S=FGD simple, FG_1=MOG",
    )
    p.add_argument("--chunk", type=int, default=32)
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--savestate", default=None,
                   help="checkpoint BGS+tracker state at end (trackingMain.cpp:685-713)")
    p.add_argument("--loadstate", default=None,
                   help="resume BGS+tracker state from a checkpoint (trackingMain.cpp:740-758)")
    p.add_argument("--bd", default="BD_CC", choices=["BD_CC", "BD_Simple"],
                   help="blob detector module (trackingMain.cpp:43-47)")
    p.add_argument("--bt", default="CCMSPF", choices=["CC", "CCMSPF", "MS", "MSFG", "MSPF"],
                   help="blob tracker module (trackingMain.cpp:49-68)")
    p.add_argument("--bta", default="HistPVS",
                   help="trajectory analysis module: HistPVS|HistP|HistPV|HistSS|TrackDist|IOR|None "
                        "(trackingMain.cpp:110-121)")
    p.add_argument("--btpp", default="Kalman", choices=["Kalman", "None"],
                   help="track post-processing: Kalman-filtered states (default) or raw blob measurements "
                        "(trackingMain.cpp:104-108)")
    p.add_argument("--btgen", default=None, choices=["YML", "RawTracks"],
                   help="trajectory generator for track= (trackingMain.cpp:505-516): YML (default) writes "
                        "OpenCV-FileStorage YAML, RawTracks a frame,id,x,y,w,h CSV")
    p.add_argument("--bt_corr", default="none",
                   help="tracker correction by post-processing (trackingMain.cpp:517-527): none | PostProcRes | "
                        "<postproc name>; the Kalman post-processor is the tracker's own predictor, so a PP name "
                        "(e.g. Kalman) selects that post-processor")
    p.add_argument("--FGTrainFrames", type=int, default=0,
                   help="train the FG detector alone for N frames before tracking starts (trackingMain.cpp:611)")
    p.add_argument("--bta_data", default=None,
                   help="trajectory-analysis database (trackingMain.cpp:545-556): loaded at start if present, "
                        "saved at end (.npz)")
    p.add_argument("--log", default=None,
                   help="append module parameter dump to a file (print_params, trackingMain.cpp:348-380)")
    p.add_argument("--device", default="cuda",
                   help="torch device the app runs on (default the card; 'cpu' only when asked)")
    return p


def parse_tracking_args(argv=None):
    """Parse the app's arguments (reference tokens included). Returns
    (args, module-parameter tokens)."""
    argv2, mod_params = _convert_ref_tokens(list(sys.argv[1:] if argv is None else argv))
    args = tracking_parser().parse_args(argv2)
    # bt_corr=<PP name> selects that post-processor + correction
    if args.bt_corr.lower() not in ("none", "postprocres"):
        args.btpp = args.bt_corr
        args.bt_corr = "PostProcRes"
    return args, mod_params


def build_modules(args, mod_params=()):
    """The app's BGS algorithm and tracker from its arguments, with the
    ``prefix:Param=value`` updates applied (``trackingMain.cpp:624-676``)."""
    from tracking_tpu_torch.core.registry import get_algorithm
    from tracking_tpu_torch.track.tracker import BlobTracker, TrackerConfig

    if args.fg:
        algo = get_algorithm({"FG_0": "FGD", "FG_0S": "FGDSimple", "FG_1": "MixtureOfGaussianV1BGS"}[args.fg])()
    else:
        algo = get_algorithm(args.bgs_type)()
    trk_cfg = TrackerConfig()
    upd = _apply_module_params(
        mod_params,
        {
            "fg": (args.fg or type(algo).__name__, algo.config),
            "bd": (args.bd, trk_cfg),
            "bt": (args.bt, trk_cfg),
            "btpp": (args.btpp, trk_cfg),
            "bta": (args.bta, trk_cfg),
        },
    )
    if "fg" in upd:
        algo = type(algo)(algo.config.replace(**upd["fg"]))
    for pfx in ("bd", "bt", "btpp", "bta"):
        if pfx in upd:
            trk_cfg = trk_cfg.replace(**upd[pfx])
    if args.log:
        with open(args.log, "a") as fh:
            fh.write(f"video={args.video} bgs_type={args.bgs_type}\n")
            fh.write(f"module: {type(algo).__name__}\n")
            for f in dataclasses.fields(algo.config):
                fh.write(f"  {f.name}={getattr(algo.config, f.name)}\n")
    return algo, BlobTracker(trk_cfg.replace(trackerType=args.bt, blobDetector=args.bd))


def _device(name, app: str = "tracking-run") -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{app}: no CUDA device; pass --device cpu to run on the CPU")
    return dev


_TRACK_FIELDS = ("x", "y", "w", "h", "rx", "ry", "rw", "rh")


def _to_host(tracks_seq):
    """A chunk's per-frame ``Tracks`` (on the device) -> one list of
    ``Tracks`` with numpy fields, in one device-to-host copy: active, ids and
    the f32 fields (as their int32 bits) stacked into [T, 10, K] int32."""
    from tracking_tpu_torch.track.tracker import Tracks

    packed = torch.stack([
        torch.stack([t.active.to(torch.int32), t.ids] + [getattr(t, f).view(torch.int32) for f in _TRACK_FIELDS])
        for t in tracks_seq
    ]).cpu().numpy()
    floats = packed[:, 2:].view(np.float32)
    return [
        Tracks(active=p[0].astype(bool), ids=p[1], **{f: floats[i, j] for j, f in enumerate(_TRACK_FIELDS)})
        for i, p in enumerate(packed)
    ]


def run_tracking(chunks, args, algo=None, tracker=None, *, start: int = 0, use_kernels: bool = True,
                 on_frame=None):
    """The app's frame loop and end-of-run outputs over ``chunks``, any
    iterator of [T, H, W, 3] u8 numpy chunks; ``args`` are the app's
    (:func:`parse_tracking_args`), ``algo`` / ``tracker`` default to theirs
    (:func:`build_modules`).

    At the first chunk: the analysis (``--bta``, its ``--bta_data`` loaded
    if the file exists) and the BGS state, then ``--loadstate``, a model
    preload (``bg_model_preload``) or the warm start. Per frame: the BGS
    step and, from ``FGTrainFrames`` on, the tracker step (on the frame);
    per chunk one copy of its tracks to the host, then per frame the
    recorder, the analysis, ``on_frame(frame_index, frame, fg, tracks,
    scores, ana)`` (the video writers; ``fg`` on the device) and the printed
    line. At the end: ``--savestate``, MultiLayer's ``saveModel``, the
    track file, the analysis summary and ``--bta_data``, and the timing
    line. ``start`` numbers the first frame (a resumed stream's count);
    ``use_kernels=False`` takes the plain versions of the kernels. Returns
    the states, the recorder, the analysis, the frame count and the
    seconds."""
    from tracking_tpu_torch.core.checkpoint import load_state, save_state
    from tracking_tpu_torch.track.trajectory import TrackRecorder, make_analysis

    dev = _device(args.device)
    if algo is None or tracker is None:
        algo, tracker = build_modules(args)
    raw = args.btpp == "None"
    fg_train = int(args.FGTrainFrames)
    bgs_state = None
    trk_state = tracker.init(device=dev)
    recorder = TrackRecorder()
    ana = None
    empty = tracker.empty_tracks(device=dev)
    n = 0
    t0 = time.perf_counter()
    for chunk in chunks:
        frames = torch.from_numpy(np.ascontiguousarray(chunk)).to(dev)
        if bgs_state is None:
            h, w = chunk.shape[1:3]
            # online per-frame trajectory analysis (trackingMain.cpp:219-297);
            # bta_data= persists the learned database across runs
            ana = make_analysis(args.bta, w, h)
            if ana is not None and args.bta_data and os.path.exists(args.bta_data):
                ana.load_data(args.bta_data)
                print(f"bta_data: loaded analysis database from {args.bta_data}")
            bgs_state = algo.init(h, w, chunk.shape[3] if chunk.ndim == 4 else 1, device=dev)
            # MLBGS-style model preload (MultiLayerBGS.cpp:94-98 BGS->Load)
            preload = getattr(algo.config, "bg_model_preload", "")
            if args.loadstate:
                restored = load_state(args.loadstate, like={"bgs": bgs_state, "trk": trk_state})
                bgs_state, trk_state = restored["bgs"], restored["trk"]
            elif preload and os.path.exists(preload):
                bgs_state = load_state(preload, like=bgs_state)
                print(f"bg model: loaded {type(algo).__name__} model from {preload}")
            else:
                bgs_state = algo.warm_start(bgs_state, frames[0])
        fgs, tracks_seq = [], []
        for i in range(frames.shape[0]):
            bgs_state, fg, _ = algo.step(bgs_state, frames[i], use_kernels=use_kernels)
            if start + n + i >= fg_train:
                trk_state, tracks = tracker.step(trk_state, fg, frames[i], use_kernels=use_kernels)
            else:  # FGTrainFrames: the FG detector trains alone (trackingMain.cpp:611)
                tracks = empty
            fgs.append(fg)
            tracks_seq.append(tracks)
        for i, frame_tracks in enumerate(_to_host(tracks_seq)):
            idx = start + n + i
            recorder.record(idx, frame_tracks, raw=raw)
            scores = {}
            if ana is not None:
                ana.add_frame(idx, frame_tracks, raw=raw)
                scores = ana.frame_scores()
            if on_frame is not None:
                on_frame(idx, chunk[i], fgs[i], frame_tracks, scores, ana)
            if not args.quiet:
                blobs = []
                for k in np.nonzero(frame_tracks.active)[0]:
                    tid = int(frame_tracks.ids[k])
                    mark = "!" if ana is not None and ana.is_abnormal(scores.get(tid, 0.0)) else ""
                    blobs.append(f"id={tid}{mark} ({frame_tracks.x[k]:.0f},{frame_tracks.y[k]:.0f})")
                if blobs:
                    print(f"frame {idx}: " + " ".join(blobs))
        n += frames.shape[0]
    dt = time.perf_counter() - t0
    if args.savestate and bgs_state is not None:
        save_state(args.savestate, {"bgs": bgs_state, "trk": trk_state})
    # MLBGS finish(): in LEARN mode with saveModel the model goes to
    # bg_model_preload (default models/MultiLayerBGSModel) for a later
    # DETECT-mode preload (MultiLayerBGS.cpp:36-48)
    if (
        bgs_state is not None
        and getattr(algo.config, "saveModel", False)
        and getattr(algo.config, "status", "MLBGS_LEARN").upper().endswith("LEARN")
    ):
        path = getattr(algo.config, "bg_model_preload", "") or "models/MultiLayerBGSModel"
        save_state(path, bgs_state)
        print(f"bg model: saved {type(algo).__name__} model to {path}")
    if args.track:
        # btgen= (trackingMain.cpp:505-516); default YML, the extension as a fallback
        gen = args.btgen or ("RawTracks" if args.track.endswith(".csv") else "YML")
        if gen == "YML":
            recorder.save_yml(args.track)
        else:
            recorder.save_csv(args.track)
    if ana is not None:
        # fold still-live tracks, then score every track against the final model
        ana.finish()
        for tid, s in sorted(ana.abnormality(recorder).items()):
            mark = " ABNORMAL" if ana.is_abnormal(s) else ""
            print(f"track {tid}: abnormality={s:.2f} ({args.bta}){mark}")
        if args.bta_data:
            ana.save_data(args.bta_data)
            print(f"bta_data: saved analysis database to {args.bta_data}")
    print(f"tracking: {n} frames in {dt:.2f}s ({n / max(dt, 1e-9):.1f} fps)")
    return SimpleNamespace(bgs_state=bgs_state, trk_state=trk_state, recorder=recorder, ana=ana, frames=n,
                           seconds=dt, algo=algo, tracker=tracker)


def _video_writers(args):
    """``on_frame`` for ``--fgavi`` / ``--btavi`` (None without them) and a
    function that closes the writers."""
    if not (args.fgavi or args.btavi):
        return None, lambda: None
    import cv2

    outs = {}

    def on_frame(idx, frame, fg, tracks, scores, ana):
        if args.fgavi:
            m = fg.cpu().numpy()
            if "fg" not in outs:
                outs["fg"] = _writer(args.fgavi, 30.0, (m.shape[1], m.shape[0]))
            outs["fg"].write(cv2.cvtColor(m, cv2.COLOR_GRAY2BGR))
        if args.btavi:
            img = frame.copy()
            for k in np.nonzero(tracks.active)[0]:
                tid = int(tracks.ids[k])
                x, y = tracks.x[k], tracks.y[k]
                w2, h2 = tracks.w[k] / 2, tracks.h[k] / 2
                # legacy draw: abnormal tracks turn red (trackingMain.cpp:219-297)
                abn = ana is not None and ana.is_abnormal(scores.get(tid, 0.0))
                color = (0, 0, 255) if abn else (0, 255, 0)
                cv2.rectangle(img, (int(x - w2), int(y - h2)), (int(x + w2), int(y + h2)), color, 1)
                cv2.putText(img, str(tid), (int(x), int(y)), cv2.FONT_HERSHEY_PLAIN, 1.0, (0, 0, 255))
            if "bt" not in outs:
                outs["bt"] = _writer(args.btavi, 30.0, (img.shape[1], img.shape[0]))
            outs["bt"].write(img)

    def close():
        for o in outs.values():
            o.release()

    return on_frame, close


def tracking_run(argv=None):
    """``tracking-run``: parse the arguments, read the video
    (``io/video.py``) and run :func:`run_tracking` on its chunks."""
    from tracking_tpu_torch.io.video import VideoSource

    args, mod_params = parse_tracking_args(argv)
    _device(args.device)
    algo, tracker = build_modules(args, mod_params)
    on_frame, close = _video_writers(args)
    src = VideoSource(input_file=args.video)
    try:
        run_tracking(src.chunks(args.chunk, max_frames=args.max_frames), args, algo, tracker, on_frame=on_frame)
    finally:
        close()
    return 0


def cdnet_run(argv=None):
    """``cdnet-run``: the CDnet-directory batch driver of the USTC mains.
    Reads ``in%06d.jpg`` frames from ``roi_start − bootstrap`` so the model
    settles before scoring (``ustc_src/shrinkBGS/main.cpp:21-24,55-74``) and
    writes ``bin%06d.png`` masks for the frames in [roi_start, roi_stop]
    (``ustc_src/bgs_subsense_optical_flow/qt_cmake_bgs_sof/shrink.cpp:115-129``).
    """
    import cv2

    from tracking_tpu_torch.core.registry import get_algorithm
    from tracking_tpu_torch.io.video import read_cdnet_dir
    from tracking_tpu_torch.runner.pipeline import _sync
    from tracking_tpu_torch.runner.scan import run_video

    p = argparse.ArgumentParser(description="CDnet in%06d.jpg batch runner (shrinkBGS/subsenseShrink parity), "
                                            "PyTorch / CUDA")
    p.add_argument("input_dir", help="dir holding in%%06d.jpg frames")
    p.add_argument("--out", required=True, help="output dir for bin%%06d.png masks")
    p.add_argument("--roi", type=int, nargs=2, metavar=("START", "STOP"), required=True,
                   help="first/last frame number to score")
    p.add_argument("--bgs", default="shrinkBGS", help="algorithm name (default shrinkBGS; e.g. subsenseShrink)")
    p.add_argument("--bootstrap", type=int, default=100,
                   help="frames processed before roi_start to settle the model (main.cpp:24 uses 100)")
    p.add_argument("--chunk", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="torch device the app runs on (default the card; 'cpu' only when asked)")
    args = p.parse_args(argv)
    dev = _device(args.device, "cdnet-run")

    start = max(args.roi[0] - args.bootstrap, 0)
    frames = read_cdnet_dir(args.input_dir, start, args.roi[1])
    os.makedirs(args.out, exist_ok=True)
    algo = get_algorithm(args.bgs)()
    state = None
    written = 0
    t0 = time.perf_counter()
    for i in range(0, len(frames), args.chunk):
        chunk = torch.from_numpy(frames[i : i + args.chunk]).to(dev)
        state, masks = run_video(algo, chunk, state)
        masks = masks.cpu().numpy()
        for j in range(masks.shape[0]):
            fnum = start + i + j
            if fnum >= args.roi[0]:
                cv2.imwrite(os.path.join(args.out, f"bin{fnum:06d}.png"), masks[j])
                written += 1
    _sync(dev)
    dt = time.perf_counter() - t0
    print(f"cdnet: {len(frames)} frames ({written} masks written to {args.out}) "
          f"in {dt:.2f}s ({len(frames) / max(dt, 1e-9):.1f} fps)")
    return 0


def main(argv=None):
    """Dispatch: ``python -m tracking_tpu_torch.runner.cli
    {bgs-run|tracking-run|cdnet-run} ...``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("bgs-run", "bgs"):
        return bgs_run(argv[1:])
    if argv and argv[0] in ("tracking-run", "tracking"):
        return tracking_run(argv[1:])
    if argv and argv[0] in ("cdnet-run", "cdnet"):
        return cdnet_run(argv[1:])
    print("usage: python -m tracking_tpu_torch.runner.cli {bgs-run|tracking-run|cdnet-run} ...")
    return 2


if __name__ == "__main__":
    sys.exit(main())
