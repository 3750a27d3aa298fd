#!/usr/bin/env python3
"""On-card check of the PyTorch / CUDA port (``tracking_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--ptxas]

(``--nccl-only`` runs the build and phase 4m's NCCL part alone, over every
card of a machine with several.)

It drives the port's paths at 720×1280×3 on seeded synthetic clips -
SuBSENSE followed by the default CCMSPF blob tracker; LOBSTER, GMG,
DPTexture and MultiLayer through the registry; SuBSENSE's consensus v3 and
fused step and subsenseShrink; FGD (FG_0) followed by the tracker, and
FGDSimple (FG_0S); the row-sharded SuBSENSE + CCMSPF pipeline in 4 shards
on the one card; the tracking app's frame loop with its MOG1 detector and
MS-family trackers; the BGS apps (``bgs-run``'s loop with its XML fan-out,
``cdnet-run`` with shrinkBGS and subsenseShrink); the Gaussian-mixture,
dp, Prati, VuMeter and lb algorithms alone and in a fan-out with SuBSENSE;
the fuzzy-integral, type-2 fuzzy GMM / MRF, KDE, IMBS and Eigenbackground
algorithms alone and in a fan-out with SuBSENSE; MultiCue and LbpMrf alone
and in a fan-out with SuBSENSE; SuBSENSE in batches of 1, 2 and 4 streams,
on a 2 x 2 stream x space mesh, and LOBSTER, SuBSENSE v3 and the fused
switch in 4 row shards; the blob table (``ops/blobs.py``) on SuBSENSE's
masks; the native FFmpeg reader and MJPEG writer; the process mesh (4 gloo
processes that share the card, and NCCL over every card) - and fails
(non-zero exit, no result line) on any broken phase:

1. device: the card's name and power limit; no CUDA device is an error;
2. build: compiles the CUDA kernels from ``tracking_tpu_torch/csrc`` (the
   13 TPU kernels' twelve counterparts: ``consensus_read`` replaces two; and
   five with no Pallas counterpart, ``kalman_predict``, ``kalman_update``,
   ``contract`` (XLA:CPU's dot: the resize's contractions, Eigenbackground's
   Gram product and lift), ``pca_project`` and ``syevd_small`` (LAPACK's
   ``ssyevd`` as jaxlib runs it), which reproduce the reference's orders), one
   ``nvcc`` per source in parallel (anew, even where a library of these
   sources was built before), and prints each kernel's registers, stack
   frame, spills and static shared memory (``--ptxas``: nvcc's own output);
   ``fused_kernel`` must not spill, and ``multilayer_kernel<0|1>``,
   ``texture_kernel<0|1>``, ``read_walk_kernel<1|3>``,
   ``lobster_kernel<1|3>``, ``greedy_assign_kernel``, the four
   ``fgd_tables_kernel``, the three ``gram_block_kernel`` and
   ``lift_kernel``, and ``gram_combine_kernel`` must have no stack frame
   and no spills;
3. each kernel against its plain PyTorch version on the card at its path's
   shapes, exactly (consensus C=3 and C=1, also with a requirement of N,
   with good samples only in its last slots, at a ragged width and in slab
   mode there; hole-fill reachability on a real mask and on a serpentine
   through every tile row, a checkerboard, a 33-px comb, all background, all
   foreground, 1xW, Hx1, (H-1)x(W-3) and 1x1, corner and border seeds; CC
   labelling 8- and 4-connected, greedy assignment (also at the edge
   shapes 64x64, 1x1, 33x7, 1x64, 64x1, 8x5 and 5x9, and on structured
   matrices: every cell equal, every row's minimum in one column, signed
   zeros); LOBSTER's consensus C=3 and C=1, also with req = N, with good
   samples only in its last slots, at a ragged width (with its req and with
   N) and with a random 3x3 pending log, whole and ragged; the GMG list
   update at t = 5, 19 and 30, and on states that keep its invariant but
   that the clip never reaches (every list full with no match and with the
   match in slot 63, lists of 63 appending into slot 63, all lists empty,
   a random mix of lengths 0-64; each at t = 5, 19 - the end of training -
   and 30), the DPTexture histograms, also on a flat
   frame with the model all 121, at a ragged width (with LBP codes, and
   with codes and a model 0-255) and on images smaller than the window
   (8x9, 1xW, Hx1), the MultiLayer update learning and not, on a real
   state and on random states on which every branch fires (removal, also
   emptying a list, match, promotion, displacement, no-match append and
   overwrite, the empty seed; the pixels of each are printed); the v3
   read-only walk C=3 and C=1, also with a requirement of N, with good
   samples only in its last slots, at a ragged width and with every walk
   still open after its first 4 samples; the fused
   whole step C=3 and C=1 at t > 0 and t = 0 with the scalar requirement,
   C=3 also with a random requirement map, and both with a requirement of
   N, with good samples only in the last slots and at a ragged width with
   the step's requirement and with N; FGD's table
   phase on inputs of real steps - the noisy and the quiet clip, the first
   frame, f32 statistics - on the quiet step with its tables filled, on
   random tables with ties, at a ragged width and an odd pixel count, and
   with f16 subnormal entries; the min-label fixed point on a 180-row shard of
   SuBSENSE's frame-3 mask with its neighbour's boundary row injected, 8- and
   4-connected, on a serpentine crossing the shard cut ten times and on a
   random mask; CC labelling and the fixed point, 8- and 4-connected, on
   the hole fill's adversarial masks and their complements and on FGD's
   flooded mask, the fixed point with random initial labels, whole and on
   a shard's rows; the consensus's slab mode on three shards' halo slabs,
   against its plain version and the unsharded kernel's rows; LOBSTER's
   consensus and the v3 walk in slab mode, C=3 and C=1, on the halo slabs
   of shards 0, 1 and 3 and of shard 1 at a ragged width, against their
   plain versions and the unsharded kernel's rows; the Kalman predict and
   update on seeded banks of 32 and 7 tracks the clip never reaches - a
   block that pivots at every step of the 4x4 inverse, gated-out slots of
   -0.0, NaN and 3e38, a singular S, magnitudes 1e-3 to 1e4 - and over 12
   chained steps; the resize on LbpMrf's u plane of the clip to its 24x32
   grid, on a 1080p and a random plane, on 240x320, 360x640 and 576x720
   planes (the row contraction sharded in Eigen's tree), and MultiCue's
   120x160 map enlarged to 720x1280 and 576x720; Eigenbackground's Gram
   product (``contract.gram``: a CTA a depth block, the upper triangle in
   register tiles, mirrored) of 20 and 64 frames at 720p and of 20, 28, 32,
   52 and 64 frames of the 360x640 crop, also of the crop less its last
   value (a depth of 3 mod 4), its lifts (``contract.lift``, one launch),
   both bit for bit against the plain versions on the card, also on every
   plan form at small random sizes (1, 2 and 4 lanes, tails, rows not
   16-byte aligned, a narrow last panel of rounded products, the 51-64-row
   orders, histories above 64), and the projection there, ``syevd`` (one
   block of 256 threads a matrix) on the eigensolver
   tests' 5,000 matrices (n = 4, 8, 20, 25; Gram, rank-deficient, zero,
   repeated eigenvalues, scaled by 1e-6, 1e6, 1e-30), their 3,500 of n =
   26-32 (sstedc's divide and conquer), their 720 of n = 33, 34, 40, 50, 51
   and 64 (blocked ssytrd, slaed0's two levels, sormqr's blocks) and the
   Gram matrices; the inverse's and the eigensolver's agreement with the
   machine's LAPACK printed as information);
4. the main path: warm start, then 64 frames of ``SuBSENSE.step`` and
   ``BlobTracker.step``; every kernel's launch count must be > 0, the mean
   foreground share in (0.1 %, 50 %), and a track active at the end;
4b. the registry path: for each of the four algorithms, ``get_algorithm``,
   ``init``, ``warm_start`` and 32 frames of ``step``; its kernel's launch
   count must be > 0 and the mean foreground share after its training
   window in (0.1 %, 50 %); then its first frames again through the plain
   versions, with masks and the state equal to the kernel run's;
4c. the consensus variants: SuBSENSE with ``TRACKING_TPU_CONSENSUS=v3``,
   SuBSENSE with ``TRACKING_TPU_FUSED=1`` and subsenseShrink fused, 32
   frames each: the new kernel's launch count > 0 and ``consensus``'s 0,
   the foreground share in (0.1 %, 50 %), the first 8 frames and the state
   again through the plain versions;
4d. the FG_0 path on the quiet clip (sensor noise 0.5: FGD's change test
   fires on most pixels at the main clip's 2.5): ``get_algorithm("FG_0")``,
   warm start, 64 frames of ``FGD.step`` and ``BlobTracker.step``; the
   launch counts of ``fgd_tables``, the fill, CC and assignment > 0, the
   foreground share after frame 1 in (0.1 %, 50 %), a track active at the
   end, the first 8 frames (masks, tracks, state) again through the plain
   versions; FG_0S for 16 frames with the same kernel-vs-plain check;
4e. the row-sharded pipeline: ``run_video_spatial_tracked`` in 4 shards of
   180 rows, 16 frames in lockstep and 8 pipelined, against the unsharded
   kernel path on the same frames (masks, per-frame track x, the tracker
   table, the gathered SuBSENSE state leaf by leaf); the launch counts of
   ``label_fixpoint``, ``consensus`` (here all in slab mode),
   ``flood_reach`` and ``greedy_assign`` > 0 and ``label_components``' 0;
   the first 4 frames again through the plain versions; the most
   components a frame had (the sharded blob table follows the unsharded one
   up to 128);
4f. the tracking app (``runner/cli.run_tracking``, the frame loop of
   ``tracking-run``) on the clip's frames in chunks of 16: the default app
   (SuBSENSE, BD_CC, CCMSPF, HistPVS, Kalman) for 32 frames writes a
   RawTracks CSV and a ``bta_data`` npz, launches the four main kernels and
   ends with an active track; 16 frames, ``--savestate``, a fresh app with
   ``--loadstate``, 16 more equal the 32-frame run (the CSV byte for byte,
   the BGS and tracker states leaf by leaf); ``FGTrainFrames=8`` records no
   track before frame 8; ``--fg FG_1`` (MOG1) + CCMSPF for 16 frames equals
   its plain path (masks, tracks, states); MS, MSFG and MSPF after SuBSENSE
   for 16 frames equal a CPU run on the same masks and frames (the table and
   templates and Kalman leaves bit for bit) and their colour
   sums equal the CPU's on the card's inputs of every 4th frame;
   MultiLayer's ``saveModel`` then
   ``bg_model_preload`` equals an unbroken run; GMG's u32 and FGD's f16
   leaves round-trip a checkpoint; where cv2 imports, ``tracking_run`` on an
   FFV1 AVI of the clip's first 16 frames gives the same CSV (else it says
   so), read through the native reader where it builds (its
   ``vio_read_batch`` calls counted), else through cv2;
4g. the BGS apps (``runner/cli.run_bgs``, the loop of ``bgs-run``, on the
   clip's frames in chunks of 8; ``cdnet_run`` on JPEGs of the clip):
   the default config directory (its 3 XMLs written; FrameDifference
   behind the PreProcessor) for 16 frames equals a CPU run; a fan-out of
   FrameDifference, StaticFrameDifference, WeightedMovingMean,
   WeightedMovingVariance, MOG1, AdaptiveBackgroundLearning, GMG,
   DPTexture, MultiLayer, SuBSENSE and LOBSTER with the PreProcessor's
   blur for 16 frames, SigmaDelta enabled by an XML edit between the
   chunks: the launch counts of ``consensus``, ``flood_reach``,
   ``consensus_lobster``, ``gmg_step``, ``texture_prox_cur`` and
   ``multilayer_step`` > 0, each algorithm's masks equal its own
   ``run_video`` on the blurred frames (SigmaDelta warm-started as the
   reload does), the first 4 frames equal the plain versions, the blur
   and the float simple algorithms (and AdaptiveSelective through ``-a``)
   equal a CPU run; ``cdnet-run`` shrinkBGS on 24 JPEGs (ROI 8-23,
   bootstrap 8) writes its 16 PNGs, its first 4 masks on the frames'
   top-left 360x640 equal a CPU run's,
   and ``--bgs subsenseShrink`` launches ``consensus`` and
   ``flood_reach``; outputs under ``build/bgs_smoke/``;
4h. the 13 algorithms that the JAX package runs with XLA ops only (MOG2,
   DPAdaptiveMedian, Grimson, Zivkovic, DPMean, DPWrenGA, DPPratiMediod,
   the five lb models, VuMeter; plain torch): each alone through
   ``run_video``, 4 frames then 16 timed with CUDA events (0/255 masks, a
   finite state); the first 6 frames of the clip's top-left 360x640 on the
   card equal a CPU run bit for bit (masks, background, state; Prati with
   historySize 4 and samplingRate 1, the SOMs with trainingSteps 3, so
   that the ring replaces slots and calibration ends), and MultiLayer's
   there too, kernel #11 on the card against the CPU's plain version (both
   take XLA's ``exp`` and ``sqrt``); a ``run_bgs``
   fan-out from an XML directory enabling the 13 and SuBSENSE, 2 chunks of
   8: ``consensus`` and ``flood_reach`` launch 16 times each and every
   fan-out mask equals its own ``run_video``; the fan-out's tictoc;
4i. the nine algorithms of the fuzzy-integral (Sugeno, Choquet), type-2
   fuzzy GMM / MRF (T2FGMM_UM/UV, T2FMRF_UM/UV), KDE, IMBS and
   Eigenbackground modules, with 4 learning frames, a sample every frame
   and a 4-sample IMBS model and a 4-frame Eigenbackground history: each
   alone through ``run_video``, 6 frames then 16 timed with CUDA events
   (masks in the algorithm's labels, IMBS's {0, 80, 180, 255}; a finite
   state; IMBS's ``label_components`` launched once per frame,
   Eigenbackground's ``contract`` twice and ``syevd_small`` once (its PCA)
   and ``pca_project`` once a frame, nothing else launched); the first 7
   frames of the clip's top-left 360x640 on the card equal a CPU run bit
   for bit (masks, background, every state leaf), and Eigenbackground with
   a 26-frame history (``syevd_small``'s divide and conquer) over 27 crop
   frames too (the PCA at the last), and with a 52-frame history over 57
   frames of the 120x160 crop at row 480, column 840, which an object
   enters after the PCA (blocked ssytrd, two levels of cuts), their
   launches counted; a ``run_bgs`` fan-out from an
   XML directory enabling the nine (those configs in their XMLs) and
   SuBSENSE, 2 chunks of 8: ``consensus`` and ``flood_reach`` launch 16
   times each, ``label_components`` once per IMBS frame that starts with a
   model, Eigenbackground's kernels as alone, and every fan-out mask equals
   its own ``run_video``; the
   fan-out's tictoc;
4j. MultiCue (type 34) at its defaults: 21 training frames with empty
   masks, then 8 detection frames that launch ``label_components`` 24
   times, 8 4-connected (its boxes) and 16 8-connected (Canny's
   hysteresis on the frame and on the candidate map), and nothing else;
   LbpMrf (type 30) on 6 frames: ``flood_reach`` once a frame (its corner
   fill) and nothing else, the first mask empty, the min cut's drain
   rounds, distance sweeps and host reads a frame; both on the clip's
   top-left 360x640 against a CPU run bit for bit (MultiCue with a 60x80
   reduced map, enlarged 6x and 8x as at 720p, over 25 frames; LbpMrf over
   5, its 24x32 scene-cut grid included); a ``run_bgs``
   fan-out from an XML directory enabling both (MultiCue with 4 training
   frames) and SuBSENSE, 2 chunks of 8: ``consensus`` 16 launches,
   ``flood_reach`` 32, ``label_components`` 33 (MultiCue's 11 detection
   frames), every fan-out mask equal to its own ``run_video``; the apps:
   ``bgs-run -a LbpMrf`` (8 frames, masks equal ``run_video``'s),
   ``tracking-run --bgs_type 34`` (32 frames: 11 past MultiCue's training)
   and ``30`` (8 frames) with their kernels' launch counts, and
   ``cdnet-run --bgs lbp-mrf`` on 8 JPEGs;
4k. stream batching and the sharded LBSP family on 4 streams (the clip and
   three seeded clips of their own), each run against the streams' own
   unsharded kernel runs (masks and every state leaf), launch counts zeroed
   just before each run and read just after: ``run_video_batch`` of
   SuBSENSE with 1, 2 and 4 streams over 16 frames (``consensus`` once a
   stream and frame); ``run_video_batch_shardmap`` on ``make_mesh(4,
   stream=4)``; 8 frames of ``run_video_batch`` on a 2 x 2 mesh (2 streams x
   2 row shards of 360), of LOBSTER, of SuBSENSE v3 and of SuBSENSE under
   ``TRACKING_TPU_FUSED=1`` in 4 row shards of 180: the path's kernel
   launched in slab mode only (``consensus``, ``consensus_lobster``,
   ``consensus_read``; ``consensus`` 0 times under v3, ``consensus_feedback``
   0 times under the fused switch, which runs v1 there); the first 3 frames
   of the first three again through the plain versions;
4l. the blob table: ``blob_properties`` (with the gray frame, 64 slots) on 8
   of SuBSENSE's masks at 720p launches ``label_components`` once a call
   and nothing else, and its tables equal those from the plain labels
   bit for bit; on the masks' top-left 360x640 the card's table, every
   ``get_*`` evaluator, ``moment_ellipse`` and a ``filter_blobs`` +
   ``nth_blob`` + ``paint_blobs`` chain equal a CPU run of the port bit for
   bit; ``native.build()`` (its library or the compiler's reason is
   printed); where it builds, ``VideoSource.chunks`` on phase 4f's AVI
   (chunk 5 with ``max_frames`` 11; chunk 6 with flip and an ROI) yields
   cv2's frames through the native reader, and the masks written through
   ``native.VideoWriter`` decode through cv2 at 720x1280 (where it does not
   build, files are read through cv2 and the run goes on, as the JAX
   package chooses);
4m. the process mesh (``parallel/dist.py``): one group of 4 gloo
   processes that share the card (``make_mesh(4, backend="gloo")``, each
   CUDA tensor of an exchange staged through the host) runs the tracked
   path (CCMSPF, pipelined, 4 shards of 180 rows, 8 frames), then, laid
   out as 2 x 2, ``run_video_batch_spatial`` and, as 4 x 1,
   ``run_video_batch_shardmap`` over 4 streams of 4 frames; each equals the
   thread group's run on the same frames bit for bit (masks, states,
   tracks), and the kernels of each launch in the ranks (their counts set
   to 0 when a rank's call starts, summed after: ``label_fixpoint``,
   ``consensus`` once a shard a frame, ``flood_reach``, ``greedy_assign``;
   ``label_components`` 0 times on the tracked path); placed batches in
   chunks with their states kept on the ranks; the reshard chain: the 4
   streams' first 12 frames placed on 4 x 1 and run 3 frames a layout
   through 4 x 1 -> 2 x 2 -> 1 x 4 -> 4 x 1, the states resharded on the
   ranks between calls (each reshard's ``bytes_moved`` equal to the plan's
   count from the two metas, 0 bytes through the parent; the first hop in
   turns with a gather plus a new placement), masks and final states
   equal to the same chain on 4 threads bit for bit; then an NCCL group,
   one rank a card over every card (``make_mesh(backend="nccl")``), runs
   ``run_video_batch`` of the same streams and equals it too, a placed
   batch in chunks, the tracked path on 1 x n cards in 2 chunks with both
   states placed (masks and SuBSENSE state bit for bit against 1 x n
   threads on card 0, tracks and tracker state bit for bit too;
   its kernels' launches a frame) and the reshard chain across the cards
   (one card: one rank, the chain has one layout, and the run says the
   multi-rank NCCL exchange was not run); each run prints its arguments'
   and results' hand-offs (CUDA IPC handles, copied on the device) and
   each rank's device memory;
5. the first 16 SuBSENSE + tracker frames again through the plain
   versions: masks, track ids and positions must equal the kernel run's;
6. timing with CUDA events: each kernel beside its plain version and its
   bound, ms/frame for the SuBSENSE step alone, the full path and each of
   the four algorithms, the tracking app's ms/frame in turns with the full
   path, v1 / v3 / fused SuBSENSE steps and the
   subsenseShrink fused step in turns, CC
   labelling on FGD's masks (quiet and flooded) beside SuBSENSE's, FGD's
   table kernel on young, full and noisy-clip tables (also on fresh copies
   of the state, and with every pixel of the noisy frame in one table), the
   FGD step with the table kernel against the plain table phase in turns and
   the FG_0 path,
   each on young and on full tables, the min-label fixed point, the slab
   mode's ms beside the unsharded consensus's, the sharded path's ms/frame
   beside the unsharded path's in turns and its peak memory, the device
   operations a call of the main path's four kernels (``consensus`` and
   ``greedy_assign`` at most 1, ``flood_reach`` and ``label_components`` at
   most 3), of ``consensus_lobster``, ``consensus_read``,
   ``consensus_feedback``, ``gmg_step``, ``fgd_tables``,
   ``texture_prox_cur`` and ``multilayer_step`` (at most 1 each; MultiLayer
   timed on fresh copies of its state, its bound counting only the words the
   data needs, the whole
   state's beside it) and of
   ``label_fixpoint`` (at most 4), an empty launch's event and device
   time, and the device's busy share and kernels per frame under
   torch.profiler (the full path, and the app over a chunk); ``bgs-run``'s
   ms/frame with the default config directory, the 12-algorithm fan-out,
   phase 4h's 14-algorithm fan-out, phase 4i's 10-algorithm fan-out and
   phase 4j's 3-algorithm fan-out, in turns, the 12-algorithm fan-out's
   tictoc (``FrameProcessor.profile``), the three fan-outs' profiles, and
   shrinkBGS's step (CUDA events and its profile); MultiCue's detection
   step and LbpMrf's step in turns and their profiles, and LbpMrf's
   per-stage table (Luv, resize, LBP, histograms, both model updates, the
   min cut with its drain rounds, sweeps and host reads, assembly, fill,
   erode; CUDA events at the stage marks); the slab mode of LOBSTER's
   consensus and of the v3 walk beside their plain versions;
   ``run_video_batch`` of SuBSENSE at 1, 2 and 4 streams in turns
   (aggregate and per-stream ms/frame) and each batch's profile (busy
   share, kernels per frame); LOBSTER's and SuBSENSE v3's steps unsharded
   and in 4 row shards, in turns; ``blob_properties`` at 720p (CUDA events,
   device operations and device ms a call), and where the native reader
   builds, the decode ms/frame of a 48-frame FFV1 AVI and the tracking
   app's ms/frame on it, through the native reader and through cv2 in
   turns; the tracked path in 4 shards and the 4-stream batch on 4 x 1, 4
   gloo processes against 4 threads in turns (ms/frame, aggregate for the
   batch), the processes' start seconds, hand-offs and device memory
   (every process's context counted) beside the threads' peak; the
   Kalman kernels and the resize against their plain versions (the resize
   beside ``F.interpolate``'s antialiased bilinear) and the tracker's step
   on the main path's masks with the Kalman kernels and with the parent's
   Kalman (cuBLAS and cuSOLVER) in turns, ms and device operations a frame;
   ``syevd_small`` on the Gram matrices of 20, 32 and 64 frames of the crop
   in turns with ``torch.linalg.eigh`` on the same matrix; Eigenbackground
   at 720p with a 64-frame history through the kernels (the step that
   builds the PCA, split into its Gram product, eigensolver, lift, norms,
   projection and the rest, and the ms/frame after it, its launches, its
   eigensolver on its own Gram matrix against the plain one in the CPU
   workers); ``contract``'s Gram product and lift of 20 frames of the crop,
   20 frames at 720p and 64 frames at 720p in turns with ``torch.matmul``.

The last three lines are a JSON object of the per-kernel results, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np
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
    "consensus_lobster": ("tracking_tpu_torch/csrc/consensus.cu", "tracking_tpu/ops/pallas_consensus.py:1254"),
    "gmg_step": ("tracking_tpu_torch/csrc/gmg.cu", "tracking_tpu/ops/pallas_gmg.py:119"),
    "texture_prox_cur": ("tracking_tpu_torch/csrc/texture.cu", "tracking_tpu/ops/pallas_texture.py:111"),
    "multilayer_step": ("tracking_tpu_torch/csrc/multilayer.cu", "tracking_tpu/ops/pallas_multilayer.py:86"),
    "consensus_read": ("tracking_tpu_torch/csrc/consensus.cu", "tracking_tpu/ops/pallas_consensus.py:778"),
    "consensus_feedback": ("tracking_tpu_torch/csrc/consensus.cu", "tracking_tpu/ops/pallas_consensus.py:1012"),
    "fgd_tables": ("tracking_tpu_torch/csrc/fgd.cu", "tracking_tpu/ops/pallas_fgd.py:64"),
    "label_fixpoint": ("tracking_tpu_torch/csrc/cc.cu", "tracking_tpu/ops/pallas_cc.py:270"),
    # kernels with no Pallas counterpart: they reproduce the JAX function named
    "kalman_predict": ("tracking_tpu_torch/csrc/kalman.cu",
                       "no Pallas counterpart; reproduces tracking_tpu/track/kalman.py:60 kalman_predict"),
    "kalman_update": ("tracking_tpu_torch/csrc/kalman.cu",
                      "no Pallas counterpart; reproduces tracking_tpu/track/kalman.py:67 kalman_update"),
    "contract": ("tracking_tpu_torch/csrc/contract.cu",
                 "no Pallas counterpart; reproduces XLA:CPU's dot in jax.image.resize (tracking_tpu/bgs/lbp_mrf.py:377) "
                 "and in Eigenbackground's Gram product and lift (tracking_tpu/bgs/eigenbackground.py:70, :74)"),
    "pca_project": ("tracking_tpu_torch/csrc/pca.cu",
                    "no Pallas counterpart; reproduces tracking_tpu/bgs/eigenbackground.py:89-90, the projection and "
                    "reconstruction"),
    "syevd_small": ("tracking_tpu_torch/csrc/pca.cu",
                    "no Pallas counterpart; reproduces jnp.linalg.eigh (LAPACK ssyevd) at "
                    "tracking_tpu/bgs/eigenbackground.py:71"),
}
# the registry path: (algorithm, its kernel, first frame after its training
# window, frames replayed through the plain versions)
REGISTRY = (
    ("LOBSTERBGS", "consensus_lobster", 1, 8),
    ("GMG", "gmg_step", 21, 24),  # the mask is empty while GMG trains (20 frames)
    ("DPTextureBGS", "texture_prox_cur", 1, 8),
    ("MultiLayerBGS", "multilayer_step", 2, 8),  # the first frame's mask is empty
)
MAIN_KERNELS = ("consensus", "flood_reach", "label_components", "greedy_assign", "kalman_predict", "kalman_update")
REGISTRY_FRAMES = 32
REGISTRY_TIMED = 16
# the consensus variants: (label, algorithm, environment, its kernel)
VARIANTS = (
    ("SuBSENSE v3", "SuBSENSEBGS", {"TRACKING_TPU_CONSENSUS": "v3"}, "consensus_read"),
    ("SuBSENSE fused", "SuBSENSEBGS", {"TRACKING_TPU_FUSED": "1"}, "consensus_feedback"),
    ("subsenseShrink fused", "subsenseShrink", {"TRACKING_TPU_FUSED": "1"}, "consensus_feedback"),
)
VARIANT_FRAMES = 32
VARIANT_PLAIN = 8
# the FG_0 path (FGD + tracker) on the quiet clip: its kernels, frames
# replayed through the plain versions, FG_0S frames, timed frames
FGD_KERNELS = ("fgd_tables", "flood_reach", "label_components", "greedy_assign")
FGD_NOISE = 0.5
FGD_PLAIN = 8
FGDS_FRAMES = 16
FGD_TIMED = 16
# the kernel table's row for fgd_tables: the full tables a deployed model runs on
FGD_ROW = "quiet clip, frame 6, full tables"
# the row-sharded path: shards, frames in lockstep, pipelined and through the
# plain versions (the halo and the blob table's root candidates are
# parallel/spatial.py's HALO and N_CAND)
SHARDS = 4
SPATIAL_FRAMES = 16
SPATIAL_PIPELINED = 8
SPATIAL_PLAIN = 4
SPATIAL_KERNELS = ("label_fixpoint", "consensus", "flood_reach", "greedy_assign")
SPATIAL_TIMED = (8, 2)  # ms/frame = (T(8 frames) - T(2 frames)) / 6
# phase 4k: stream batching (streams a batch, frames a stream) and the
# LBSP family's row sharding (frames; frames through the plain versions);
# phase 6 times the batches (a batch frame = (T(10) - T(2)) / 8)
BATCH_STREAMS = (1, 2, 4)
BATCH_FRAMES = 16
SHARDED_FRAMES = 8
SHARDED_PLAIN = 3
BATCH_TIMED = (10, 2)
# phase 4m: the process mesh on the one card. One group of MESH_RANKS gloo
# processes that share it runs the tracked path (1 x 4, pipelined), a 2 x 2
# stream x space batch and a 4 x 1 stream batch, each against the thread
# group's run on the same frames; then an NCCL group over every card runs
# the stream batch (run_video_batch on its default mesh). Phase 6 times
# processes against threads in turns (ms/frame = (T(6) - T(2)) / 4: the
# threads' wall, the processes' compute from the first rank's start to
# the last rank's end, their hand-offs apart).
# The placed batches: the 4 streams' first MESH_PLACED frames placed on 4 x 1
# and run in chunks of MESH_CHUNK with the states kept on the ranks, the
# tracked path in chunks of MESH_CHUNK with both states kept; phase 6 runs
# the batch in chunks of MESH_TIMED frames with its states as tensors and
# placed, in turns.
MESH_RANKS = 4
MESH_FRAMES = 8
MESH_BATCH_FRAMES = 4
MESH_TIMED = (6, 2)
MESH_PLACED = 12
MESH_CHUNK = 4
RESHARD_STREAMS = (4, 2, 1)  # the reshard chain's stream counts (those that divide the ranks), then the first
# phase 4l: the blob table on SuBSENSE's masks of the clip (the evaluator
# chain also on the top-left crop against a CPU run), then the native FFmpeg
# reader on phase 4f's FFV1 AVI (chunk, max_frames, flip, ROI) and its MJPEG
# writer; phase 6 decodes a longer AVI and runs the app on it through each
# reader
BLOB_FRAMES = 8
BLOB_CUT = (360, 640)
READER_CASES = ((5, 11, False, None), (6, 0, True, (100, 50, 900, 600)))
READER_FRAMES = 48
APP_FRAMES = 32  # phase 4f: the tracking app
APP_CHUNK = 16
APP_TRAIN = 8  # FGTrainFrames
APP_ML = 4  # MultiLayer frames before and after its model checkpoint
APP_DIR = "build/app_smoke"  # the app's output files (git-ignored)
# phase 4g: the BGS apps. The fan-out enables every ported algorithm that
# has a FrameProcessor flag but SigmaDelta, which an XML edit between the
# two chunks adds; AdaptiveSelective has no flag and runs through -a
BGS_FRAMES = 16
BGS_CHUNK = 8
FANOUT = ("FrameDifferenceBGS", "StaticFrameDifferenceBGS", "WeightedMovingMeanBGS", "WeightedMovingVarianceBGS",
          "MixtureOfGaussianV1BGS", "AdaptiveBackgroundLearning", "GMG", "DPTextureBGS", "MultiLayerBGS",
          "SuBSENSEBGS", "LOBSTERBGS")
FANOUT_ADDED = "SigmaDeltaBGS"
FANOUT_KERNELS = ("consensus", "flood_reach", "consensus_lobster", "gmg_step", "texture_prox_cur", "multilayer_step")
FLOAT_SIMPLE = ("WeightedMovingMeanBGS", "WeightedMovingVarianceBGS", "AdaptiveBackgroundLearning")
FANOUT_PLAIN = 4  # fan-out frames replayed through the plain versions
CDNET_FRAMES = 24  # cdnet-run: in%06d.jpg frames, the ROI and the bootstrap
CDNET_ROI = (8, 23)
CDNET_BOOT = 8
# its first frames on the card and on the CPU, on a cut of the frames:
# shrinkBGS's int64 threefry draws take ~5 s a 720p frame on the card
# machine's CPU
CDNET_CPU = 4
CDNET_CUT = (360, 640)
BGS_DIR = "build/bgs_smoke"  # the BGS apps' files (git-ignored)
# phase 4h: the Gaussian-mixture, dp, Prati, VuMeter and lb algorithms, in
# the flags' order (plain torch: the JAX package has no Pallas code for
# them); each alone, warm-up and timed frames; the first frames of the crop
# on the card and on the CPU, with configs that reach the branches a short
# clip misses; then a fan-out of all 13 beside SuBSENSE, whose kernels are
# the phase's CUDA kernels
NEW_ALGOS = ("MixtureOfGaussianV2BGS", "DPAdaptiveMedianBGS", "DPGrimsonGMMBGS", "DPZivkovicAGMMBGS", "DPMeanBGS",
             "DPWrenGABGS", "DPPratiMediodBGS", "LBSimpleGaussian", "LBFuzzyGaussian", "LBMixtureOfGaussians",
             "LBAdaptiveSOM", "LBFuzzyAdaptiveSOM", "VuMeter")
NEW_WARM, NEW_TIMED = 4, 16
NEW_CPU = 6
NEW_CUT = (360, 640)
NEW_CUT_CFG = {"DPPratiMediodBGS": {"historySize": 4, "samplingRate": 1}, "LBAdaptiveSOM": {"trainingSteps": 3},
               "LBFuzzyAdaptiveSOM": {"trainingSteps": 3}}
NEW_KERNELS = ("consensus", "flood_reach")
# phase 4i: the fuzzy-integral, type-2 fuzzy GMM / MRF, KDE, IMBS and
# Eigenbackground algorithms, in the flags' order (plain torch but IMBS's
# component labelling, the CC kernel); configs that reach detection inside
# the phase (4 learning frames, a sample every frame and a 4-sample IMBS
# model, a 4-frame Eigenbackground history), also written into the
# fan-out's XMLs; each alone, the first frames of the crop on the card and
# on the CPU, then a fan-out of the nine beside SuBSENSE
S15_ALGOS = ("DPEigenbackgroundBGS", "T2FGMM_UM", "T2FGMM_UV", "T2FMRF_UM", "T2FMRF_UV", "FuzzySugenoIntegral",
             "FuzzyChoquetIntegral", "KDE", "IndependentMultimodalBGS")
S15_CFG = {"DPEigenbackgroundBGS": {"historySize": 4, "embeddedDim": 3}, "FuzzySugenoIntegral": {"framesToLearn": 4},
           "FuzzyChoquetIntegral": {"framesToLearn": 4}, "KDE": {"framesToLearn": 4},
           "IndependentMultimodalBGS": {"fps": 2.0, "numSamples": 4}}
S15_LABELS = {"IndependentMultimodalBGS": {0, 80, 180, 255}}
S15_LONG = {"historySize": 26, "embeddedDim": 10}  # Eigenbackground past ssteqr: sstedc divides and conquers
# Eigenbackground past one slatrd panel and one level of cuts (52 frames:
# blocked ssytrd, slaed0's two levels) on a small crop that an object
# enters after the PCA, card against CPU
S15_LONG52 = {"historySize": 52, "embeddedDim": 10}
LONG52_CUT, LONG52_AT, LONG52_AFTER = (120, 160), (480, 840), 5  # 5 frames after the PCA
S15_WARM, S15_TIMED = 6, 16
S15_CPU = 7  # crop frames on the card and on the CPU: two past every algorithm's learning
S15_KERNELS = ("consensus", "flood_reach", "label_components")
# phase 4j: MultiCue (type 34) and LbpMrf (type 30), plain torch on the CC
# kernel (MultiCue's boxes 4-connected, Canny's hysteresis 8-connected) and
# the hole-fill kernel (LbpMrf's corner fill): each alone at 720p (MultiCue
# at its defaults past its 21 training frames, LbpMrf on a few frames), the
# top-left crop on the card against a CPU run (MultiCue with a 60x80 reduced
# map: enlarged 6x and 8x as at 720p), then a fan-out of both with SuBSENSE
S16_ALGOS = ("LbpMrf", "SJN_MultiCueBGS")
S16_TRAIN = 21  # MultiCue's training frames at its defaults (t = 0..20)
S16_DETECT = 8  # MultiCue's detection frames alone
S16_LBP = 6  # LbpMrf's frames alone
S16_CPU = {"SJN_MultiCueBGS": 25, "LbpMrf": 5}  # crop frames on the card and on the CPU
S16_CUT_CFG = {"SJN_MultiCueBGS": {"reducedHeight": 60, "reducedWidth": 80}}
S16_FAN_CFG = {"SJN_MultiCueBGS": {"trainingPeriod": 4}}  # detects inside the fan-out's frames
# phase 3: Eigenbackground's products at its default history and basis
EIGEN_S, EIGEN_E = 20, 10
SYEVD_THREADS = 256  # csrc/pca.cu: EIG_THREADS
# phase 6 times pca_project's plain version on the crop's first values (~40 s at the whole crop)
PCA_PLAIN_D = 691200 // 16
# phase 6: Eigenbackground at 720p with a 64-frame history, through the
# kernels: the PCA's step and the frames after it
EIGEN720_CFG = {"historySize": 64, "embeddedDim": 10}
EIGEN720_AFTER = 16
# phase 6: the tracker's steps on the main path's masks, the Kalman kernels
# against the parent's Kalman (cuBLAS products and cuSOLVER's inverse), in
# turns
TRACKER_TIMED = 32
SWITCHES = ("TRACKING_TPU_CONSENSUS", "TRACKING_TPU_FUSED", "TRACKING_TPU_FUSED_INTERP")
# kernels that must keep their state in registers or shared memory: no
# stack frame (a local array indexed at run time) and no spills
NO_STACK = {
    "multilayer_kernel<0>", "multilayer_kernel<1>", "texture_kernel<0>", "texture_kernel<1>",
    "read_walk_kernel<1>", "read_walk_kernel<3>", "lobster_kernel<1>", "lobster_kernel<3>", "greedy_assign_kernel",
    "fgd_tables_kernel<0, 0>", "fgd_tables_kernel<0, 1>", "fgd_tables_kernel<1, 0>", "fgd_tables_kernel<1, 1>",
    "gram_block_kernel<4, 1>", "gram_block_kernel<2, 2>", "gram_block_kernel<2, 4>", "gram_combine_kernel",
    "lift_kernel<1>", "lift_kernel<2>", "lift_kernel<4>",
}
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, float32 outside the
# tensor cores; the bound of a kernel is the larger of its bytes and its
# operations over these
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


T0 = time.perf_counter()


def elapsed() -> str:
    return f"(t = {time.perf_counter() - T0:.1f} s)"


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
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def max_err(a, b) -> float:
    """Largest |a − b| over matching tensors (tuples and dicts compared leaf
    by leaf; u32 leaves through their int32 view, which CUDA torch can
    convert)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"leaf mismatch {sorted(set(a) ^ set(b))}")
        return max((max_err(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, (tuple, list)):
        return max((max_err(x, y) for x, y in zip(a, b)), default=0.0)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype mismatch {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
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


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the least time for ``n_bytes`` of device memory
    traffic and ``n_ops`` operations at the card's peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def examined(good: torch.Tensor, req) -> torch.Tensor:
    """Samples a walk examines per pixel: sample j is read iff fewer than
    ``req`` earlier samples were good."""
    g = good.to(torch.int32)
    before = torch.cumsum(g, dim=0) - g
    return (before < req).sum(dim=0)


def consensus_cost(planes, banks_before, banks_after, good, req, in_bytes_px: int, out_maps: int,
                   extra_bytes_px: int = 0, extra_ops_px: int = 0):
    """(bound_ms, bound_by) of a consensus (SuBSENSE's or LOBSTER's) on
    these inputs: it must read the frame planes, every colour slot (for
    bg_sum), the descriptors of the samples its walk examines and
    ``in_bytes_px`` bytes per pixel of maps (the pending log, thresholds),
    write the bank bytes the replay changes and ``out_maps`` int32 maps;
    plus ``extra_bytes_px`` / ``extra_ops_px`` per pixel (the fused step's
    feedback state)."""
    (colors0, descs0), (colors, descs) = banks_before, banks_after
    Cn = len(planes)
    N, Hh, Ww = colors[0].shape
    hw = Hh * Ww
    walked = int(examined(good, req).sum())
    changed = sum(int((a != b).sum()) for a, b in zip(colors0, colors))
    changed += 2 * sum(int((a != b).sum()) for a, b in zip(descs0, descs))
    n_bytes = Cn * hw + N * Cn * hw + 2 * Cn * walked + in_bytes_px * hw + changed + 4 * out_maps * hw
    n_bytes += extra_bytes_px * hw
    n_ops = N * Cn * hw + walked * Cn * 48 + extra_ops_px * hw  # ~48 integer ops per examined sample and channel
    return bound(n_bytes, n_ops)


def gmg_cost(code, nf, colors, weights, new_colors, new_weights):
    """(bound_ms, bound_by) of a GMG list update on these inputs. Slots at
    or past a pixel's list length hold (-1, 0) and never change, so the
    update must read code and nf and write fg and nf1 (int32 maps), read
    the colours its find examines (up to the first match, else the whole
    list) and the list's weights (each one is decayed or summed), and write
    the colour and weight slots that change."""
    K, Hh, Ww = colors.shape
    kidx = torch.arange(K, device=colors.device)[:, None, None]
    match = (colors == code[None]) & (kidx < nf[None])
    fi = torch.where(match, kidx, K).amin(dim=0)
    col_read = int(torch.where(fi < K, fi + 1, nf).sum())
    listed = int(nf.sum())
    changed = int((new_colors != colors).sum()) + int((new_weights != weights).sum())
    n_bytes = 16 * Hh * Ww + 4 * col_read + 4 * listed + 4 * changed
    print(f"  gmg_step bound: mean list length {listed / (Hh * Ww):.3f}, {col_read} colours read, "
          f"{changed} slots changed, {n_bytes / 1e6:.1f} MB", flush=True)
    return bound(n_bytes, 12 * (listed + Hh * Ww))  # ~12 operations per list slot and per pixel


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"  ok: {what}", flush=True)


def profile(run_frame, frame_ids, tag, label, top: int = 14, n_frames=None) -> None:
    """Where the time goes: torch.profiler over ``run_frame(t)`` for the
    frames ``frame_ids``, after the caller's warm-up; device time by kernel
    and the device's busy share of the wall time. ``n_frames`` (default:
    one per id) is what the per-frame figures divide by."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    n_frames = n_frames or len(frame_ids)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in frame_ids:
            run_frame(t)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, n_frames, tag, label, top)


def report_profile(prof, wall_us: float, n_frames: int, tag, label, top: int = 14) -> None:
    """Device time by kernel, busy share and kernels per frame of a
    finished torch.profiler run over ``n_frames`` frames."""
    events = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    busy = sum(dev_us(e) for e in events)
    if busy == 0.0:
        print(f"  {tag} {label} profile: the profiler saw no device time", flush=True)
        return
    print(f"  {tag} {label} profile over {n_frames} frames (profiler on): device busy "
          f"{busy / n_frames / 1e3:.3f} ms/frame of {wall_us / n_frames / 1e3:.3f} ms wall "
          f"= {busy / wall_us:.1%} busy; {sum(e.count for e in events) / n_frames:.0f} kernels/frame", flush=True)
    for e in sorted(events, key=dev_us, reverse=True)[:top]:
        print(f"    {dev_us(e) / n_frames / 1e3:8.4f} ms/frame  {e.count / n_frames:6.1f}x  {e.key[:90]}", flush=True)


def device_ops(fn, label, tag, reps: int = 20):
    """(device operations, device ms) per call of ``fn`` (kernels, copies,
    memsets) under torch.profiler; prints each operation's device ms per
    call."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    n = sum(e.count for e in events) / reps
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in events) / reps / 1e3
    print(f"  {tag} {label}: {n:.1f} device operations a call, {total:.4f} device ms: " + "; ".join(
        f"{e.key[:60]} {getattr(e, 'self_device_time_total', 0.0) / reps / 1e3:.4f} ms ({e.count / reps:.1f}x)"
        for e in events), flush=True)
    return n, total


def profile_full_path(algo, tracker, state0, frames, dev, tag, n_frames: int = 8) -> None:
    """The SuBSENSE + tracker path under the profiler, after 16 frames."""
    box = {"s": clone(state0), "tr": tracker.init(device=dev)}

    def run_frame(t):
        box["s"], fg, _ = algo.step(box["s"], frames[t])
        box["tr"], _ = tracker.step(box["tr"], fg)

    for t in range(1, 17):
        run_frame(t)
    profile(run_frame, range(17, 17 + n_frames), tag, "full path")


def nan_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a − b| where both are numbers; inf where one is NaN and the
    other not, or where the two infinities or signed zeros differ (the bits
    of two NaNs may differ: the plain versions' FMAs make NaN in f64)."""
    b = b.to(a.device)
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return math.inf
    a, b = a[~nan], b[~nan]
    if torch.equal(a.view(torch.int32), b.view(torch.int32)):
        return 0.0
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) or math.inf


def kalman_bank(gen, K: int, case: str, dev):
    """A seeded bank (x, P, z, gate) on ``dev``, as tests/test_torch_kalman.py
    makes its cases: random covariances, a block that pivots at every step
    of the 4x4 inverse, gated-out slots holding −0.0, NaN and 3e38, a
    singular S on the first 8 slots, magnitudes 1e-3 to 1e4."""
    scale = 10.0 ** gen.uniform(-3, 4, size=(K, 1)) if case == "scales" else 100.0
    x = (gen.normal(size=(K, 8)) * scale).astype(np.float32)
    A = gen.normal(size=(K, 8, 8)) * np.exp(gen.normal(size=(K, 8, 1)))
    P = A @ A.transpose(0, 2, 1)
    if case == "pivoting":
        P[:, :4, :4] = P[:, :4, :4][:, ::-1] * 10.0 ** np.arange(4)[None, :, None]
    if case == "scales":
        P = P * 10.0 ** gen.uniform(-3, 4, size=(K, 1, 1))
    P = P.astype(np.float32)
    z = (x[:, :4] + gen.normal(size=(K, 4)) * scale).astype(np.float32)
    gate = gen.uniform(size=K) < 0.75
    if case == "gated":
        out = ~gate
        x[out] = np.where(gen.uniform(size=(out.sum(), 8)) < 0.5, -0.0, np.nan).astype(np.float32)
        P[out] = np.where(gen.uniform(size=(out.sum(), 8, 8)) < 0.5, -0.0, 3e38).astype(np.float32)
    if case == "singular":
        P[:4, :4, :4] = -np.eye(4, dtype=np.float32) * np.float32(0.1)
        P[4:8, :4, :4] = np.float32(0.5) - np.eye(4, dtype=np.float32) * np.float32(0.1)
        gate[:8] = True
    return tuple(torch.from_numpy(v).to(dev) for v in (x, P, z, gate))


KALMAN_UPDATE_OPS = 3455  # a gated track's operations in kalman.cu's update (an FMA counts 2)
KALMAN_PREDICT_OPS = 2240  # a track's in its predict


def kalman_cost(x, gate, update: bool):
    """(bound_ms, bound_by) of one predict or update of the bank: x, P (and
    z, the gate, H and R) read, x and P written; the operations of the
    tracks the step changes."""
    K = x.shape[0]
    n_bytes = 4 * 2 * (K * 8 + K * 64) + (4 * (K * 4 + 32 + 16) + K if update else 4 * 128)
    n_ops = (int(gate.sum()) * KALMAN_UPDATE_OPS) if update else K * KALMAN_PREDICT_OPS
    return bound(n_bytes, n_ops)


def resize_cost(h: int, w: int, shape):
    """(bound_ms, bound_by) of the resize's two contractions: the plane and
    the weights' bands read once, the result written; two operations a
    band term."""
    from tracking_tpu_torch.ops.resize import _band

    oh, ow = shape
    n_bytes = 4 * (h * w + oh * ow)
    n_ops = 0
    for m, n, q in ((h, oh, w), (w, ow, oh)):  # the rows first: the grid's order
        if m == n:
            continue
        _, lo, hi = _band(m, n, "cpu")
        band = int((hi - lo + 1).clamp(min=0).sum())
        n_bytes += 4 * band
        n_ops += 2 * band * q
    return bound(n_bytes, n_ops)


def check_kalman_resize_kernels(frames, dev, errs, timing_inputs, bounds) -> None:
    """Phase 3 for the kernels with no Pallas counterpart, exactly against
    their plain versions on the card: kalman_predict and kalman_update on
    seeded banks of 32 and 7 tracks that the clip never reaches (a block
    that pivots at every step, gated-out slots of −0.0, NaN and 3e38, a
    singular S, magnitudes 1e-3 to 1e4) and over twelve chained steps;
    the resize's contraction kernel on LbpMrf's u plane of the clip (720p to
    24x32), a 1080p plane and a random one, 240x320, 360x640 and 576x720
    planes (Eigen's sharded tree), MultiCue's 0/255 map enlarged to
    720x1280 and 576x720. The inverse's agreement with this machine's
    LAPACK (scipy's sgetrf + strsm) is printed, as information: OpenBLAS
    picks its kernels by the host's CPU."""
    from tracking_tpu_torch.bgs.lbp_mrf import _rgb2luv_u8
    from tracking_tpu_torch.ops.resize import resize_bilinear
    from tracking_tpu_torch.track import kalman

    kp = kalman.default_params(device=dev)
    gen = np.random.default_rng(22)
    n_cases = 0
    for K in (32, 7):
        for case in ("random", "pivoting", "gated", "singular", "scales"):
            x, P, z, gate = kalman_bank(gen, K, case, dev)
            e = max(nan_err(a, b) for a, b in zip(kalman.kalman_update(x, P, z, gate, kp),
                                                   kalman.kalman_update_ref(x, P, z, gate, kp)))
            errs["kalman_update"] = max(errs["kalman_update"], e)
            e = max(nan_err(a, b) for a, b in zip(kalman.kalman_predict(x, P, kp), kalman.kalman_predict_ref(x, P, kp)))
            errs["kalman_predict"] = max(errs["kalman_predict"], e)
            n_cases += 1
    x, P, _, _ = kalman_bank(gen, 32, "random", dev)
    xr, Pr = x, P
    for t in range(12):
        z = x[:, :4] + torch.from_numpy(gen.normal(size=(32, 4)).astype(np.float32)).to(dev)
        gate = torch.from_numpy(gen.uniform(size=32) < 0.7).to(dev)
        x, P = kalman.kalman_update(*kalman.kalman_predict(x, P, kp), z, gate, kp)
        xr, Pr = kalman.kalman_update_ref(*kalman.kalman_predict_ref(xr, Pr, kp), z, gate, kp)
        errs["kalman_update"] = max(errs["kalman_update"], nan_err(x, xr), nan_err(P, Pr))
    torch.cuda.synchronize()
    check(errs["kalman_predict"] == 0.0 and errs["kalman_update"] == 0.0,
          f"kalman_predict and kalman_update equal their plain versions on {n_cases} banks (pivoting, gated-out "
          f"-0.0 / NaN / 3e38, a singular S, magnitudes 1e-3 to 1e4) and over 12 chained steps")
    try:
        from scipy.linalg import blas, lapack

        S = kalman_bank(gen, 4096, "pivoting", "cpu")[1][:, :4, :4].numpy() + np.eye(4, dtype=np.float32) * 0.1
        same = 0
        got = kalman._inverse(torch.from_numpy(S).to(dev)).cpu().numpy()
        for i, s in enumerate(S):
            lu, piv, _ = lapack.sgetrf(np.asfortranarray(s))
            perm = np.arange(4)
            for k, p in enumerate(piv):
                perm[[k, p]] = perm[[p, k]]
            y = blas.strsm(1.0, lu, np.asfortranarray(np.eye(4, dtype=np.float32)[perm]), side=0, lower=1, diag=1)
            same += bool(np.array_equal(blas.strsm(1.0, lu, y, side=0, lower=0), got[i]))
        print(f"  information: the card's ordered 4x4 inverse equals this machine's LAPACK (scipy) on {same} of "
              f"{len(S)} pivoting matrices", flush=True)
    except ImportError:
        print("  information: scipy does not import here; the inverse is not held against LAPACK", flush=True)
    xb, Pb, zb, gb = kalman_bank(gen, 32, "random", dev)
    timing_inputs["kalman_update"] = (xb, Pb, zb, gb, kp)
    timing_inputs["kalman_predict"] = (xb, Pb, kp)
    bounds["kalman_update"] = kalman_cost(xb, gb, True)
    bounds["kalman_predict"] = kalman_cost(xb, gb, False)

    u = _rgb2luv_u8(frames[1])[..., 1].to(torch.float32).contiguous()
    rng = torch.Generator(device="cpu").manual_seed(3)
    cases = [("LbpMrf's u plane, 720p -> 24x32", u, (24, 32)),
             ("a 1080p plane -> 24x32", torch.randint(0, 256, (1080, 1920), generator=rng).to(torch.float32), (24, 32)),
             ("a random normal plane, 720p -> 24x32", torch.randn((H, W), generator=rng) * 100, (24, 32))]
    for hw_ in ((240, 320), (360, 640), (576, 720)):
        cases.append((f"a {hw_[0]}x{hw_[1]} plane -> 24x32 (sharded rows)",
                      torch.randint(0, 256, hw_, generator=rng).to(torch.float32), (24, 32)))
    for shape in ((720, 1280), (576, 720)):
        fore = torch.where(torch.rand((120, 160), generator=rng) < 0.3, 255.0, 0.0)
        cases.append((f"MultiCue's 120x160 map -> {shape[0]}x{shape[1]}", fore, shape))
    for what, img, shape in cases:
        img = img.to(dev).contiguous()
        e = nan_err(resize_bilinear(img, shape), resize_bilinear(img, shape, use_kernels=False))
        errs["contract"] = max(errs["contract"], e)
        check(e == 0.0, f"contract equal in the resize of {what}")
    timing_inputs["resize"] = (u, (24, 32))


def parent_kalman_predict(x, P, params):
    """The parent commit's kalman_predict (cuBLAS products), for phase 6."""
    return x @ params.F.T, params.F @ P @ params.F.T + params.Q


def parent_kalman_update(x, P, z, gate_mask, params):
    """The parent commit's kalman_update (cuBLAS products, cuSOLVER's
    batched inverse), for phase 6."""
    H, R = params.H, params.R
    y = z - x @ H.T
    S = H @ P @ H.T + R
    K = P @ H.T @ torch.linalg.inv_ex(S).inverse
    x_new = x + (K @ y[:, :, None])[:, :, 0]
    P_new = (torch.eye(8, dtype=torch.float32, device=x.device) - K @ H) @ P
    return torch.where(gate_mask[:, None], x_new, x), torch.where(gate_mask[:, None, None], P_new, P)


def time_kalman_resize(timing_inputs, results, masks, tracker, dev, tag) -> None:
    """Phase 6 for kalman_predict and kalman_update (each against its plain
    version in turns, beside the parent's Kalman: cuBLAS products and
    cuSOLVER's batched inverse, the library calls for the same function)
    and the resize through the contraction kernel (beside
    torch.nn.functional.interpolate's antialiased bilinear), then the
    tracker's steps on the main path's masks with the Kalman kernels and
    with the parent's Kalman, in turns: ms a frame and device operations a
    frame."""
    from tracking_tpu_torch.ops.resize import resize_bilinear
    from tracking_tpu_torch.track import kalman

    x, P, z, g, kp = timing_inputs["kalman_update"]
    time_pair("kalman_update", lambda: kalman.kalman_update(x, P, z, g, kp),
              lambda: kalman.kalman_update_ref(x, P, z, g, kp), 200, 5, results, tag)
    time_pair("kalman_predict", lambda: kalman.kalman_predict(x, P, kp),
              lambda: kalman.kalman_predict_ref(x, P, kp), 200, 5, results, tag)
    for k, lib_fn in (("kalman_update", lambda: parent_kalman_update(x, P, z, g, kp)),
                      ("kalman_predict", lambda: parent_kalman_predict(x, P, kp))):
        lib = [cuda_ms(lib_fn, 200) for _ in range(2)]
        results[k]["library_ms"] = min(lib)
        print(f"  {tag} {k}'s library calls (the parent's Kalman: torch.matmul, torch.linalg.inv_ex): "
              f"{lib[0]:.4f} / {lib[1]:.4f} ms", flush=True)
    u, shape = timing_inputs["resize"]
    own = [cuda_ms(lambda: resize_bilinear(u, shape), 200) for _ in range(2)]
    plain = [cuda_ms(lambda: resize_bilinear(u, shape, use_kernels=False), 3) for _ in range(2)]
    lib = [cuda_ms(lambda: torch.nn.functional.interpolate(u[None, None], size=shape, mode="bilinear",
                                                           antialias=True), 200) for _ in range(2)]
    r = results["contract"]
    r["resize_ms"], r["resize_plain_ms"], r["resize_library_ms"] = min(own), min(plain), min(lib)
    r["resize_bound_ms"] = resize_cost(H, W, shape)[0]
    print(f"  {tag} the resize 720p -> 24x32 through contract (two launches a contraction): kernel {own[0]:.4f} / "
          f"{own[1]:.4f} ms, plain {plain[0]:.4f} / {plain[1]:.4f} ms, bound {r['resize_bound_ms']:.4f} ms (bytes); "
          f"library call (F.interpolate, bilinear, antialias) {lib[0]:.4f} / {lib[1]:.4f} ms", flush=True)

    own = (kalman.kalman_predict, kalman.kalman_update)

    def use(pair):
        kalman.kalman_predict, kalman.kalman_update = pair

    def run(n: int):
        box = {"tr": tracker.init(device=dev), "i": 0}

        def one():
            box["tr"], _ = tracker.step(box["tr"], masks[box["i"] % len(masks)])
            box["i"] += 1

        for _ in range(8):
            one()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n, one

    ms, ops = {}, {}
    try:
        for label, pair in (("kernels", own), ("parent", (parent_kalman_predict, parent_kalman_update)),
                            ("parent", (parent_kalman_predict, parent_kalman_update)), ("kernels", own)):
            use(pair)
            t, one = run(TRACKER_TIMED)
            ms.setdefault(label, []).append(t)
            if label not in ops:
                ops[label] = device_ops(one, f"a tracker step, {label} Kalman", tag, reps=8)[0]
    finally:
        use(own)
    print(f"  {tag} the tracker's step on the main path's masks ({TRACKER_TIMED} frames, in turns): Kalman kernels "
          f"{ms['kernels'][0]:.3f} / {ms['kernels'][1]:.3f} ms/frame, {ops['kernels']:.1f} device operations a frame; "
          f"the parent's Kalman {ms['parent'][0]:.3f} / {ms['parent'][1]:.3f} ms/frame, {ops['parent']:.1f} device "
          f"operations a frame", flush=True)


def eigh_cases(n: int, count: int, seed: int) -> np.ndarray:
    """tests/test_torch_eigh.py's seeded symmetric matrices: Gram matrices of
    centred u8 histories (rank-deficient where a history is short), the same
    scaled by 1e-6, 1e6 and 1e-30, zero, and repeated eigenvalues."""
    gen = np.random.default_rng(seed)
    out = []
    for t in range(count):
        kind = t % 6
        if kind == 4:
            g = np.zeros((n, n), np.float32)
        elif kind == 5:
            q = np.linalg.qr(gen.standard_normal((n, n)))[0]
            g = ((q * gen.integers(0, 3, n)) @ q.T).astype(np.float32)
        else:
            x = gen.integers(0, 256, (n, int(gen.integers(2, 4 * n)))).astype(np.float32)
            xc = x - x.mean(1, keepdims=True).astype(np.float32)
            g = (xc @ xc.T).astype(np.float32) * np.float32((1.0, 1e-6, 1e6, 1e-30)[kind])
        out.append(((g + g.T) * np.float32(0.5)).astype(np.float32))
    return np.stack(out)


# The CPU side of phase 3's eigensolver check and of phase 4i's crop runs
# in a pool of spawned processes while the card works through phases 3-4h
# (one task a size of the eigensolver's sets): the same comparisons, their
# CPU time out of the command's wall time.
BLOCKED_NS = (33, 34, 40, 50, 51, 64)  # blocked ssytrd from 33, slaed0's two levels from 51, sormqr's blocks at 64
EIGH_SETS = ((4, 1500, 4), (8, 1500, 8), (20, 1200, 20), (25, 800, 25)) + tuple(
    (n, 500, 300 + n) for n in range(26, 33)) + tuple(
    (n, 120, 500 + n) for n in BLOCKED_NS)  # (n, count, seed): the tests' 5,000, 3,500 and 720
CPU_WORKERS, CPU_WORKER_THREADS = 4, 1  # four cores left to the card's process


def cpu_worker_init(root: str) -> None:
    sys.path.insert(0, root)
    torch.set_num_threads(CPU_WORKER_THREADS)


def cpu_eigh_sets(sets):
    """The plain ssyevd on the CPU of eigh_cases(n, count, seed) for each set:
    numpy (eigenvalues, eigenvectors, info)."""
    from tracking_tpu_torch.ops import eigh

    out = []
    for n, count, seed in sets:
        w, V, info = eigh.syevd(torch.from_numpy(eigh_cases(n, count, seed)))
        out.append((w.numpy(), V.numpy(), info.numpy()))
    return out


def cpu_eigh_mats(m: np.ndarray):
    """The plain ssyevd on the CPU of the matrices m [B, n, n]: numpy
    (eigenvalues, eigenvectors, info)."""
    from tracking_tpu_torch.ops import eigh

    w, V, info = eigh.syevd(torch.from_numpy(m))
    return w.numpy(), V.numpy(), info.numpy()


def to_numpy_tree(t):
    if isinstance(t, dict):
        return {k: to_numpy_tree(v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return tuple(to_numpy_tree(v) for v in t)
    return t.numpy()


def from_numpy_tree(t):
    if isinstance(t, dict):
        return {k: from_numpy_tree(v) for k, v in t.items()}
    if isinstance(t, tuple):
        return tuple(from_numpy_tree(v) for v in t)
    return torch.from_numpy(t)


def cpu_crop_runs(cut: np.ndarray, runs):
    """run_video on the CPU over the first ``frames`` of ``cut`` for each
    (name, config, frames): numpy (masks, backgrounds, state)."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.runner.scan import run_video

    out = []
    for name, cfg, nf in runs:
        st, (m, b) = run_video(get_algorithm(name)(**cfg), torch.from_numpy(cut[:nf].copy()), with_background=True)
        out.append(to_numpy_tree((m, b, st)))
    return out


def gram_cost(s: int, d: int):
    """(bound_ms, bound_by) of Eigenbackground's Gram product: the centred
    history read once, the [S, S] matrix written; S (S + 1) D operations
    (the upper triangle's FMAs, the lower one its mirror)."""
    return bound(4 * (s * d + s * s), s * (s + 1) * d)


def lift_cost(s: int, d: int):
    """(bound_ms, bound_by) of Eigenbackground's lift evecs^T Xc: the [S, S]
    matrix and Xc read once, the [S, D] output written; 2 S^2 D operations."""
    return bound(4 * (s * s + 2 * s * d), 2 * s * s * d)


# the Gram product's and the lift's plan forms on small random data (S, D),
# one case a form: one chain, 1, 2 and 4 lanes, tails of rounded products,
# D mod 4 != 0 (4-byte copies), blocks' sums past the combine's batches of
# 32, the lift's panels with a narrow last panel of rounded products (S =
# 4, 41) and one with FMAs (20), its 4 lanes on frames of <= 16 values and
# its 51-64-row orders, histories above 64 (CTA groups)
GRAM_FORMS = ((3, 4099), (8, 4096 * 34 + 5), (17, 90), (25, 2051), (33, 5), (41, 2050), (50, 512 * 37 + 3),
              (130, 1000))
LIFT_FORMS = ((3, 100), (4, 16390), (17, 2051), (20, 2061), (41, 1027), (9, 16), (51, 17), (53, 1100), (60, 63),
              (64, 1027), (130, 1000))


def pca_cost(e: int, d: int):
    """(bound_ms, bound_by) of pca_project: the basis, the centred frame and
    the mean read once, the reconstruction written; two products of 2 E D
    operations."""
    return bound(4 * (e * d + 3 * d), 4 * e * d)


def syevd_cost(n: int):
    """(bound_ms, bound_by) of syevd_small on one matrix: the matrix read, the
    eigenvalues and vectors written; ssytd2's 4/3 n^3 and sorm2r's 2 n^3
    operations (the QL / QR sweeps and, above n = 25, the merge's secular
    roots and products, which depend on the data, not counted)."""
    return bound(4 * (2 * n * n + n), (4 * n ** 3) // 3 + 2 * n ** 3)


def check_pca_kernels(frames, dev, errs, timing_inputs, bounds, cpu_eigh) -> None:
    """Phase 3 for Eigenbackground's kernels, exactly against their plain
    versions (the contractions on the card, the projection and the
    eigensolver on the CPU, the tests' batches in the CPU workers,
    ``cpu_eigh``; phase 4i holds the card against the CPU): the
    contraction's Gram product (``gram``) and lift (``lift``) of 20 and 64
    frames of the clip at 720p and of 20 frames of its 360x640 crop, the
    Gram product of 28 and 32 frames of the crop (MKL-DNN's 2-lane kernel,
    blocks of 1,024), and of 20 and 28 frames of the crop less its last
    value (D = 691,199: a tail of 3 and of 1 rounded products); the lift at
    20 and 28 frames (panels of 2,048, chains of 16) at both D; the Gram
    product and the lift of 52 and 64 frames of the crop (one chain a value
    in blocks of 512); both on every plan form at small random sizes
    (GRAM_FORMS, LIFT_FORMS, with rows 16-byte aligned and not); the
    projection on the crop (a basis of 10);
    syevd_small on the eigensolver tests' 5,000 matrices of n <= 25, 3,500
    of n = 26-32 (sstedc's divide and conquer) and 720 of n = 33-64 (blocked
    ssytrd, slaed0's two levels, sormqr's blocks at 64), and on the Gram
    matrices. The eigensolver's agreement with this machine's LAPACK
    (scipy's ssyevd) is printed, as information."""
    from tracking_tpu_torch.ops import eigh, pca
    from tracking_tpu_torch.ops.contract import contract_ref, gram, gram_plan, lift, lift_plan

    def centred(hist):
        X = hist.reshape(hist.shape[0], -1).to(torch.float32)
        return X - X.sum(0) * np.float32(1.0 / X.shape[0])

    def held(name, what, got, plain):
        e = nan_err(got, plain)
        errs[name] = max(errs[name], e)
        check(e == 0.0, f"{name}: {what} equals the plain version")

    t0 = time.perf_counter()
    S, E = EIGEN_S, EIGEN_E
    crop = frames[1:, : NEW_CUT[0], : NEW_CUT[1]]
    grams, lifts = {}, {}
    for s, what, hist, cut in ((S, "720p", frames[1 : 1 + S], 0), (64, "720p", frames[:64], 0),
                               (S, "the 360x640 crop", crop[:S], 0),
                               (28, "the crop", crop[:28], 0), (32, "the crop", crop[:32], 0),
                               (52, "the crop", crop[:52], 0), (64, "the crop", crop[:64], 0),
                               (S, "the crop less its last value", crop[:S], 1),
                               (28, "the crop less its last value", crop[:28], 1)):
        Xc = centred(hist)
        Xc = Xc[:, : Xc.shape[1] - cut].contiguous()
        D = Xc.shape[1]
        plan = gram_plan(s, D)
        G = gram(Xc, plan)
        held("contract", f"the Gram product of {s} frames at {what} (D = {D}, {plan.lanes} lanes, "
                         f"{len(plan.blocks)} blocks)", G, gram(Xc, plan, use_kernels=False))
        G = (G + G.T) * 0.5
        if s == S or what != "720p":  # the 64-frame 720p matrix's eigensolver check is phase 6's
            grams[(s, what)] = G
        if s != 32:
            w, V, info = eigh.syevd(G[None])
            L = V[0][:, torch.argsort(-w[0], stable=True)].T.contiguous()
            lp = lift_plan(s, D)
            comps = lift(L, Xc, lp)
            held("contract", f"the lift [{s}, {s}] x [{s}, {D}] at {what} (chains a column: {len(lp.blocks)}"
                             f"{', in the last panel ' + str(len(lp.alt)) if lp.alt else ''})",
                 comps, lift(L, Xc, lp, use_kernels=False))
            if what != "720p":
                lifts[(s, what)] = (comps, Xc, hist)
        del Xc
    gen = torch.Generator().manual_seed(26)
    for label, forms in (("Gram product", GRAM_FORMS), ("lift", LIFT_FORMS)):
        e = 0.0
        for s, d in forms:
            for off in (0, 1):  # rows 16-byte aligned (d mod 4 = 0) or not: the 4-byte copies
                X = torch.randn((s, d + off), generator=gen).to(dev)[:, off:]
                if label == "lift":
                    L = torch.randn((s, s), generator=gen).to(dev)
                    p = lift_plan(s, d)
                    got, plain = lift(L, X, p), contract_ref(L, X, p)
                else:
                    p = gram_plan(s, d)
                    got, plain = gram(X, p), contract_ref(X, X.T, p)
                e = max(e, nan_err(got, plain))
        errs["contract"] = max(errs["contract"], e)
        check(e == 0.0, f"contract: the {label} equals the plain version on {2 * len(forms)} plan forms at small "
                        f"random sizes")
    comps, Xc, hist = lifts[(S, "the 360x640 crop")]
    D = Xc.shape[1]
    basis = (comps / torch.clamp(pca.row_norms(comps)[:, None], min=1e-12))[:E].contiguous()
    mean = hist.reshape(S, -1).to(torch.float32).sum(0) * np.float32(1.0 / S)
    flat = frames[1 + S, : NEW_CUT[0], : NEW_CUT[1]].reshape(-1).to(torch.float32)
    xc = flat - mean
    e = nan_err(pca.project(basis, xc, mean), pca.project(basis.cpu(), xc.cpu(), mean.cpu()).to(dev))
    errs["pca_project"] = max(errs["pca_project"], e)
    small = torch.randn((4, 24 * 37), generator=torch.Generator().manual_seed(23))
    e2 = nan_err(pca.project(small.to(dev), small[0].to(dev), small[1].to(dev)), pca.project(small, small[0], small[1]))
    errs["pca_project"] = max(errs["pca_project"], e2)
    check(e == 0.0 and e2 == 0.0, f"pca_project equals the plain version on the crop (E = {E}, D = {D}) and at "
                                  f"E = 4, D = 888 (a partial tile of rows, columns with a remainder mod 8)")
    print(f"  Eigenbackground's contractions and projection: {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    sets = [eigh_cases(n, c, seed) for n, c, seed in EIGH_SETS]
    sets += [np.stack([g.cpu().numpy()]) for k, g in grams.items() if k[0] != S or k[1] in ("720p", "the 360x640 crop")]
    plain = [tuple(map(torch.from_numpy, r)) for task in cpu_eigh for r in task.get()]  # the workers', on the CPU
    n_bad = n_same = n_all = 0
    for i, m in enumerate(sets):
        Gm = torch.from_numpy(m)
        wk, Vk, ik = eigh.syevd(Gm.to(dev))
        wp, Vp, ip = plain[i] if i < len(plain) else eigh.syevd(Gm)  # the plain version on the CPU
        errs["syevd_small"] = max(errs["syevd_small"], nan_err(wk, wp), nan_err(Vk, Vp))
        n_bad += int(sum(not (same_bits(wk[b], wp[b]) and same_bits(Vk[b], Vp[b]) and int(ik[b]) == int(ip[b]))
                         for b in range(len(m))))
        n_all += len(m)
        try:
            from scipy.linalg import lapack

            wk_, Vk_ = wk.cpu().numpy(), Vk.cpu().numpy()
            for b in range(len(m)):
                wr, vr, _ = lapack.ssyevd(m[b], compute_v=1, lower=1)
                n_same += bool(np.array_equal(wr, wk_[b]) and np.array_equal(vr, Vk_[b]))
        except ImportError:
            n_same = -1
    check(n_bad == 0, f"syevd_small equals the plain version on all {n_all} matrices (the eigensolver tests' 5,000 "
                      f"of n <= 25, 3,500 of n = 26-32 and 720 of n = 33-64, and the Gram matrices of 20, 28, 32, "
                      f"52 and 64 frames)")
    print(f"  information: the card's ssyevd equals this machine's LAPACK (scipy) on {n_same} of {n_all} matrices "
          f"(-1: scipy does not import here); {time.perf_counter() - t1:.1f} s", flush=True)
    comps, Xc, _ = lifts[(S, "the 360x640 crop")]
    timing_inputs["contract"] = Xc
    timing_inputs["syevd_small"] = grams[(32, "the crop")][None].contiguous()
    timing_inputs["syevd_by_n"] = {n: grams[k][None].contiguous() for n, k in (
        (20, (S, "the 360x640 crop")), (32, (32, "the crop")), (64, (64, "the crop")))}
    timing_inputs["pca_project"] = (basis, xc, mean)
    bounds["contract"] = gram_cost(S, Xc.shape[1])
    bounds["syevd_small"] = syevd_cost(32)
    bounds["pca_project"] = pca_cost(E, Xc.shape[1])


def eigen_720p_path(frames, dev, errs, results, tag, cpu_pool) -> None:
    """Phase 6: DPEigenbackgroundBGS at 720x1280x3 with a 64-frame history
    through the kernels (contract, syevd_small, pca_project): the history
    of the clip's frames 0-63, the step at t = 64 that builds the PCA and
    projects its frame (CUDA events), then EIGEN720_AFTER frames (ms/frame);
    the launches counted; the eigensolver's output on the step's own 64 x 64
    Gram matrix held against the plain syevd in a CPU worker; the PCA
    step split by CUDA events around its calls of gram, syevd, lift,
    row_norms and project (the rest: the mean, the centring, the
    symmetrising, the sort, the normalising and the host's reads), on the
    step itself and again on a copy of its state; pca_project on the path's
    720p basis in turns with the torch.matmul pair."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.bgs import eigenbackground as eb
    from tracking_tpu_torch.ops import _native, eigh, pca

    S = EIGEN720_CFG["historySize"]
    algo = get_algorithm("DPEigenbackgroundBGS")(**EIGEN720_CFG)
    st = algo.init(H, W, C, device=dev)
    t0 = time.perf_counter()
    for t in range(S):
        st, _, _ = algo.step(st, frames[t])
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    seen, orig, spans = [], eigh.syevd, []
    timed = {"gram": (eb, eb.gram), "syevd_small": (eigh, orig), "lift": (eb, eb.lift),
             "row_norms": (eb, eb.row_norms), "pca_project": (eb, eb.project)}

    def spy(G, *a, **k):
        out = orig(G, *a, **k)
        seen.append((G.clone(), tuple(o.clone() for o in out)))
        return out

    def timer(name, fn):
        def run(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            spans.append((name, e0, e1))
            return out
        return run

    def pca_step(state, what):
        spans.clear()
        for name, (mod, fn) in timed.items():
            setattr(mod, "syevd" if name == "syevd_small" else "project" if name == "pca_project" else name,
                    timer(name, spy if name == "syevd_small" and not seen else fn))
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        try:
            e0.record()
            out = algo.step(state, frames[S])
            e1.record()
            torch.cuda.synchronize()
        finally:
            for name, (mod, fn) in timed.items():
                setattr(mod, "syevd" if name == "syevd_small" else "project" if name == "pca_project" else name, fn)
        total = e0.elapsed_time(e1)
        parts = {name: a.elapsed_time(b) for name, a, b in spans}
        print(f"  {tag} Eigenbackground's PCA step at {H}x{W}x{C}, {S} frames, {what} (CUDA events): "
              + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
              + f", the rest {total - sum(parts.values()):.3f}, of {total:.3f} ms", flush=True)
        return out, total, parts

    before = clone(st)
    _native.reset_launches()
    (st, fg, bg), build_ms, split = pca_step(st, "the step")
    at_pca = dict(_native.LAUNCHES)
    _, again_ms, split2 = pca_step(before, "again on a copy of its state")
    del before
    _native.reset_launches()
    masks = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for t in range(EIGEN720_AFTER):
        st, m, bg = algo.step(st, frames[1 + t])
        masks.append(m)
    end.record()
    torch.cuda.synchronize()
    after_ms = start.elapsed_time(end) / EIGEN720_AFTER
    after = dict(_native.LAUNCHES)
    masks = torch.stack(masks)
    check(at_pca["contract"] == 2 and at_pca["syevd_small"] == 1 and at_pca["pca_project"] == 1
          and sum(at_pca.values()) == 4 and after["pca_project"] == EIGEN720_AFTER
          and sum(after.values()) == EIGEN720_AFTER,
          f"Eigenbackground {EIGEN720_CFG} at {H}x{W}x{C}: the step at t = {S} launched contract "
          f"{at_pca['contract']} times, syevd_small {at_pca['syevd_small']}, pca_project {at_pca['pca_project']}; "
          f"the {EIGEN720_AFTER} frames after it pca_project {after['pca_project']} times, nothing else")
    basis = st["basis"]
    check(masks.dtype == torch.uint8 and set(masks.unique().tolist()) <= {0, 255}
          and bool(torch.isfinite(basis).all()) and float(basis.abs().max()) > 0.0,
          f"Eigenbackground at 720p: u8 masks in [0, 255] (foreground share "
          f"{float(masks.gt(0).to(torch.float32).mean()):.4f}), a finite basis {tuple(basis.shape)}")
    G, (wk, Vk, ik) = seen[0]
    wp, Vp, ip = map(torch.from_numpy, cpu_pool.apply_async(cpu_eigh_mats, (G.cpu().numpy(),)).get())
    e = max(nan_err(wk, wp), nan_err(Vk, Vp))
    errs["syevd_small"] = max(errs["syevd_small"], e)
    check(same_bits(wk, wp) and same_bits(Vk, Vp) and int(ik[0]) == int(ip[0]),
          f"syevd_small on the 720p path's {S} x {S} Gram matrix equals the plain syevd in a CPU worker")
    results["syevd_small"]["eigen720_launches"] = at_pca["syevd_small"]
    results["syevd_small"]["eigen720_pca_step_ms"] = build_ms
    results["contract"]["eigen720_pca_step_ms"] = [build_ms, again_ms]
    results["contract"]["eigen720_pca_split_ms"] = {k: min(split[k], split2[k]) for k in split}
    results["syevd_small"]["eigen720_ms_per_frame"] = after_ms
    print(f"  {tag} Eigenbackground at {H}x{W}x{C} with a {S}-frame history: the history in {fill_s:.1f} s, the "
          f"step that builds the PCA {build_ms:.3f} ms (CUDA events: 2 contract, syevd_small, pca_project), then "
          f"{after_ms:.3f} ms/frame over {EIGEN720_AFTER} frames", flush=True)
    # pca_project at 720p on the path's basis, in turns with the library pair
    mean = st["mean"]
    xc = frames[1 + EIGEN720_AFTER].reshape(-1).to(torch.float32) - mean
    k1, l1 = cuda_ms(lambda: pca.project(basis, xc, mean), 10), cuda_ms(
        lambda: mean + torch.matmul(basis.T, torch.matmul(basis, xc)), 10)
    l2, k2 = cuda_ms(lambda: mean + torch.matmul(basis.T, torch.matmul(basis, xc)), 10), cuda_ms(
        lambda: pca.project(basis, xc, mean), 10)
    r = results["pca_project"]
    r["ms_720p"], r["library_ms_720p"] = min(k1, k2), min(l1, l2)
    r["bound_ms_720p"], r["bound_by_720p"] = pca_cost(basis.shape[0], basis.shape[1])
    print(f"  {tag} pca_project at {H}x{W}x{C} (E = {basis.shape[0]}, the 720p path's basis, in turns with the "
          f"torch.matmul pair): kernel {k1:.4f} / {k2:.4f} ms, library {l1:.4f} / {l2:.4f} ms, bound "
          f"{r['bound_ms_720p']:.4f} ms ({r['bound_by_720p']})", flush=True)


def time_pca_kernels(timing_inputs, results, frames, tag) -> None:
    """Phase 6 for contract (the Gram product of 20 frames of the 360x640
    crop against its plain version; then the Gram product and the lift of
    20 frames of the crop, 20 frames at 720p and 64 frames at 720p, each in
    turns with torch.matmul on the same inputs), syevd_small (the Gram
    matrix of 32 frames of the crop: sstedc's divide and conquer) and
    pca_project (a basis of 10 on the crop; its plain version, a launch a
    chain step, on the crop's first PCA_PLAIN_D values): each against its
    plain version on the card in turns and beside the library call that
    computes the same function (torch.matmul; torch.linalg.eigh;
    torch.matmul for both products)."""
    from tracking_tpu_torch.ops import eigh, pca
    from tracking_tpu_torch.ops.contract import gram, gram_plan, lift, lift_plan

    Xc = timing_inputs["contract"]
    S, D = Xc.shape
    plan = gram_plan(S, D)
    time_pair("contract", lambda: gram(Xc, plan), lambda: gram(Xc, plan, use_kernels=False),
              20, 1, results, tag, label=f"contract, the Gram product [{S}, {D}]")
    G = timing_inputs["syevd_small"]
    time_pair("syevd_small", lambda: eigh.syevd(G), lambda: eigh.syevd(G, use_kernels=False), 20, 1, results, tag,
              label=f"syevd_small, n = {G.shape[1]} (a 32-frame history's Gram matrix)",
              plain_warmup=0, plain_turns=1)  # the plain version ~2.5-6 s a call on the card
    basis, xc, mean = timing_inputs["pca_project"]
    cut = (basis[:, :PCA_PLAIN_D].contiguous(), xc[:PCA_PLAIN_D].contiguous(), mean[:PCA_PLAIN_D].contiguous())
    time_pair("pca_project", lambda: pca.project(basis, xc, mean),
              lambda: pca.project(*cut, use_kernels=False), 10, 1, results, tag,
              label=f"pca_project (E = {basis.shape[0]}, D = {basis.shape[1]}; the plain version at D = "
                    f"{PCA_PLAIN_D}, a launch a chain step)", plain_warmup=0, plain_turns=1)
    results["pca_project"]["plain_ms_shape"] = [basis.shape[0], PCA_PLAIN_D]  # plain_ms's E, D
    for k, fn in (("contract", lambda: torch.matmul(Xc, Xc.T)), ("syevd_small", lambda: torch.linalg.eigh(G[0])),
                  ("pca_project", lambda: mean + torch.matmul(basis.T, torch.matmul(basis, xc)))):
        lib = [cuda_ms(fn, 20) for _ in range(2)]
        results[k]["library_ms"] = min(lib)
        print(f"  {tag} {k}'s library call: {lib[0]:.4f} / {lib[1]:.4f} ms", flush=True)
    for n, Gn in timing_inputs["syevd_by_n"].items():  # in turns with torch.linalg.eigh on the same matrix
        k1, l1 = cuda_ms(lambda: eigh.syevd(Gn), 20), cuda_ms(lambda: torch.linalg.eigh(Gn[0]), 20)
        k2, l2 = cuda_ms(lambda: eigh.syevd(Gn), 20), cuda_ms(lambda: torch.linalg.eigh(Gn[0]), 20)
        results["syevd_small"][f"ms_n{n}"] = min(k1, k2)
        results["syevd_small"][f"library_ms_n{n}"] = min(l1, l2)
        print(f"  {tag} syevd_small at n = {n} (one block of {SYEVD_THREADS} threads): {k1:.4f} / {k2:.4f} ms, "
              f"torch.linalg.eigh {l1:.4f} / {l2:.4f} ms, in turns", flush=True)
    gen = torch.Generator().manual_seed(26)
    r = results["contract"]
    for hist in (frames[1:21, : NEW_CUT[0], : NEW_CUT[1]], frames[1:21], frames[:64]):
        X = hist.reshape(hist.shape[0], -1).to(torch.float32)
        s, d = X.shape
        Xs = (X - X.sum(0) * np.float32(1.0 / s)).contiguous()
        del X
        L = torch.linalg.qr(torch.randn((s, s), generator=gen, dtype=torch.float64))[0].float()
        L = L.contiguous().to(Xs.device)
        gp, lp = gram_plan(s, d), lift_plan(s, d)
        for what, fk, fl, cost in (("gram", lambda: gram(Xs, gp), lambda: torch.matmul(Xs, Xs.T), gram_cost),
                                   ("lift", lambda: lift(L, Xs, lp), lambda: torch.matmul(L, Xs), lift_cost)):
            k1, l1 = cuda_ms(fk, 20), cuda_ms(fl, 20)
            l2, k2 = cuda_ms(fl, 20), cuda_ms(fk, 20)
            b_ms, b_by = cost(s, d)
            key = f"{s}x{d}"
            r[f"{what}_ms_{key}"], r[f"{what}_library_ms_{key}"] = min(k1, k2), min(l1, l2)
            r[f"{what}_bound_ms_{key}"], r[f"{what}_bound_by_{key}"] = b_ms, b_by
            print(f"  {tag} contract, the {'Gram product' if what == 'gram' else 'lift'} [{s}, {d}] (in turns with "
                  f"torch.matmul): kernel {k1:.4f} / {k2:.4f} ms, torch.matmul {l1:.4f} / {l2:.4f} ms, bound "
                  f"{b_ms:.4f} ms ({b_by}) = {b_ms / min(k1, k2):.1%} of it reached", flush=True)
        del Xs
    torch.cuda.empty_cache()


def check_registry_kernels(frames, dev, errs, timing_inputs, bounds) -> None:
    """Phase 3 for the registry path's four kernels, each against its plain
    version on inputs its algorithm made at 720p, exactly."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.bgs.gmg import _quantize
    from tracking_tpu_torch.ops.consensus import (
        consensus_lobster, consensus_lobster_ref, intra_descriptors, sample_good_lobster_ref, thr_lobster,
    )
    from tracking_tpu_torch.ops.gmg import gmg_step, gmg_step_ref
    from tracking_tpu_torch.ops.texture import NUM_BINS, texture_prox_cur, texture_prox_cur_ref

    hw = H * W

    def compare(name, what, a, b):
        e = max_err(a, b)
        errs[name] = max(errs[name], e)
        check(e == 0.0, f"{name} {what} equal (max |err| {e})")

    # K5: LOBSTER's consensus, banks after warm start + 3 steps
    lob = get_algorithm("LOBSTERBGS")()
    for c in (3, 1):
        fr = frames if c == 3 else frames[..., 0].contiguous()
        st = lob.warm_start(lob.init(H, W, c, device=dev), fr[0])
        for t in range(1, 4):
            st, _, _ = lob.step(st, fr[t])
        planes = tuple(fr[4][..., i].contiguous() for i in range(c)) if c == 3 else (fr[4],)
        kw = lob._kernel_kw(c)

        def lob_args(s):
            return (planes, s["colors"], s["descs"], s["pend_ctrl"], s["pend_vals"])

        k_out = consensus_lobster(*lob_args(clone(st)), **kw)
        p_out = consensus_lobster_ref(*lob_args(clone(st)), **kw)
        for name, a, b in zip(("count", "intra", "bg_sum", "colors", "descs"), k_out, p_out):
            compare("consensus_lobster", f"C={c} {name}", a, b)
        n_short = int((p_out[0] < kw["req"]).sum())
        check(0 < n_short < hw, f"consensus_lobster C={c}: {n_short} px short of the required samples")
        check_lobster_adversarial(lob_args(st), kw, dev, errs)
        if c == 3:
            timing_inputs["consensus_lobster"] = (lob_args(clone(st)), kw)
            thr = lambda v: thr_lobster(v, kw["rel"], kw["offset"], kw["div"])  # noqa: E731
            _, nbs = intra_descriptors(planes, thr)
            good = sample_good_lobster_ref(planes, p_out[3], p_out[4], nbs, thr, *(kw[k] for k in ("c_sc", "d_sc", "c_tot", "d_tot")))
            bounds["consensus_lobster"] = consensus_cost(
                planes, (st["colors"], st["descs"]), (p_out[3], p_out[4]), good, kw["req"], 4 * (1 + c), 1 + 2 * c
            )

    # K6: GMG's list update, real lists after 24 steps, at t = 5, 19 and 30
    gmg = get_algorithm("GMG")()
    cfg = gmg.config
    st = gmg.init(H, W, C, device=dev)
    for t in range(1, 25):
        st, _, _ = gmg.step(st, frames[t])
    code = _quantize(frames[25], cfg.quantizationLevels)
    kw = dict(lr=cfg.learningRate, prior=cfg.backgroundPrior, thr=cfg.decisionThreshold,
              init_frames=cfg.initializationFrames)
    for tt in (5, 19, 30):
        tv = torch.tensor(tt, dtype=torch.int32, device=dev)

        def gmg_args(s):
            return (code, s["nf"], s["colors"].view(torch.int32), s["weights"], tv)

        k_out = gmg_step(*gmg_args(clone(st)), **kw)
        p_out = gmg_step_ref(*gmg_args(clone(st)), **kw)
        for name, a, b in zip(("fg", "nf", "colors", "weights"), k_out, p_out):
            compare("gmg_step", f"t={tt} {name}", a, b)
    check(int(st["nf"].max()) > 1 and int((p_out[0] > 0).sum()) > 0, f"gmg_step lists up to {int(st['nf'].max())} long, fg at t=30")
    timing_inputs["gmg_step"] = (gmg_args(clone(st)), kw)
    bounds["gmg_step"] = gmg_cost(code, st["nf"], st["colors"].view(torch.int32), st["weights"], p_out[2], p_out[3])
    check_gmg_adversarial(dev, errs, kw, cfg.initializationFrames)

    # K7: DPTexture's histograms, the model after warm start + 3 steps
    tex = get_algorithm("DPTextureBGS")()
    st = tex.warm_start(tex.init(H, W, C, device=dev), frames[0])
    for t in range(1, 4):
        st, _, _ = tex.step(st, frames[t])
    codes = tex._codes(frames[4])
    k_out = texture_prox_cur(codes, st["model"])
    p_out = texture_prox_cur_ref(codes, st["model"])
    for name, a, b in zip(("prox", "cur"), k_out, p_out):
        compare("texture_prox_cur", name, a, b)
    timing_inputs["texture_prox_cur"] = ((codes, st["model"]), {})
    bounds["texture_prox_cur"] = bound(3 * hw + 2 * 3 * NUM_BINS * hw + 4 * hw, 3 * hw * (121 + 3 * NUM_BINS))
    check_texture_adversarial(dev, errs)

    # K8: MultiLayer's update, a state 8 frames in, learning and not
    ml = get_algorithm("MultiLayerBGS")()
    st = ml.warm_start(ml.init(H, W, C, device=dev), frames[0])
    for t in range(1, 9):
        st, _, _ = ml.step(st, frames[t])
    cf, pat = ml.features(frames[9])
    fidx = st["t"] + 1
    scal = ml.rates(fidx)
    learned = check_multilayer(ml.config, st, cf, pat, scal, fidx, errs, "a state 8 frames in")
    check(int(learned["n"].max()) > 1, f"multilayer lists up to {int(learned['n'].max())} modes")
    timing_inputs["multilayer_step"] = ((ml.config, clone(st), cf, pat, scal, fidx, True), {})
    bounds["multilayer_step"] = multilayer_cost(ml.config, st, cf, pat, scal, learned)
    # random 720p states on which every branch fires
    from tracking_tpu_torch.synth import multilayer_adversarial

    adv, cf_a, pat_a = multilayer_adversarial(H, W, seed=11)
    adv = {k: torch.from_numpy(v).to(dev) for k, v in adv.items()}
    cf_a, pat_a = torch.from_numpy(cf_a).to(dev), torch.from_numpy(pat_a).to(dev)
    check_multilayer(ml.config, adv, cf_a, pat_a, scal, fidx, errs, "random states", every_branch=True)


def check_multilayer(cfg, st, cf, pat, scal, fidx, errs, what, every_branch=False):
    """Phase 3: the MultiLayer update against its plain version on ``st``,
    learning and not, exactly (every leaf and the distance), with the pixels
    each branch took. Returns the plain version's learning outputs."""
    from tracking_tpu_torch.ops.multilayer import multilayer_step, multilayer_step_ref, update_branches

    for learn in (True, False):
        k_maps, k_dist = multilayer_step(cfg, clone(st), cf, pat, scal, fidx, learn)
        p_maps, p_dist = multilayer_step_ref(cfg, clone(st), cf, pat, scal, fidx, learn)
        diffs = {k: max_err(k_maps[k], p_maps[k]) for k in p_maps}
        diffs["dist"] = max_err(k_dist, p_dist)
        if any(diffs.values()):
            n_px = {k: int((k_maps[k] != p_maps[k]).reshape(-1, H * W).any(0).sum()) for k in p_maps}
            print(f"  multilayer_step learn={learn} differs: max |err| {diffs}; px differing {n_px}", flush=True)
        e = max(diffs.values())
        errs["multilayer_step"] = max(errs["multilayer_step"], e)
        counts = {k: int(v.sum()) for k, v in update_branches(cfg, st, cf, pat, scal, p_maps["n"], learn).items()}
        check(e == 0.0, f"multilayer_step on {what}, learn={learn}: every leaf and the distance equal (max |err| "
                        f"{e}); pixels a branch {counts}")
        if learn:
            learned = p_maps
            if every_branch:
                check(min(counts.values()) > 0, f"multilayer_step on {what}: every branch fired")
    return learned


def multilayer_cost(cfg, st, cf, pat, scal, out):
    """(bound_ms, bound_by) of a learning MultiLayer update of ``st`` into
    ``out`` (in place), counting what this run's data needs: read cf, the
    pattern, n and bg_num, every live mode's words (m < n), a tail mode's
    words on pixels with a removal (the shift moves them) and its layer word
    on pixels with a displacement (the renumbering reaches it); write the
    distance and the words of n, bg_num and the modes that change. The whole
    state read and written once is printed beside it."""
    from tracking_tpu_torch.ops.multilayer import LEAF_SPEC, update_branches

    n, M, hw = st["n"], cfg.max_mode_num, H * W
    words = sum(st[leaf][0].numel() // hw for leaf, _ in LEAF_SPEC)  # a mode's words
    br = update_branches(cfg, st, cf, pat, scal, out["n"], True)
    tail = M - n
    read = words * int(n.sum()) + words * int((tail * br["removal"]).sum()) + int((tail * br["displacement"]).sum())
    # the same in 32-byte sectors (8 adjacent pixels of a plane), the
    # device's unit of transfer: a sector moves if one of its words does
    slot = torch.arange(M, device=n.device)[:, None, None]
    need = (slot < n) | (br["removal"] & (slot >= n))
    sectors = lambda mask: int(mask.reshape(-1, 8).any(dim=1).sum())  # noqa: E731
    sec = (words - 1) * sectors(need) + sectors(need | (br["displacement"] & (slot >= n)))
    changed = 0
    for a, b in [(n, out["n"]), (st["bg_num"], out["bg_num"])] + [(st[leaf], out[leaf]) for leaf, _ in LEAF_SPEC]:
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        changed += int((a != b).sum())
        sec += sectors(a != b)
    planes = cf.shape[0] + pat.shape[0] + 3  # cf, pattern, n, bg_num, dist
    n_bytes = 4 * (planes * hw + read + changed)
    sec_bytes = 4 * planes * hw + 32 * sec
    whole = 2 * (words * M * 4 + 8) + 4 * (cf.shape[0] + pat.shape[0]) + 4  # per pixel
    print(f"  multilayer_step bound: mean n {int(n.sum()) / hw:.3f}, {read} mode words read, {changed} words "
          f"changed, {n_bytes / 1e6:.1f} MB = {bound(n_bytes, 450 * hw)[0]:.4f} ms; in 32-byte sectors "
          f"{sec_bytes / 1e6:.1f} MB = {bound(sec_bytes, 450 * hw)[0]:.4f} ms; the whole state read and written "
          f"{whole * hw / 1e6:.1f} MB = {bound(whole * hw, 450 * hw)[0]:.4f} ms", flush=True)
    return bound(n_bytes, 450 * hw)  # ~450 operations a pixel


def check_texture_adversarial(dev, errs) -> None:
    """Phase 3: DPTexture's histograms against their plain version, exactly,
    on inputs the clip never gives: a flat frame (every window one bin,
    counts 121) with the model all 121; a ragged width, with LBP codes and
    with codes 0-255 (>= 64 count nothing) and a model 0-255; images smaller
    than the 11x11 window (8x9, 1xW, Hx1)."""
    from tracking_tpu_torch.ops.texture import NUM_BINS, texture_prox_cur, texture_prox_cur_ref

    gen = torch.Generator(device=dev).manual_seed(9)

    def rand(shape, hi):
        return torch.randint(0, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(torch.uint8)

    u8 = dict(dtype=torch.uint8, device=dev)
    cases = (
        ("a flat frame with the model all 121", torch.full((C, H, W), 37, **u8),
         torch.full((C, NUM_BINS, H, W), 121, **u8)),
        (f"a ragged width {H}x{W - 3}", rand((C, H, W - 3), NUM_BINS), rand((C, NUM_BINS, H, W - 3), 122)),
        (f"a ragged width {H}x{W - 3}, codes and model 0-255", rand((C, H, W - 3), 256),
         rand((C, NUM_BINS, H, W - 3), 256)),
        ("8x9", rand((C, 8, 9), NUM_BINS), rand((C, NUM_BINS, 8, 9), 122)),
        (f"1x{W}", rand((C, 1, W), NUM_BINS), rand((C, NUM_BINS, 1, W), 122)),
        (f"{H}x1", rand((C, H, 1), NUM_BINS), rand((C, NUM_BINS, H, 1), 122)),
    )
    for what, codes, model in cases:
        k_out = texture_prox_cur(codes, model)
        p_out = texture_prox_cur_ref(codes, model)
        e = max(max_err(a, b) for a, b in zip(k_out, p_out))
        errs["texture_prox_cur"] = max(errs["texture_prox_cur"], e)
        check(e == 0.0, f"texture_prox_cur on {what}: prox and cur equal (max |err| {e}); counts up to "
                        f"{int(p_out[1].max())}, prox up to {int(p_out[0].max())}")


def check_gmg_adversarial(dev, errs, kw, init_frames: int) -> None:
    """Phase 3: the GMG list update against its plain version, exactly, on
    720p states that keep GMG's invariant (slots at or past nf hold (-1,
    +0.0)) but that real lists on the clip never reach: every list full with
    no match (eviction) and with the match in slot 63, lists of 63 that
    append into slot 63, all lists empty, and a random mix of lengths 0-64;
    each in training, at its last frame (the normalisation at its end) and
    after it."""
    from tracking_tpu_torch.ops.gmg import gmg_step, gmg_step_ref

    K = 64
    gen = torch.Generator(device=dev).manual_seed(8)
    kk = torch.arange(K, device=dev, dtype=torch.int32)[:, None, None]

    def state(nf, where):
        """Lists of length nf with distinct codes in 0..4095 and weights in
        [0.001, 1); the frame's code at slot `where` of each list (a map;
        -1: a code no list holds)."""
        codes = (kk * 7919 + torch.randint(0, 4096, (H, W), generator=gen, device=dev, dtype=torch.int32)) % 4096
        live = kk < nf[None]
        colors = torch.where(live, codes, -1)
        weights = torch.where(live, torch.rand((K, H, W), generator=gen, device=dev) * 0.999 + 0.001, 0.0)
        picked = codes.gather(0, where.clamp(min=0).long()[None])[0]
        code = torch.where(where >= 0, picked, 4096 + torch.randint(0, 100, (H, W), generator=gen, device=dev))
        return code.to(torch.int32), nf.to(torch.int32), colors.contiguous(), weights.contiguous()

    def full(v):
        return torch.full((H, W), v, dtype=torch.int32, device=dev)

    mix = torch.randint(0, K + 1, (H, W), generator=gen, device=dev, dtype=torch.int32)
    mix_where = torch.where(torch.rand((H, W), generator=gen, device=dev) < 0.6,
                            (torch.rand((H, W), generator=gen, device=dev) * mix).to(torch.int32), -1)
    mix_where = torch.where(mix > 0, mix_where, -1)
    cases = (
        ("every list full, no match (eviction)", full(K), full(-1)),
        ("every list full, the match in slot 63", full(K), full(K - 1)),
        ("lists of 63 appending into slot 63", full(K - 1), full(-1)),
        ("all lists empty", full(0), full(-1)),
        ("a random mix of lengths 0-64", mix, mix_where),
    )
    for what, nf, where in cases:
        args = state(nf, where)
        for tt in (5, init_frames - 1, 30):
            tv = torch.tensor(tt, dtype=torch.int32, device=dev)
            k_out = gmg_step(*clone(args), tv, **kw)
            p_out = gmg_step_ref(*clone(args), tv, **kw)
            e = max(max_err(a, b) for a, b in zip(k_out, p_out))
            errs["gmg_step"] = max(errs["gmg_step"], e)
            check(e == 0.0, f"gmg_step {what}, t={tt}: fg, nf1, colours and weights equal (max |err| {e})")


@contextlib.contextmanager
def switches(env):
    """The JAX package's switches (``SWITCHES``) set to ``env`` inside the
    block, and restored after it."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
        os.environ.pop(k, None)
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def capture_call(module, name, run):
    """(args, kwargs) of the first call of ``module.name`` while ``run()``
    runs, the tensors cloned before the call (kernels update them in place)."""
    orig = getattr(module, name)
    box = []

    def spy(*a, **k):
        if not box:
            box.append((clone(a), k))
        return orig(*a, **k)

    setattr(module, name, spy)
    try:
        run()
    finally:
        setattr(module, name, orig)
    return box[0]


def check_variant_kernels(frames, dev, errs, timing_inputs, bounds) -> None:
    """Phase 3 for the consensus variants' two kernels, each against its
    plain version on the inputs a 720p step of its path gives it, exactly:
    the v3 walk (C=3, C=1; also on ``adversarial_inputs`` and with its
    first 4 slots far and a requirement of 6, so that every walk is queued
    after phase B) and the fused step (C=3 and C=1 at t > 0 and t = 0 with
    the scalar requirement, C=3 also with a random map, and both on
    ``adversarial_inputs``)."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.bgs import lbsp_family as LF
    from tracking_tpu_torch.ops.consensus import (
        color_desc_thresholds, consensus_feedback, consensus_feedback_ref, consensus_read, consensus_read_ref,
        intra_descriptors, roi_map, sample_good_ref, thr_closed_form,
    )

    hw = H * W

    def compare(name, what, a, b):
        e = max_err(a, b)
        errs[name] = max(errs[name], e)
        check(e == 0.0, f"{name} {what} equal (max |err| {e})")

    def walked_samples(planes, colors, descs, intra, lut_delta, R, unstable, req, kw):
        thr = lambda v: thr_closed_form(v, lut_delta, kw["rel"], kw["div"], kw["hi_const"])  # noqa: E731
        _, nbs = intra_descriptors(planes, thr)
        ct, dt = color_desc_thresholds(R, unstable, len(planes) == 1, kw["min_cd"], kw["desc_off"])
        good, _, _ = sample_good_ref(planes, colors, descs, intra, nbs, thr, ct, dt)
        return good, int(examined(good, req[None]).sum())

    for c in (3, 1):
        fr = frames if c == 3 else frames[..., 0].contiguous()
        # K9: the v3 walk, on the banks of a v3 state 3 frames in
        with switches({"TRACKING_TPU_CONSENSUS": "v3"}):
            algo = get_algorithm("subsense")()
            st = algo.warm_start(algo.init(H, W, c, device=dev), fr[0])
            for t in range(1, 4):
                st, _, _ = algo.step(st, fr[t])
            args, kw = capture_call(LF, "consensus_read", lambda: algo.step(clone(st), fr[4]))
        k_out = consensus_read(*clone(args), **kw)
        p_out = consensus_read_ref(*clone(args), **kw)
        for name, a, b in zip(("count", "min_desc", "min_sum", "intra"), k_out, p_out):
            compare("consensus_read", f"C={c} {name}", a, b)
        planes, colors, descs, lut_delta, R, unstable, req = args
        check(int((p_out[0] < req).sum()) > 0, f"consensus_read C={c} has pixels short of the required samples")
        far4 = tuple(torch.cat([(p[None] ^ 0x80).expand(4, -1, -1), col[4:]]) for p, col in zip(planes, colors))
        hard = adversarial_inputs(args, req_at=6)
        hard.append(("first 4 slots far, required = 6", (planes, far4) + args[2:6] + (torch.full_like(req, 6),)))
        for what, a in hard:
            k_h = consensus_read(*clone(a), **kw)
            p_h = consensus_read_ref(*clone(a), **kw)
            e = max(max_err(x, y) for x, y in zip(k_h, p_h))
            errs["consensus_read"] = max(errs["consensus_read"], e)
            check(e == 0.0, f"consensus_read C={c} {what}: all four outputs equal (max |err| {e}); "
                            f"{int((p_h[0] < a[6]).sum())} px short of their requirement")
        if c == 3:
            timing_inputs["consensus_read"] = (args, kw)
            _, walked = walked_samples(planes, colors, descs, p_out[3], lut_delta, R, unstable, req, kw)
            # the frame, R, unstable, required; the examined samples; 3 + C int32 maps out
            bounds["consensus_read"] = bound(c * hw + 9 * hw + 3 * c * walked + 4 * (3 + c) * hw, walked * c * 48)
            print(f"  consensus_read C=3: the walk examines {walked} samples ({walked / hw:.3f} per px), "
                  f"bound {bounds['consensus_read'][0]:.4f} ms", flush=True)

        # K10: the fused step, on a v1 state 3 frames in
        with switches({}):
            algo = get_algorithm("subsense")()
            st = algo.warm_start(algo.init(H, W, c, device=dev), fr[0])
            for t in range(1, 4):
                st, _, _ = algo.step(st, fr[t])
        with switches({"TRACKING_TPU_FUSED": "1"}):
            args, kw = capture_call(LF, "consensus_feedback", lambda: algo.step(clone(st), fr[4]))
        scal0 = args[14][:5] + (torch.zeros_like(args[14][5]),)
        cases = [("t>0 scalar requirement", args), ("t=0 scalar requirement", args[:14] + (scal0,))]
        if c == 3:
            gen = torch.Generator(device="cpu").manual_seed(3)
            req_map = torch.where(torch.rand((H, W), generator=gen) < 0.3, 7, 2).to(torch.int32).to(dev)
            cases += [
                ("t>0 random requirement map", args[:8] + (req_map,) + args[9:]),
                ("t=0 random requirement map", args[:8] + (req_map,) + args[9:14] + (scal0,)),
            ]
        cases += adversarial_inputs(args)
        names = ("flags", "pend_ctrl", "pend_vals", "f32 maps", "bg_sum", "colors", "descs")
        for what, a in cases:
            k_out = consensus_feedback(*clone(a), **kw)
            p_out = consensus_feedback_ref(*clone(a), **kw)
            for name, x, y in zip(names, k_out, p_out):
                compare("consensus_feedback", f"C={c} {what} {name}", x, y)
            if what == cases[0][0]:
                p_main = p_out
        check(0 < int((p_main[0] & 1).sum()) < hw, f"consensus_feedback C={c}: foreground and background pixels")
        if c == 3:
            timing_inputs["consensus_feedback"] = (args, kw)
            planes = args[0]
            req_eff = torch.where(roi_map(H, W, dev), args[8], 0)
            intra = tuple((v >> 8) & 0xFFFF for v in p_main[2])
            good, walked = walked_samples(planes, p_main[5], p_main[6], intra, args[5], args[6], args[7], req_eff, kw)
            # feedback state per px: 9 f32 maps in, 16 B of bits, 5 mask bytes, the last frame's colour and
            # descriptors (3 B per channel), 8 f32 maps out
            fb_px = 9 * 4 + 16 + 5 + 3 * c + 8 * 4
            bounds["consensus_feedback"] = consensus_cost(
                planes, (args[1], args[2]), (p_main[5], p_main[6]), good, req_eff[None], 4 * (1 + c) + 9,
                2 + 2 * c, extra_bytes_px=fb_px, extra_ops_px=120,
            )
            print(f"  consensus_feedback C=3: the walk examines {walked} samples ({walked / hw:.3f} per px), "
                  f"{fb_px} B/px of feedback state, bound {bounds['consensus_feedback'][0]:.4f} ms", flush=True)


def crop_width(a, wc: int):
    """``a`` (a tensor or a tuple of them) cut to its first ``wc`` columns;
    0-d tensors and numbers as they are."""
    if isinstance(a, tuple):
        return tuple(crop_width(x, wc) for x in a)
    return a[..., :wc].contiguous() if isinstance(a, torch.Tensor) and a.dim() >= 2 else a


def adversarial_inputs(args, req_at: int = 8):
    """Adversarial inputs for the consensus, the fused step and the v3 walk,
    built from a 720p step's arguments (planes, colour banks, ..., the
    requirement at index ``req_at``): a requirement of N, so that every
    sample is walked; banks whose first N - 3 colour slots are far from the
    frame, so that good samples lie only in the last slots; a ragged width
    (W - 6 = 1274, no multiple of 4 or 16) with the step's requirement and
    with N."""
    planes, colors = args[0], args[1]
    N = colors[0].shape[0]
    wr = W - 6
    full_n = torch.full((H, W), N, dtype=torch.int32, device=planes[0].device)
    far = tuple(torch.cat([(p[None] ^ 0x80).expand(N - 3, -1, -1), col[N - 3 :]]) for p, col in zip(planes, colors))
    with_n = args[:req_at] + (full_n,) + args[req_at + 1 :]
    return [
        ("required = N", with_n),
        ("good samples only in the last 3 slots", (planes, far) + args[2:]),
        (f"ragged width {H}x{wr}", crop_width(args, wr)),
        (f"ragged width {H}x{wr}, required = N", crop_width(with_n, wr)),
    ]


def variant_paths(frames, dev, results):
    """Phase 4c: SuBSENSE v3, SuBSENSE fused and subsenseShrink fused at
    720p, each through its new kernel with the launch counts zeroed just
    before and read just after, then its first frames again through the
    plain versions. Returns the warm-started states for the timing phase."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.ops import _native

    starts = {}
    for label, name, env, kern in VARIANTS:
        with switches(env):
            algo = get_algorithm(name)()
            start = algo.warm_start(algo.init(H, W, C, device=dev), frames[0])
            starts[label] = (algo, env, clone(start))
            print(f"[4c] {label} ({env}): warm start + {VARIANT_FRAMES} frames at {H}x{W}x{C}", flush=True)
            s, masks, snap = clone(start), [], None
            _native.reset_launches()
            for t in range(1, VARIANT_FRAMES + 1):
                s, fg, _ = algo.step(s, frames[t])
                masks.append(fg)
                if t == VARIANT_PLAIN:
                    snap = clone(s)
            torch.cuda.synchronize()
            launches = dict(_native.LAUNCHES)
            print(f"  launches: {launches}", flush=True)
            check(launches[kern] > 0, f"{kern} launched {launches[kern]} times on the {label} path")
            check(launches["consensus"] == 0, f"consensus launched {launches['consensus']} times on the {label} path")
            results[kern].setdefault("launches", launches[kern])
            share = float(torch.stack(masks).gt(0).to(torch.float32).mean())
            check(0.001 < share < 0.5, f"{label} mean foreground share {share:.4f} in (0.001, 0.5)")
            s = clone(start)
            for t in range(1, VARIANT_PLAIN + 1):
                s, fg, _ = algo.step(s, frames[t], use_kernels=False)
                if not torch.equal(fg, masks[t - 1]):
                    raise AssertionError(f"{label}: the plain path's mask differs from the kernel path's at frame {t}")
            e = max_err(s, snap)
            check(e == 0.0, f"{label}: masks over {VARIANT_PLAIN} frames and the state after them equal through "
                            "the plain versions")
    return starts


def time_variants(algo, state0, starts, frames, tag) -> None:
    """Phase 6 for the consensus variants: v1 / v3 / fused SuBSENSE step and
    the subsenseShrink fused step ms/frame in turns (v1, v3, fused, shrink,
    shrink, fused, v3, v1), then kernels per frame and the busy share of
    each under the profiler."""
    runs = {"SuBSENSE v1": (algo, {}, state0)}
    runs.update((k, starts[k]) for k in ("SuBSENSE v3", "SuBSENSE fused", "subsenseShrink fused"))
    ms = {k: [] for k in runs}
    for k in (*runs, *reversed(runs)):
        a, env, start = runs[k]
        with switches(env):
            s = clone(start)
            for t in range(1, 5):  # warm-up
                s, _, _ = a.step(s, frames[t])
            torch.cuda.synchronize()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            for t in range(5, 5 + TIMED_FRAMES):
                s, _, _ = a.step(s, frames[t])
            ev1.record()
            torch.cuda.synchronize()
            ms[k].append(ev0.elapsed_time(ev1) / TIMED_FRAMES)
    for k, v in ms.items():
        print(f"  {tag} {k} step (in turns): {v[0]:.3f} / {v[1]:.3f} ms/frame = {1000 / min(v):.1f} fps "
              f"({TIMED_FRAMES} frames, {H}x{W}x{C})", flush=True)
    for k, (a, env, start) in runs.items():
        with switches(env):
            box = {"s": clone(start)}
            for t in range(1, 5):
                box["s"], _, _ = a.step(box["s"], frames[t])

            def run_frame(t, a=a, box=box):
                box["s"], _, _ = a.step(box["s"], frames[t])

            profile(run_frame, range(5, 13), tag, f"{k} step", top=6)


def registry_path(frames, dev, results):
    """Phase 4b: each registry algorithm at 720p through its kernel, then its
    first frames again through the plain versions. Returns the warm-started
    states (algo, state) for the timing phase."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.ops import _native

    starts = {}
    for name, kern, first, n_plain in REGISTRY:
        algo = get_algorithm(name)()
        start = algo.warm_start(algo.init(H, W, C, device=dev), frames[0])
        starts[name] = (algo, clone(start))
        print(f"[4b] {name}: warm start + {REGISTRY_FRAMES} frames at {H}x{W}x{C}", flush=True)
        s, masks, snap = clone(start), [], None
        _native.reset_launches()
        for t in range(1, REGISTRY_FRAMES + 1):
            s, fg, _ = algo.step(s, frames[t])
            masks.append(fg)
            if t == n_plain:
                snap = clone(s)
        torch.cuda.synchronize()
        launches = dict(_native.LAUNCHES)
        print(f"  launches: {launches}", flush=True)
        check(launches[kern] > 0, f"{kern} launched {launches[kern]} times on the {name} path")
        results[kern]["launches"] = launches[kern]
        share = float(torch.stack(masks[first - 1 :]).gt(0).to(torch.float32).mean())
        check(0.001 < share < 0.5, f"{name} mean foreground share {share:.4f} over frames {first}-{REGISTRY_FRAMES} in (0.001, 0.5)")
        s = clone(start)
        for t in range(1, n_plain + 1):
            s, fg, _ = algo.step(s, frames[t], use_kernels=False)
            if not torch.equal(fg, masks[t - 1]):
                raise AssertionError(f"{name}: the plain path's mask differs from the kernel path's at frame {t}")
        e = max_err(s, snap)
        check(e == 0.0, f"{name}: masks over {n_plain} frames and the state after them equal through the plain versions")
    return starts


def time_registry(timing_inputs, results, starts, frames, tag) -> None:
    """Phase 6 for the registry path: each kernel beside its plain version
    (plain, kernel, kernel, plain) and ms/frame for each algorithm, twice."""
    from tracking_tpu_torch.ops.consensus import consensus_lobster, consensus_lobster_ref
    from tracking_tpu_torch.ops.gmg import gmg_step, gmg_step_ref
    from tracking_tpu_torch.ops.multilayer import multilayer_step, multilayer_step_ref
    from tracking_tpu_torch.ops.texture import texture_prox_cur, texture_prox_cur_ref

    pairs = {
        "consensus_lobster": (consensus_lobster, consensus_lobster_ref, 20, 3),
        "gmg_step": (gmg_step, gmg_step_ref, 20, 3),
        "texture_prox_cur": (texture_prox_cur, texture_prox_cur_ref, 20, 3),
    }
    for k, (fk, fp, rk, rp) in pairs.items():
        args, kw = timing_inputs[k]
        time_pair(k, lambda: fk(*args, **kw), lambda: fp(*args, **kw), rk, rp, results, tag)
    # the MultiLayer kernel updates its state in place and moves only what
    # changes: each timed call gets a fresh copy of the phase-3 state (the
    # data its bound counts); the same frame applied again and again to one
    # state, which changes less, is printed beside it
    (cfg, st, *rest), _ = timing_inputs["multilayer_step"]
    reps = 10
    fresh = iter([clone(st) for _ in range(2 * (reps + 1))])
    time_pair("multilayer_step", lambda: multilayer_step(cfg, next(fresh), *rest),
              lambda: multilayer_step_ref(cfg, st, *rest), reps, 3, results, tag)
    del fresh
    again = clone(st)
    ms = [cuda_ms(lambda: multilayer_step(cfg, again, *rest), 20) for _ in range(2)]
    results["multilayer_step"]["ms_same_frame_again"] = min(ms)
    del again
    print(f"  {tag} multilayer_step, the same frame again on one state: {ms[0]:.4f} / {ms[1]:.4f} ms", flush=True)
    for k, fk in (("consensus_lobster", consensus_lobster), ("texture_prox_cur", texture_prox_cur),
                  ("multilayer_step", multilayer_step)):
        args, kw = timing_inputs[k]
        n_ops, results[k]["device_ms"] = device_ops(lambda: fk(*args, **kw), k, tag)
        check(n_ops <= 1, f"{k} takes {n_ops:.1f} device operations a call (at most 1)")
    for name, (algo, start) in starts.items():
        ms = []
        for _ in range(2):
            s = clone(start)
            for t in range(1, 5):  # warm-up
                s, _, _ = algo.step(s, frames[t])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev0.record()
            for t in range(5, 5 + REGISTRY_TIMED):
                s, _, _ = algo.step(s, frames[t])
            ev1.record()
            torch.cuda.synchronize()
            ms.append(ev0.elapsed_time(ev1) / REGISTRY_TIMED)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  {tag} {name} step: {ms[0]:.3f} / {ms[1]:.3f} ms/frame = {1000 / min(ms):.1f} fps "
              f"({REGISTRY_TIMED} frames, {H}x{W}x{C}); peak device memory {peak:.2f} GiB", flush=True)
        box = {"s": s}

        def run_frame(t, algo=algo, box=box):
            box["s"], _, _ = algo.step(box["s"], frames[t])

        profile(run_frame, range(5 + REGISTRY_TIMED, 13 + REGISTRY_TIMED), tag, name, top=6)


def time_pair(k, fk, fp, rk, rp, results, tag, label=None, plain_warmup: int = 1, plain_turns: int = 2) -> None:
    """A kernel's and its plain version's ms, in turns (plain, kernel,
    kernel, plain), beside the kernel's bound, into ``results[k]``
    (``plain_warmup`` 0 and ``plain_turns`` 1 for a plain version that takes
    seconds a call: plain, kernel, kernel)."""
    ms_p1 = cuda_ms(fp, rp, plain_warmup)
    ms_k1 = cuda_ms(fk, rk)
    ms_k2 = cuda_ms(fk, rk)
    ms_p2 = cuda_ms(fp, rp, plain_warmup) if plain_turns > 1 else ms_p1
    r = results[k]
    r["ms"] = min(ms_k1, ms_k2)
    r["plain_ms"] = min(ms_p1, ms_p2)
    plain = f"{ms_p1:.4f} / {ms_p2:.4f}" if plain_turns > 1 else f"{ms_p1:.4f} (one call)"
    print(f"  {tag} {label or k}: kernel {ms_k1:.4f} / {ms_k2:.4f} ms, plain {plain} ms, "
          f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) = {r['bound_ms'] / r['ms']:.1%} of it reached", flush=True)


def fgd_cost(args, out):
    """(bound_ms, bound_by), bytes per pixel and table occupancy of FGD's
    table phase on these inputs, counting what this run's data needs. A
    pixel consults one table: the colour table where it did not change (or
    on the first frame), the co-occurrence table where it did. There it must
    read its own key, the P of every entry (for the least P and the match's
    rank), the key bytes of the used entries (P > 0) up to the first match,
    each up to its first differing byte, and the Pb of the used entries (an
    unused entry has Pb = 0 in every state the algorithm reaches); and write
    the P, Pb and key bytes whose value changes. Every pixel reads
    ``changed``, reads fg_age where it is foreground, writes fg_age where it
    changes and writes two masks. ``out`` is the plain version's result."""
    cfg, st, ckey, cckey, changed, first = args
    upd, is_bg, _ = out
    hw = changed.numel()
    sb = st["ct_P"].element_size()
    n_bytes = n_ops = 0
    occ = {}
    for prefix, key, consult in (("ct", ckey, ~changed | first), ("cc", cckey, changed)):
        keys, P, Pb = st[f"{prefix}_key"], st[f"{prefix}_P"], st[f"{prefix}_Pb"]
        N, Ck = keys.shape[:2]
        used = (P > 0) & consult[None]
        lead = torch.cumprod((keys == key[None]).to(torch.int32), dim=1).sum(dim=1)  # leading equal key bytes
        kidx = torch.arange(N, device=P.device)[:, None, None]
        fi = torch.where(used & (lead == Ck), kidx, N).amin(dim=0)
        examined = used & (kidx <= fi[None])
        key_read = int(torch.where(examined, (lead + 1).clamp(max=Ck), 0).sum())
        n_px, n_used = int(consult.sum()), int(used.sum())
        stat_w = int((upd[f"{prefix}_P"] != P).sum()) + int((upd[f"{prefix}_Pb"] != Pb).sum())
        key_w = int((upd[f"{prefix}_key"] != keys).sum())
        n_bytes += n_px * (Ck + N * sb) + key_read + (n_used + stat_w) * sb + key_w
        n_ops += 2 * key_read + 8 * N * n_px  # a compare per key byte; least P, rank and decay per entry
        occ[prefix] = (n_px / hw, n_used / max(n_px, 1), int(examined.sum()) / max(n_px, 1))
    n_fg = int((~is_bg).sum())
    age_w = int((upd["fg_age"] != st["fg_age"]).sum())
    n_bytes += 3 * hw + 4 * (n_fg + age_w)
    return bound(n_bytes, n_ops), n_bytes / hw, occ


def aged(cfg, state, seed: int = 5):
    """A copy of an FGD ``state`` with every unused entry (P = 0) of both
    tables filled as hours of running leave a table: a key next to the
    pixel's background colour (each byte of colour-table entry 0, or of its
    co-occurrence with itself, moved by -2..2 within the quantised range),
    P = alpha2 · (1 − alpha2)^k of an entry last seen k = 100..2000 frames
    ago, and Pb = P or 0. The used entries keep their keys and statistics."""
    st = clone(state)
    dev = st["fg_age"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    bg_key = st["ct_key"][0]
    for prefix, centre, levels in (("ct", bg_key, cfg.Lc), ("cc", torch.cat([bg_key >> 1, bg_key >> 1]), cfg.Lcc)):
        keys, P, Pb = st[f"{prefix}_key"], st[f"{prefix}_P"], st[f"{prefix}_Pb"]
        empty = P == 0
        step = torch.randint(-2, 3, keys.shape, generator=gen, device=dev, dtype=torch.int32)
        near = (centre[None].to(torch.int32) + step).clamp(0, levels - 1).to(torch.uint8)
        keys.copy_(torch.where(empty[:, None], near, keys))
        k = torch.randint(100, 2001, P.shape, generator=gen, device=dev).to(torch.float64)
        p_old = (cfg.alpha2 * (1.0 - cfg.alpha2) ** k).to(torch.float32)
        seen_bg = torch.rand(P.shape, generator=gen, device=dev) < 0.5
        P.copy_(torch.where(empty, p_old, P.to(torch.float32)).to(P.dtype))
        Pb.copy_(torch.where(empty, torch.where(seen_bg, p_old, 0.0), Pb.to(torch.float32)).to(Pb.dtype))
    return st


def crop_fgd(args, h: int, w: int):
    """FGD table-phase arguments cut to their first ``h`` rows and ``w``
    columns."""
    cfg, st, *maps, first = args
    cut = lambda t: t[..., :h, :w].contiguous() if t.dim() >= 2 else t  # noqa: E731
    return (cfg, {k: cut(v) for k, v in st.items()}, *map(cut, maps), first)


def subnormal_entries(args, seed: int = 6):
    """FGD table-phase arguments (f16 statistics) with every unused entry
    (P = 0) given an f16 subnormal P = k * 2^-24, k in 1..199, and Pb = P
    or 0: the decay by 1 - alpha2 rounds k < 100 back to itself."""
    cfg, st, *rest = args
    st = clone(st)
    dev = st["fg_age"].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for prefix in ("ct", "cc"):
        P, Pb = st[f"{prefix}_P"], st[f"{prefix}_Pb"]
        sub = (torch.randint(1, 200, P.shape, generator=gen, device=dev).to(torch.float32) * 2.0**-24).to(P.dtype)
        seen_bg = torch.rand(P.shape, generator=gen, device=dev) < 0.5
        Pb.copy_(torch.where(P == 0, torch.where(seen_bg, sub, torch.zeros_like(sub)), Pb))
        P.copy_(torch.where(P == 0, sub, P))
    return (cfg, st, *rest)


def check_fgd_kernel(frames, quiet, dev, errs, timing_inputs, bounds) -> None:
    """Phase 3 for FGD's table kernel against its plain version at 720p,
    exactly: on inputs captured from real FGD steps (the noisy and the quiet
    clip, the first frame, f32 statistics), on the quiet step with full
    tables, on random tables with forced ties, at a ragged width (720x1277:
    the kernel's quads still whole) and an odd pixel count (719x1277: its
    per-pixel path), and with f16 subnormal P in every unused entry (most
    decay to themselves); each timed input's bound."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.bgs import fgd as BF
    from tracking_tpu_torch.ops.fgd import TABLE_LEAVES, fgd_tables, fgd_tables_ref

    def compare(what, args):
        k_out = fgd_tables(*clone(args))
        p_out = fgd_tables_ref(*clone(args))
        e = max(max_err(k_out[0], p_out[0]), max_err(k_out[1], p_out[1]), max_err(k_out[2], p_out[2]))
        errs["fgd_tables"] = max(errs["fgd_tables"], e)
        fg = float((~p_out[1]).to(torch.float32).mean())
        check(e == 0.0, f"fgd_tables {what}: every table leaf, is_bg and lab_bg equal (max |err| {e}); "
                        f"changed {float(args[4].to(torch.float32).mean()):.4f}, raw foreground {fg:.4f}")
        return p_out

    def captured(fr, n_steps):
        algo = get_algorithm("FG_0")()
        st = algo.warm_start(algo.init(H, W, C, device=dev), fr[0])
        for t in range(1, n_steps):
            st, _, _ = algo.step(st, fr[t])
        return capture_call(BF, "fgd_tables", lambda: algo.step(clone(st), fr[n_steps]))[0]

    first_args, _ = capture_call(BF, "fgd_tables", lambda: get_algorithm("FG_0")().step(
        get_algorithm("FG_0")().init(H, W, C, device=dev), quiet[0]))
    compare("first frame (t = 0)", first_args)
    # the timed cases: a young model (6 frames, tables nearly empty), the
    # noisy clip's model after 64 frames (its co-occurrence tables full) and
    # the young quiet model with full tables (a model that ran for hours)
    quiet_args = captured(quiet, 6)
    cases = {"quiet clip, frame 6 (young tables)": quiet_args,
             "noisy clip, frame 64": captured(frames, MAIN_FRAMES),
             FGD_ROW: (quiet_args[0], aged(quiet_args[0], quiet_args[1]), *quiet_args[2:])}
    outs = {what: compare(what, a) for what, a in cases.items()}
    compare("noisy clip, frame 6", captured(frames, 6))
    saved = BF.FGD.STAT_DTYPE
    BF.FGD.STAT_DTYPE = torch.float32
    try:
        f32_args = captured(frames, 4)
    finally:
        BF.FGD.STAT_DTYPE = saved
    compare("f32 statistics, noisy clip, frame 4", f32_args)

    # random tables with forced ties: keys from 2 values per byte (matches,
    # repeated matches), P from 4 values with unused entries (rank and
    # argmin ties), fg_age around absorbFrames
    cfg = quiet_args[0]
    gen = torch.Generator(device="cpu").manual_seed(4)
    vals = torch.tensor([0.0, 0.005, 0.01, 0.25], dtype=torch.float32)
    st = {}
    for prefix, n, ck in (("ct", cfg.N2c, C), ("cc", cfg.N2cc, 2 * C)):
        st[f"{prefix}_key"] = torch.randint(0, 2, (n, ck, H, W), generator=gen, dtype=torch.uint8).to(dev)
        P = vals[torch.randint(0, 4, (n, H, W), generator=gen)]
        st[f"{prefix}_P"] = P.to(torch.float16).to(dev)
        st[f"{prefix}_Pb"] = (P * vals[torch.randint(0, 4, (n, H, W), generator=gen)] * 4).to(torch.float16).to(dev)
    st["fg_age"] = torch.randint(27, 32, (H, W), generator=gen, dtype=torch.int32).to(dev)
    keys = (torch.randint(0, 2, (C, H, W), generator=gen, dtype=torch.uint8).to(dev),
            torch.randint(0, 2, (2 * C, H, W), generator=gen, dtype=torch.uint8).to(dev))
    changed = (torch.rand((H, W), generator=gen) < 0.5).to(dev)
    compare("random tables with ties", (cfg, st, *keys, changed, torch.zeros((), dtype=torch.bool, device=dev)))
    for what in (FGD_ROW, "noisy clip, frame 64"):
        compare(f"{what}, ragged width {H}x{W - 3}", crop_fgd(cases[what], H, W - 3))
        compare(f"{what}, odd pixel count {H - 1}x{W - 3}", crop_fgd(cases[what], H - 1, W - 3))
    compare("quiet clip, frame 6, f16 subnormal P in every unused entry", subnormal_entries(quiet_args))

    timed = {}
    for what, a in cases.items():
        (b_ms, b_by), bpx, occ = fgd_cost(a, outs[what])
        timed[what] = (a, b_ms, b_by)
        tabs = "; ".join(f"{pf} table: {o[0]:.4f} of pixels, {o[1]:.2f} used and {o[2]:.2f} examined entries a pixel"
                         for pf, o in occ.items())
        print(f"  fgd_tables bound, {what}: {tabs}; {bpx:.1f} B/px = {b_ms:.4f} ms ({b_by})", flush=True)
    timing_inputs["fgd_tables"] = timed
    _, *bounds["fgd_tables"] = timed[FGD_ROW]
    full16 = 2 * sum(quiet_args[1][k].numel() * quiet_args[1][k].element_size() for k in TABLE_LEAVES) / (H * W)
    full32 = full16 + 2 * 2 * (cfg.N2c + cfg.N2cc) * 2  # P and Pb at 4 bytes in place of 2
    inputs = 3 * C + 1 + 2  # keys, changed, two masks
    print(f"  fgd_tables, both whole tables streamed in and out: f16 {full16 + inputs:.0f} B/px = "
          f"{(full16 + inputs) * H * W / HBM_BYTES_PER_S * 1e3:.4f} ms, f32 {full32 + inputs:.0f} B/px = "
          f"{(full32 + inputs) * H * W / HBM_BYTES_PER_S * 1e3:.4f} ms", flush=True)


def fgd_path(quiet, dev, results, tracker, timing_inputs):
    """Phase 4d: FG_0 (FGD) + the CCMSPF tracker at 720p on the quiet clip,
    with the launch counts zeroed just before and read just after, then the
    first frames again through the plain versions; FG_0S through the
    registry with the same checks. Returns the FG_0 start state."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.ops import _native

    algo = get_algorithm("FG_0")()
    start = algo.warm_start(algo.init(H, W, C, device=dev), quiet[0])
    print(f"[4d] FG_0 path: warm start + {MAIN_FRAMES} frames of FGD + CCMSPF at {H}x{W}x{C}, quiet clip", flush=True)
    s, trk = clone(start), tracker.init(device=dev)
    masks, ids, xs, ys, snap = [], [], [], [], None
    _native.reset_launches()
    for t in range(1, MAIN_FRAMES + 1):
        s, fg, _ = algo.step(s, quiet[t])
        trk, tracks = tracker.step(trk, fg)
        masks.append(fg)
        ids.append(tracks.ids)
        xs.append(tracks.x)
        ys.append(tracks.y)
        if t == FGD_PLAIN:
            snap = clone(s)
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    print(f"  launches: {launches}", flush=True)
    for k in FGD_KERNELS:
        check(launches[k] > 0, f"{k} launched {launches[k]} times on the FG_0 path")
    results["fgd_tables"]["launches"] = launches["fgd_tables"]
    shares = torch.stack(masks[1:]).gt(0).to(torch.float32).mean(dim=(1, 2))
    print(f"  foreground share per frame: {[round(float(x), 4) for x in shares]}", flush=True)
    share = float(shares.mean())
    check(0.001 < share < 0.5, f"FG_0 mean foreground share {share:.4f} after frame 1 in (0.001, 0.5)")
    n_active = int(trk["active"].sum())
    check(n_active >= 1, f"{n_active} tracks active at the end of the FG_0 path")
    timing_inputs["fgd_mask"] = masks[int(shares.argmax()) + 1]
    s, trk = clone(start), tracker.init(device=dev)
    for t in range(1, FGD_PLAIN + 1):
        s, fg, _ = algo.step(s, quiet[t], use_kernels=False)
        trk, tr = tracker.step(trk, fg, use_kernels=False)
        i = t - 1
        if not (torch.equal(fg, masks[i]) and torch.equal(tr.ids, ids[i]) and torch.equal(tr.x, xs[i])
                and torch.equal(tr.y, ys[i])):
            raise AssertionError(f"FG_0 path: the plain path differs from the kernel path at frame {t}")
    e = max_err(s, snap)
    check(e == 0.0, f"FG_0 path: masks, tracks over {FGD_PLAIN} frames and the FGD state after them equal through "
                    "the plain versions")

    simple = get_algorithm("FG_0S")()
    s0 = simple.warm_start(simple.init(H, W, C, device=dev), quiet[0])
    print(f"[4d] FG_0S: warm start + {FGDS_FRAMES} frames at {H}x{W}x{C}, quiet clip", flush=True)
    s, masks = clone(s0), []
    _native.reset_launches()
    for t in range(1, FGDS_FRAMES + 1):
        s, fg, _ = simple.step(s, quiet[t])
        masks.append(fg)
        if t == FGD_PLAIN:
            snap = clone(s)
    torch.cuda.synchronize()
    n = _native.LAUNCHES["fgd_tables"]
    check(n > 0, f"fgd_tables launched {n} times on the FG_0S path")
    share = float(torch.stack(masks[1:]).gt(0).to(torch.float32).mean())
    print(f"  FG_0S mean foreground share {share:.4f} after frame 1 (it floods: no share check)", flush=True)
    s = clone(s0)
    for t in range(1, FGD_PLAIN + 1):
        s, fg, _ = simple.step(s, quiet[t], use_kernels=False)
        if not torch.equal(fg, masks[t - 1]):
            raise AssertionError(f"FG_0S: the plain path's mask differs from the kernel path's at frame {t}")
    e = max_err(s, snap)
    check(e == 0.0, f"FG_0S: masks over {FGD_PLAIN} frames and the state after them equal through the plain versions")
    return algo, start


def time_fgd(timing_inputs, results, algo, start, tracker, quiet, dev, tag) -> None:
    """Phase 6 for FGD: the table kernel beside its plain version on young,
    full and noisy-clip tables (also on fresh copies of each state), its
    device operations a call, and on the noisy clip's frame with every pixel
    in one table; CC labelling on FGD's masks beside SuBSENSE's; on a young
    model and on the same model with full tables, the step with the table
    kernel against the step with the plain table phase (all else the same)
    in turns, and the FG_0 path ms/frame; the FG_0 path under the
    profiler."""
    from tracking_tpu_torch.bgs import fgd as BF
    from tracking_tpu_torch.ops.cc import label_components
    from tracking_tpu_torch.ops.fgd import fgd_tables, fgd_tables_ref

    for what, m in (("SuBSENSE's frame-3 mask (phase 3)", timing_inputs["label_components"][0]),
                    ("FG_0's densest quiet-clip mask", timing_inputs["fgd_mask"]),
                    ("FGD's noisy-clip mask, frame 6", timing_inputs["fgd_flooded"])):
        ms = [cuda_ms(lambda m=m: label_components(m), 50) for _ in range(2)]
        print(f"  {tag} label_components on {what} ({float(m.gt(0).to(torch.float32).mean()):.4f} foreground): "
              f"{ms[0]:.4f} / {ms[1]:.4f} ms", flush=True)
        device_ops(lambda m=m: label_components(m), f"label_components on {what}", tag)

    def fresh_ms(args, reps: int = 10) -> float:
        # the kernel updates the tables in place and stores only what
        # changes: each timed call gets a fresh copy of the state
        cfg, st, *rest = args
        pool = iter([clone(st) for _ in range(reps + 1)])
        return cuda_ms(lambda: fgd_tables(cfg, next(pool), *rest), reps)

    # first on fresh copies: the same call again (below, as earlier PRs
    # timed it) updates the phase-3 states in place. A quad whose pixels
    # consult both tables runs both: the noisy frame (the kinds mixed) is
    # also timed with every pixel in one table, and the two mixed by the
    # frame's share of changed pixels
    fresh = {what: [fresh_ms(a[0]) for _ in range(2)] for what, a in timing_inputs["fgd_tables"].items()}
    args = timing_inputs["fgd_tables"]["noisy clip, frame 64"][0]
    share = float(args[4].to(torch.float32).mean())
    one = {label: min(fresh_ms(args[:4] + (torch.full_like(args[4], v),) + args[5:]) for _ in range(2))
           for label, v in (("co-occurrence", True), ("colour", False))}
    print(f"  {tag} fgd_tables, noisy clip, frame 64, fresh copies: as it is ({share:.4f} of the pixels changed) "
          f"{min(fresh['noisy clip, frame 64']):.4f} ms; every pixel in the co-occurrence table "
          f"{one['co-occurrence']:.4f} ms, in the colour table {one['colour']:.4f} ms; their mix by the share "
          f"{share * one['co-occurrence'] + (1 - share) * one['colour']:.4f} ms", flush=True)
    for what, (args, b_ms, b_by) in timing_inputs["fgd_tables"].items():
        row = {"bound_ms": b_ms, "bound_by": b_by}
        print(f"  {tag} fgd_tables, {what}, on fresh copies of the state: {fresh[what][0]:.4f} / "
              f"{fresh[what][1]:.4f} ms = {b_ms / min(fresh[what]):.1%} of the bound", flush=True)
        time_pair("fgd_tables", lambda args=args: fgd_tables(*args), lambda args=args: fgd_tables_ref(*args), 20, 3,
                  {"fgd_tables": row}, tag, label=f"fgd_tables, {what}, the same call again")
        if what == FGD_ROW:
            results["fgd_tables"].update(ms=row["ms"], plain_ms=row["plain_ms"], ms_fresh_state=min(fresh[what]))
    args = timing_inputs["fgd_tables"][FGD_ROW][0]
    n_ops, _ = device_ops(lambda: fgd_tables(*args), "fgd_tables", tag)
    check(n_ops <= 1, f"fgd_tables takes {n_ops:.1f} device operations a call (at most 1)")

    def run(model, with_tracker: bool):
        s, tr = clone(model), tracker.init(device=dev)
        for t in range(1, 5):  # warm-up
            s, fg, _ = algo.step(s, quiet[t])
        torch.cuda.synchronize()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        for t in range(5, 5 + FGD_TIMED):
            s, fg, _ = algo.step(s, quiet[t])
            if with_tracker:
                tr, _ = tracker.step(tr, fg)
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / FGD_TIMED

    # the model just started (tables nearly empty) and the same model with
    # full tables (see aged)
    models = {"young tables": start, "full tables": aged(algo.config, start)}
    for label, model in models.items():
        ab = {"kernel": [], "plain": []}
        for arm in ("kernel", "plain", "plain", "kernel"):
            BF.fgd_tables = fgd_tables if arm == "kernel" else fgd_tables_ref
            try:
                ab[arm].append(run(model, False))
            finally:
                BF.fgd_tables = fgd_tables
        for arm, v in ab.items():
            print(f"  {tag} FGD step, {label}, table phase {arm} (in turns): {v[0]:.3f} / {v[1]:.3f} ms/frame "
                  f"({FGD_TIMED} frames, {H}x{W}x{C})", flush=True)
    torch.cuda.reset_peak_memory_stats()
    for label, model in models.items():
        full = [run(model, True), run(model, True)]
        print(f"  {tag} FG_0 path (FGD + tracking), {label}: {full[0]:.3f} / {full[1]:.3f} ms/frame = "
              f"{1000 / min(full):.1f} fps ({FGD_TIMED} frames)", flush=True)
    print(f"  {tag} peak device memory of the FG_0 runs {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    box = {"s": clone(start), "tr": tracker.init(device=dev)}

    def run_frame(t):
        box["s"], fg, _ = algo.step(box["s"], quiet[t])
        box["tr"], _ = tracker.step(box["tr"], fg)

    for t in range(1, 5):
        run_frame(t)
    profile(run_frame, range(5, 13), tag, "FG_0 path", top=10)


def shard_rows(rank: int):
    """Global rows [r0 - E, r0 + h + E) of shard ``rank`` (E the sharded
    path's halo) and (r0, h)."""
    from tracking_tpu_torch.parallel.spatial import HALO

    h = H // SHARDS
    r0 = rank * h
    return torch.arange(r0 - HALO, r0 + h + HALO), r0, h


def check_spatial_kernels(algo, state3, frames, dev, errs, timing_inputs, bounds) -> None:
    """Phase 3 for the sharded path: ``label_fixpoint`` against its plain
    version on shards of real and built masks, and the consensus's slab mode
    against its plain version and against the unsharded kernel's rows, on
    the halo slabs of the first, second and last of 4 shards, exactly."""
    from tracking_tpu_torch.ops.cc import label_components_ref, label_fixpoint, label_fixpoint_ref
    from tracking_tpu_torch.ops.consensus import (
        color_desc_thresholds, consensus, consensus_ref, intra_descriptors, roi_map, sample_good_ref,
        thr_closed_form,
    )
    from tracking_tpu_torch.parallel.spatial import HALO, inject_row

    big = H * W
    final = state3["last_final"] > 0
    # the real mask's shard: the one whose upper cut the most foreground crosses
    cross = [int((final[r * (H // SHARDS) - 1] & final[r * (H // SHARDS)]).sum()) for r in range(1, SHARDS)]
    rank_real = 1 + max(range(SHARDS - 1), key=lambda i: cross[i])

    def fixpoint_case(what, mask, conn, rank=1):
        """Shard ``rank``'s rows of ``mask``, global-offset labels, the
        previous shard's boundary row of the global labelling injected."""
        _, r0, h = shard_rows(rank)
        glob = label_components_ref(mask, conn)
        fg = (mask[r0 : r0 + h] > 0).contiguous()
        iota = r0 * W + torch.arange(h * W, dtype=torch.int32, device=dev).reshape(h, W)
        lab0 = torch.where(fg, iota, big).to(torch.int32)
        nb = glob[r0 - 1 : r0]
        lab0[:1] = inject_row(lab0[:1], torch.where(nb >= 0, nb, big), big, conn)
        a, conv = label_fixpoint(fg, lab0, big, conn)
        b, _ = label_fixpoint_ref(fg, lab0, big, conn)
        e = max_err(a, b)
        errs["label_fixpoint"] = max(errs["label_fixpoint"], e)
        n_inj = int((lab0[0] < r0 * W).sum())
        check(e == 0.0 and conv, f"label_fixpoint ({conn}-conn) equal on {what}, rows {r0}-{r0 + h - 1}, "
                                 f"{n_inj} px of the first row injected")
        return fg, lab0, b, glob

    print(f"  the frame-3 mask's foreground crosses the shard cuts at rows {[r * (H // SHARDS) for r in range(1, SHARDS)]} "
          f"in {cross} columns", flush=True)
    fg, lab0, _, _ = fixpoint_case("SuBSENSE's frame-3 mask", final, 8, rank_real)
    timing_inputs["label_fixpoint"] = (fg, lab0, big, rank_real)
    fixpoint_case("SuBSENSE's frame-3 mask", final, 4, rank_real)
    _, r0, h = shard_rows(1)
    serp = torch.zeros((H, W), dtype=torch.uint8, device=dev)
    for k in range(10):  # strokes across the cut, joined above it and below it in turn
        x = 100 + 40 * k
        serp[r0 - 30 : r0 + 31, x : x + 3] = 255
        if k % 2 == 0:
            serp[r0 - 30 : r0 - 27, x : x + 43] = 255
        elif k < 9:
            serp[r0 + 28 : r0 + 31, x : x + 43] = 255
    _, _, b, glob = fixpoint_case("a serpentine crossing the shard cut ten times", serp, 8)
    check(torch.equal(torch.where(b < big, b, -1), glob[r0 : r0 + h]),
          "label_fixpoint on the serpentine gives the global labels (one component)")
    gen = torch.Generator(device="cpu").manual_seed(3)
    fixpoint_case("a random mask of density 0.45", (torch.rand((H, W), generator=gen) < 0.45).to(dev), 8)
    bounds["label_fixpoint"] = bound(9 * h * W, 10 * h * W)  # fg 1 + lab0 4 + labels 4 B/px; ~10 ops/px

    # the consensus's slab mode: the state after 3 steps, frame 4
    kw = algo._kernel_kw(C)
    planes = tuple(frames[4][..., i].contiguous() for i in range(C))
    req_full = torch.where(roi_map(H, W, dev), algo.config.nRequiredBGSamples, 0).to(torch.int32)
    full = consensus(planes, *clone((state3["colors"], state3["descs"], state3["pend_ctrl"], state3["pend_vals"])),
                     state3["lut_delta"], state3["R"], state3["unstable"], req_full, **kw)
    for rank in (0, 1, SHARDS - 1):
        rows, r0, h = shard_rows(rank)
        rows = rows.to(dev)

        def own(x):
            return x[..., r0 : r0 + h, :].contiguous()

        slab = tuple(p.index_select(0, rows.clamp(0, H - 1)).contiguous() for p in planes)
        vals = tuple(v.index_select(0, rows.clamp(2, H - 3)).contiguous() for v in state3["pend_vals"])
        args = (slab, tuple(map(own, state3["colors"])), tuple(map(own, state3["descs"])), own(state3["pend_ctrl"]),
                vals, state3["lut_delta"], own(state3["R"]), own(state3["unstable"]), own(req_full))
        k_out = consensus(*clone(args), **kw, row_ext=HALO)
        p_out = consensus_ref(*clone(args), **kw, row_ext=HALO)
        for name, a, b, u in zip(("count", "min_desc", "min_sum", "intra", "bg_sum", "colors", "descs"),
                                 k_out, p_out, full):
            e = max_err(a, b)
            errs["consensus"] = max(errs["consensus"], e)
            check(e == 0.0 and max_err(a, tuple(map(own, u)) if isinstance(u, tuple) else own(u)) == 0.0,
                  f"consensus slab mode, shard {rank} (rows {r0}-{r0 + h - 1}, halo {HALO}): {name} equal "
                  f"to its plain version and to the unsharded kernel's rows")
        if rank == 1:
            timing_inputs["consensus_slab"] = (clone(args), kw)
            thr = lambda v: thr_closed_form(v, state3["lut_delta"], kw["rel"], kw["div"], kw["hi_const"])  # noqa: E731
            _, nbs = intra_descriptors(tuple(map(own, planes)), thr)
            ct, dt = color_desc_thresholds(args[6], args[7], False, kw["min_cd"], kw["desc_off"])
            good, _, _ = sample_good_ref(tuple(map(own, planes)), p_out[5], p_out[6], p_out[3], nbs, thr, ct, dt)
            # the owned rows' bytes: the halo rows the stencils read (2 of the
            # 8 above and below) add 2 % and are left out of the bound
            timing_inputs["consensus_slab_bound"] = consensus_cost(
                tuple(map(own, planes)), (args[1], args[2]), (p_out[5], p_out[6]), good, args[8][None],
                4 * (1 + C) + 9, 3 + 2 * C,
            )


def shard_args(args, rank: int, plane_idx: int, vals_idx, dev):
    """A consensus call's arguments cut to shard ``rank`` of ``SHARDS``:
    argument ``plane_idx`` (the planes) as halo slabs with the edge clamp,
    ``vals_idx`` (the pending values, or None) with the ROI clamp, every
    other map its owned rows; 0-d tensors as they are. Returns (args, r0,
    h)."""
    rows, r0, h = shard_rows(rank)
    rows = rows.to(dev)
    Hc = args[plane_idx][0].shape[0]

    def cut(i, a):
        if isinstance(a, tuple):
            return tuple(cut(i, x) for x in a)
        if not isinstance(a, torch.Tensor) or a.dim() < 2:
            return a
        if i == plane_idx:
            return a.index_select(0, rows.clamp(0, Hc - 1)).contiguous()
        if i == vals_idx:
            return a.index_select(0, rows.clamp(2, Hc - 3)).contiguous()
        return a[..., r0 : r0 + h, :].contiguous()

    return tuple(cut(i, a) for i, a in enumerate(args)), r0, h


def check_slab_kernels(frames, dev, errs, timing_inputs) -> None:
    """Phase 3: LOBSTER's consensus and the v3 walk in slab mode (E = the
    sharded path's halo) on the halo slabs of shards 0, 1 and 3 of 4, and
    of shard 1 at the ragged width W - 6, C = 3 and 1, on the arguments a
    720p step gives them (the state after 3 frames, frame 4): each output
    equal to the plain version's slab mode and to the unsharded kernel's
    rows, exactly."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.bgs import lbsp_family as LF
    from tracking_tpu_torch.ops.consensus import (
        color_desc_thresholds, consensus_lobster, consensus_lobster_ref, consensus_read, consensus_read_ref,
        intra_descriptors, sample_good_lobster_ref, sample_good_ref, thr_closed_form, thr_lobster,
    )
    from tracking_tpu_torch.parallel.spatial import HALO

    def slab_bound(name, s_args, p_out, kw, h):
        """(bound_ms, bound_by) of the call on shard 1's owned rows (the
        halo rows the stencils read add ~2 % and are left out), counted as
        phase 3 counts the unsharded call."""
        planes = tuple(p[HALO : HALO + h] for p in s_args[0])
        c, hw_s = len(planes), h * W
        if name == "consensus_lobster":
            thr = lambda v: thr_lobster(v, kw["rel"], kw["offset"], kw["div"])  # noqa: E731
            _, nbs = intra_descriptors(planes, thr)
            good = sample_good_lobster_ref(planes, p_out[3], p_out[4], nbs, thr,
                                           *(kw[k] for k in ("c_sc", "d_sc", "c_tot", "d_tot")))
            return consensus_cost(planes, s_args[1:3], p_out[3:5], good, kw["req"], 4 * (1 + c), 1 + 2 * c)
        _, colors, descs, lut, R, unstable, req = s_args
        thr = lambda v: thr_closed_form(v, lut, kw["rel"], kw["div"], kw["hi_const"])  # noqa: E731
        _, nbs = intra_descriptors(planes, thr)
        ct, dt = color_desc_thresholds(R, unstable, c == 1, kw["min_cd"], kw["desc_off"])
        good, _, _ = sample_good_ref(planes, colors, descs, p_out[3], nbs, thr, ct, dt)
        walked = int(examined(good, req[None]).sum())
        return bound(c * hw_s + 9 * hw_s + 3 * c * walked + 4 * (3 + c) * hw_s, walked * c * 48)

    kernels = (
        ("consensus_lobster", "LOBSTERBGS", {}, consensus_lobster, consensus_lobster_ref, 4,
         ("count", "intra", "bg_sum", "colors", "descs")),
        ("consensus_read", "subsense", {"TRACKING_TPU_CONSENSUS": "v3"}, consensus_read, consensus_read_ref, None,
         ("count", "min_desc", "min_sum", "intra")),
    )
    wr = W - 6
    for name, algo_name, env, fk, fp, vals_idx, outs in kernels:
        for c in (3, 1):
            fr = frames if c == 3 else frames[..., 0].contiguous()
            with switches(env):
                algo = get_algorithm(algo_name)()
                st = algo.warm_start(algo.init(H, W, c, device=dev), fr[0])
                for t in range(1, 4):
                    st, _, _ = algo.step(st, fr[t])
                args, kw = capture_call(LF, name, lambda: algo.step(clone(st), fr[4]))
            kw = {k: v for k, v in kw.items() if k != "row_ext"}
            full = {W: fk(*clone(args), **kw), wr: fk(*clone(crop_width(args, wr)), **kw)}
            for rank, wc in ((0, W), (1, W), (SHARDS - 1, W), (1, wr)):
                a = args if wc == W else crop_width(args, wc)
                s_args, r0, h = shard_args(a, rank, 0, vals_idx, dev)
                k_out = fk(*clone(s_args), **kw, row_ext=HALO)
                p_out = fp(*clone(s_args), **kw, row_ext=HALO)
                own = lambda x: x[..., r0 : r0 + h, :]  # noqa: E731
                rows = tuple(tuple(map(own, u)) if isinstance(u, tuple) else own(u) for u in full[wc])
                e = max(max_err(x, y) for x, y in zip(k_out, p_out))
                e_u = max(max_err(x, y) for x, y in zip(k_out, rows))
                errs[name] = max(errs[name], e)
                check(e == 0.0 and e_u == 0.0, f"{name} slab mode C={c}, shard {rank} (rows {r0}-{r0 + h - 1}, "
                                               f"halo {HALO}, {H}x{wc}): {', '.join(outs)} equal to its plain "
                                               f"version and to the unsharded kernel's rows")
                if c == 3 and rank == 1 and wc == W:
                    timing_inputs[f"{name}_slab"] = (clone(s_args), kw, slab_bound(name, s_args, p_out, kw, h))


def fill_cases(dev):
    """Phase 3's adversarial hole-fill masks, (what, background): a
    serpentine corridor that turns in every other row (one set through
    every tile row, the longest union chains), a checkerboard (every
    background pixel alone under 4-connectivity), a comb of period 33 (its
    teeth straddle the 32-px tiles; every other gap is closed at the top,
    a hole for the corner seed but not for the border seed), all
    background, all foreground, and random masks of the shapes 1 x W,
    H x 1, (H - 1) x (W - 3) and 1 x 1."""
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    gap = torch.where((yy // 2) % 2 == 0, xx == W - 1, xx == 0)
    serpentine_fg = (yy % 2 == 1) & ~gap
    comb_fg = ((xx % 33 == 32) & (yy >= 1)) | ((yy == 1) & ((xx // 33) % 2 == 1))
    cases = [
        ("a serpentine through every tile row", ~serpentine_fg),
        ("a checkerboard", (yy + xx) % 2 == 0),
        ("a 33-px comb", ~comb_fg),
        ("all background", torch.ones((H, W), dtype=torch.bool, device=dev)),
        ("all foreground", torch.zeros((H, W), dtype=torch.bool, device=dev)),
    ]
    gen = torch.Generator(device="cpu").manual_seed(7)
    for h, w in ((1, W), (H, 1), (H - 1, W - 3), (1, 1)):
        cases.append((f"random {h}x{w}", (torch.rand((h, w), generator=gen) > 0.35).to(dev)))
    cases.append(("1x1 foreground", torch.zeros((1, 1), dtype=torch.bool, device=dev)))
    return cases


def seed_masks(bg):
    """The hole fill's two seeds on ``bg``'s shape: the corner and the border."""
    corner = torch.zeros_like(bg)
    corner[0, 0] = True
    border = torch.zeros_like(bg)
    border[0, :] = border[-1, :] = border[:, 0] = border[:, -1] = True
    return {"corner": corner & bg, "border": border & bg}


def check_fill_adversarial(dev, errs) -> None:
    """Phase 3: ``flood_reach`` against its plain version on
    :func:`fill_cases`, corner and border seeds, exactly."""
    from tracking_tpu_torch.ops.fill import flood_reach, flood_reach_ref

    for what, bg in fill_cases(dev):
        reached = {}
        for name, sd in seed_masks(bg).items():
            a, b = flood_reach(bg, sd), flood_reach_ref(bg, sd)
            e = max_err(a, b)
            errs["flood_reach"] = max(errs["flood_reach"], e)
            if e != 0.0:
                raise AssertionError(f"flood_reach ({name} seed) differs on {what} (max |err| {e})")
            reached[name] = int(b.sum())
        check(True, f"flood_reach equal on {what} {tuple(bg.shape)}, {int(bg.sum())} background px; reached from "
                    f"the corner {reached['corner']}, from the border {reached['border']}")


def flooded_fgd_mask(frames, dev):
    """FGD's mask at frame 6 of the noisy clip, started without a warm
    start: its change test fires on most pixels, so the mask floods (one
    component across every tile)."""
    from tracking_tpu_torch import get_algorithm

    algo = get_algorithm("FG_0")()
    s = algo.init(H, W, C, device=dev)
    for t in range(7):
        s, mask, _ = algo.step(s, frames[t])
    return mask


def check_cc_adversarial(flooded, dev, errs) -> None:
    """Phase 3: ``label_components`` and ``label_fixpoint``, 8- and
    4-connected, against their plain versions on :func:`fill_cases` and
    their complements and on FGD's flooded mask, exactly; the fixed point
    with random initial labels (not ordered like the pixels), on the whole
    mask and on its rows of shard 1 (a shard's shape)."""
    from tracking_tpu_torch.ops.cc import label_components, label_components_ref, label_fixpoint, label_fixpoint_ref

    gen = torch.Generator(device="cpu").manual_seed(9)
    cases = [(f"the fill's {what}" + (", complement" if inv else ""), ~m if inv else m)
             for what, m in fill_cases(dev) for inv in (0, 1)]
    cases.append(("FGD's flooded mask (noisy clip, frame 6)", flooded > 0))
    _, r0, h = shard_rows(1)
    for what, fg in cases:
        parts = [fg] + ([fg[r0 : r0 + h].contiguous()] if fg.shape[0] == H else [])
        for conn in (8, 4):
            e = max_err(label_components(fg, conn), label_components_ref(fg, conn))
            errs["label_components"] = max(errs["label_components"], e)
            if e != 0.0:
                raise AssertionError(f"label_components ({conn}-conn) differs on {what} (max |err| {e})")
            for part in parts:
                big = H * W
                lab0 = torch.randint(0, big, part.shape, generator=gen, dtype=torch.int32).to(dev)
                lab0 = torch.where(part, lab0, big)
                (a, conv), (b, _) = label_fixpoint(part, lab0, big, conn), label_fixpoint_ref(part, lab0, big, conn)
                e = max_err(a, b)
                errs["label_fixpoint"] = max(errs["label_fixpoint"], e)
                if e != 0.0 or not conv:
                    raise AssertionError(f"label_fixpoint ({conn}-conn) differs on {what} {tuple(part.shape)} "
                                         f"(max |err| {e})")
        check(True, f"label_components and label_fixpoint (8, 4) equal on {what} {tuple(fg.shape)}, "
                    f"{int(fg.sum())} foreground px" + (f"; the fixed point also on rows {r0}-{r0 + h - 1}"
                                                        if len(parts) > 1 else ""))


def check_consensus_adversarial(args, kw, dev, errs) -> None:
    """Phase 3: the consensus against its plain version, exactly, on
    ``adversarial_inputs`` and on the slab mode at the ragged width."""
    from tracking_tpu_torch.ops.consensus import consensus, consensus_ref
    from tracking_tpu_torch.parallel.spatial import HALO

    planes, colors, descs, ctrl, vals, lut, R, unst, req = args
    Cn = len(planes)
    wr = W - 6
    rows, r0, h = shard_rows(1)
    rows = rows.to(dev)
    own = lambda x: x[..., r0 : r0 + h, :].contiguous()  # noqa: E731
    slab_rows = lambda ts, lo, hi: tuple(t.index_select(0, rows.clamp(lo, hi)).contiguous() for t in ts)  # noqa: E731
    slab = (slab_rows(planes, 0, H - 1), tuple(map(own, colors)), tuple(map(own, descs)), own(ctrl),
            slab_rows(vals, 2, H - 3), lut, own(R), own(unst), own(req))
    cases = [(what, a, 0) for what, a in adversarial_inputs(args)]
    cases.append((f"slab mode at the ragged width (rows {r0}-{r0 + h - 1} + halo {HALO})", crop_width(slab, wr), HALO))
    for what, a, E in cases:
        k_out = consensus(*clone(a), **kw, row_ext=E)
        p_out = consensus_ref(*clone(a), **kw, row_ext=E)
        e = max(max_err(x, y) for x, y in zip(k_out, p_out))
        errs["consensus"] = max(errs["consensus"], e)
        short = int((p_out[0] < a[8]).sum())
        check(e == 0.0, f"consensus C={Cn} {what}: all seven outputs equal (max |err| {e}); {short} px short of "
                        f"their requirement")


def check_lobster_adversarial(args, kw, dev, errs) -> None:
    """Phase 3: LOBSTER's consensus against its plain version, exactly, on
    adversarial 720p inputs built from a step's arguments (planes, colour
    banks, descriptor banks, pending log, pending values): ``req`` = N, so
    that every sample is walked; the first N - 3 colour slots far from the
    frame, so that good samples lie only in the last slots; the ragged width
    W - 6 = 1274 (no multiple of 4 or 16: the byte path of the colour copy),
    with the step's ``req`` and with N; a random 3x3-only pending log (the
    self write and the spread on random slots, the spread's fire bit on half
    the pixels), whole and at the ragged width."""
    from tracking_tpu_torch.ops.consensus import NB3_IN_NB5, consensus_lobster, consensus_lobster_ref

    planes, colors = args[0], args[1]
    Cn, N, wr = len(planes), colors[0].shape[0], W - 6
    gen = torch.Generator(device="cpu").manual_seed(7 + Cn)
    rnd = lambda hi: torch.randint(0, hi, (H, W), generator=gen)  # noqa: E731
    u3 = torch.tensor(NB3_IN_NB5)[rnd(8)]
    ctrl = (rnd(2) | rnd(N) << 1 | u3 << 7 | rnd(N) << 17).to(torch.int32).to(dev)
    vals = tuple((rnd(256) | rnd(65536) << 8 | (rnd(2) << 24 if c == 0 else 0)).to(torch.int32).to(dev)
                 for c in range(Cn))
    far = tuple(torch.cat([(p[None] ^ 0x80).expand(N - 3, -1, -1), col[N - 3 :]]) for p, col in zip(planes, colors))
    kw_n = dict(kw, req=N)
    log = args[:3] + (ctrl, vals)
    cases = [
        ("req = N", args, kw_n),
        ("good samples only in the last 3 slots", (planes, far) + args[2:], kw),
        (f"ragged width {H}x{wr}", crop_width(args, wr), kw),
        (f"ragged width {H}x{wr}, req = N", crop_width(args, wr), kw_n),
        ("a random 3x3 log", log, kw),
        (f"a random 3x3 log at the ragged width {H}x{wr}", crop_width(log, wr), kw),
    ]
    for what, a, k in cases:
        k_out = consensus_lobster(*clone(a), **k)
        p_out = consensus_lobster_ref(*clone(a), **k)
        e = max(max_err(x, y) for x, y in zip(k_out, p_out))
        errs["consensus_lobster"] = max(errs["consensus_lobster"], e)
        check(e == 0.0, f"consensus_lobster C={Cn} {what}: all five outputs equal (max |err| {e}); "
                        f"{int((p_out[0] < k['req']).sum())} px short of req = {k['req']}")


def greedy_cases(gen):
    """Phase 3's assignment inputs beside the tracker's own: 20 random gated
    32x64 matrices with many ties and whole rows gated; as the CPU tests
    build them, random gated matrices with ties and gated rows at the edge
    shapes (MAX_CELLS = 64x64, two rows a lane; 1x1, 33x7, 1x64, 64x1, 8x5,
    5x9) and structured ones - every cell equal, every row's minimum in the
    lowest open column (every open row rescanned after each pair), -0 and +0
    at random - at 32x64, 64x64, 1x1, 33x7, 1x64 and 64x1."""
    for i in range(20):
        q = torch.randint(0, 9, (32, 64), generator=gen).to(torch.float32) * 0.25
        gated = torch.rand((32, 64), generator=gen) < 0.5
        gated[torch.randint(0, 32, (4,), generator=gen)] = True
        yield f"random 32x64 #{i}", torch.where(gated, torch.tensor(1e9), q)
    for K, B in ((64, 64), (1, 1), (33, 7), (1, 64), (64, 1), (8, 5), (5, 9)):
        for i in range(3):
            q = torch.randint(0, 9, (K, B), generator=gen).to(torch.float32) * 0.25
            gated = torch.rand((K, B), generator=gen) < 0.4
            if i:
                gated[torch.randint(0, K, (2,), generator=gen)] = True
            yield f"random {K}x{B} #{i}", torch.where(gated, torch.tensor(1e9), q)
    for K, B in ((32, 64), (64, 64), (1, 1), (33, 7), (1, 64), (64, 1)):
        yield f"every cell equal {K}x{B}", torch.full((K, B), 0.5)
        off = torch.randint(0, 4, (K, 1), generator=gen).to(torch.float32) * 0.25
        yield f"row minima in one column {K}x{B}", torch.arange(B, dtype=torch.float32)[None] + off
        yield f"signed zeros {K}x{B}", torch.where(torch.rand((K, B), generator=gen) < 0.5, -0.0, 0.0)


def kernel_name(sym: str) -> str:
    """A kernel's name from its mangled symbol: the last component of a
    (namespaced) name, with its leading integral template arguments as
    <n, ...>."""
    import re

    pos, name = len(re.match(r"_ZN?", sym).group(0)), sym
    while pos < len(sym) and sym[pos].isdigit():
        digits = re.match(r"\d+", sym[pos:]).group(0)
        pos += len(digits)
        name = sym[pos : pos + int(digits)]
        pos += int(digits)
    t = re.match(r"I((?:L[ib]\d+E)+)", sym[pos:])
    return name + ("<" + ", ".join(re.findall(r"\d+", t.group(1))) + ">" if t else "")


def ptxas_table(text: str) -> list:
    """(kernel, registers, stack frame, spill stores, spill loads, shared
    bytes) from ``nvcc -Xptxas=-v`` output."""
    import re

    rows, name, frame = [], None, (0, 0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            frame = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((name, int(m.group(1)), *frame, int(smem.group(1)) if smem else 0))
            name = None
    return rows


def count_components(mask) -> int:
    from tracking_tpu_torch.ops.cc import label_components

    lab = label_components(mask)
    return int((lab == torch.arange(H * W, device=mask.device, dtype=torch.int32).reshape(H, W)).sum())


def app_args(cli, *extra):
    """The app's arguments as ``tracking-run`` parses them (the video name
    is unused: the chunks come from the caller)."""
    args, _ = cli.parse_tracking_args(["synthetic-clip", "--quiet", "--chunk", str(APP_CHUNK)] + [str(e) for e in extra])
    return args


def app_chunks(clip, a: int, b: int):
    return [clip[s : min(s + APP_CHUNK, b)] for s in range(a, b, APP_CHUNK)]


def app_masks(store):
    """``on_frame`` that keeps each frame's mask (on the card)."""
    return lambda idx, frame, fg, tracks, scores, ana: store.append(fg)


def check_ms_functions(frame_k, fg_k, hist_k, pred_k, key_k, centres_k, K: int):
    """The MS family's float sums on the card against the CPU on the same
    inputs, exactly: each track's colour mean-shift (MS, MSFG), MSPF's
    particle refinement and the templates at the frame's blob centres."""
    from tracking_tpu_torch.ops import rng
    from tracking_tpu_torch.track.meanshift import meanshift_color_refine, particle_color_refine, window_color_hist

    cpu = lambda *ts: [t.cpu() for t in ts]  # noqa: E731
    frame_c, fg_c, hist_c, pred_c, key_c, centres_c = cpu(frame_k, fg_k, hist_k, pred_k, key_k, centres_k)
    e = 0.0
    for use_fg in (False, True):
        e = max(e, max_err(meanshift_color_refine(frame_k, fg_k, hist_k, pred_k[:, 1], pred_k[:, 0], use_fg),
                           [t.to(frame_k.device) for t in meanshift_color_refine(
                               frame_c, fg_c, hist_c, pred_c[:, 1], pred_c[:, 0], use_fg)]))
    e = max(e, max_err(particle_color_refine(frame_k, fg_k, hist_k, rng.split(key_k, K), pred_k[:, 1], pred_k[:, 0],
                                             True),
                       [t.to(frame_k.device) for t in particle_color_refine(
                           frame_c, fg_c, hist_c, rng.split(key_c, K), pred_c[:, 1], pred_c[:, 0], True)]))
    e = max(e, max_err(window_color_hist(frame_k, fg_k, centres_k[:, 1], centres_k[:, 0]),
                       window_color_hist(frame_c, fg_c, centres_c[:, 1], centres_c[:, 0]).to(frame_k.device)))
    return e


def app_path(clip, frames, dev, results, out) -> None:
    """Phase 4f: the tracking app (``runner/cli.run_tracking``, the loop of
    ``tracking-run``) on synthetic chunks at 720p, and ``tracking_run`` on
    an FFV1 file where cv2 imports."""
    import shutil

    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.core.checkpoint import load_state, save_state
    from tracking_tpu_torch.ops import _native
    from tracking_tpu_torch.runner import cli
    from tracking_tpu_torch.track.kalman import default_params, kalman_predict
    from tracking_tpu_torch.track.tracker import BlobTracker, _blob_xywh
    from tracking_tpu_torch.ops.cc import extract_blobs

    print(f"[4f] the tracking app: SuBSENSE + BD_CC + CCMSPF + HistPVS + Kalman, {APP_FRAMES} frames in chunks of "
          f"{APP_CHUNK} at {H}x{W}x{C} {elapsed()}", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    _native.reset_launches()
    full = cli.run_tracking(app_chunks(clip, 0, APP_FRAMES), app_args(
        cli, "--track", f"{out}/tracks.csv", "--btgen", "RawTracks", "--bta_data", f"{out}/bta.npz"))
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    print(f"  launches: {launches}", flush=True)
    for k in MAIN_KERNELS:
        check(launches[k] > 0, f"{k} launched {launches[k]} times by the app")
        results[k]["app_launches"] = launches[k]
    n_active = int(full.trk_state["active"].sum())
    check(n_active >= 1, f"{n_active} tracks active at the end of the app's run")
    whole = open(f"{out}/tracks.csv").read()
    with open(f"{out}/bta.npz", "rb") as fh:
        n_npz = len(fh.read())
    check(whole.count("\n") > 1 and n_npz > 0, f"RawTracks CSV of {whole.count(chr(10)) - 1} rows and a bta_data "
                                                f"npz of {n_npz} bytes written")

    # resume: 16 frames, save, a fresh app state, load, 16 more
    cli.run_tracking(app_chunks(clip, 0, APP_CHUNK), app_args(
        cli, "--track", f"{out}/a.csv", "--btgen", "RawTracks", "--savestate", f"{out}/state.ckpt"))
    second = cli.run_tracking(app_chunks(clip, APP_CHUNK, APP_FRAMES), app_args(
        cli, "--track", f"{out}/b.csv", "--btgen", "RawTracks", "--loadstate", f"{out}/state.ckpt"), start=APP_CHUNK)
    joined = open(f"{out}/a.csv").read() + open(f"{out}/b.csv").read().split("\n", 1)[1]
    check(joined == whole, "the resumed run's track CSV equals the unbroken run's byte for byte")
    e = max(max_err(full.bgs_state, second.bgs_state), max_err(full.trk_state, second.trk_state))
    check(e == 0.0, f"the resumed run's BGS and tracker states equal the unbroken run's leaf by leaf (max |err| {e})")

    print(f"  {elapsed()}", flush=True)

    # FGTrainFrames: the tracker waits
    trained = cli.run_tracking(app_chunks(clip, 0, APP_CHUNK), app_args(cli, "--FGTrainFrames", APP_TRAIN))
    first = min((r[0] for r in trained.recorder.rows), default=None)
    check(first is None or first >= APP_TRAIN, f"FGTrainFrames={APP_TRAIN}: no track before frame {APP_TRAIN} "
                                               f"(first track row at frame {first})")

    # --fg FG_1: MOG1 + CCMSPF, the kernel path against the plain path
    mk, mp = [], []
    fk = cli.run_tracking(app_chunks(clip, 0, APP_CHUNK), app_args(cli, "--fg", "FG_1"), on_frame=app_masks(mk))
    fp = cli.run_tracking(app_chunks(clip, 0, APP_CHUNK), app_args(cli, "--fg", "FG_1"), use_kernels=False,
                          on_frame=app_masks(mp))
    e = max(max_err(mk, mp), max_err(fk.bgs_state, fp.bgs_state), max_err(fk.trk_state, fp.trk_state))
    share = float(torch.stack(mk[1:]).gt(0).to(torch.float32).mean())
    check(e == 0.0 and fk.recorder.rows == fp.recorder.rows,
          f"FG_1 (MOG1) + CCMSPF: masks, tracks ({len(fk.recorder.rows)} rows) and states of the kernel path equal "
          f"the plain path's over {APP_CHUNK} frames (foreground share after frame 0 {share:.4f})")
    check(0.001 < share < 0.5, f"FG_1 foreground share {share:.4f} in (0.001, 0.5)")

    print(f"  {elapsed()}", flush=True)

    # MS, MSFG, MSPF after SuBSENSE: the card against the CPU
    algo = get_algorithm(36)()
    st = algo.warm_start(algo.init(H, W, C, device=dev), frames[0])
    masks = []
    for t in range(1, 1 + APP_CHUNK):
        st, fg, _ = algo.step(st, frames[t])
        masks.append(fg)
    del st
    # the CPU run's blob tables, extracted once from the same masks on the
    # CPU and shared by the three trackers (its CC labelling is most of a
    # CPU step at 720p)
    cpu_blobs = [extract_blobs(m.cpu(), max_blobs=BlobTracker().config.maxBlobs) for m in masks]
    kp = default_params(device=dev)
    for ttype in ("MS", "MSFG", "MSPF"):
        tr = BlobTracker(trackerType=ttype)
        sk, sc = tr.init(device=dev), tr.init(device="cpu")
        e_tab, e_kal, e_fn, n_on = 0.0, 0.0, 0.0, 0
        for i in range(APP_CHUNK):
            t = i + 1
            pred = kalman_predict(sk["kx"], sk["kP"], kp)[0][:, :4]
            blobs = extract_blobs(masks[i], max_blobs=tr.config.maxBlobs)
            if i % 4 == 3:  # every 4th frame: the functions alone, on the card's inputs
                e_fn = max(e_fn, check_ms_functions(frames[t], (masks[i] > 0).to(torch.float32), sk["hist"], pred,
                                                    sk["key"], _blob_xywh(blobs), tr.config.maxTracks))
            sk, ok_ = tr.step(sk, masks[i], frames[t])
            sc, oc = tr.step(sc, masks[i].cpu(), frames[t].cpu(), blobs=cpu_blobs[i])
            exact = ("active", "ids", "age", "lost", "cand_pos", "cand_age", "next_id", "hist", "key", "cand_vel")
            e_tab = max(e_tab, max_err({k: sk[k].cpu() for k in exact}, {k: sc[k] for k in exact}),
                        max_err([ok_.active.cpu(), ok_.ids.cpu()], [oc.active, oc.ids]))
            e_kal = max(e_kal, max_err([sk["kx"].cpu(), sk["kP"].cpu()] + [getattr(ok_, f).cpu() for f in ok_._fields[2:]],
                                       [sc["kx"], sc["kP"]] + [getattr(oc, f) for f in oc._fields[2:]]))
            n_on += int(ok_.active.sum())
        check(e_fn == 0.0, f"{ttype}: the colour mean-shift, MSPF's particles and the templates equal the CPU's on "
                           f"the card's inputs of every 4th frame")
        check(e_tab == 0.0 and n_on > 0, f"{ttype}: the tracker table (templates, key, ids, ages, candidates) equals "
                                          f"the CPU run's after every frame ({n_on} active track-frames)")
        check(e_kal == 0.0, f"{ttype}: Kalman states and positions equal the CPU run's bit for bit")

    print(f"  {elapsed()}", flush=True)

    # MultiLayer: saveModel, then bg_model_preload
    path = f"{out}/multilayer.ckpt"
    ml_args = app_args(cli, "--bgs_type", 23)
    learn, trk = cli.build_modules(ml_args, ["fg:saveModel=1", f"fg:bg_model_preload={path}"])
    cli.run_tracking(app_chunks(clip, 0, APP_ML), ml_args, learn, trk)
    detect, _ = cli.build_modules(ml_args, [f"fg:bg_model_preload={path}"])
    resumed = cli.run_tracking(app_chunks(clip, APP_ML, 2 * APP_ML), ml_args, detect, trk, start=APP_ML)
    unbroken = cli.run_tracking(app_chunks(clip, 0, 2 * APP_ML), ml_args, get_algorithm(23)(), trk)
    e = max_err(unbroken.bgs_state, resumed.bgs_state)
    check(e == 0.0, f"MultiLayer saveModel -> bg_model_preload: {APP_ML} + {APP_ML} frames equal {2 * APP_ML} unbroken "
                    f"frames ({os.path.getsize(path) / 2**20:.0f} MiB model)")
    del learn, detect, resumed, unbroken

    print(f"  {elapsed()}", flush=True)

    # u32 and f16 leaves through a checkpoint on this torch
    hs, ws = min(72, H), min(128, W)
    crop = frames[:4, :hs, :ws].contiguous()
    trees = {}
    for name in ("GMG", "FGD"):
        a = get_algorithm(name)()
        s = a.warm_start(a.init(hs, ws, C, device=dev), crop[0])
        for t in range(1, 4):
            s, _, _ = a.step(s, crop[t])
        trees[name] = s
    save_state(f"{out}/leaves.ckpt", trees)
    back = load_state(f"{out}/leaves.ckpt", like=trees)
    check(max_err(trees, back) == 0.0 and back["GMG"]["colors"].dtype == torch.uint32
          and back["FGD"]["ct_P"].dtype == torch.float16,
          f"GMG's u32 colour codes and FGD's f16 planes round-trip a checkpoint on torch {torch.__version__}")

    # the app on a video file, where cv2 imports
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        print("  cv2 does not import here: the synthetic-chunk runs above are the app's run (no video file)",
              flush=True)
        return
    avi = f"{out}/clip.avi"
    vw = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"FFV1"), 30.0, (W, H))
    for f in clip[:APP_CHUNK]:
        vw.write(f)
    vw.release()
    from tracking_tpu_torch import native

    lib = native.load()
    with counted(lib, "vio_read_batch") if lib else contextlib.nullcontext([]) as reads:
        cli.tracking_run([avi, "--quiet", "--chunk", str(APP_CHUNK), "--track", f"{out}/avi.csv",
                          "--btgen", "RawTracks"])
    why = native.last_error.splitlines() if native.last_error else [""]
    reader = (f"the native reader ({len(reads)} vio_read_batch calls)" if lib else
              f"cv2 (the native library is unavailable: {next((x for x in why if 'error' in x), why[0])})")
    check(open(f"{out}/avi.csv").read() == open(f"{out}/a.csv").read(),
          f"cv2 {cv2.__version__} imports: tracking_run on an FFV1 AVI of the clip's first {APP_CHUNK} frames, read "
          f"through {reader}, gives the synthetic run's track CSV")
    check(not lib or len(reads) > 0, "the app read the file through the native reader where it builds")


def bgs_args(cli, *extra):
    """``bgs-run``'s arguments as its parser makes them (the frames come
    from the caller)."""
    return cli.bgs_parser().parse_args(["--chunk", str(BGS_CHUNK)] + [str(e) for e in extra])


def bgs_chunks(clip, a: int, b: int, chunk: int = BGS_CHUNK):
    return [clip[s : min(s + chunk, b)] for s in range(a, b, chunk)]


def collect_masks(store):
    """``on_masks`` of ``run_bgs`` that keeps each algorithm's mask chunks."""
    def on_masks(first, masks):
        for name, m in masks.items():
            store.setdefault(name, []).append(m)
    return on_masks


def joined(store, dev):
    return {name: torch.cat(ms).to(dev) for name, ms in store.items()}


def bgs_app_path(clip, frames, dev, results, out) -> None:
    """Phase 4g: ``bgs-run``'s loop (``runner/cli.run_bgs``) with the default
    config directory and with a fan-out of 12 algorithms edited between
    chunks, and ``cdnet_run`` (shrinkBGS, subsenseShrink) on JPEGs of the
    clip, at 720p."""
    import shutil

    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.core.config import config_to_xml
    from tracking_tpu_torch.ops import _native
    from tracking_tpu_torch.runner import cli
    from tracking_tpu_torch.runner.pipeline import (
        _ENABLE_FLAGS, FrameProcessor, FrameProcessorConfig, PreProcessor, PreProcessorConfig,
    )
    from tracking_tpu_torch.runner.scan import run_video

    print(f"[4g] the BGS apps: bgs-run with the default config directory and with a fan-out of {len(FANOUT) + 1} "
          f"algorithms, {BGS_FRAMES} frames in chunks of {BGS_CHUNK}, and cdnet-run, at {H}x{W}x{C} {elapsed()}",
          flush=True)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)

    # the default config directory: FrameDifference behind the PreProcessor
    k, c = {}, {}
    cli.run_bgs(bgs_chunks(clip, 0, BGS_FRAMES), bgs_args(cli, "--config_dir", f"{out}/default"),
                on_masks=collect_masks(k))
    cli.run_bgs(bgs_chunks(clip, 0, BGS_FRAMES), bgs_args(cli, "--config_dir", f"{out}/default", "--device", "cpu"),
                on_masks=collect_masks(c))
    k, c = joined(k, dev), joined(c, dev)
    share = float(k["FrameDifferenceBGS"][1:].gt(0).to(torch.float32).mean())
    check(sorted(os.listdir(f"{out}/default")) == ["FrameDifferenceBGS.xml", "FrameProcessor.xml", "PreProcessor.xml"]
          and list(k) == ["FrameDifferenceBGS"] and max_err(k, c) == 0.0,
          f"bgs-run's default config directory (written: 3 XMLs): FrameDifference's {BGS_FRAMES} masks on the card "
          f"equal the CPU run's (foreground share after frame 0 {share:.4f})")
    check(0.001 < share < 0.5, f"FrameDifference foreground share {share:.4f} in (0.001, 0.5)")

    # the fan-out, SigmaDelta enabled by an edit of the XML between the chunks
    fan = f"{out}/fanout"
    flag = {name: f for f, name in _ENABLE_FLAGS}
    pre_cfg = PreProcessorConfig(gaussianBlur=True)
    config_to_xml(FrameProcessorConfig(**{flag[n]: True for n in FANOUT}), f"{fan}/FrameProcessor.xml")
    config_to_xml(pre_cfg, f"{fan}/PreProcessor.xml")

    def edited():
        yield clip[:BGS_CHUNK]
        # the loop stages a chunk ahead: the edit is on disk before the
        # first chunk runs, and the reload after it reads the edit
        path = f"{fan}/FrameProcessor.xml"
        text = open(path).read()
        open(path, "w").write(text.replace(f"<{flag[FANOUT_ADDED]}>0<", f"<{flag[FANOUT_ADDED]}>1<"))
        yield clip[BGS_CHUNK:BGS_FRAMES]

    fk = {}
    _native.reset_launches()
    run = cli.run_bgs(edited(), bgs_args(cli, "--config_dir", fan), on_masks=collect_masks(fk))
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    print(f"  launches: {launches}", flush=True)
    for name in FANOUT_KERNELS:
        check(launches[name] > 0, f"{name} launched {launches[name]} times by the fan-out")
        results[name]["bgs_app_launches"] = launches[name]
    fk = joined(fk, dev)
    check(set(run.fp.algorithms) == set(FANOUT) | {FANOUT_ADDED} and len(fk[FANOUT_ADDED]) == BGS_FRAMES - BGS_CHUNK,
          f"the XML edit added {FANOUT_ADDED} after chunk 1: {len(run.fp.algorithms)} algorithms in chunk 2")

    pre = PreProcessor(pre_cfg)
    prepped = torch.stack([pre.process(f) for f in frames[:BGS_FRAMES]])
    e, shares = 0.0, {}
    for name in FANOUT:
        _, alone = run_video(get_algorithm(name)(), prepped)
        e = max(e, max_err(alone, fk[name]))
        shares[name] = round(float(fk[name].gt(0).to(torch.float32).mean()), 4)
    a = get_algorithm(FANOUT_ADDED)()
    st = a.warm_start(a.init(H, W, C, device=dev), prepped[BGS_CHUNK - 1])
    _, alone = run_video(a, prepped[BGS_CHUNK:], st)
    e = max(e, max_err(alone, fk[FANOUT_ADDED]))
    shares[FANOUT_ADDED] = round(float(fk[FANOUT_ADDED].gt(0).to(torch.float32).mean()), 4)
    check(e == 0.0, f"each algorithm's fan-out masks equal its own run_video on the prepped frames ({FANOUT_ADDED} "
                    f"warm-started on frame {BGS_CHUNK - 1}, as the reload does); foreground shares {shares}")
    check(0.001 < shares["SuBSENSEBGS"] < 0.5, f"SuBSENSE's foreground share in the fan-out {shares['SuBSENSEBGS']} "
                                               f"in (0.001, 0.5)")

    fp_plain = FrameProcessor({n: get_algorithm(n)() for n in FANOUT}, pre_cfg)
    _, plain = fp_plain.run(frames[:FANOUT_PLAIN], use_kernels=False)
    e = max(max_err(plain[n], fk[n][:FANOUT_PLAIN]) for n in FANOUT)
    check(e == 0.0, f"the fan-out's first {FANOUT_PLAIN} frames through the plain versions equal the kernel run's")

    prepped_cpu = torch.stack([pre.process(torch.from_numpy(f)) for f in clip[:BGS_FRAMES]])
    e = max_err(prepped, prepped_cpu.to(dev))
    for name in FLOAT_SIMPLE:
        _, m = run_video(get_algorithm(name)(), prepped_cpu)
        e = max(e, max_err(m.to(dev), fk[name]))
    ak, ac = {}, {}
    sel = "AdaptiveSelectiveBackgroundLearning"
    cli.run_bgs(bgs_chunks(clip, 0, BGS_FRAMES), bgs_args(cli, "-a", sel), on_masks=collect_masks(ak))
    cli.run_bgs(bgs_chunks(clip, 0, BGS_FRAMES), bgs_args(cli, "-a", sel, "--device", "cpu"),
                on_masks=collect_masks(ac))
    e = max(e, max_err(joined(ak, dev), joined(ac, dev)))
    check(e == 0.0, f"the blur and the float algorithms ({', '.join(FLOAT_SIMPLE)}; {sel} through -a) on the card "
                    f"equal the CPU run's over {BGS_FRAMES} frames")
    del fk, prepped, prepped_cpu, plain, fp_plain

    print(f"  {elapsed()}", flush=True)
    try:
        import cv2
    except ImportError:
        print("  cv2 does not import here: cdnet-run (JPEG in, PNG out) is not run", flush=True)
        return
    src = f"{out}/cdnet_in"
    os.makedirs(src)
    for i in range(CDNET_FRAMES):
        cv2.imwrite(f"{src}/in{i:06d}.jpg", clip[i])
    lo, hi = CDNET_ROI
    roi = ["--roi", str(lo), str(hi), "--bootstrap", str(CDNET_BOOT), "--chunk", str(BGS_CHUNK)]
    with switches({}):
        cli.cdnet_run([src, "--out", f"{out}/shrink"] + roi)
        names = sorted(os.listdir(f"{out}/shrink"))
        bins = [cv2.imread(f"{out}/shrink/{n}", cv2.IMREAD_UNCHANGED) for n in names]
        share = float(sum((b > 0).mean() for b in bins[1:]) / (len(bins) - 1))
        check(names == [f"bin{i:06d}.png" for i in range(lo, hi + 1)] and 0.001 < share < 0.5,
              f"cdnet-run shrinkBGS wrote bin{lo:06d}-bin{hi:06d}.png (foreground share {share:.4f})")
        cut = f"{out}/cdnet_cut"
        os.makedirs(cut)
        for i in range(CDNET_CPU):
            cv2.imwrite(f"{cut}/in{i:06d}.jpg", clip[i, : CDNET_CUT[0], : CDNET_CUT[1]])
        first = ["--roi", "0", str(CDNET_CPU - 1), "--bootstrap", "0"]
        cli.cdnet_run([cut, "--out", f"{out}/first_card"] + first)
        cli.cdnet_run([cut, "--out", f"{out}/first_cpu", "--device", "cpu"] + first)
        firsts = [[cv2.imread(f"{out}/first_{d}/bin{i:06d}.png", cv2.IMREAD_UNCHANGED) for i in range(CDNET_CPU)]
                  for d in ("card", "cpu")]
        check(all((a == b).all() for a, b in zip(*firsts)) and max((a > 0).mean() for a in firsts[0]) > 0.001,
              f"cdnet-run shrinkBGS: the first {CDNET_CPU} masks of the frames' top-left {CDNET_CUT[0]}x{CDNET_CUT[1]} "
              f"on the card equal the CPU run's")
        _native.reset_launches()
        cli.cdnet_run([src, "--out", f"{out}/subsenseShrink", "--bgs", "subsenseShrink"] + roi)
        torch.cuda.synchronize()
        launches = dict(_native.LAUNCHES)
    print(f"  launches: {launches}", flush=True)
    for name in ("consensus", "flood_reach"):
        check(launches[name] > 0, f"{name} launched {launches[name]} times by cdnet-run --bgs subsenseShrink")
        results[name]["cdnet_launches"] = launches[name]


BIT_VIEWS = {torch.float32: torch.int32, torch.uint32: torch.int32, torch.uint16: torch.int16}


def same_bits(a, b) -> bool:
    """Trees of tensors equal bit for bit (f32 through its int32 view: a
    signed zero or a NaN payload counts; u16 and u32, which CUDA torch
    cannot compare, through their signed views), ``b`` moved to ``a``'s
    device."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    b = b.to(a.device)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in BIT_VIEWS:
        a, b = a.view(BIT_VIEWS[a.dtype]), b.view(BIT_VIEWS[a.dtype])
    return torch.equal(a, b)


def new_algorithms_path(clip, frames, dev, results, out, tag) -> None:
    """Phase 4h: the 13 algorithms of ``bgs/gmm.py`` (MOG2, Grimson,
    Zivkovic), ``bgs/dp.py``, ``bgs/prati_mediod.py``, ``bgs/lb.py`` and
    ``bgs/vumeter.py``, each alone through ``run_video`` at 720p (CUDA
    events), the first frames of the top-left crop on the card against the
    CPU bit for bit (masks, background and state; MultiLayer's too, kernel
    #11 on the card against the CPU's plain version), and a ``run_bgs``
    fan-out from an XML directory of all 13 beside SuBSENSE: the launch
    counts of SuBSENSE's kernels, each fan-out mask against its own run,
    and the fan-out's tictoc."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.core.config import config_to_xml
    from tracking_tpu_torch.ops import _native
    from tracking_tpu_torch.runner import cli
    from tracking_tpu_torch.runner.pipeline import _ENABLE_FLAGS, FrameProcessorConfig
    from tracking_tpu_torch.runner.scan import run_video

    t_phase = time.perf_counter()
    print(f"[4h] {len(NEW_ALGOS)} algorithms in plain torch: each alone ({NEW_WARM} + {NEW_TIMED} frames), the first "
          f"{NEW_CPU} frames of the top-left {NEW_CUT[0]}x{NEW_CUT[1]} against the CPU, and a bgs-run fan-out of "
          f"them with SuBSENSE, {BGS_FRAMES} frames in chunks of {BGS_CHUNK}, at {H}x{W}x{C} {elapsed()}", flush=True)
    ms, shares = {}, {}
    for name in NEW_ALGOS:
        algo = get_algorithm(name)()
        st, _ = run_video(algo, frames[:NEW_WARM])
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        st, masks = run_video(algo, frames[NEW_WARM : NEW_WARM + NEW_TIMED], st)
        end.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end) / NEW_TIMED
        shares[name] = round(float(masks.gt(0).to(torch.float32).mean()), 4)
        leaves = [v for v in st.values() if isinstance(v, torch.Tensor)] + [
            x for v in st.values() if isinstance(v, tuple) for x in v]
        check(masks.shape == (NEW_TIMED, H, W) and masks.dtype == torch.uint8
              and set(masks.unique().tolist()) <= {0, 255}
              and all(bool(torch.isfinite(x).all()) for x in leaves if x.is_floating_point()),
              f"{name}: {NEW_TIMED} u8 0/255 masks, a finite state, foreground share {shares[name]}")
        del st, masks
    print(f"  {tag} each alone, ms/frame (CUDA events, {NEW_TIMED} frames after {NEW_WARM}): "
          + ", ".join(f"{n} {v:.3f}" for n, v in ms.items()), flush=True)

    cut = torch.from_numpy(clip[:NEW_CPU, : NEW_CUT[0], : NEW_CUT[1]].copy())
    t0 = time.perf_counter()
    for name in NEW_ALGOS:
        cfg = NEW_CUT_CFG.get(name, {})
        sk, (mk, bk) = run_video(get_algorithm(name)(**cfg), cut.to(dev), with_background=True)
        sc, (mc, bc) = run_video(get_algorithm(name)(**cfg), cut, with_background=True)
        check(same_bits((mk, bk, sk), (mc, bc, sc)),
              f"{name}{cfg or ''}: masks, background and state of the card equal the CPU's bit for bit over "
              f"{NEW_CPU} frames (foreground share {float(mc.gt(0).to(torch.float32).mean()):.4f})")
    # MultiLayer's colour distance takes XLA's exp and sqrt on both devices:
    # kernel #11 on the card equals a CPU run of the plain version
    _native.reset_launches()
    sk, (mk, bk) = run_video(get_algorithm("MultiLayerBGS")(), cut.to(dev), with_background=True)
    torch.cuda.synchronize()
    n_ml = _native.LAUNCHES["multilayer_step"]
    sc, (mc, bc) = run_video(get_algorithm("MultiLayerBGS")(), cut, with_background=True)
    check(n_ml > 0 and same_bits((mk, bk, sk), (mc, bc, sc)),
          f"MultiLayerBGS: kernel #11 ({n_ml} launches) gives masks, background and state equal to the CPU's plain "
          f"run bit for bit over {NEW_CPU} frames (up to {int(sc['n'].max())} modes, foreground share "
          f"{float(mc.gt(0).to(torch.float32).mean()):.4f})")
    print(f"  card against CPU on the crop: {time.perf_counter() - t0:.1f} s", flush=True)

    fan = f"{out}/fanout_new"
    flag = {name: f for f, name in _ENABLE_FLAGS}
    names = NEW_ALGOS + ("SuBSENSEBGS",)
    config_to_xml(FrameProcessorConfig(enableFrameDifferenceBGS=False, **{flag[n]: True for n in names}),
                  f"{fan}/FrameProcessor.xml")
    fk = {}
    _native.reset_launches()
    run = cli.run_bgs(bgs_chunks(clip, 0, BGS_FRAMES), bgs_args(cli, "--config_dir", fan), on_masks=collect_masks(fk))
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    print(f"  launches: {launches}", flush=True)
    for k in NEW_KERNELS:
        check(launches[k] == BGS_FRAMES, f"{k} launched {launches[k]} times by the fan-out of {len(names)}")
        results[k]["bgs_new_launches"] = launches[k]
    check(list(run.fp.algorithms) == [n for _, n in _ENABLE_FLAGS if n in names],
          f"the XML directory enabled {len(run.fp.algorithms)} algorithms, in the flags' order")
    fk = joined(fk, dev)
    prepped = torch.stack([run.fp.pre.process(f) for f in frames[:BGS_FRAMES]])
    e = 0.0
    for name in names:
        _, alone = run_video(get_algorithm(name)(), prepped)
        e = max(e, max_err(alone, fk[name]))
    check(e == 0.0, f"each algorithm's fan-out masks equal its own run_video over {BGS_FRAMES} frames")
    secs = run.fp.profile(frames[1 : 1 + BGS_CHUNK], repeats=2)
    print(f"  {tag} fan-out tictoc (FrameProcessor.profile, {BGS_CHUNK} frames from a fresh state each), ms/frame: "
          + ", ".join(f"{k} {v / BGS_CHUNK * 1e3:.3f}" for k, v in secs.items()), flush=True)
    print(f"  phase 4h: {time.perf_counter() - t_phase:.1f} s", flush=True)


def s15_cpu_runs():
    """Phase 4i's CPU runs on the crop (for cpu_crop_runs): each algorithm
    over S15_CPU frames, then Eigenbackground with the long history."""
    return [(name, S15_CFG.get(name, {}), S15_CPU) for name in S15_ALGOS] + [
        ("DPEigenbackgroundBGS", S15_LONG, S15_LONG["historySize"] + 1)]


def slice15_path(clip, frames, dev, results, out, tag, cpu_crop, cpu_long52) -> None:
    """Phase 4i: the nine algorithms of ``bgs/fuzzy.py``, ``bgs/t2f.py``,
    ``bgs/kde.py``, ``bgs/imbs.py`` and ``bgs/eigenbackground.py``, each
    alone through ``run_video`` at 720p (CUDA events; IMBS's
    ``label_components`` launches once per frame that starts with a model),
    the first frames of the top-left crop on the card against the CPU
    (bit for bit, Eigenbackground's basis included), and a ``run_bgs``
    fan-out from an XML directory of the nine beside SuBSENSE: the launch
    counts of SuBSENSE's, IMBS's and Eigenbackground's kernels (``contract``
    twice and ``syevd_small`` once at its PCA, ``pca_project`` once a
    frame), each fan-out mask against its own run. Eigenbackground with a
    26-frame history runs on the crop too, and with a 52-frame one on a
    120x160 crop (blocked ssytrd, slaed0's two levels of cuts), card
    against CPU, their launches counted. Eigenbackground's
    counts, read over its warm-up and timed frames alone, give the kernels
    line its launches of ``syevd_small`` and ``pca_project``."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.core.config import config_to_xml
    from tracking_tpu_torch.ops import _native
    from tracking_tpu_torch.runner import cli
    from tracking_tpu_torch.runner.pipeline import _ENABLE_FLAGS, FrameProcessorConfig
    from tracking_tpu_torch.runner.scan import run_video

    t_phase = time.perf_counter()
    print(f"[4i] {len(S15_ALGOS)} algorithms (plain torch; IMBS's components by the CC kernel): each alone "
          f"({S15_WARM} + {S15_TIMED} frames), the first {S15_CPU} frames of the top-left {NEW_CUT[0]}x{NEW_CUT[1]} "
          f"against the CPU, and a bgs-run fan-out of them with SuBSENSE, {BGS_FRAMES} frames in chunks of "
          f"{BGS_CHUNK}, at {H}x{W}x{C} {elapsed()}", flush=True)
    ms, shares = {}, {}
    eigen_kernels = ("contract", "syevd_small", "pca_project")
    for name in S15_ALGOS:
        algo = get_algorithm(name)(**S15_CFG.get(name, {}))
        _native.reset_launches()
        st, _ = run_video(algo, frames[:S15_WARM])
        torch.cuda.synchronize()
        warm = dict(_native.LAUNCHES)
        ready = bool(st["model_ready"]) if "model_ready" in st else True
        torch.cuda.synchronize()
        _native.reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        st, masks = run_video(algo, frames[S15_WARM : S15_WARM + S15_TIMED], st)
        end.record()
        torch.cuda.synchronize()
        launches = dict(_native.LAUNCHES)
        ms[name] = start.elapsed_time(end) / S15_TIMED
        shares[name] = round(float(masks.gt(0).to(torch.float32).mean()), 4)
        leaves = [v for v in st.values() if isinstance(v, torch.Tensor)] + [
            x for v in st.values() if isinstance(v, tuple) for x in v]
        labels = S15_LABELS.get(name, {0, 255})
        check(masks.shape == (S15_TIMED, H, W) and masks.dtype == torch.uint8
              and set(masks.unique().tolist()) <= labels
              and all(bool(torch.isfinite(x).all()) for x in leaves if x.is_floating_point()),
              f"{name}: {S15_TIMED} u8 masks in {sorted(labels)}, a finite state, foreground share {shares[name]}")
        if name == "DPEigenbackgroundBGS":
            got = {k: warm[k] + launches[k] for k in eigen_kernels}
            want = {"contract": 2, "syevd_small": 1, "pca_project": S15_WARM + S15_TIMED}
            check(got == want and sum(warm.values()) + sum(launches.values()) == sum(want.values()),
                  f"{name}: over its {S15_WARM} + {S15_TIMED} frames contract launched {got['contract']} times "
                  f"(the Gram product and the lift), syevd_small {got['syevd_small']} (the PCA at t = "
                  f"{S15_CFG[name]['historySize']}), pca_project {got['pca_project']} (once a frame), nothing else")
            for k in ("syevd_small", "pca_project"):
                results[k]["launches"] = got[k]
            results["contract"]["eigen_launches"] = got["contract"]
        else:
            want = S15_TIMED if name == "IndependentMultimodalBGS" else 0
            check(ready and launches["label_components"] == want and sum(launches.values()) == want,
                  f"{name}: label_components launched {launches['label_components']} times in {S15_TIMED} frames "
                  f"that start with a model (kernels launched in all: {sum(launches.values())})")
            if want:
                results["label_components"]["imbs_launches"] = launches["label_components"]
        del st, masks
    print(f"  {tag} each alone, ms/frame (CUDA events, {S15_TIMED} frames after {S15_WARM}): "
          + ", ".join(f"{n} {v:.3f}" for n, v in ms.items()), flush=True)

    cut = torch.from_numpy(clip[:S15_CPU, : NEW_CUT[0], : NEW_CUT[1]].copy())
    t0 = time.perf_counter()
    cpu_runs = [from_numpy_tree(r) for r in cpu_crop.get()]  # the CPU worker's runs, s15_cpu_runs()
    for i, name in enumerate(S15_ALGOS):
        cfg = S15_CFG.get(name, {})
        sk, (mk, bk) = run_video(get_algorithm(name)(**cfg), cut.to(dev), with_background=True)
        mc, bc, sc = cpu_runs[i]
        share = float(mc.gt(0).to(torch.float32).mean())
        check(same_bits((mk, bk, sk), (mc, bc, sc)),
              f"{name}{cfg or ''}: masks, background and state of the card equal the CPU's bit for bit over "
              f"{S15_CPU} frames (foreground share {share:.4f})")
    print(f"  card against CPU on the crop: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    name, cfg = "DPEigenbackgroundBGS", S15_LONG
    frames_long = S15_LONG["historySize"] + 1  # the PCA at the last frame, which it projects
    long_cut = torch.from_numpy(clip[:frames_long, : NEW_CUT[0], : NEW_CUT[1]].copy())
    _native.reset_launches()
    sk, (mk, bk) = run_video(get_algorithm(name)(**cfg), long_cut.to(dev), with_background=True)
    torch.cuda.synchronize()
    got = {k: _native.LAUNCHES[k] for k in eigen_kernels}
    want = {"contract": 2, "syevd_small": 1, "pca_project": frames_long}
    check(got == want and sum(_native.LAUNCHES.values()) == sum(want.values()),
          f"{name}{cfg} on the crop: contract launched {got['contract']} times, syevd_small {got['syevd_small']} "
          f"(sstedc's divide and conquer at n = {cfg['historySize']}), pca_project {got['pca_project']} in "
          f"{frames_long} frames, nothing else")
    mc, bc, sc = cpu_runs[-1]
    check(same_bits((mk, bk, sk), (mc, bc, sc)) and float(sc["basis"].abs().max()) > 0.0,
          f"{name}{cfg}: masks, background and state (the basis built at t = {cfg['historySize']}) of the card "
          f"equal the CPU's bit for bit over {frames_long} frames (foreground share "
          f"{float(mc.gt(0).to(torch.float32).mean()):.4f})")
    results["syevd_small"]["long_history_launches"] = got["syevd_small"]
    print(f"  a {cfg['historySize']}-frame history, card against CPU on the crop: {time.perf_counter() - t0:.1f} s "
          f"(the CPU's runs in the worker)", flush=True)
    t0 = time.perf_counter()
    cfg = S15_LONG52
    n52 = cfg["historySize"] + LONG52_AFTER
    (y0, x0), (ch, cw) = LONG52_AT, LONG52_CUT
    cut52 = torch.from_numpy(clip[:n52, y0 : y0 + ch, x0 : x0 + cw].copy())
    _native.reset_launches()
    sk, (mk, bk) = run_video(get_algorithm(name)(**cfg), cut52.to(dev), with_background=True)
    torch.cuda.synchronize()
    got = {k: _native.LAUNCHES[k] for k in eigen_kernels}
    want = {"contract": 2, "syevd_small": 1, "pca_project": n52}
    check(got == want and sum(_native.LAUNCHES.values()) == sum(want.values()),
          f"{name}{cfg} on the {LONG52_CUT[0]}x{LONG52_CUT[1]} crop at {LONG52_AT}: contract launched {got['contract']} times, "
          f"syevd_small {got['syevd_small']} (blocked ssytrd, slaed0's two levels of cuts at n = "
          f"{cfg['historySize']}), pca_project {got['pca_project']} in {n52} frames, nothing else")
    mc, bc, sc = from_numpy_tree(cpu_long52.get()[0])
    check(same_bits((mk, bk, sk), (mc, bc, sc)) and float(sc["basis"].abs().max()) > 0.0,
          f"{name}{cfg}: masks, background and state (the basis built at t = {cfg['historySize']}) of the card "
          f"equal the CPU's bit for bit over {n52} frames of the {LONG52_CUT[0]}x{LONG52_CUT[1]} crop (foreground "
          f"share {float(mc.gt(0).to(torch.float32).mean()):.4f})")
    results["syevd_small"]["long52_launches"] = got["syevd_small"]
    print(f"  a {cfg['historySize']}-frame history, card against CPU on the {LONG52_CUT[0]}x{LONG52_CUT[1]} crop: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    fan = f"{out}/fanout_15"
    flag = {name: f for f, name in _ENABLE_FLAGS}
    names = S15_ALGOS + ("SuBSENSEBGS",)
    config_to_xml(FrameProcessorConfig(enableFrameDifferenceBGS=False, **{flag[n]: True for n in names}),
                  f"{fan}/FrameProcessor.xml")
    for name, cfg in S15_CFG.items():
        algo = get_algorithm(name)
        config_to_xml(algo.Config(**cfg), f"{fan}/{algo.name}.xml")
    fk = {}
    _native.reset_launches()
    run = cli.run_bgs(bgs_chunks(clip, 0, BGS_FRAMES), bgs_args(cli, "--config_dir", fan), on_masks=collect_masks(fk))
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    print(f"  launches: {launches}", flush=True)
    check(list(run.fp.algorithms) == [n for _, n in _ENABLE_FLAGS if n in names],
          f"the XML directory enabled {len(run.fp.algorithms)} algorithms, in the flags' order")
    fk = joined(fk, dev)
    prepped = torch.stack([run.fp.pre.process(f) for f in frames[:BGS_FRAMES]])
    e, with_model = 0.0, 0
    for name in names:
        algo = get_algorithm(name)(**S15_CFG.get(name, {}))
        if name == "IndependentMultimodalBGS":  # frame by frame: the frames that start with a model
            st = algo.warm_start(algo.init(H, W, C, device=dev), prepped[0])
            alone = []
            for f in prepped:
                with_model += int(st["model_ready"])
                st, m, _ = algo.step(st, f)
                alone.append(m)
            alone = torch.stack(alone)
        else:
            _, alone = run_video(algo, prepped)
        e = max(e, max_err(alone, fk[name]))
    check(e == 0.0, f"each algorithm's fan-out masks equal its own run_video over {BGS_FRAMES} frames")
    for k, want in (("consensus", BGS_FRAMES), ("flood_reach", BGS_FRAMES), ("label_components", with_model),
                    ("contract", 2), ("syevd_small", 1), ("pca_project", BGS_FRAMES)):
        check(launches[k] == want and want > 0, f"{k} launched {launches[k]} times by the fan-out of {len(names)} "
                                                f"(expected {want})")
        results[k]["bgs15_launches"] = launches[k]
    secs = run.fp.profile(frames[1 : 1 + BGS_CHUNK], repeats=2)
    print(f"  {tag} fan-out tictoc (FrameProcessor.profile, {BGS_CHUNK} frames from a fresh state each), ms/frame: "
          + ", ".join(f"{k} {v / BGS_CHUNK * 1e3:.3f}" for k, v in secs.items()), flush=True)
    print(f"  phase 4i: {time.perf_counter() - t_phase:.1f} s", flush=True)


def count_by_connectivity():
    """Wrap ``label_components`` where MultiCue reaches it (``ops/cc`` for
    the boxes, ``ops/canny`` for the hysteresis) to count calls by
    connectivity; returns (the counts, a function that restores both)."""
    from tracking_tpu_torch.ops import canny, cc

    counts = {4: 0, 8: 0}
    orig = cc.label_components

    def counted(mask, connectivity=8):
        counts[connectivity] += 1
        return orig(mask, connectivity)

    cc.label_components = canny.label_components = counted

    def restore():
        cc.label_components = canny.label_components = orig

    return counts, restore


def finite(st) -> bool:
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, torch.Tensor) and t.is_floating_point():
            leaves.append(t)

    walk(st)
    return all(bool(torch.isfinite(x).all()) for x in leaves)


def same_as_plain(algo, state0, frames, span, masks, state, what) -> None:
    """Run ``algo`` over ``span`` from ``state0`` with the plain versions
    of its kernels and require its masks and its whole state to equal the
    kernel run's (``masks``, ``state``) bit for bit."""
    st, plain = clone(state0), []
    for t in span:
        st, m, _ = algo.step(st, frames[t], use_kernels=False)
        plain.append(m)
    check(same_bits((masks, state), (torch.stack(plain), st)),
          f"{what}: masks and every state leaf equal a run with the plain versions bit for bit")


def slice16_path(clip, frames, dev, results, out) -> dict:
    """Phase 4j: MultiCue (``bgs/multicue.py``) and LbpMrf
    (``bgs/lbp_mrf.py``), each alone at 720p (MultiCue at its defaults:
    21 training frames, then detection frames each launching
    ``label_components`` once 4-connected and twice 8-connected; LbpMrf:
    ``flood_reach`` once a frame, the min cut's drain rounds, sweeps and
    host reads a frame), the top-left crop on the card against a CPU run,
    and a ``run_bgs`` fan-out of both beside SuBSENSE: the launch counts,
    each fan-out mask against its own run. Returns the states for the
    timing phase."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.core.config import config_to_xml
    from tracking_tpu_torch.ops import _native, mincut
    from tracking_tpu_torch.runner import cli
    from tracking_tpu_torch.runner.pipeline import _ENABLE_FLAGS, FrameProcessorConfig
    from tracking_tpu_torch.runner.scan import run_video

    t_phase = time.perf_counter()
    print(f"[4j] MultiCue and LbpMrf (plain torch on the CC and hole-fill kernels): MultiCue alone ({S16_TRAIN} "
          f"training + {S16_DETECT} detection frames), LbpMrf alone ({S16_LBP} frames), the top-left "
          f"{NEW_CUT[0]}x{NEW_CUT[1]} against the CPU, and a bgs-run fan-out of both with SuBSENSE, {BGS_FRAMES} "
          f"frames in chunks of {BGS_CHUNK}, at {H}x{W}x{C} {elapsed()}", flush=True)
    keep = {}

    # MultiCue alone at its defaults
    mc = get_algorithm("SJN_MultiCueBGS")()
    st = mc.warm_start(mc.init(H, W, C, device=dev), frames[0])
    for t in range(1, S16_TRAIN + 1):
        st, m, _ = mc.step(st, frames[t])
    check(int(st["t"]) == S16_TRAIN + 1 and not bool(m.any()),
          f"MultiCue: {S16_TRAIN} training frames with empty masks, t = {int(st['t'])} (the end of training's extra "
          f"count)")
    keep["SJN_MultiCueBGS"] = (mc, clone(st), S16_TRAIN + 1)
    counts, restore = count_by_connectivity()
    torch.cuda.synchronize()
    _native.reset_launches()
    masks = []
    try:
        for t in range(S16_TRAIN + 1, S16_TRAIN + 1 + S16_DETECT):
            st, m, _ = mc.step(st, frames[t])
            masks.append(m)
    finally:
        torch.cuda.synchronize()
        restore()
    launches = dict(_native.LAUNCHES)
    masks = torch.stack(masks)
    share = float(masks.gt(0).to(torch.float32).mean())
    check(masks.shape == (S16_DETECT, H, W) and masks.dtype == torch.uint8 and 0.0 < share < 0.5 and finite(st),
          f"MultiCue: {S16_DETECT} u8 detection masks (soft enlarged edges), foreground share {share:.4f}, a finite "
          f"state")
    check(launches["label_components"] == 3 * S16_DETECT and counts == {4: S16_DETECT, 8: 2 * S16_DETECT}
          and launches["contract"] == 2 * S16_DETECT and sum(launches.values()) == 5 * S16_DETECT,
          f"MultiCue: label_components launched {launches['label_components']} times in {S16_DETECT} detection "
          f"frames, {counts[4]} 4-connected (the boxes) and {counts[8]} 8-connected (Canny on the frame and on the "
          f"candidate map), contract {launches['contract']} times (the enlarge's two contractions), "
          f"nothing else")
    results["contract"]["multicue_launches"] = launches["contract"]
    results["label_components"]["multicue_launches"] = launches["label_components"]
    same_as_plain(mc, keep["SJN_MultiCueBGS"][1], frames, range(S16_TRAIN + 1, S16_TRAIN + 1 + S16_DETECT), masks, st,
                  f"MultiCue: its {S16_DETECT} detection frames (the CC kernel on the "
                  f"{mc.config.reducedHeight}x{mc.config.reducedWidth} reduced map, 4- and 8-connected)")

    # LbpMrf alone
    lb = get_algorithm("LbpMrf")()
    st = lb.warm_start(lb.init(H, W, C, device=dev), frames[0])
    keep["LbpMrf"] = (lb, clone(st), 1)
    torch.cuda.synchronize()
    _native.reset_launches()
    stats, masks = [], []
    for t in range(1, 1 + S16_LBP):
        mincut.reset_stats()
        st, m, _ = lb.step(st, frames[t])
        stats.append(dict(mincut.STATS))
        masks.append(m)
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    masks = torch.stack(masks)
    shares = [round(float(x.gt(0).to(torch.float32).mean()), 4) for x in masks]
    check(masks.dtype == torch.uint8 and set(masks.unique().tolist()) <= {0, 255} and shares[0] == 0.0
          and max(shares[1:]) > 0.0 and finite(st),
          f"LbpMrf: {S16_LBP} 0/255 masks (the first empty), foreground shares {shares}, a finite state")
    check(launches["flood_reach"] == S16_LBP and launches["contract"] == 2 * S16_LBP
          and sum(launches.values()) == 3 * S16_LBP,
          f"LbpMrf: flood_reach launched {launches['flood_reach']} times in {S16_LBP} frames (the corner fill), "
          f"contract {launches['contract']} times (the scene-cut grid's two contractions), nothing "
          f"else")
    results["flood_reach"]["lbp_mrf_launches"] = launches["flood_reach"]
    results["contract"]["launches"] = launches["contract"]
    print(f"  LbpMrf's min cut per frame (drain rounds, distance sweeps, host reads): "
          + "; ".join(f"{s['drain_rounds']}, {s['sweeps']}, {s['host_reads']}" for s in stats), flush=True)
    same_as_plain(lb, keep["LbpMrf"][1], frames, range(1, 1 + S16_LBP), masks, st,
                  f"LbpMrf: its {S16_LBP} frames (the hole-fill kernel on its {H}x{W} masks)")

    # the crop on the card against the CPU
    t0 = time.perf_counter()
    for name in S16_ALGOS:
        cfg = S16_CUT_CFG.get(name, {})
        cut = torch.from_numpy(clip[: S16_CPU[name], : NEW_CUT[0], : NEW_CUT[1]].copy())
        sk, (mk, bk) = run_video(get_algorithm(name)(**cfg), cut.to(dev), with_background=True)
        sc, (mc_, bc) = run_video(get_algorithm(name)(**cfg), cut, with_background=True)
        share = float(mc_.gt(0).to(torch.float32).mean())
        check(same_bits((mk, bk, sk), (mc_, bc, sc)) and (share > 0.0 or name == "LbpMrf"),
              f"{name}{cfg}: masks, background and state (the scene-cut grid included) of the card equal the "
              f"CPU's bit for bit over {S16_CPU[name]} frames (foreground share {share:.4f})")
    print(f"  card against CPU on the crop: {time.perf_counter() - t0:.1f} s", flush=True)

    # the fan-out with SuBSENSE
    fan = f"{out}/fanout_16"
    flag = {name: f for f, name in _ENABLE_FLAGS}
    names = S16_ALGOS + ("SuBSENSEBGS",)
    config_to_xml(FrameProcessorConfig(enableFrameDifferenceBGS=False, **{flag[n]: True for n in names}),
                  f"{fan}/FrameProcessor.xml")
    for name, cfg in S16_FAN_CFG.items():
        algo = get_algorithm(name)
        config_to_xml(algo.Config(**cfg), f"{fan}/{algo.name}.xml")
    fk = {}
    _native.reset_launches()
    run = cli.run_bgs(bgs_chunks(clip, 0, BGS_FRAMES), bgs_args(cli, "--config_dir", fan), on_masks=collect_masks(fk))
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    print(f"  launches: {launches}", flush=True)
    check(list(run.fp.algorithms) == [n for _, n in _ENABLE_FLAGS if n in names],
          f"the XML directory enabled {len(run.fp.algorithms)} algorithms, in the flags' order")
    fk = joined(fk, dev)
    prepped = torch.stack([run.fp.pre.process(f) for f in frames[:BGS_FRAMES]])
    e = 0.0
    for name in names:
        cfg = S16_FAN_CFG.get(name, {})
        _, alone = run_video(get_algorithm(name)(**cfg), prepped)
        e = max(e, max_err(alone, fk[name]))
    check(e == 0.0, f"each algorithm's fan-out masks equal its own run_video over {BGS_FRAMES} frames")
    detect = BGS_FRAMES - (S16_FAN_CFG["SJN_MultiCueBGS"]["trainingPeriod"] + 1)  # the steps past training
    for k, want in (("consensus", BGS_FRAMES), ("flood_reach", 2 * BGS_FRAMES), ("label_components", 3 * detect)):
        check(launches[k] == want, f"{k} launched {launches[k]} times by the fan-out of {len(names)} (expected "
                                   f"{want})")
        results[k]["bgs16_launches"] = launches[k]
    slice16_apps(clip, frames, dev, out)
    print(f"  phase 4j: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return keep


def slice16_apps(clip, frames, dev, out) -> None:
    """Phase 4j's apps at 720p: ``bgs-run -a LbpMrf`` (its masks against
    ``run_video``), ``tracking-run --bgs_type 34`` past MultiCue's training
    and ``--bgs_type 30`` (the launches of each detector's kernels and of
    the tracker's), ``cdnet-run --bgs lbp-mrf`` on JPEGs of the clip."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.ops import _native
    from tracking_tpu_torch.runner import cli
    from tracking_tpu_torch.runner.scan import run_video

    ak = {}
    _native.reset_launches()
    cli.run_bgs(bgs_chunks(clip, 0, BGS_CHUNK), bgs_args(cli, "-a", "LbpMrf"), on_masks=collect_masks(ak))
    torch.cuda.synchronize()
    launches = dict(_native.LAUNCHES)
    _, alone = run_video(get_algorithm("LbpMrf")(), frames[:BGS_CHUNK])
    check(launches["flood_reach"] == BGS_CHUNK and launches["contract"] == 2 * BGS_CHUNK
          and sum(launches.values()) == 3 * BGS_CHUNK and max_err(joined(ak, dev)["LbpMrf"], alone) == 0.0,
          f"bgs-run -a LbpMrf: {BGS_CHUNK} frames, flood_reach launched {launches['flood_reach']} times, "
          f"contract {launches['contract']}, the masks equal run_video's")
    # the tracker (BD_CC + CCMSPF) labels each frame once and assigns once
    for bgs_type, n, detect in ((34, APP_FRAMES, APP_FRAMES - S16_TRAIN), (30, BGS_CHUNK, 0)):
        _native.reset_launches()
        run = cli.run_tracking(app_chunks(clip, 0, n), app_args(cli, "--bgs_type", bgs_type))
        torch.cuda.synchronize()
        launches = dict(_native.LAUNCHES)
        want = {"label_components": n + 3 * detect, "greedy_assign": n, "flood_reach": n if bgs_type == 30 else 0,
                "kalman_predict": n, "kalman_update": n, "contract": 2 * (n if bgs_type == 30 else detect)}
        check(run.frames == n and {k: launches[k] for k in want} == want
              and sum(launches.values()) == sum(want.values()) and bool(torch.isfinite(run.trk_state["kx"]).all()),
              f"tracking-run --bgs_type {bgs_type}: {n} frames, launches {want} ({detect} MultiCue detection frames "
              f"with 3 labellings and an enlarge each)")
    try:
        import cv2
    except ImportError:
        print("  cv2 does not import here: cdnet-run --bgs lbp-mrf is not run", flush=True)
        return
    src = f"{out}/cdnet16_in"
    os.makedirs(src, exist_ok=True)
    for i in range(BGS_CHUNK):
        cv2.imwrite(f"{src}/in{i:06d}.jpg", clip[i])
    _native.reset_launches()
    cli.cdnet_run([src, "--out", f"{out}/lbp_mrf", "--bgs", "lbp-mrf", "--roi", "2", str(BGS_CHUNK - 1),
                   "--bootstrap", "2", "--chunk", str(BGS_CHUNK)])
    torch.cuda.synchronize()
    names = sorted(os.listdir(f"{out}/lbp_mrf"))
    bins = [cv2.imread(f"{out}/lbp_mrf/{n}", cv2.IMREAD_UNCHANGED) for n in names]
    check(names == [f"bin{i:06d}.png" for i in range(2, BGS_CHUNK)] and max((b > 0).mean() for b in bins) > 0.0
          and _native.LAUNCHES["flood_reach"] == BGS_CHUNK,
          f"cdnet-run --bgs lbp-mrf wrote bin000002-bin{BGS_CHUNK - 1:06d}.png, flood_reach launched "
          f"{_native.LAUNCHES['flood_reach']} times")


def time_slice16(keep, frames, dev, tag) -> None:
    """Phase 6 for MultiCue and LbpMrf: each step's ms/frame (CUDA events,
    in turns) and its profile, and LbpMrf's per-stage table (CUDA events
    at the stage marks of ``bgs/lbp_mrf.py``, with the min cut's drain
    rounds, distance sweeps and host reads)."""
    from tracking_tpu_torch.bgs import lbp_mrf
    from tracking_tpu_torch.ops import mincut

    t_phase = time.perf_counter()
    mc, mc_st, mc_t = keep["SJN_MultiCueBGS"]
    lb, lb_st, _ = keep["LbpMrf"]
    box = {}

    def mc_frame(t):
        box["mc"], _, _ = mc.step(box["mc"], frames[t])

    def lb_frame(t):
        box["lb"], _, _ = lb.step(box["lb"], frames[t])

    spans = {"MultiCue detection step": (mc_frame, "mc", mc_st, range(mc_t, mc_t + 8)),
             "LbpMrf step": (lb_frame, "lb", lb_st, range(1, 7))}
    ms = {k: [] for k in spans}
    for _ in range(2):
        for label, (fn, key, st0, span) in spans.items():
            box[key] = clone(st0)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for t in span:
                fn(t)
            end.record()
            torch.cuda.synchronize()
            ms[label].append(start.elapsed_time(end) / len(span))
    for label, v in ms.items():
        print(f"  {tag} {label}, in turns: {v[0]:.3f} / {v[1]:.3f} ms/frame", flush=True)

    # LbpMrf's stages, frames 1-6 from the first
    marks = []

    def hook(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    box["lb"] = clone(lb_st)
    table = {}
    lbp_mrf.stage_hook = hook
    try:
        for t in range(1, 7):
            marks.clear()
            mincut.reset_stats()
            hook("start")
            lb_frame(t)
            torch.cuda.synchronize()
            row = {name: a.elapsed_time(b) for (_, a), (name, b) in zip(marks, marks[1:])}
            row.update(mincut.STATS)
            table[t] = row
    finally:
        lbp_mrf.stage_hook = None
    stages = [k for k in table[1] if k not in mincut.STATS]
    print(f"  {tag} LbpMrf stages, ms (CUDA events at the stage marks), frames 1-6: " + ", ".join(stages)
          + "; min cut drain rounds, sweeps, host reads", flush=True)
    for t, row in table.items():
        print(f"    frame {t}: " + " ".join(f"{row[k]:.3f}" for k in stages) + f" | total "
              f"{sum(row[k] for k in stages):.3f} ms | {row['drain_rounds']} {row['sweeps']} {row['host_reads']}",
              flush=True)
    box["mc"] = clone(mc_st)
    for t in range(mc_t, mc_t + 4):
        mc_frame(t)
    profile(mc_frame, range(mc_t + 4, mc_t + 8), tag, "MultiCue detection step")
    box["lb"] = clone(lb_st)
    for t in range(1, 5):
        lb_frame(t)
    profile(lb_frame, range(5, 7), tag, "LbpMrf step")  # 17,400 kernels a frame: the profiler's own cost
    print(f"  phase 6, MultiCue and LbpMrf: {time.perf_counter() - t_phase:.1f} s", flush=True)


def time_bgs_apps(clip, frames, dev, out, tag) -> None:
    """ms/frame of ``bgs-run``'s loop with the default config directory, with
    the fan-out (after its edit: 12 algorithms), with phase 4h's fan-out
    (14), with phase 4i's (10) and with phase 4j's (3), in turns, as (T(3 chunks) − T(1 chunk)) / 2 chunks: ``run_bgs``'s
    seconds end with a synchronize, and the difference cancels the set-up
    (XMLs, states, warm starts); the first fan-out's tictoc, the three fan-outs'
    profiles; then shrinkBGS's step (CUDA events) and its profile."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.runner import cli
    from tracking_tpu_torch.runner.pipeline import FrameProcessor

    cases = (("bgs-run, default config (FrameDifference + PreProcessor)", f"{out}/default", 16),
             (f"bgs-run, fan-out of {len(FANOUT) + 1} with the blur", f"{out}/fanout", BGS_CHUNK),
             (f"bgs-run, fan-out of the {len(NEW_ALGOS)} plain-torch algorithms of phase 4h and SuBSENSE",
              f"{out}/fanout_new", BGS_CHUNK),
             (f"bgs-run, fan-out of the {len(S15_ALGOS)} algorithms of phase 4i and SuBSENSE", f"{out}/fanout_15",
              BGS_CHUNK),
             ("bgs-run, fan-out of LbpMrf, MultiCue and SuBSENSE (phase 4j)", f"{out}/fanout_16", BGS_CHUNK // 4))
    ms = {label: [] for label, _, _ in cases}
    for _ in range(2):
        for label, cfg, chunk in cases:
            args = bgs_args(cli, "--config_dir", cfg, "--chunk", chunk)
            with contextlib.redirect_stdout(io.StringIO()):
                t1 = cli.run_bgs(bgs_chunks(clip, 0, chunk, chunk), args).seconds
                t3 = cli.run_bgs(bgs_chunks(clip, 0, 3 * chunk, chunk), args).seconds
            ms[label].append((t3 - t1) / (2 * chunk) * 1e3)
    for label, v in ms.items():
        print(f"  {tag} {label}, in turns: {v[0]:.3f} / {v[1]:.3f} ms/frame = {1000 / min(v):.1f} fps", flush=True)
    # the fan-out's tictoc: each algorithm alone over a chunk from a fresh
    # state (init and warm start included), CUDA events
    fp = FrameProcessor.from_config_dir(f"{out}/fanout")
    secs = fp.profile(frames[1 : 1 + BGS_CHUNK], repeats=2)
    print(f"  {tag} fan-out tictoc (FrameProcessor.profile, {BGS_CHUNK} frames from a fresh state each), ms/frame: "
          + ", ".join(f"{k} {v / BGS_CHUNK * 1e3:.3f}" for k, v in secs.items()), flush=True)
    fan = {"s": fp.warm_start(fp.init(H, W, C, device=dev), frames[0])}

    def fan_frame(t):
        fan["s"], _ = fp.step(fan["s"], frames[t])

    for t in range(1, 9):
        fan_frame(t)
    profile(fan_frame, range(9, 13), tag, "bgs-run fan-out step")
    fp = FrameProcessor.from_config_dir(f"{out}/fanout_new")
    fan["s"] = fp.warm_start(fp.init(H, W, C, device=dev), frames[0])
    for t in range(1, 9):
        fan_frame(t)
    profile(fan_frame, range(9, 13), tag, f"bgs-run fan-out of {len(fp.algorithms)} (phase 4h) step")
    fp = FrameProcessor.from_config_dir(f"{out}/fanout_15")
    fan["s"] = fp.warm_start(fp.init(H, W, C, device=dev), frames[0])
    for t in range(1, 9):
        fan_frame(t)
    profile(fan_frame, range(9, 13), tag, f"bgs-run fan-out of {len(fp.algorithms)} (phase 4i) step", top=20)
    del fan, fp

    algo = get_algorithm("shrinkBGS")()
    box = {"s": algo.warm_start(algo.init(H, W, C, device=dev), frames[0])}

    def run_frame(t):
        box["s"], _, _ = algo.step(box["s"], frames[t])

    for t in range(1, 9):
        run_frame(t)
    st = box["s"]
    step_ms = cuda_ms(lambda: algo.step(st, frames[9]), 10)
    print(f"  {tag} shrinkBGS step: {step_ms:.3f} ms/frame (CUDA events, frame 9 on a state 8 frames in)", flush=True)
    profile(run_frame, range(9, 13), tag, "shrinkBGS step")


def time_app(clip, out, n_chunks: int = 3):
    """ms/frame of the app's second chunk (frames 16-31): the interval
    between the loop's requests for chunks 2 and 3, which covers the chunk's
    device work (the per-chunk copy waits for it), its copy and the
    recorder and analysis."""
    from tracking_tpu_torch.runner import cli

    marks = []

    def gen():
        for i in range(n_chunks):
            marks.append(time.perf_counter())
            yield clip[i * APP_CHUNK : (i + 1) * APP_CHUNK]
        marks.append(time.perf_counter())

    cli.run_tracking(gen(), app_args(cli, "--track", f"{out}/timed.csv", "--btgen", "RawTracks"))
    return (marks[2] - marks[1]) / APP_CHUNK * 1e3


def profile_app(clip, tag, out) -> None:
    """torch.profiler over the app's second chunk."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from tracking_tpu_torch.runner import cli

    prof = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    box = {}

    def gen():
        for i in range(3):
            if i == 1:
                torch.cuda.synchronize()
                prof.start()
                box["t0"] = time.perf_counter()
            if i == 2:
                box["wall"] = (time.perf_counter() - box["t0"]) * 1e6
                prof.stop()
            yield clip[i * APP_CHUNK : (i + 1) * APP_CHUNK]

    cli.run_tracking(gen(), app_args(cli, "--track", f"{out}/profiled.csv", "--btgen", "RawTracks"))
    report_profile(prof, box["wall"], APP_CHUNK, tag, "tracking app (chunk 2)")


def spatial_path(algo, tracker, state0, frames, dev, results) -> None:
    """Phase 4e: the row-sharded SuBSENSE + CCMSPF pipeline in 4 shards,
    lockstep and pipelined, against the unsharded kernel path on the same
    frames, with the launch counts zeroed just before each sharded run and
    read just after; then its first frames through the plain versions."""
    from tracking_tpu_torch.ops import _native
    from tracking_tpu_torch.parallel.spatial import HALO, N_CAND, run_video_spatial_tracked

    print(f"[4e] sharded path: {SHARDS} shards of {H // SHARDS} rows (halo {HALO}), "
          f"{SPATIAL_FRAMES} frames of SuBSENSE + CCMSPF at {H}x{W}x{C} {elapsed()}", flush=True)
    s, tr = clone(state0), tracker.init(device=dev)
    ref_masks, ref_xs, snaps = [], [], {}
    for t in range(1, SPATIAL_FRAMES + 1):
        s, fg, _ = algo.step(s, frames[t])
        tr, tracks = tracker.step(tr, fg)
        ref_masks.append(fg)
        ref_xs.append(tracks.x)
        if t in (SPATIAL_PLAIN, SPATIAL_PIPELINED, SPATIAL_FRAMES):
            snaps[t] = (clone(s), clone(tr))
    n_comp = max(count_components(m) for m in ref_masks)
    note = "" if n_comp <= N_CAND else f" - FINDING: above {N_CAND}, the sharded blob table may differ"
    print(f"  the most components in a frame: {n_comp}{note}", flush=True)

    def compare(what, out, n):
        st, ts, masks, xs = out
        check(torch.equal(masks, torch.stack(ref_masks[:n])), f"{what}: masks equal the unsharded path's ({n} frames)")
        check(torch.equal(xs, torch.stack(ref_xs[:n])), f"{what}: per-frame track x equal")
        e_t, e_s = max_err(ts, snaps[n][1]), max_err(st, snaps[n][0])
        check(e_t == 0.0 and e_s == 0.0, f"{what}: the tracker table and the gathered SuBSENSE state equal, leaf by "
                                         f"leaf (max |err| {e_t}, {e_s})")

    runs = (("lockstep", SPATIAL_FRAMES, dict()), ("pipelined", SPATIAL_PIPELINED, dict(pipelined=True)),
            ("plain versions", SPATIAL_PLAIN, dict(use_kernels=False)))
    for what, n, kw in runs:
        _native.reset_launches()
        out = run_video_spatial_tracked(algo, tracker, frames[1 : n + 1], n_shards=SHARDS, states=clone(state0),
                                        **kw)
        torch.cuda.synchronize()
        launches = dict(_native.LAUNCHES)
        print(f"  {what} launches: {launches}", flush=True)
        if what == "plain versions":
            check(sum(launches.values()) == 0, "no kernel launched through the plain versions")
        else:
            for k in SPATIAL_KERNELS:
                check(launches[k] > 0, f"{k} launched {launches[k]} times on the sharded path ({what})")
            check(launches["label_components"] == 0, "label_components launched 0 times on the sharded path")
            if what == "lockstep":
                results["label_fixpoint"]["launches"] = launches["label_fixpoint"]
                results["consensus"]["slab_mode"] = {"launches": launches["consensus"]}
                print(f"  per frame: {launches['label_fixpoint'] / n:.2f} label_fixpoint, "
                      f"{launches['consensus'] / n:.2f} consensus (slab mode) launches", flush=True)
        compare(f"sharded path, {what}", out, n)
        print(f"  {elapsed()}", flush=True)


@contextlib.contextmanager
def row_exts(module, name):
    """The ``row_ext`` of each call of ``module.name`` inside the block (a
    list that grows by one per call); the calls go through unchanged."""
    orig = getattr(module, name)
    seen = []

    def spy(*a, **k):
        seen.append(k.get("row_ext", 0))
        return orig(*a, **k)

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


def batch_streams(frames):
    """Phase 4k's streams: [B, BATCH_FRAMES, H, W, C], the main clip's
    first frames and seeded clips of their own (one seed a stream)."""
    from tracking_tpu_torch.synth import make_clip

    more = [torch.from_numpy(make_clip(BATCH_FRAMES, H, W, C, seed=s)).to(frames.device)
            for s in range(1, max(BATCH_STREAMS))]
    return torch.stack([frames[:BATCH_FRAMES]] + more)


def batch_path(streams, dev, results) -> None:
    """Phase 4k: the stream-batched runners and the LBSP family's row
    sharding at 720p, each against the streams' own unsharded kernel runs
    (masks and every state leaf), with the launch counts zeroed just before
    each run and read just after; the sharded runs' first frames again
    through the plain versions."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.bgs import lbsp_family as LF
    from tracking_tpu_torch.convert import split_states
    from tracking_tpu_torch.ops import _native
    from tracking_tpu_torch.parallel.mesh import make_mesh, run_video_batch, run_video_batch_shardmap
    from tracking_tpu_torch.parallel.spatial import HALO, run_video_spatial
    from tracking_tpu_torch.runner.scan import run_video

    B = max(BATCH_STREAMS)
    print(f"[4k] stream batching and sharded LBSP: {B} streams of {BATCH_FRAMES} frames at {H}x{W}x{C} "
          f"{elapsed()}", flush=True)
    refs = {}

    def ref(label, env, algo_name, b, n):
        """Stream b's unsharded kernel run over its first n frames."""
        if (label, b, n) not in refs:
            with switches(env):
                refs[label, b, n] = run_video(get_algorithm(algo_name)(), streams[b, :n])
        return refs[label, b, n]

    def launched(run):
        _native.reset_launches()
        out = run()
        torch.cuda.synchronize()
        return out, dict(_native.LAUNCHES)

    def same(what, out, label, env, algo_name, n, streams_idx):
        st, masks = out
        per = split_states(st, len(streams_idx)) if masks.dim() == 4 else [st]
        masks = masks if masks.dim() == 4 else masks[None]
        for i, b in enumerate(streams_idx):
            r_st, r_m = ref(label, env, algo_name, b, n)
            check(torch.equal(masks[i], r_m) and max_err(per[i], r_st) == 0.0,
                  f"{what}: stream {b}'s masks and state equal its unsharded kernel run ({n} frames, fg "
                  f"{float(r_m.gt(0).float().mean()):.4f})")

    algo = get_algorithm("subsense")()
    for n_streams in BATCH_STREAMS:
        out, la = launched(lambda: run_video_batch(algo, streams[:n_streams, :BATCH_FRAMES]))
        check(la["consensus"] == n_streams * BATCH_FRAMES and la["flood_reach"] > 0,
              f"run_video_batch, {n_streams} streams: consensus launched {la['consensus']} times, flood_reach "
              f"{la['flood_reach']}")
        same(f"run_video_batch, {n_streams} streams", out, "v1", {}, "subsense", BATCH_FRAMES, range(n_streams))
    results["consensus"]["batch_launches"] = la["consensus"]
    mesh = make_mesh(B, stream=B, device=dev)
    out, la = launched(lambda: run_video_batch_shardmap(algo, streams[:, :BATCH_FRAMES], mesh))
    check(la["consensus"] == B * BATCH_FRAMES, f"run_video_batch_shardmap on {mesh.shape}: consensus launched "
                                               f"{la['consensus']} times")
    same(f"run_video_batch_shardmap on {mesh.shape}", out, "v1", {}, "subsense", BATCH_FRAMES, range(B))
    print(f"  {elapsed()}", flush=True)

    # the sharded runs: (what, algorithm, switches, its kernel, run, streams, the plain run)
    n = SHARDED_FRAMES
    mesh2 = make_mesh(4, stream=2, device=dev)
    runs = (
        (f"run_video_batch on {mesh2.shape}", "subsense", {}, "consensus", "v1",
         lambda k, m: run_video_batch(get_algorithm("subsense")(), streams[:2, :m], mesh=mesh2, use_kernels=k),
         range(2)),
        (f"LOBSTER in {SHARDS} shards", "LOBSTERBGS", {}, "consensus_lobster", "lobster",
         lambda k, m: run_video_spatial(get_algorithm("LOBSTERBGS")(), streams[0, :m], SHARDS, use_kernels=k),
         range(1)),
        (f"SuBSENSE v3 in {SHARDS} shards", "subsense", {"TRACKING_TPU_CONSENSUS": "v3"}, "consensus_read", "v3",
         lambda k, m: run_video_spatial(get_algorithm("subsense")(), streams[0, :m], SHARDS, use_kernels=k),
         range(1)),
        (f"SuBSENSE under TRACKING_TPU_FUSED=1 in {SHARDS} shards (v1)", "subsense", {"TRACKING_TPU_FUSED": "1"},
         "consensus", "v1", None, range(1)),
    )
    for what, algo_name, env, kernel, label, run, idx in runs:
        if run is None:
            run = lambda k, m: run_video_spatial(get_algorithm("subsense")(), streams[0, :m], SHARDS,  # noqa: E731
                                                 use_kernels=k)
        with switches(env), row_exts(LF, kernel) as seen:
            out, la = launched(lambda: run(True, n))
        slab = sum(1 for e in seen if e == HALO)
        print(f"  {what} launches: {la}", flush=True)
        check(la[kernel] > 0 and la[kernel] == len(seen) == slab,
              f"{what}: {kernel} launched {la[kernel]} times, all in slab mode (halo {HALO})")
        if label == "v3":
            check(la["consensus"] == 0, f"{what}: consensus launched 0 times")
        if env.get("TRACKING_TPU_FUSED"):
            check(la["consensus_feedback"] == 0, f"{what}: consensus_feedback launched 0 times")
        else:
            results[kernel].setdefault("slab_mode", {})["launches_per_frame"] = la[kernel] / (len(idx) * n)
        same(what, out, label, {} if label == "v1" else env, algo_name, n, idx)
        if not env.get("TRACKING_TPU_FUSED"):
            with switches(env):
                out, la = launched(lambda: run(False, SHARDED_PLAIN))
            check(sum(la.values()) == 0, f"{what}: no kernel launched through the plain versions")
            same(f"{what}, plain versions", out, label, env, algo_name, SHARDED_PLAIN, idx)
        print(f"  {elapsed()}", flush=True)


def time_slab_kernels(timing_inputs, results, tag) -> None:
    """Phase 6: the slab mode of LOBSTER's consensus and of the v3 walk on
    shard 1's phase-3 slabs, kernel and plain version in turns."""
    from tracking_tpu_torch.ops.consensus import (
        consensus_lobster, consensus_lobster_ref, consensus_read, consensus_read_ref,
    )
    from tracking_tpu_torch.parallel.spatial import HALO

    for name, fk, fp in (("consensus_lobster", consensus_lobster, consensus_lobster_ref),
                         ("consensus_read", consensus_read, consensus_read_ref)):
        args, kw, (b_ms, b_by) = timing_inputs[f"{name}_slab"]
        p1 = cuda_ms(lambda: fp(*args, **kw, row_ext=HALO), 3)
        k1 = cuda_ms(lambda: fk(*args, **kw, row_ext=HALO), 20)
        k2 = cuda_ms(lambda: fk(*args, **kw, row_ext=HALO), 20)
        p2 = cuda_ms(lambda: fp(*args, **kw, row_ext=HALO), 3)
        row = results[name].setdefault("slab_mode", {})
        row.update(ms=min(k1, k2), plain_ms=min(p1, p2), bound_ms=b_ms, bound_by=b_by)
        print(f"  {tag} {name} slab mode (shard 1 of {SHARDS} + halo {HALO}): kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain {p1:.4f} / {p2:.4f} ms, bound {b_ms:.4f} ms ({b_by}) = {b_ms / row['ms']:.1%} of it "
              f"reached; unsharded {results[name]['ms']:.4f} ms", flush=True)


def time_batch(streams, dev, tag) -> None:
    """Phase 6: ``run_video_batch`` of SuBSENSE at 1, 2 and 4 streams in
    turns: wall ms a batch frame as (T(long) - T(short)) / (long - short)
    with the device synchronized (the split of the stacked state and the
    stacking cancel), aggregate and per-stream ms/frame; then each batch
    under the profiler."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.parallel.mesh import run_video_batch

    algo = get_algorithm("subsense")()
    long_, short = BATCH_TIMED
    warm = {b: run_video_batch(algo, streams[:b, :2])[0] for b in BATCH_STREAMS}

    def wall(b, m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_video_batch(algo, streams[:b, 2 : 2 + m], states=warm[b])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    ms = {b: [] for b in BATCH_STREAMS}
    for b in list(BATCH_STREAMS) + list(BATCH_STREAMS)[::-1]:
        ms[b].append((wall(b, long_) - wall(b, short)) / (long_ - short) * 1e3)
    for b, v in ms.items():
        print(f"  {tag} run_video_batch SuBSENSE, {b} stream(s) (in turns): {v[0]:.3f} / {v[1]:.3f} ms a batch "
              f"frame = {v[0] / b:.3f} / {v[1] / b:.3f} ms/frame aggregate ({1000 * b / min(v):.1f} fps), "
              f"per stream {1000 / min(v):.1f} fps", flush=True)
    for b in BATCH_STREAMS:
        profile(lambda _: run_video_batch(algo, streams[:b, 2:6], states=warm[b]), [0], tag,
                f"run_video_batch, {b} stream(s), 4 frames each with the split and stack", n_frames=4 * b)


def time_sharded_lbsp(streams, dev, tag) -> None:
    """Phase 6: LOBSTER's and SuBSENSE v3's steps unsharded and in
    ``SHARDS`` row shards (``run_video_spatial``) in turns, on the first
    stream: wall ms a frame as (T(8) - T(2)) / 6 with the device
    synchronized (the state's split and join and the threads' start
    cancel)."""
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.parallel.spatial import run_video_spatial

    fr = streams[0]
    long_, short = SPATIAL_TIMED
    for label, name, env in (("LOBSTER", "LOBSTERBGS", {}),
                             ("SuBSENSE v3", "subsense", {"TRACKING_TPU_CONSENSUS": "v3"})):
        with switches(env):
            algo = get_algorithm(name)()
            st0 = algo.warm_start(algo.init(H, W, C, device=dev), fr[0])

            def unsharded(n):
                s = clone(st0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for t in range(1, n + 1):
                    s, _, _ = algo.step(s, fr[t])
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            def sharded(n):
                st = clone(st0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_video_spatial(algo, fr[1 : n + 1], SHARDS, states=st)
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            arms = {"unsharded": unsharded, f"{SHARDS} shards": sharded}
            ms = {k: [] for k in arms}
            for arm in ("unsharded", f"{SHARDS} shards", f"{SHARDS} shards", "unsharded"):
                ms[arm].append((arms[arm](long_) - arms[arm](short)) / (long_ - short) * 1e3)
        print(f"  {tag} {label} step, unsharded · {SHARDS} shards (in turns): " + " · ".join(
            f"{v[0]:.3f} / {v[1]:.3f}" for v in ms.values()) + " ms/frame", flush=True)


def gib(n_bytes) -> str:
    return f"{n_bytes / 2**30:.2f} GiB"


def print_pool(pool, what) -> None:
    """A process group's last call: its arguments' and results' hand-offs,
    the ranks' compute (first start to last end) and each rank's device
    memory."""
    last = pool.last
    mem = "; ".join(f"rank {r}: peak {gib(m['peak_allocated'])} allocated, {gib(m['peak_reserved'])} reserved"
                    for r, m in enumerate(last["ranks"]) if "peak_allocated" in m)
    used = max((m["device_used"] for m in last["ranks"] if "device_used" in m), default=0)
    print(f"  {what}: arguments onto the ranks {last['in_s']:.3f} s, compute {last['compute_s']:.3f} s, "
          f"results back {last['out_s']:.3f} s; {mem}; the card's memory in use at the end {gib(used)} "
          f"(every process's context and cache)", flush=True)


def process_mesh_path(algo, tracker, state0, frames, streams, dev, results):
    """Phase 4m: one group of ``MESH_RANKS`` gloo processes that share the
    card runs the tracked path (1 x 4, pipelined), a 2 x 2 stream x space
    batch and a 4 x 1 stream batch, each against the thread group's run on
    the same frames, bit for bit, with each rank's launch counts set to 0
    when its call starts and read at its end; then an NCCL group over every
    card (one rank a card) runs the stream batch. Returns the gloo mesh and
    the thread mesh for the timing phase."""
    from tracking_tpu_torch.parallel.mesh import make_mesh, run_video_batch_shardmap
    from tracking_tpu_torch.parallel.spatial import run_video_batch_spatial, run_video_spatial_tracked

    t_phase = time.perf_counter()
    n, nf = MESH_RANKS, MESH_FRAMES
    batch = streams[:, :MESH_BATCH_FRAMES]
    print(f"[4m] process mesh: {n} gloo processes sharing the card (the tracked path, {nf} frames at {H}x{W}x{C} "
          f"in {n} shards of {H // n} rows; {batch.shape[0]} streams x {batch.shape[1]} frames on 2 x 2 and 4 x 1), "
          f"then NCCL over {torch.cuda.device_count()} card(s) {elapsed()}", flush=True)
    threads = make_mesh(n, stream=1, device=dev)

    def tracked(mesh):
        return run_video_spatial_tracked(algo, tracker, frames[1 : nf + 1], states=clone(state0), pipelined=True,
                                         mesh=mesh)

    # (what, run on a mesh, its kernels, consensus launches)
    runs = (("the tracked path on 1 x 4, pipelined", tracked, SPATIAL_KERNELS, n * nf),
            ("run_video_batch_spatial on 2 x 2", lambda m: run_video_batch_spatial(algo, batch, m.split(2)),
             ("consensus", "flood_reach"), batch.shape[0] * batch.shape[1] * 2),
            ("run_video_batch_shardmap on 4 x 1", lambda m: run_video_batch_shardmap(algo, batch, m.split(n)),
             ("consensus", "flood_reach"), batch.shape[0] * batch.shape[1]))
    refs = [run(threads) for _, run, _, _ in runs]
    torch.cuda.synchronize()
    print(f"  the thread group's runs {elapsed()}", flush=True)

    mesh = make_mesh(n, stream=1, device=dev, backend="gloo")
    pool = mesh.group()
    print(f"  {n} gloo processes started and joined in {pool.start_s:.2f} s", flush=True)
    for (what, run, kernels, n_cons), ref in zip(runs, refs):
        out = run(mesh)
        la = pool.last["launches"]
        print(f"  {what} launches (summed over the ranks): {la}", flush=True)
        for k in kernels:
            check(la[k] > 0, f"{what}: {k} launched {la[k]} times in the ranks")
        check(la["consensus"] == n_cons, f"{what}: consensus launched {la['consensus']} times ({n_cons} expected)")
        if kernels is SPATIAL_KERNELS:
            check(la["label_components"] == 0, f"{what}: label_components launched 0 times")
            results["label_fixpoint"]["process_mesh_launches"] = la["label_fixpoint"]
        check(same_bits(ref, out), f"{what}: masks, states{', tracks' if kernels is SPATIAL_KERNELS else ''} equal "
                                   f"the thread group's run bit for bit")
        print_pool(pool, what)

    ref12 = placed_path(algo, tracker, state0, frames, streams, mesh, threads, refs[0])
    batch12 = streams[:, :MESH_PLACED]
    thread_ref = thread_refs(algo, tracker, state0, frames, batch12, dev, {("tracked", n): refs[0]})
    t0 = time.perf_counter()
    got = reshard_chain(algo, batch12, mesh, "the reshard chain on the gloo processes")
    layouts = " -> ".join(f"{m.stream} x {m.space}" for m in chain_layouts(mesh))
    check(same_bits(thread_ref("chain", n), got),
          f"the reshard chain on {n} gloo processes ({layouts}): masks of every chunk and the final states equal the "
          f"thread mesh's chain bit for bit ({time.perf_counter() - t0:.1f} s)")
    nccl_mesh_path(algo, tracker, state0, frames, batch, refs[1], batch12, ref12, thread_ref)
    print(f"  phase 4m: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return mesh, threads


def thread_refs(algo, tracker, state0, frames, batch12, dev, known):
    """A getter of the thread meshes' references on card 0, made once each:
    ("tracked", n) the tracked path on 1 x n threads over 2 · MESH_CHUNK
    frames (pipelined, from ``state0``), ("chain", n) the reshard chain of
    ``batch12`` on n threads; ``known`` holds those made already."""
    from tracking_tpu_torch.parallel.mesh import make_mesh
    from tracking_tpu_torch.parallel.spatial import run_video_spatial_tracked

    cache = dict(known)

    def get(kind, n):
        if (kind, n) not in cache:
            threads = make_mesh(n, stream=1, device=dev)
            t0 = time.perf_counter()
            if kind == "tracked":
                cache[kind, n] = run_video_spatial_tracked(algo, tracker, frames[1 : 1 + 2 * MESH_CHUNK],
                                                           states=clone(state0), pipelined=True, mesh=threads)
            else:
                cache[kind, n] = reshard_chain(algo, batch12, threads, f"the reshard chain on {n} threads")
            torch.cuda.synchronize()
            print(f"  the thread mesh's {kind} reference on {n} ranks: {time.perf_counter() - t0:.1f} s", flush=True)
        return cache[kind, n]

    return get


def chain_placed(algo, placed, mesh, what, plain_chunk=None):
    """The placed batch's chunks of MESH_CHUNK frames through
    run_video_batch_shardmap on ``mesh``, the states kept on the ranks
    (chunk 1 from ``plain_chunk``, a tensor, where given); each call's
    consensus launches and the bytes it moved (the plain chunk's frames in,
    the masks out) checked. Returns (the last states, the masks along T,
    the states before the last chunk, the parent's device memory above its
    level before the first chunk, its largest between chunks)."""
    from tracking_tpu_torch.parallel.mesh import run_video_batch_shardmap
    from tracking_tpu_torch.parallel.placed import tensor_bytes

    pool = mesh.group()
    b, nf, ck = placed.shape[0], placed.shape[1], MESH_CHUNK
    torch.cuda.synchronize()
    base, rise = torch.cuda.memory_allocated(), 0
    st = prev = None
    masks = []
    for k in range(nf // ck):
        chunk = plain_chunk if k == 1 and plain_chunk is not None else placed.narrow(1, k * ck, ck)
        prev = st
        st, m = run_video_batch_shardmap(algo, chunk, mesh, states=st)
        last = pool.last
        moved = (tensor_bytes(chunk), tensor_bytes(m))
        check((last["bytes_in"], last["bytes_out"]) == moved,
              f"{what}, chunk {k}: {last['bytes_in']} bytes in, {last['bytes_out']} out (frames in {moved[0]}, "
              f"masks out {moved[1]}: no state)")
        check(last["launches"]["consensus"] == b * ck,
              f"{what}, chunk {k}: consensus launched {last['launches']['consensus']} times in the ranks")
        masks.append(m)
        torch.cuda.synchronize()
        rise = max(rise, torch.cuda.memory_allocated() - base)
        print_pool(pool, f"{what}, chunk {k} ({last['bytes_in']} bytes in, {last['bytes_out']} out)")
    return st, torch.cat(masks, dim=1), prev, rise


def placed_path(algo, tracker, state0, frames, streams, mesh, threads, tracked_ref):
    """Phase 4m's placed batches on the gloo processes: the 4 streams' first
    MESH_PLACED frames placed with shard_video_batch on 4 x 1 (each block
    straight to its rank) and run in chunks of MESH_CHUNK with the states
    kept on the ranks, masks and the gathered states against one thread
    group call over every frame; the last chunk again from the same state
    handle; the tracked path (1 x 4, pipelined) in chunks of MESH_CHUNK
    with both states kept, against the phase's thread run. The parent's
    device memory between chunks stays below one stream's state. Returns
    the thread group's run of the batch."""
    from tracking_tpu_torch.parallel.mesh import run_video_batch_shardmap, shard_video_batch
    from tracking_tpu_torch.parallel.placed import place, tensor_bytes
    from tracking_tpu_torch.parallel.spatial import run_video_spatial_tracked

    t0 = time.perf_counter()
    pool, nf, ck = mesh.group(), MESH_PLACED, MESH_CHUNK
    batch = streams[:, :nf]
    b = batch.shape[0]
    print(f"  placed: {b} streams x {nf} frames on {MESH_RANKS} x 1 in chunks of {ck}, states kept on the ranks; "
          f"the tracked path in chunks of {ck} {elapsed()}", flush=True)
    ref = run_video_batch_shardmap(algo, batch, threads.split(MESH_RANKS))
    one_state = tensor_bytes(state0)
    m4 = mesh.split(MESH_RANKS)
    placed = shard_video_batch(batch, m4)
    last = pool.last
    check((last["bytes_in"], last["bytes_out"]) == (tensor_bytes(batch), 0),
          f"shard_video_batch moved {last['bytes_in']} bytes in, {last['bytes_out']} out (the batch's "
          f"{tensor_bytes(batch)}, each block once)")
    print_pool(pool, "shard_video_batch of the batch")
    st, masks, prev, rise = chain_placed(algo, placed, m4, "the placed batch on 4 x 1", batch[:, ck : 2 * ck])
    check(rise < one_state, f"the parent's device memory rose {gib(rise)} over the chained calls, below one "
                            f"stream's state ({gib(one_state)})")
    again_st, again = run_video_batch_shardmap(algo, placed.narrow(1, nf - ck, ck), m4, states=prev)
    check(torch.equal(again, masks[:, nf - ck :]) and same_bits(st.gather(), again_st.gather()),
          "the same state handle run again gives the same masks and states")
    check(same_bits(ref, (st.gather(), masks)),
          f"the chained placed batch: masks of every chunk and the gathered states equal one thread group call "
          f"over {nf} frames bit for bit")
    del again_st, st, prev, placed

    # the first chunk hands the ranks state0 (a tensor tree) and keeps the
    # states there; the second runs from the placed states
    st, ts, m0, x0 = run_video_spatial_tracked(algo, tracker, place(frames[1 : 1 + ck], mesh, (None, "space")),
                                               states=clone(state0), pipelined=True, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.ipc_collect()  # the handed-over state0 clone, once the ranks have let it go
    base = torch.cuda.memory_allocated()
    st, ts, m1, x1 = run_video_spatial_tracked(algo, tracker, frames[1 + ck : 1 + MESH_FRAMES], states=st,
                                               tracker_state=ts, pipelined=True, mesh=mesh)
    torch.cuda.synchronize()
    rise = torch.cuda.memory_allocated() - base
    last = pool.last
    print_pool(pool, "the tracked path's second chunk")
    moved = (tensor_bytes(frames[1 + ck : 1 + MESH_FRAMES]), tensor_bytes((m1, x1)))
    check((last["bytes_in"], last["bytes_out"]) == moved,
          f"the tracked path's second chunk: {last['bytes_in']} bytes in, {last['bytes_out']} out (frames in "
          f"{moved[0]}, masks and tracks out {moved[1]})")
    check(rise < one_state, f"the parent's device memory rose {gib(rise)} over the tracked path's second chunk, "
                            f"below one stream's state ({gib(one_state)})")
    for k in SPATIAL_KERNELS:
        check(last["launches"][k] > 0, f"the tracked path's second chunk: {k} launched {last['launches'][k]} times")
    check(same_bits(tracked_ref, (st.gather(), ts.gather(), torch.cat([m0, m1]), torch.cat([x0, x1]))),
          "the tracked path in two chunks with both states placed: masks, states and tracks equal the thread "
          "group's run bit for bit")
    print(f"  placed: {time.perf_counter() - t0:.1f} s", flush=True)
    return ref


def chain_layouts(mesh) -> list:
    """The reshard chain's layouts of ``mesh``'s ranks: stream counts of
    RESHARD_STREAMS that divide the ranks and the batch's 4 streams, in
    order, then the first again (4 x 1, 2 x 2, 1 x 4, 4 x 1 on 4 ranks)."""
    counts = [s for s in RESHARD_STREAMS if mesh.size % s == 0]
    return [mesh.split(s) for s in counts + counts[:1]]


def chain_states_rule(m):
    """(the dims rule, the holders) a layout's runner takes the batch's
    states with: the shardmap's on one space rank, else the spatial
    batch's (rows on ``space``)."""
    from tracking_tpu_torch.parallel.spatial import row_rule

    return (lambda shape: ("stream",) + (None,) * (len(shape) - 1)) if m.space == 1 else row_rule(H, batched=True)


def reshard_chain(algo, batch, mesh, what):
    """The 4-stream batch placed once on the chain's first layout of
    ``mesh``'s ranks (``chain_layouts``) and run a chunk of frames a layout
    (the shardmap on one space rank, else the spatial batch), the frames
    narrowed from the one placement (each call reshards them) and the
    states resharded explicitly between calls. On a process mesh each
    reshard's wall, its bytes through the parent (checked 0) and
    ``bytes_moved`` (checked against the plan's count from the two metas)
    are printed; the first hop's reshard is timed in turns with a gather
    plus a new placement of the same handle; and each call's launches per
    rank. Returns (the masks along T, the gathered final states)."""
    from tracking_tpu_torch.parallel.mesh import run_video_batch_shardmap, shard_video_batch
    from tracking_tpu_torch.parallel.placed import leaves, place, plan_bytes, relaid, reshard_plan, tensor_bytes
    from tracking_tpu_torch.parallel.spatial import run_video_batch_spatial

    layouts = chain_layouts(mesh)
    ck = batch.shape[1] // len(layouts)
    procs = mesh.backend is not None
    pool = mesh.group() if procs else None
    placed = shard_video_batch(batch, layouts[0])
    st, masks = None, []
    for k, m in enumerate(layouts):
        rule = chain_states_rule(m)
        if st is not None and st.mesh.shape != m.shape:
            hop = f"{st.mesh.stream} x {st.mesh.space} -> {m.stream} x {m.space}"
            new_meta = relaid(st.meta, rule, m.shape)
            want = plan_bytes(reshard_plan(st.meta, st.mesh.shape, st.holders, new_meta, m.shape, range(m.size)))
            arms = ("reshard", "gather + place", "gather + place", "reshard") if procs and k == 1 else ("reshard",)
            state_mib = sum(leaf.dtype.itemsize * math.prod(leaf.shape) for leaf in leaves(st.meta)) / 2**20
            secs = {}
            for arm in arms:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = st.reshard(m, rule) if arm == "reshard" else place(st.gather(), m, rule)
                torch.cuda.synchronize()
                secs.setdefault(arm, []).append(time.perf_counter() - t0)
                if procs:
                    last = pool.last
                    if arm == "reshard":
                        check((last["bytes_in"], last["bytes_out"], last["bytes_moved"]) == (0, 0, want),
                              f"{what}, reshard {hop}: {last['bytes_in']} bytes in, {last['bytes_out']} out (0 "
                              f"through the parent), {last['bytes_moved']} bytes rank to rank ({want} planned)")
                    else:
                        print(f"  {what}, gather + place {hop}: the place moved {last['bytes_in']} bytes in",
                              flush=True)
                if arm == "reshard":
                    new = y
                else:
                    y.delete()
            print(f"  {what}, {hop}: " + "; ".join(f"{arm} " + " / ".join(f"{t:.3f}" for t in v) + " s"
                                                 for arm, v in secs.items())
                  + f" (in turns; {state_mib:.1f} MiB of states, {want / 2**20:.1f} MiB planned rank to rank)",
                  flush=True)
            st = new
        frames = placed.narrow(1, k * ck, ck)
        if m.space == 1:
            st, mk = run_video_batch_shardmap(algo, frames, m, states=st)
        else:
            st, mk = run_video_batch_spatial(algo, frames, m, states=st)
        masks.append(mk)
        if procs:
            last = pool.last
            check(last["bytes_out"] == tensor_bytes(mk) and last["bytes_in"] == 0,
                  f"{what}, chunk {k} on {m.stream} x {m.space}: {last['bytes_in']} bytes in, {last['bytes_out']} out "
                  f"(the masks only)")
            print(f"  {what}, chunk {k} on {m.stream} x {m.space}: launches per rank "
                  + "; ".join(f"{r}: " + ", ".join(f"{n} {c}" for n, c in rank["launches"].items() if c)
                              for r, rank in enumerate(last["ranks"])), flush=True)
    out = torch.cat(masks, dim=1), st.gather()
    placed.delete()
    st.delete()
    return out


def nccl_tracked(algo, tracker, state0, frames, nccl, ref):
    """The tracked path (SuBSENSE + CCMSPF, pipelined) on the NCCL ranks laid
    out 1 x n, one row shard a card, in two chunks of MESH_CHUNK frames with
    both states placed: masks and SuBSENSE state bit for bit against ``ref``
    (the thread mesh's run of the same shards on card 0), the tracks and
    tracker state bit for bit; each kernel's launches a frame, summed and
    per rank."""
    from tracking_tpu_torch.parallel.placed import place
    from tracking_tpu_torch.parallel.spatial import run_video_spatial_tracked

    mesh, ck, group = nccl.split(1), MESH_CHUNK, nccl.group()
    what = f"the tracked path on the NCCL mesh 1 x {mesh.size}"
    st, ts, m0, x0 = run_video_spatial_tracked(algo, tracker, place(frames[1 : 1 + ck], mesh, (None, "space")),
                                               states=clone(state0), pipelined=True, mesh=mesh)
    st, ts, m1, x1 = run_video_spatial_tracked(algo, tracker, frames[1 + ck : 1 + 2 * ck], states=st,
                                               tracker_state=ts, pipelined=True, mesh=mesh)
    la = group.last["launches"]
    print(f"  {what}, second chunk: launches a frame (summed over the ranks) "
          + ", ".join(f"{k} {la[k] / ck:g}" for k in SPATIAL_KERNELS) + "; per rank "
          + "; ".join(f"{r}: " + ", ".join(f"{k} {rank['launches'][k] / ck:g}" for k in SPATIAL_KERNELS)
                      for r, rank in enumerate(group.last["ranks"])), flush=True)
    for k in SPATIAL_KERNELS:
        check(la[k] > 0, f"{what}: {k} launched {la[k]} times in the ranks")
    check(la["label_components"] == 0, f"{what}: label_components launched 0 times")
    print_pool(group, f"{what}, second chunk")
    got = (st.gather(), ts.gather(), torch.cat([m0, m1]), torch.cat([x0, x1]))
    check(same_bits(ref[0], got[0]) and same_bits(ref[2], got[2]),
          f"{what}, 2 chunks with both states placed: masks and SuBSENSE state equal the thread mesh's run on card 0 "
          f"bit for bit")
    check(same_bits((ref[1], ref[3]), (got[1], got[3])),
          f"{what}: tracks and tracker state equal the thread mesh's bit for bit")
    st.delete()
    ts.delete()


def nccl_mesh_path(algo, tracker, state0, frames, batch, ref, batch12, ref12, thread_ref) -> None:
    """Phase 4m's NCCL part: a group of one process a card over every card
    (``make_mesh(backend="nccl")``) runs ``run_video_batch`` of the batch on
    its default mesh and, laid out a stream a card, the shardmap; each
    equals ``ref`` (the thread group's run of the batch) bit for bit. Then
    ``batch12`` placed a stream block a card and run in chunks with the
    states kept on the cards, against ``ref12``; the tracked path on 1 x n
    cards (``nccl_tracked``) and ``batch12`` through the reshard chain
    across the cards (``reshard_chain``), each against the thread mesh's
    run on card 0 (``thread_ref``). On one card that is one rank, and it
    says so."""
    import torch.distributed as dist

    from tracking_tpu_torch.parallel.mesh import make_mesh, run_video_batch, run_video_batch_shardmap, shard_video_batch

    check(dist.is_nccl_available(), "torch.distributed has NCCL")
    with make_mesh(backend="nccl") as nccl:
        group = nccl.group()
        print(f"  NCCL: {nccl.size} rank(s), one a card, mesh {nccl.shape}, started and joined in "
              f"{group.start_s:.2f} s", flush=True)
        runs = ((f"run_video_batch on the NCCL mesh {nccl.shape}", lambda: run_video_batch(algo, batch, mesh=nccl),
                 nccl.space),)
        if nccl.size > 1:
            runs += ((f"run_video_batch_shardmap on the NCCL mesh {nccl.size} x 1",
                      lambda: run_video_batch_shardmap(algo, batch, nccl.split(nccl.size)), 1),)
        for what, run, shards in runs:
            out = run()
            la = group.last["launches"]
            check(la["consensus"] == batch.shape[0] * batch.shape[1] * shards,
                  f"{what}: consensus launched {la['consensus']} times in the ranks")
            check(same_bits(ref, out), f"{what}: masks and states equal the thread group's run bit for bit")
            print_pool(group, what)
        streams_mesh = nccl.split(nccl.size)
        what = f"the placed batch on the NCCL mesh {nccl.size} x 1"
        placed = shard_video_batch(batch12, streams_mesh)
        print_pool(group, f"shard_video_batch on the NCCL mesh {nccl.size} x 1 ({group.last['bytes_in']} bytes in)")
        st, masks, _, _ = chain_placed(algo, placed, streams_mesh, what)
        check(same_bits(ref12, (st.gather(), masks)),
              f"{what}: masks of every chunk and the gathered states equal the thread group's run bit for bit")
        del st, placed
        nccl_tracked(algo, tracker, state0, frames, nccl, thread_ref("tracked", nccl.size))
        layouts = " -> ".join(f"{m.stream} x {m.space}" for m in chain_layouts(nccl))
        t0 = time.perf_counter()
        got = reshard_chain(algo, batch12, nccl, "the reshard chain on the NCCL ranks")
        check(same_bits(thread_ref("chain", nccl.size), got),
              f"the reshard chain on {nccl.size} NCCL rank(s) ({layouts}): masks of every chunk and the final states "
              f"equal the thread mesh's chain on card 0 bit for bit ({time.perf_counter() - t0:.1f} s)")
        if nccl.size < 2:
            print("  the multi-rank NCCL exchange was not run: this machine has one card (the tracked path ran in "
                  "one shard, the chain had no second layout to reshard to)", flush=True)


def nccl_only(algo, frames, dev, kind) -> None:
    """``--nccl-only``: phase 4m's NCCL part alone, for a machine with
    several cards: the thread group's references on card 0, then the NCCL
    group over every card (``nccl_mesh_path``)."""
    from tracking_tpu_torch.parallel.mesh import make_mesh, run_video_batch_shardmap
    from tracking_tpu_torch.parallel.spatial import run_video_batch_spatial
    from tracking_tpu_torch.track.tracker import BlobTracker

    streams = batch_streams(frames)
    batch, batch12 = streams[:, :MESH_BATCH_FRAMES], streams[:, :MESH_PLACED]
    print(f"[4m] NCCL alone over {torch.cuda.device_count()} card(s): {batch.shape[0]} streams x {batch.shape[1]} "
          f"frames at {H}x{W}x{C}, then {batch12.shape[1]} frames placed, the tracked path and the reshard chain "
          f"{elapsed()}", flush=True)
    ref = run_video_batch_spatial(algo, batch, make_mesh(MESH_RANKS, stream=2, device=dev))
    ref12 = run_video_batch_shardmap(algo, batch12, make_mesh(MESH_RANKS, stream=MESH_RANKS, device=dev))
    tracker = BlobTracker()
    state0 = algo.warm_start(algo.init(H, W, C, device=dev), frames[0])
    nccl_mesh_path(algo, tracker, state0, frames, batch, ref, batch12, ref12,
                   thread_refs(algo, tracker, state0, frames, batch12, dev, {}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def time_process_mesh(mesh, threads, algo, tracker, state0, frames, streams, tag) -> None:
    """Phase 6: the tracked path in 4 shards and the 4-stream batch on 4 x 1,
    on the gloo processes and on the threads, in turns, ms a frame as
    (T(6) - T(2)) / 4: for the threads the wall with the device
    synchronized (the states' split and join cancel), for the processes
    their compute, from the first rank's start to the last rank's end (the
    ranks meet in one collective before they start; each device
    synchronized), with each call's hand-offs and wall beside it; the
    processes' device memory."""
    from tracking_tpu_torch.parallel.mesh import run_video_batch_shardmap
    from tracking_tpu_torch.parallel.spatial import run_video_spatial_tracked

    long_, short = MESH_TIMED
    pool = mesh.group()
    warm = run_video_batch_shardmap(algo, streams[:, :2], threads.split(MESH_RANKS))[0]
    b = streams.shape[0]
    paths = {
        f"SuBSENSE + CCMSPF in {MESH_RANKS} shards": (
            lambda m, k: run_video_spatial_tracked(algo, tracker, frames[1 : k + 1], states=clone(state0), mesh=m), 1),
        f"run_video_batch_shardmap, {b} streams on {MESH_RANKS} x 1": (
            lambda m, k: run_video_batch_shardmap(algo, streams[:, 2 : 2 + k], m.split(MESH_RANKS), states=warm), b),
    }
    for label, (run, per) in paths.items():
        def timed(m, k):
            """(seconds of the call's wall, of its compute): the threads'
            compute is their wall."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(m, k)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return wall, (wall if m is threads else pool.last["compute_s"])

        ms = {"threads": [], "processes": []}
        calls = []
        for arm, m in (("threads", threads), ("processes", mesh), ("processes", mesh), ("threads", threads)):
            if arm == "threads":
                torch.cuda.reset_peak_memory_stats()
            w_long, c_long = timed(m, long_)
            last = pool.last
            w_short, c_short = timed(m, short)
            ms[arm].append((c_long - c_short) / (long_ - short) * 1e3 / per)
            if arm == "threads":
                peak = torch.cuda.max_memory_allocated()
            else:
                calls.append(f"{w_long:.3f} s for {long_} frames (arguments onto the ranks {last['in_s']:.3f} s, "
                             f"compute {last['compute_s']:.3f} s, results back {last['out_s']:.3f} s), "
                             f"{w_short:.3f} s for {short}")
        print(f"  {tag} {label}, {MESH_RANKS} threads · {MESH_RANKS} gloo processes on the card (in turns): "
              + " · ".join(f"{v[0]:.3f} / {v[1]:.3f}" for v in ms.values())
              + f" ms/frame{' aggregate' if per > 1 else ''} (the processes' compute); the threads' peak device "
                f"memory {gib(peak)}", flush=True)
        print(f"  {tag} {label}, the processes' calls: " + "; ".join(calls), flush=True)
        print_pool(pool, f"{tag} {label}, the processes' last call")
    time_placed(mesh, algo, streams, warm, tag)
    print(f"  {tag} the gloo group's start: {pool.start_s:.2f} s", flush=True)


def time_placed(mesh, algo, streams, warm, tag) -> None:
    """Phase 6: the 4-stream batch on the gloo processes' 4 x 1 in chunks of
    MESH_TIMED frames, its states as tensors (split, handed to the ranks and
    back at every call) against states placed on the ranks (``place``, then
    kept), in turns; each call's wall, hand-offs, compute and bytes."""
    from tracking_tpu_torch.parallel.mesh import run_video_batch_shardmap
    from tracking_tpu_torch.parallel.placed import place

    m4, pool = mesh.split(MESH_RANKS), mesh.group()

    def line(last) -> str:
        return (f"in {last['in_s']:.3f} s, compute {last['compute_s']:.3f} s, out {last['out_s']:.3f} s, "
                f"{last['bytes_in'] / 2**20:.1f} MiB in, {last['bytes_out'] / 2**20:.1f} MiB out")

    for arm in ("tensors", "placed", "placed", "tensors"):
        st = warm
        if arm == "placed":
            st = place(warm, m4, ("stream",))
            print(f"  {tag} the batch's states placed on {MESH_RANKS} x 1: {line(pool.last)}", flush=True)
        start = 2
        for k in MESH_TIMED:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = run_video_batch_shardmap(algo, streams[:, start : start + k], m4, states=st)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"  {tag} {streams.shape[0]} streams on {MESH_RANKS} x 1, states as {arm}, a chunk of {k} "
                  f"frames: wall {wall:.3f} s, {line(pool.last)}", flush=True)
            start += k


def time_spatial(algo, tracker, state0, frames, dev, timing_inputs, results, tag) -> None:
    """Phase 6 for the sharded path: label_fixpoint and the slab mode beside
    their plain versions and bounds, the unsharded consensus on the same
    state beside the slab mode, the sharded and unsharded paths' ms/frame in
    turns, the sharded path's peak memory and its kernels per frame."""
    from tracking_tpu_torch.ops.cc import label_fixpoint, label_fixpoint_ref
    from tracking_tpu_torch.ops.consensus import consensus, consensus_ref
    from tracking_tpu_torch.parallel.spatial import HALO, run_video_spatial_tracked

    fg, lab0, big, rank = timing_inputs["label_fixpoint"]
    _, r0, h = shard_rows(rank)
    time_pair("label_fixpoint", lambda: label_fixpoint(fg, lab0, big), lambda: label_fixpoint_ref(fg, lab0, big),
              50, 5, results, tag, label=f"label_fixpoint (rows {r0}-{r0 + h - 1} of the frame-3 mask)")
    n_ops, _ = device_ops(lambda: label_fixpoint(fg, lab0, big), "label_fixpoint", tag)
    check(n_ops <= 4, f"label_fixpoint takes {n_ops:.1f} device operations a call (at most 4)")
    _, r0, h = shard_rows(1)
    args, kw = timing_inputs["consensus_slab"]
    b_ms, b_by = timing_inputs["consensus_slab_bound"]
    row = {"bound_ms": b_ms, "bound_by": b_by}
    time_pair("slab", lambda: consensus(*args, **kw, row_ext=HALO),
              lambda: consensus_ref(*args, **kw, row_ext=HALO), 20, 3, {"slab": row}, tag,
              label=f"consensus slab mode (rows {r0}-{r0 + h - 1} + halo {HALO})")
    results["consensus"]["slab_mode"].update(ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=b_ms, bound_by=b_by)
    print(f"  {tag} consensus: slab mode {row['ms']:.4f} ms a shard x {SHARDS} = {SHARDS * row['ms']:.4f} ms against "
          f"{results['consensus']['ms']:.4f} ms unsharded (phase 3 state, frame 4)", flush=True)

    def unsharded(n):
        s, tr = clone(state0), tracker.init(device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(1, n + 1):
            s, fg, _ = algo.step(s, frames[t])
            tr, _ = tracker.step(tr, fg)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def sharded(n, shards=SHARDS):
        st = clone(state0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_video_spatial_tracked(algo, tracker, frames[1 : n + 1], n_shards=shards, states=st)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # ms/frame as (T(long) - T(short)) / (long - short): the state's split
    # and join and the threads' start cancel; in turns, wall time with the
    # device synchronized. One shard runs the sharded code on one thread:
    # its gap to the unsharded path is the sharded algorithm's own extra
    # work, the gap from it to 4 shards the threads'.
    long_, short = SPATIAL_TIMED
    arms = {"unsharded": unsharded, f"{SHARDS} shards": sharded, "1 shard": lambda n: sharded(n, 1)}
    ms = {k: [] for k in arms}
    for arm in ("unsharded", f"{SHARDS} shards", "1 shard", "1 shard", f"{SHARDS} shards", "unsharded"):
        if arm == f"{SHARDS} shards":
            torch.cuda.reset_peak_memory_stats()
        ms[arm].append((arms[arm](long_) - arms[arm](short)) / (long_ - short) * 1e3)
        if arm == f"{SHARDS} shards":
            peak = torch.cuda.max_memory_allocated() / 2**30
    for arm, v in ms.items():
        print(f"  {tag} SuBSENSE + CCMSPF, {arm} (in turns): {v[0]:.3f} / {v[1]:.3f} ms/frame", flush=True)
    print(f"  {tag} peak device memory of a sharded run of {long_} frames {peak:.2f} GiB", flush=True)
    profile(lambda _: run_video_spatial_tracked(algo, tracker, frames[1:4], n_shards=SHARDS, states=clone(state0)),
            [0], tag, f"sharded path ({SHARDS} shards, 3 frames with the split and join)", n_frames=3)


@contextlib.contextmanager
def counted(obj, name):
    """Count the calls of ``obj.name`` inside the block: yields a list that
    grows by one a call (``obj`` a module, a class or a ctypes library)."""
    calls = []
    fn = getattr(obj, name)

    def wrap(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    setattr(obj, name, wrap)
    try:
        yield calls
    finally:
        setattr(obj, name, fn)


def blob_chain(B, t, lab):
    """Phase 4l's evaluator chain on a table: every ``get_*`` evaluator,
    ``moment_ellipse``, ``filter_blobs`` + ``nth_blob`` + ``paint_blobs``."""
    out = {name: getattr(B, name)(t) for name in dir(B)
           if name.startswith("get_") and name not in ("get_moment", "get_num_blobs")}
    out["get_distance_from_point"] = B.get_distance_from_point(t, 320.0, 180.0)
    out["get_xy_inside"] = B.get_xy_inside(t, 320.0, 180.0)
    out["moments"] = tuple(B.get_moment(t, p, q) for p, q in ((0, 0), (1, 0), (0, 1), (2, 0), (0, 2), (1, 1)))
    out["moment_ellipse"] = B.moment_ellipse(t)
    kept = B.filter_blobs(t, B.get_area(t), B.B_GREATER, 20.0)
    out["filtered"] = tuple(kept)
    out["num"] = B.get_num_blobs(kept)
    out["nth"] = tuple(B.nth_blob(kept, B.get_perimeter(kept), 1))
    out["painted"] = B.paint_blobs(lab, kept)
    return out


def video_frames(path, max_frames=0, flip=False, roi=None):
    """The AVI decoded by cv2, flipped and cut as ``VideoSource`` does."""
    import cv2

    cap = cv2.VideoCapture(path)
    out = []
    while not max_frames or len(out) < max_frames:
        ok, f = cap.read()
        if not ok:
            break
        f = cv2.flip(f, 1) if flip else f
        out.append(f if roi is None else f[roi[1]:roi[3], roi[0]:roi[2]])
    cap.release()
    return np.stack(out)


def blobs_reader_path(frames, dev, app_out, out) -> dict:
    """Phase 4l: ``blob_properties`` on SuBSENSE's masks at 720p (kernel #3's
    labels against the plain labels, launch counts), the evaluator chain on
    the crop against a CPU run of the port, the native reader's build and,
    where it builds, its frames against cv2's and its writer. Returns the
    timing phase's inputs."""
    import cv2

    from tracking_tpu_torch import get_algorithm, native
    from tracking_tpu_torch.io.video import VideoSource
    from tracking_tpu_torch.ops import _native
    from tracking_tpu_torch.ops import blobs as B
    from tracking_tpu_torch.ops.cc import label_components, label_components_ref
    from tracking_tpu_torch.ops.color import bgr2gray_u8

    print(f"[4l] blob_properties on {BLOB_FRAMES} SuBSENSE masks at {H}x{W}, the evaluator chain on the top-left "
          f"{BLOB_CUT[0]}x{BLOB_CUT[1]} against the CPU, the native video reader and writer {elapsed()}", flush=True)
    t_phase = time.perf_counter()
    algo = get_algorithm("subsense")()
    st = algo.warm_start(algo.init(H, W, C, device=dev), frames[0])
    masks, grays = [], []
    for t in range(1, BLOB_FRAMES + 1):
        st, fg, _ = algo.step(st, frames[t])
        masks.append(fg)
        grays.append(bgr2gray_u8(frames[t]))
    torch.cuda.synchronize()
    _native.reset_launches()
    tables = [B.blob_properties(m, image=g, max_blobs=64) for m, g in zip(masks, grays)]
    torch.cuda.synchronize()
    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
    check(launches == {"label_components": BLOB_FRAMES},
          f"blob_properties launched {launches} in {BLOB_FRAMES} calls: label_components once a call, nothing else")
    plain = [B.blob_properties(m, image=g, max_blobs=64, use_kernels=False) for m, g in zip(masks, grays)]
    check(all(same_bits(a, b) for a, b in zip(tables, plain)),
          f"the {H}x{W} tables from kernel #3's labels equal those from the plain labels, every field bit for bit")
    n_valid = [int(t.valid.sum()) for t in tables]
    big = [float(t.area.max()) for t in tables]
    print(f"  blobs a frame {n_valid}, largest areas {big}, 2**24 passed by sumxx in "
          f"{sum(int((t.sumxx > 2**24).sum()) for t in tables)} blobs, by sumxy in "
          f"{sum(int((t.sumxy > 2**24).sum()) for t in tables)}", flush=True)
    check(min(n_valid) >= 1, "every mask has blobs")

    hc, wc = BLOB_CUT
    for i, (m, g) in enumerate(zip(masks, grays)):
        mc, gc = m[:hc, :wc].contiguous(), g[:hc, :wc].contiguous()
        card = blob_chain(B, B.blob_properties(mc, image=gc), label_components(mc))
        cpu = blob_chain(B, B.blob_properties(mc.cpu(), image=gc.cpu()), label_components_ref(mc.cpu()))
        bad = sorted(k for k in card if not same_bits(cpu[k], card[k]))
        if bad:
            raise AssertionError(f"crop of frame {i + 1}: the card differs from the CPU in {bad}")
    check(True, f"on the {hc}x{wc} crop of {BLOB_FRAMES} masks the card's table, every evaluator, moment_ellipse and "
                f"the filter_blobs + nth_blob + paint_blobs chain equal a CPU run of the port bit for bit")

    t0 = time.perf_counter()
    lib_path = native.build(force=True)
    if lib_path is None:
        print(f"  native.build: the compiler's reason:\n{native.last_error}", flush=True)
    print(f"  native.build() -> {lib_path} ({time.perf_counter() - t0:.1f} s)", flush=True)
    lib = native.load()
    avi = f"{app_out}/clip.avi"
    keep = {"masks": masks, "grays": grays, "avi": None}
    if not os.path.exists(avi):  # cv2 does not import: phase 4f wrote no AVI
        print(f"  the readers are not checked: no AVI {elapsed()}", flush=True)
        print(f"  phase 4l: {time.perf_counter() - t_phase:.1f} s", flush=True)
        return keep
    keep["avi"] = f"{out}/reader.avi"
    vw = cv2.VideoWriter(keep["avi"], cv2.VideoWriter_fourcc(*"FFV1"), 30.0, (W, H))
    for f in frames[:READER_FRAMES].cpu().numpy():
        vw.write(f)
    vw.release()
    if lib is None:
        print(f"  the native reader is not checked: it does not build here; files are read through cv2 "
              f"{elapsed()}", flush=True)
        print(f"  phase 4l: {time.perf_counter() - t_phase:.1f} s", flush=True)
        return keep
    for chunk, max_frames, flip, roi in READER_CASES:
        src = VideoSource(input_file=avi, enable_flip=flip, roi=roi)
        with counted(VideoSource, "_native_chunks") as opened, counted(lib, "vio_read_batch") as reads:
            got = list(src.chunks(chunk, max_frames=max_frames))
        want = video_frames(avi, max_frames, flip, roi)
        n = len(want)
        check(len(opened) == 1 and len(reads) == len(got)
              and [len(c) for c in got] == [min(chunk, n - i) for i in range(0, n, chunk)]
              and np.array_equal(np.concatenate(got), want),
              f"VideoSource.chunks({chunk}, max_frames={max_frames}) flip={flip} roi={roi}: {n} frames of "
              f"{want.shape[1]}x{want.shape[2]} through the native reader ({len(reads)} vio_read_batch calls) "
              f"equal cv2's")
    path = f"{out}/blob_masks.avi"
    w = native.VideoWriter(path, 30.0, (W, H))
    host = [m.cpu().numpy() for m in masks]
    for m in host:
        w.write(m)
    w.release()
    back = video_frames(path)
    err = float(np.abs(back[..., 1].astype(np.int32) - np.stack(host).astype(np.int32)).mean())
    check(back.shape == (BLOB_FRAMES, H, W, 3) and err < 8.0,
          f"native.VideoWriter: {BLOB_FRAMES} masks written as MJPEG decode through cv2 at {back.shape[1:]}, "
          f"mean |error| {err:.3f} levels")
    print(f"  phase 4l: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return keep


def time_blobs_reader(keep, tag) -> None:
    """Phase 6: ``blob_properties`` at 720p (CUDA events; device operations
    and device ms under the profiler), then the decode ms/frame of a 720p
    FFV1 AVI and the tracking app's ms/frame reading it (a whole run: its
    loop's seconds over its frames, the first chunk's warm-up included),
    through the native reader where it builds and through cv2, in turns."""
    from tracking_tpu_torch import native
    from tracking_tpu_torch.io.video import VideoSource
    from tracking_tpu_torch.ops import blobs as B
    from tracking_tpu_torch.runner import cli

    i = max(range(BLOB_FRAMES), key=lambda j: int(keep["masks"][j].count_nonzero()))
    m, g = keep["masks"][i], keep["grays"][i]
    ms = [cuda_ms(lambda: B.blob_properties(m, image=g), 10, 2) for _ in range(2)]
    plain_ms = cuda_ms(lambda: B.blob_properties(m, image=g, use_kernels=False), 3, 1)
    n_ops, dev_ms = device_ops(lambda: B.blob_properties(m, image=g), "blob_properties", tag, reps=5)
    print(f"  {tag} blob_properties at {H}x{W} (frame {i + 1}, {int(m.count_nonzero())} fg px, max_blobs 64): "
          f"{ms[0]:.3f} / {ms[1]:.3f} ms a call (CUDA events), {dev_ms:.4f} device ms in {n_ops:.0f} device "
          f"operations; with the plain labels {plain_ms:.3f} ms", flush=True)
    avi = keep["avi"]
    if avi is None:
        print(f"  {tag} decode and the app from a file: not timed (no AVI: cv2 does not import)", flush=True)
        return
    lib = native.load()

    @contextlib.contextmanager
    def reader(name):
        """The block reads through ``name``'s reader (checked by its calls)."""
        if name == "native":
            with counted(lib, "vio_read_batch") as calls:
                yield
        else:
            with counted_off(native), counted(VideoSource, "_prep") as calls:
                yield
        if not calls:
            raise AssertionError(f"a {name} turn did not read through {name}")

    def decode(name):
        with reader(name):
            t0 = time.perf_counter()
            n = sum(len(c) for c in VideoSource(input_file=avi).chunks(APP_CHUNK))
            return (time.perf_counter() - t0) / n * 1e3

    def app(name):
        args, mod = cli.parse_tracking_args([avi, "--quiet", "--chunk", str(APP_CHUNK)])
        algo, tracker = cli.build_modules(args, mod)
        with reader(name), contextlib.redirect_stdout(io.StringIO()):
            res = cli.run_tracking(VideoSource(input_file=avi).chunks(APP_CHUNK), args, algo, tracker)
        return res.seconds / res.frames * 1e3

    turns = ("native", "cv2", "cv2", "native") if lib else ("cv2", "cv2")
    for label, fn in (("decode", decode), ("tracking app from the file", app)):
        got = {"native": [], "cv2": []}
        for name in turns:
            got[name].append(fn(name))
        native_ms = (f"{got['native'][0]:.3f} / {got['native'][1]:.3f} ms/frame" if lib else
                     "not built here")
        print(f"  {tag} {label}, {READER_FRAMES} frames of an FFV1 AVI at {H}x{W} in chunks of {APP_CHUNK} (in turns "
              f"{', '.join(turns)}): native reader {native_ms}, cv2 {got['cv2'][0]:.3f} / {got['cv2'][1]:.3f} "
              f"ms/frame", flush=True)


@contextlib.contextmanager
def counted_off(native):
    """Inside the block ``native.load`` returns None: files go through cv2."""
    fn = native.load
    native.load = lambda: None
    try:
        yield
    finally:
        native.load = fn


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check runs only on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tracking_tpu_torch import get_algorithm
    from tracking_tpu_torch.ops.consensus import roi_map
    from tracking_tpu_torch.ops import _native
    from tracking_tpu_torch.ops.assoc import greedy_assign, greedy_assign_ref
    from tracking_tpu_torch.ops.cc import label_components, label_components_ref
    from tracking_tpu_torch.ops.consensus import (
        color_desc_thresholds, consensus, consensus_ref, intra_descriptors, sample_good_ref, thr_closed_form,
    )
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
    nvcc_out = io.StringIO()
    with contextlib.redirect_stdout(nvcc_out):
        _native.build(verbose=True, force=True)
    _native.library()
    print(f"[2] build {tag}: {time.perf_counter() - t0:.1f} s ({len(_native.sources())} sources, "
          f"nvcc {' '.join(_native.NVCC_FLAGS)})", flush=True)
    if "--ptxas" in argv:
        print(nvcc_out.getvalue(), flush=True)
    table = ptxas_table(nvcc_out.getvalue())
    print("  ptxas (registers, stack frame, spill stores / loads in bytes, static shared bytes): " + "; ".join(
        f"{k} {r}, {sf}, {ss}/{sl}, {sm}" for k, r, sf, ss, sl, sm in table), flush=True)
    for k, r, sf, ss, sl, _ in table:
        if k.startswith("fused_kernel"):
            check(ss == 0 and sl == 0, f"{k}: {r} registers, no spills")
        if k in NO_STACK:
            check(sf == 0 and ss == 0 and sl == 0, f"{k}: {r} registers, no stack frame, no spills")
    check(NO_STACK <= {k for k, *_ in table}, f"ptxas reported {', '.join(sorted(NO_STACK))}")

    t0 = time.perf_counter()
    clip = make_clip(1 + MAIN_FRAMES, H, W, C, seed=0)
    frames = torch.from_numpy(clip).to(dev)
    quiet = torch.from_numpy(make_clip(1 + MAIN_FRAMES, H, W, C, seed=0, noise=FGD_NOISE)).to(dev)
    print(f"  synthetic clips {tuple(frames.shape)}, sensor noise 2.5 and {FGD_NOISE}, in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    algo = get_algorithm("subsense")()
    if "--nccl-only" in argv:
        nccl_only(algo, frames, dev, kind)
        return
    cpu_pool = multiprocessing.get_context("spawn").Pool(CPU_WORKERS, cpu_worker_init,
                                                         (os.path.dirname(os.path.abspath(__file__)),))
    cpu_eigh = [cpu_pool.apply_async(cpu_eigh_sets, ((one,),)) for one in EIGH_SETS]
    n_cut = max(nf for _, _, nf in s15_cpu_runs())
    cpu_crop = cpu_pool.apply_async(cpu_crop_runs, (clip[:n_cut, : NEW_CUT[0], : NEW_CUT[1]], s15_cpu_runs()))
    n52 = S15_LONG52["historySize"] + LONG52_AFTER
    (y0, x0), (ch, cw) = LONG52_AT, LONG52_CUT
    cpu_long52 = cpu_pool.apply_async(cpu_crop_runs, (clip[:n52, y0 : y0 + ch, x0 : x0 + cw],
                                                      [("DPEigenbackgroundBGS", S15_LONG52, n52)]))
    tracker = BlobTracker()
    state0 = algo.warm_start(algo.init(H, W, C, device=dev), frames[0])
    results = {
        k: {"name": k, "route": "cuda", "source": SOURCES[k][0], "replaces": SOURCES[k][1], "library_ms": None}
        for k in SOURCES
    }
    # consensus_read also stands for the retired v2 walk (the same function)
    results["consensus_read"]["also_replaces"] = "attic/pallas_consensus2.py:265"
    errs = {k: 0.0 for k in SOURCES}
    bounds = {}
    hw = H * W

    # -- 3. kernels against their plain versions at the main path's shapes --
    print(f"[3] kernels vs plain versions (exact) {elapsed()}", flush=True)
    timing_inputs = {}
    for c in (3, 1):
        fr = frames if c == 3 else frames[..., 0].contiguous()
        st = algo.warm_start(algo.init(H, W, c, device=dev), fr[0])
        for t in range(1, 4):
            st, _, _ = algo.step(st, fr[t])
        planes = tuple(fr[4][..., i].contiguous() for i in range(c)) if c == 3 else (fr[4],)
        req = torch.where(roi_map(H, W, dev), algo.config.nRequiredBGSamples, 0).to(torch.int32)
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
        check_consensus_adversarial(cons_args(st), kw, dev, errs)
        if c == 3:
            timing_inputs["consensus"] = (cons_args(clone(st)), kw)
            state_for_masks = st
            thr = lambda v: thr_closed_form(v, st["lut_delta"], kw["rel"], kw["div"], kw["hi_const"])  # noqa: E731
            _, nbs = intra_descriptors(planes, thr)
            ct, dt = color_desc_thresholds(st["R"], st["unstable"], False, kw["min_cd"], kw["desc_off"])
            good, _, _ = sample_good_ref(planes, p_out[5], p_out[6], p_out[3], nbs, thr, ct, dt)
            bounds["consensus"] = consensus_cost(
                planes, (st["colors"], st["descs"]), (p_out[5], p_out[6]), good, req[None], 4 * (1 + c) + 9, 3 + 2 * c
            )
            walked = int(examined(good, req[None]).sum())
            print(f"  consensus C=3: the walk examines {walked} samples ({walked / hw:.3f} per px), "
                  f"bound {bounds['consensus'][0]:.4f} ms", flush=True)

    raw = state_for_masks["last_raw"]
    pre_flood = morph_close(raw, 3)
    bg = pre_flood == 0
    seeds = seed_masks(bg)
    for name, sd in seeds.items():
        a, b = flood_reach(bg, sd), flood_reach_ref(bg, sd)
        e = max_err(a, b)
        errs["flood_reach"] = max(errs["flood_reach"], e)
        check(e == 0.0, f"flood_reach ({name} seed) equal on a real post-close mask, {int((~b & bg).sum())} hole px")
    timing_inputs["flood_reach"] = (bg, seeds["corner"])
    check_fill_adversarial(dev, errs)

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
        sd = seed_masks(~fg)["border"]
        e = max(e, max_err(flood_reach(~fg, sd), flood_reach_ref(~fg, sd)))
        errs["label_components"] = max(errs["label_components"], e)
        errs["flood_reach"] = max(errs["flood_reach"], e)
        if e != 0.0:
            raise AssertionError(f"label_components / flood_reach differ on a random mask of density {p}")
    check(True, "label_components (8, 4) and flood_reach equal on random masks of density 0 to 1")

    gen.manual_seed(1)
    n_cases = 0
    for what, cost in greedy_cases(gen):
        cost = cost.to(dev).contiguous()
        a, b = greedy_assign(cost), greedy_assign_ref(cost)
        e = max(max_err(a[0], b[0]), max_err(a[1], b[1]))
        errs["greedy_assign"] = max(errs["greedy_assign"], e)
        if e != 0.0:
            raise AssertionError(f"greedy_assign differs on {what}")
        n_cases += 1
    check(True, f"greedy_assign equal on {n_cases} matrices: 20 random gated 32x64 with ties, the edge shapes, "
                f"structured ones")
    bounds["flood_reach"] = bound(3 * hw, 10 * hw)  # bg + seeds read, reach written (bool)
    bounds["label_components"] = bound(5 * hw, 20 * hw)  # mask read (u8), labels written (int32)
    check_registry_kernels(frames, dev, errs, timing_inputs, bounds)
    check_variant_kernels(frames, dev, errs, timing_inputs, bounds)
    check_fgd_kernel(frames, quiet, dev, errs, timing_inputs, bounds)
    timing_inputs["fgd_flooded"] = flooded_fgd_mask(frames, dev)
    check_cc_adversarial(timing_inputs["fgd_flooded"], dev, errs)
    print(f"  {elapsed()}", flush=True)
    check_spatial_kernels(algo, state_for_masks, frames, dev, errs, timing_inputs, bounds)
    check_slab_kernels(frames, dev, errs, timing_inputs)
    check_kalman_resize_kernels(frames, dev, errs, timing_inputs, bounds)
    check_pca_kernels(frames, dev, errs, timing_inputs, bounds, cpu_eigh)
    print(f"  {elapsed()}", flush=True)
    for k, (b_ms, b_by) in bounds.items():
        results[k]["bound_ms"], results[k]["bound_by"] = b_ms, b_by

    # -- 4. the main path --------------------------------------------------
    print(f"[4] main path: warm start + {MAIN_FRAMES} frames of SuBSENSE + CCMSPF at {H}x{W}x{C} {elapsed()}", flush=True)
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
    for k in MAIN_KERNELS:
        check(launches[k] > 0, f"{k} launched {launches[k]} times on the main path")
        results[k]["launches"] = launches[k]
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
    Kt, Bt = cost.shape
    results["greedy_assign"]["bound_ms"], results["greedy_assign"]["bound_by"] = bound(4 * Kt * Bt + 4 * Kt + Bt, Kt * Kt * Bt)

    # -- 4b. the registry path ---------------------------------------------
    starts = registry_path(frames, dev, results)

    # -- 4c. the consensus variants ----------------------------------------
    variant_starts = variant_paths(frames, dev, results)

    # -- 4d. the FG_0 path -------------------------------------------------
    fgd_algo, fgd_start = fgd_path(quiet, dev, results, tracker, timing_inputs)

    # -- 4e. the row-sharded path ------------------------------------------
    spatial_path(algo, tracker, state0, frames, dev, results)

    # -- 4f. the tracking app ----------------------------------------------
    app_out = os.path.join(os.path.dirname(os.path.abspath(__file__)), APP_DIR)
    app_path(clip, frames, dev, results, app_out)

    # -- 4g. the BGS apps --------------------------------------------------
    bgs_out = os.path.join(os.path.dirname(os.path.abspath(__file__)), BGS_DIR)
    bgs_app_path(clip, frames, dev, results, bgs_out)

    # -- 4h. the Gaussian-mixture, dp, Prati, VuMeter and lb algorithms ----
    new_algorithms_path(clip, frames, dev, results, bgs_out, tag)

    # -- 4i. the fuzzy, T2F, KDE, IMBS and Eigenbackground algorithms ----
    slice15_path(clip, frames, dev, results, bgs_out, tag, cpu_crop, cpu_long52)

    # -- 4j. MultiCue and LbpMrf --------------------------------------------
    s16 = slice16_path(clip, frames, dev, results, bgs_out)

    # -- 4k. stream batching and the sharded LBSP family ------------------
    streams = batch_streams(frames)
    batch_path(streams, dev, results)

    # -- 4l. the blob table and the native video reader --------------------
    blobs_keep = blobs_reader_path(frames, dev, app_out, bgs_out)

    # -- 4m. the process mesh -----------------------------------------------
    proc_mesh, thread_mesh = process_mesh_path(algo, tracker, state0, frames, streams, dev, results)

    # -- 5. path against path ----------------------------------------------
    print(f"[5] the first {PATH_FRAMES} frames through the plain versions {elapsed()}", flush=True)
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
    print(f"[6] timing {tag} {elapsed()}", flush=True)
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
        time_pair(k, fk, fp, rk, rp, results, tag)
    # device operations a call and their device time (at the launch floor the
    # CUDA-event times above follow the host's pace, the profiler's do not)
    for k, most in (("consensus", 1), ("flood_reach", 3), ("label_components", 3), ("greedy_assign", 1)):
        n_ops, results[k]["device_ms"] = device_ops(plain_fns[k][0], k, tag)
        check(n_ops <= most, f"{k} takes {n_ops:.1f} device operations a call (at most {most})")
    # the launch floor: an empty launch's time (a 1-element fill, back to
    # back, CUDA events) times a call's launches, and its device time
    one = torch.zeros(1, device=dev)
    empty_ms = cuda_ms(one.zero_, 500, 10)
    _, empty_dev = device_ops(one.zero_, "an empty launch", tag, reps=200)
    results["greedy_assign"]["floor_device_ms"] = empty_dev
    print(f"  {tag} an empty launch: {empty_ms:.4f} ms of events, {empty_dev:.4f} device ms; launch floor of "
          f"label_components and flood_reach (3 launches) {3 * empty_ms:.4f} ms, of label_fixpoint (4) "
          f"{4 * empty_ms:.4f} ms; greedy_assign's device floor (1 launch) {empty_dev:.4f} ms", flush=True)
    time_registry(timing_inputs, results, starts, frames, tag)
    from tracking_tpu_torch.ops.consensus import (
        consensus_feedback, consensus_feedback_ref, consensus_read, consensus_read_ref,
    )

    for k, fk, fp in (("consensus_read", consensus_read, consensus_read_ref),
                      ("consensus_feedback", consensus_feedback, consensus_feedback_ref)):
        v_args, v_kw = timing_inputs[k]
        time_pair(k, lambda fk=fk: fk(*v_args, **v_kw), lambda fp=fp: fp(*v_args, **v_kw), 20, 3, results, tag)
    from tracking_tpu_torch.ops.gmg import gmg_step

    for k, fk in (("consensus_read", consensus_read), ("consensus_feedback", consensus_feedback),
                  ("gmg_step", gmg_step)):
        v_args, v_kw = timing_inputs[k]
        n_ops, results[k]["device_ms"] = device_ops(lambda fk=fk: fk(*v_args, **v_kw), k, tag)
        check(n_ops <= 1, f"{k} takes {n_ops:.1f} device operations a call (at most 1)")
    time_variants(algo, state0, variant_starts, frames, tag)
    time_fgd(timing_inputs, results, fgd_algo, fgd_start, tracker, quiet, dev, tag)
    print(f"  {elapsed()}", flush=True)
    time_spatial(algo, tracker, state0, frames, dev, timing_inputs, results, tag)
    print(f"  {elapsed()}", flush=True)
    time_slab_kernels(timing_inputs, results, tag)
    time_kalman_resize(timing_inputs, results, masks, tracker, dev, tag)
    time_pca_kernels(timing_inputs, results, frames, tag)
    eigen_720p_path(frames, dev, errs, results, tag, cpu_pool)
    cpu_pool.close()
    cpu_pool.join()
    print(f"  {elapsed()}", flush=True)
    time_batch(streams, dev, tag)
    time_sharded_lbsp(streams, dev, tag)
    print(f"  {elapsed()}", flush=True)
    time_process_mesh(proc_mesh, thread_mesh, algo, tracker, state0, frames, streams, tag)
    proc_mesh.close()
    del streams
    print(f"  {elapsed()}", flush=True)
    for k in SOURCES:
        results[k]["max_abs_err"] = errs[k]

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

    torch.cuda.reset_peak_memory_stats()
    span = range(17, 17 + TIMED_FRAMES)
    bgs_ms = [run(span, False), run(span, False)]
    full_ms, app_ms = [], []
    for _ in range(2):  # in turns: the path's own loop, then the app's
        full_ms.append(run(span, True))
        app_ms.append(time_app(clip, app_out))
    for name, v in (("BGS step", bgs_ms), ("full path (BGS + tracking)", full_ms)):
        print(f"  {tag} {name}: {v[0]:.3f} / {v[1]:.3f} ms/frame = {1000 / min(v):.1f} fps "
              f"({TIMED_FRAMES} frames, {H}x{W}x{C})", flush=True)
    print(f"  {tag} tracking app (run_tracking, chunk of {APP_CHUNK}: the steps, the per-chunk copy, recorder and "
          f"HistPVS analysis), in turns with the full path: {app_ms[0]:.3f} / {app_ms[1]:.3f} ms/frame = "
          f"{1000 / min(app_ms):.1f} fps", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {tag} peak device memory of the SuBSENSE + tracker runs {peak:.2f} GiB", flush=True)
    print(f"  {elapsed()}", flush=True)
    profile_full_path(algo, tracker, state0, frames, dev, tag)
    profile_app(clip, tag, app_out)
    print(f"  {elapsed()}", flush=True)
    time_bgs_apps(clip, frames, dev, bgs_out, tag)
    print(f"  {elapsed()}", flush=True)
    time_slice16(s16, frames, dev, tag)
    time_blobs_reader(blobs_keep, tag)
    print(f"  {elapsed()}", flush=True)

    print(json.dumps({"kernels": [results[k] for k in SOURCES]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
