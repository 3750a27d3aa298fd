"""tracking_tpu_torch: the PyTorch / CUDA port of ``tracking_tpu``.

The JAX package stays the reference; this package imports torch and numpy
and never JAX or ``tracking_tpu``. Module names mirror the reference's:

- ``bgs/base.py``, ``core/registry.py``, ``runner/scan.py``: the
  ``init`` / ``warm_start`` / ``step`` contract, registry and frame loop;
- ``bgs/lbsp_family.py``: SuBSENSE (type 36; consensus v1, v3 and the
  fused step) and LOBSTER (37); ``bgs/subsense_shrink.py``:
  subsenseShrink; ``bgs/gmg.py``: GMG (8); ``bgs/texture.py``: DPTexture
  (16); ``bgs/multilayer.py``: MultiLayer (23); ``bgs/fgd.py``: FGD and
  FGDSimple (FG_0, FG_0S); ``bgs/gmm.py``: MOG1 (4, FG_1);
  ``bgs/simple.py``: types 0-3, 6 and 7; ``bgs/sigma_delta.py``:
  SigmaDelta (35); ``bgs/shrink.py``: shrinkBGS and MyBGS (plain torch);
- ``ops/rng.py``: JAX's threefry key chain, its uniform and normal draws,
  and the counter-hash field; ``ops/xla_math.py``: XLA:CPU's ``sqrt``,
  ``log1p`` and ``erf_inv``;
- ``ops/lbsp.py``, ``ops/morphology.py``, ``ops/filters.py``,
  ``ops/color.py``, ``ops/sort.py``, ``ops/feedback.py``
  (``pallas_feedback.py``): plain torch;
- ``ops/consensus.py``, ``ops/fill.py``, ``ops/cc.py``, ``ops/assoc.py``,
  ``ops/gmg.py``, ``ops/texture.py``, ``ops/multilayer.py``, ``ops/fgd.py``:
  each holds CUDA kernels (``csrc/``, replacing ``pallas_consensus``,
  ``pallas_fill``, ``pallas_cc``, ``pallas_assoc``, ``pallas_gmg``,
  ``pallas_texture``, ``pallas_multilayer``, ``pallas_fgd``) beside their
  plain versions; CPU tensors take the plain version, CUDA tensors the
  kernel;
- ``track/``: Kalman filters, mean-shift, the blob tracker (CC, CCMSPF, MS,
  MSFG, MSPF) and the trajectory files and analyses;
- ``runner/cli.py``: the apps ``bgs-run`` (with ``runner/pipeline.py``'s
  PreProcessor and XML FrameProcessor fan-out, ``core/config.py``),
  ``tracking-run`` and ``cdnet-run``, with ``io/video.py`` (cv2) and
  ``core/checkpoint.py`` (``torch.save``); ``analysis/``: the mask
  metrics and the FET scorer;
- ``parallel/``: row sharding of one stream (``spatial.py``) over the
  thread ranks of ``mesh.ShardGroup`` on one device; ``ops/cc.py``'s
  ``label_fixpoint`` (replacing ``pallas_cc.label_fixpoint_pallas``) is its
  CC core;
- ``convert.py``: states to and from the JAX package's pytrees.
"""

from tracking_tpu_torch.core.registry import get_algorithm, list_algorithms  # noqa: F401

__version__ = "0.1.0"
