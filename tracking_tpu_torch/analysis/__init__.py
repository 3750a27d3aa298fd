"""Mask scoring: ``metrics.py`` (on the device) and ``fet.py`` (the FET
directory scorer, numpy)."""

from tracking_tpu_torch.analysis.metrics import (  # noqa: F401
    confusion_counts,
    image_roc,
    mask_similarity,
    precision_recall_fscore,
    roc_curve,
    roc_threshold_search,
    save_roc_file,
)
