"""FET offline scorer, counterpart of ``tracking_tpu/analysis/fet.py``
(``fet/fet.py`` in the reference; numpy and cv2, no device work).

Given a ground-truth directory and a foreground-mask directory of paired
images (same file names), counts per-pixel TP / FP / TN / FN, writes
colour-coded score images into an ``SC/`` directory (TP white, FP red, FN
green, TN black, ``fet/fet.py:62-88``) and prints the aggregate recall,
precision and F-score (``fet/fet.py:93-103``).

    fet-score-torch GT_DIR FG_DIR [SC_DIR]
    python -m tracking_tpu_torch.analysis.fet GT_DIR FG_DIR [SC_DIR]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def score_pair(gt: np.ndarray, fg: np.ndarray):
    """Returns (tp, fp, tn, fn, score image BGR)."""
    g = gt > 127
    p = fg > 127
    tp = p & g
    fp = p & ~g
    fn = ~p & g
    sc = np.zeros(g.shape + (3,), np.uint8)
    sc[tp] = (255, 255, 255)
    sc[fp] = (0, 0, 255)  # red (BGR)
    sc[fn] = (0, 255, 0)  # green
    return int(tp.sum()), int(fp.sum()), int((~p & ~g).sum()), int(fn.sum()), sc


def score_dirs(gt_dir: str, fg_dir: str, sc_dir: str | None = None):
    """Score every paired image; returns the totals, the rates and the
    per-file rows."""
    import cv2

    names = sorted(f for f in os.listdir(gt_dir) if f.lower().endswith((".png", ".jpg", ".bmp")))
    if sc_dir:
        os.makedirs(sc_dir, exist_ok=True)
    tot = dict(tp=0, fp=0, tn=0, fn=0)
    rows = []
    for name in names:
        fg_path = os.path.join(fg_dir, name)
        if not os.path.exists(fg_path):
            continue
        gt = cv2.imread(os.path.join(gt_dir, name), cv2.IMREAD_GRAYSCALE)
        fg = cv2.imread(fg_path, cv2.IMREAD_GRAYSCALE)
        tp, fp, tn, fn, sc = score_pair(gt, fg)
        for k, v in zip(("tp", "fp", "tn", "fn"), (tp, fp, tn, fn)):
            tot[k] += v
        rows.append((name, tp, fp, tn, fn))
        if sc_dir:
            cv2.imwrite(os.path.join(sc_dir, name), sc)
    tp, fp, fn = tot["tp"], tot["fp"], tot["fn"]
    recall = tp / (tp + fn) if tp + fn else 0.0
    precision = tp / (tp + fp) if tp + fp else 0.0
    fscore = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
    return dict(**tot, recall=recall, precision=precision, fscore=fscore, rows=rows)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print("usage: python -m tracking_tpu_torch.analysis.fet GT_DIR FG_DIR [SC_DIR]")
        return 1
    res = score_dirs(argv[0], argv[1], argv[2] if len(argv) > 2 else None)
    print(f"TP={res['tp']} FP={res['fp']} TN={res['tn']} FN={res['fn']}")
    print(f"Recall={res['recall']:.6f} Precision={res['precision']:.6f} F-score={res['fscore']:.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
