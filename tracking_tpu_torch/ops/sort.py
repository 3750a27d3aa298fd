"""Per-pixel sort of a few parallel map-lists, counterpart of
``tracking_tpu/bgs/gmm.py:_sort_desc_maps``."""

from __future__ import annotations

import torch


def sort_desc_maps(key, payloads):
    """Stable descending sort of K parallel [..., H, W] map-lists by ``key``:
    an odd-even transposition network of K rounds of compare-exchange on
    adjacent pairs, swapping only on a STRICT ``<`` so equal keys keep their
    order. ``key`` is a list of K maps; ``payloads`` a list of such lists
    (a payload map may carry leading axes, the swap broadcasts over them).
    Returns (sorted key, sorted payloads)."""
    K = len(key)
    key = list(key)
    payloads = [list(p) for p in payloads]
    for rnd in range(K):
        for i in range(rnd % 2, K - 1, 2):
            swap = key[i] < key[i + 1]
            key[i], key[i + 1] = torch.where(swap, key[i + 1], key[i]), torch.where(swap, key[i], key[i + 1])
            for p in payloads:
                p[i], p[i + 1] = torch.where(swap, p[i + 1], p[i]), torch.where(swap, p[i], p[i + 1])
    return key, payloads
