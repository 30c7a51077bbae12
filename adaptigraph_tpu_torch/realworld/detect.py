"""Perception masks (numpy copy of the parts of
``adaptigraph_tpu/realworld/detect.py`` that need no model weights): the IoU
deduplication of instance masks and ``color_spread_mask_fn``, the sim-backed
mask that drives the non-``use_raw`` perception path without a detector.
``GroundedSAMMask`` and ``make_mask_fn`` (GroundingDINO + SAM) have no
counterpart: they need downloaded weights.
"""

import numpy as np


def mask_iou(a, b):
    """IoU of two boolean masks (reference: perception.py:137-141 dedup)."""
    a = np.asarray(a, bool)
    b = np.asarray(b, bool)
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / float(union) if union else 0.0


def dedup_masks(masks, scores, iou_thresh=0.9, max_n=None):
    """Drop lower-scoring masks that overlap a kept one above ``iou_thresh``
    (reference: perception.py:133-148), keeping at most ``max_n``."""
    order = np.argsort(-np.asarray(scores))
    kept = []
    for i in order:
        if any(mask_iou(masks[i], masks[j]) > iou_thresh for j in kept):
            continue
        kept.append(i)
        if max_n is not None and len(kept) >= max_n:
            break
    return kept


def color_spread_mask_fn(spread=20.0, max_value=255):
    """Sim-backed mask_fn: keep pixels whose RGB channel spread exceeds
    ``spread`` — the splat renderer paints particles with saturated
    per-instance hues over a gray table (sim/env.py MATERIAL_BASE_RGB), so
    channel spread separates object from background exactly. This drives the
    same non-``use_raw`` perception path as the learned tier, hardware-free."""

    def mask_fn(rgb):
        rgb = np.asarray(rgb, np.float32)
        return (rgb.max(axis=-1) - rgb.min(axis=-1)) > spread

    return mask_fn
