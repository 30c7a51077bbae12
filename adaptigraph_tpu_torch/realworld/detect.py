"""Perception masks (counterpart of ``adaptigraph_tpu/realworld/detect.py``).

The learned tier: ``GroundedSAMMask(prompts)(rgb) -> (H, W) bool``, an
open-vocabulary detector (GroundingDINO family) and a segmenter (SAM) with
the reference's thresholds, instance budget, IoU dedup and union keep-mask
(reference: ``src/planning/perception.py:68-148``). Both backends can be
injected. The default ones are ``transformers`` models loaded at first use
(torch and transformers are imported inside the loaders, so this module
imports neither). Without SAM weights the segmenter falls back to
``boxes_to_masks``.

The model runs on ``device``, the card unless the caller names another;
the JAX package's default is the CPU.

``color_spread_mask_fn`` is the sim-backed mask: it drives the same
non-``use_raw`` perception path without a detector.
"""

import numpy as np

DEFAULT_DETECTOR_MODEL = "IDEA-Research/grounding-dino-tiny"
DEFAULT_SAM_MODEL = "facebook/sam-vit-base"


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


def boxes_to_masks(rgb, boxes):
    """Geometric fallback segmenter: filled boxes (n, H, W) bool."""
    H, W = np.asarray(rgb).shape[:2]
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    out = np.zeros((len(boxes), H, W), bool)
    for i, (x0, y0, x1, y1) in enumerate(boxes):
        out[i, int(max(y0, 0)) : int(min(y1, H)) + 1,
            int(max(x0, 0)) : int(min(x1, W)) + 1] = True
    return out


class GroundedSAMMask:
    """Open-vocabulary detect + segment keep-mask (the reference's real-robot
    perception entry, perception.py:68-148).

    Args:
      prompts: open-vocabulary text prompts (task_config obj_list).
      box_threshold/text_threshold: detector confidence gates
        (perception.py:86-88).
      iou_thresh: instance mask dedup threshold (perception.py:137).
      max_n: instance budget (task_config max_n).
      device: where the default models run.
      detector/segmenter: injectable backends.
    """

    def __init__(self, prompts, box_threshold=0.5, text_threshold=0.5,
                 iou_thresh=0.9, max_n=1, device="cuda",
                 detector=None, segmenter=None,
                 detector_model=DEFAULT_DETECTOR_MODEL,
                 sam_model=DEFAULT_SAM_MODEL):
        self.prompts = tuple(prompts)
        self.box_threshold = box_threshold
        self.text_threshold = text_threshold
        self.iou_thresh = iou_thresh
        self.max_n = max_n
        self.device = device
        self._detector = detector
        self._segmenter = segmenter
        self._detector_model = detector_model
        self._sam_model = sam_model

    def _load_detector(self):
        from transformers import pipeline

        pipe = pipeline("zero-shot-object-detection",
                        model=self._detector_model, device=self.device)
        labels = [p if p.endswith(".") else p + "." for p in self.prompts]

        def detect(rgb):
            from PIL import Image

            res = pipe(Image.fromarray(np.asarray(rgb, np.uint8)),
                       candidate_labels=list(labels),
                       threshold=self.box_threshold)
            boxes = np.asarray([[r["box"]["xmin"], r["box"]["ymin"],
                                 r["box"]["xmax"], r["box"]["ymax"]]
                                for r in res], np.float32).reshape(-1, 4)
            scores = np.asarray([r["score"] for r in res], np.float32)
            return boxes, scores, [r["label"] for r in res]

        return detect

    def _load_segmenter(self):
        import torch
        from transformers import SamModel, SamProcessor

        model = SamModel.from_pretrained(self._sam_model).to(self.device)
        processor = SamProcessor.from_pretrained(self._sam_model)

        def segment(rgb, boxes):
            if not len(boxes):
                return np.zeros((0,) + np.asarray(rgb).shape[:2], bool)
            inputs = processor(np.asarray(rgb, np.uint8),
                               input_boxes=[[list(map(float, b)) for b in boxes]],
                               return_tensors="pt").to(self.device)
            with torch.no_grad():
                out = model(**inputs)
            masks = processor.image_processor.post_process_masks(
                out.pred_masks.cpu(), inputs["original_sizes"].cpu(),
                inputs["reshaped_input_sizes"].cpu())[0]
            return np.asarray(masks[:, 0].numpy(), bool)  # best proposal per box

        return segment

    def detect(self, rgb):
        """(boxes (n, 4) xyxy, scores, labels) above the thresholds
        (reference: perception.py:68-107). The reference gates box logits on
        box_threshold and label scores on text_threshold; a zero-shot
        pipeline gives one score per (box, label), so the gate is their max."""
        if self._detector is None:
            self._detector = self._load_detector()
        boxes, scores, labels = self._detector(rgb)
        keep = (np.asarray(scores, np.float32)
                >= max(self.box_threshold, self.text_threshold))
        return (np.asarray(boxes, np.float32).reshape(-1, 4)[keep],
                np.asarray(scores, np.float32)[keep],
                [l for l, k in zip(labels, keep) if k])

    def segment(self, rgb):
        """Instance masks with IoU dedup (reference: perception.py:110-148).
        Returns (masks (m, H, W) bool, scores (m,))."""
        boxes, scores, _ = self.detect(rgb)
        if self._segmenter is None:
            try:
                self._segmenter = self._load_segmenter()
            except Exception:
                self._segmenter = boxes_to_masks  # no SAM weights: filled boxes
        masks = self._segmenter(rgb, boxes)
        if not len(masks):
            return np.zeros((0,) + np.asarray(rgb).shape[:2], bool), scores
        kept = dedup_masks(masks, scores, self.iou_thresh, self.max_n)
        return np.asarray(masks)[kept], np.asarray(scores)[kept]

    def __call__(self, rgb):
        """PerceptionModule mask_fn: the union keep-mask (H, W) bool, or every
        pixel when nothing is detected."""
        masks, _ = self.segment(rgb)
        if not len(masks):
            return np.ones(np.asarray(rgb).shape[:2], bool)
        return np.any(masks, axis=0)


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


def make_mask_fn(obj_prompts, max_n=1, box_threshold=0.5, device="cuda"):
    """mask_fn factory for the CLI: a GroundedSAMMask on ``device`` when torch
    and transformers import, else None."""
    if not obj_prompts:
        return None
    try:
        import torch  # noqa: F401
        import transformers  # noqa: F401
    except ImportError:
        return None
    return GroundedSAMMask(obj_prompts, max_n=max_n, box_threshold=box_threshold,
                           device=device)
