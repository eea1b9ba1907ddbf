"""Training-time augmentations (reference ``magicdrive/dataset/pipeline.py``
``RandomFlip3DwithViews`` :528-735 — horizontal scene flip with view
reordering).  Default configs keep ``flip_ratio: 0.0`` (same as reference)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["random_flip_3d_with_views", "object_range_filter"]


def object_range_filter(
    boxes: np.ndarray,
    labels: np.ndarray,
    point_cloud_range: Sequence[float],
) -> tuple:
    """Keep boxes whose BEV center lies inside ``point_cloud_range``
    ``[x0, y0, z0, x1, y1, z1]`` and normalize yaw to [-pi, pi) —
    reference ``ObjectRangeFilterM`` (``pipeline.py:334-383``,
    ``in_range_bev`` + ``limit_yaw``).  Returns (boxes, labels, keep_mask).
    """
    boxes = np.asarray(boxes, np.float32)
    labels = np.asarray(labels)
    if len(boxes) == 0:
        return boxes, labels, np.zeros((0,), bool)
    pcr = np.asarray(point_cloud_range, np.float32)
    keep = ((boxes[:, 0] >= pcr[0]) & (boxes[:, 0] < pcr[3])
            & (boxes[:, 1] >= pcr[1]) & (boxes[:, 1] < pcr[4]))
    boxes, labels = boxes[keep].copy(), labels[keep]
    boxes[:, 6] = (boxes[:, 6] + np.pi) % (2 * np.pi) - np.pi
    return boxes, labels, keep

# horizontal flip swaps left/right cameras:
# [FL, F, FR, BR, B, BL] -> [FR, F, FL, BL, B, BR]
_FLIP_VIEW_PERM = [2, 1, 0, 5, 4, 3]

_MIRROR = np.diag([1.0, -1.0, 1.0, 1.0])  # lidar-frame y -> -y


def random_flip_3d_with_views(
    sample: Dict,
    rng: np.random.Generator,
    flip_ratio: float = 0.0,
    image_width: int = 1600,
) -> Dict:
    """Flip the whole scene across the x-z plane with probability
    ``flip_ratio``: images mirrored, views reordered left<->right, boxes
    y/yaw negated, camera matrices mirrored, intrinsics cx reflected."""
    if flip_ratio <= 0 or rng.random() >= flip_ratio:
        return sample
    s = dict(sample)
    perm = _FLIP_VIEW_PERM

    if "img" in s:
        s["img"] = s["img"][perm, :, ::-1].copy()

    boxes = np.array(s["gt_bboxes_3d"], np.float32, copy=True)
    if len(boxes):
        boxes[:, 1] *= -1.0  # y
        boxes[:, 6] *= -1.0  # yaw
    s["gt_bboxes_3d"] = boxes

    c2l = s["camera2lidar"][perm].copy()
    c2l = _MIRROR[None] @ c2l @ _MIRROR[None]  # mirror pose + mirror cam x
    s["camera2lidar"] = c2l.astype(np.float32)
    s["lidar2camera"] = np.linalg.inv(c2l).astype(np.float32)

    intr = s["camera_intrinsics"][perm].copy()
    intr[:, 0, 2] = image_width - intr[:, 0, 2]  # cx reflect
    s["camera_intrinsics"] = intr.astype(np.float32)
    s["lidar2image"] = (intr @ s["lidar2camera"]).astype(np.float32)
    s["img_aug_matrix"] = s["img_aug_matrix"][perm].copy()

    if "gt_masks_bev" in s:
        # BEV y-axis mirror (mask layout: (C, x, y))
        s["gt_masks_bev"] = s["gt_masks_bev"][:, :, ::-1].copy()
    return s
