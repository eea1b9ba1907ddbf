"""Host-side 3D box geometry + per-view bbox preprocessing (numpy).

Replaces the reference's mmdet3d ``LiDARInstance3DBoxes`` usage and the
collate-time ``_preprocess_bbox`` (reference ``magicdrive/dataset/utils.py:
60-262``, ``magicdrive/runner/box_visualizer.py:17-86``).  Pure numpy — runs
in data-loader workers; outputs are padded to a *static* ``max_len`` so the
batch is jit/XLA friendly (the reference pads to the ragged per-batch max).

Box tensor layout (mmdet3d LiDAR convention): ``(x, y, z, dx, dy, dz, yaw)``
with gravity center given by ``origin`` (datasets use bottom-center
``(0.5, 0.5, 0)``; projection shifts to ``(0.5, 0.5, 0.5)``).
Corner order: binary over (x, y, z) — index = 4*x + 2*y + z.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "box_corners",
    "trans_box_corners_to_view",
    "ensure_positive_z",
    "ensure_canvas",
    "preprocess_bbox",
    "CXYZ_CORNER_INDICES",
]

# reference dataset/utils.py:224 — 'cxyz' mode picks these 4 of the 8 corners
CXYZ_CORNER_INDICES = (6, 5, 7, 2)

_CORNERS_NORM = np.stack(
    np.unravel_index(np.arange(8), (2, 2, 2)), axis=1
).astype(np.float64)  # (8, 3) binary corners, index = 4x + 2y + z


def box_corners(
    boxes: np.ndarray, origin: Tuple[float, float, float] = (0.5, 0.5, 0.0)
) -> np.ndarray:
    """(N, 7+) -> (N, 8, 3) corners in LiDAR frame.

    ``origin`` is where (x, y, z) sits inside the box (mmdet3d semantics:
    LiDAR boxes store bottom-center by default)."""
    boxes = np.asarray(boxes, np.float64)
    if boxes.size == 0:
        return np.zeros((0, 8, 3))
    centers, dims, yaw = boxes[:, :3], boxes[:, 3:6], boxes[:, 6]
    corners = (_CORNERS_NORM[None] - np.asarray(origin)) * dims[:, None]
    # rotate around z (mmdet3d rotation_3d_in_axis, axis=2): p @ R_T
    cos, sin = np.cos(yaw), np.sin(yaw)
    zeros, ones = np.zeros_like(cos), np.ones_like(cos)
    rot_t = np.stack(
        [cos, sin, zeros, -sin, cos, zeros, zeros, zeros, ones], axis=-1
    ).reshape(-1, 3, 3)
    corners = corners @ rot_t
    return corners + centers[:, None]


def trans_box_corners_to_view(
    corners: np.ndarray,
    transform: np.ndarray,
    aug_matrix: Optional[np.ndarray] = None,
    proj: bool = True,
) -> np.ndarray:
    """Project (N, 8, 3) corners with a 4x4 view transform
    (lidar2image or lidar2camera), optional image-aug matrix.

    With ``proj``: returns (N, 8, 3) where xy are pixel coords and z is the
    *sign* of depth (reference box_visualizer.py:49-86 keeps the sign)."""
    n = corners.shape[0]
    if n == 0:
        return np.zeros((0, 8, 3))
    trans = np.asarray(transform, np.float64).reshape(4, 4)
    if aug_matrix is not None:
        trans = np.asarray(aug_matrix, np.float64).reshape(4, 4) @ trans
    coords = np.concatenate(
        [corners.reshape(-1, 3), np.ones((n * 8, 1))], axis=-1)
    coords = coords @ trans.T
    if proj:
        z = np.clip(coords[:, 2], 1e-5, 1e5)
        coords[:, 0] /= z
        coords[:, 1] /= z
        coords[:, 2] /= np.abs(coords[:, 2])
    return coords[:, :3].reshape(-1, 8, 3)


def ensure_positive_z(coords: np.ndarray) -> np.ndarray:
    """(N, 8, 3) camera-frame corners -> (N,) keep-mask (any corner z > 0)."""
    return np.any(coords[..., 2] > 0, axis=1)


def ensure_canvas(coords: np.ndarray, canvas_size: Tuple[int, int]) -> np.ndarray:
    """Keep boxes with any projected corner on the (h, w) canvas and z > 0."""
    h, w = canvas_size
    c = np.any(coords[..., 2] > 0, axis=1)
    wm = np.any((coords[..., 0] > 0) & (coords[..., 0] < w), axis=1)
    hm = np.any((coords[..., 1] > 0) & (coords[..., 1] < h), axis=1)
    return c & wm & hm


def preprocess_bbox(
    gt_boxes: Sequence[np.ndarray],  # per sample: (N_i, 7+)
    gt_labels: Sequence[np.ndarray],  # per sample: (N_i,)
    lidar2camera: np.ndarray,  # (B, N_cam, 4, 4)
    lidar2image: np.ndarray,  # (B, N_cam, 4, 4)
    img_aug_matrix: Optional[np.ndarray],  # (B, N_cam, 4, 4)
    canvas_size: Tuple[int, int],
    bbox_mode: str = "all-xyz",
    view_shared: bool = False,
    use_3d_filter: bool = True,
    max_len: int = 160,
    is_train: bool = True,
    bbox_drop_ratio: float = 0.0,
    bbox_add_ratio: float = 0.0,
    bbox_add_num: int = 3,
    rng: Optional[np.random.Generator] = None,
    for_mask: bool = False,
) -> Optional[Dict[str, np.ndarray]]:
    """Static-shape equivalent of reference ``_preprocess_bbox``
    (dataset/utils.py:128-262).

    Returns dict(bboxes (B, N_out, max_len, P, 3), classes (B, N_out,
    max_len) int64 (-1 pad), masks (B, N_out, max_len) bool) or None when no
    visible boxes exist anywhere in the batch."""
    rng = rng or np.random.default_rng()
    B, n_cam = lidar2image.shape[:2]
    n_out = 1 if view_shared else n_cam
    origin = (0.5, 0.5, 0.5) if for_mask else (0.5, 0.5, 0.0)
    n_pts = 4 if bbox_mode == "cxyz" else 8

    out_boxes = np.zeros((B, n_out, max_len, n_pts, 3), np.float32)
    out_classes = -np.ones((B, n_out, max_len), np.int64)
    out_masks = np.zeros((B, n_out, max_len), bool)
    any_box = False

    for b in range(B):
        boxes = np.asarray(gt_boxes[b], np.float64).reshape(-1, gt_boxes[b].shape[-1]) \
            if np.size(gt_boxes[b]) else np.zeros((0, 7))
        labels = np.asarray(gt_labels[b], np.int64).reshape(-1)
        if len(boxes) == 0 or (is_train and rng.random() < bbox_drop_ratio):
            continue
        corners = box_corners(boxes, origin=origin)
        if bbox_mode == "cxyz":
            pts = corners[:, list(CXYZ_CORNER_INDICES)]
        elif bbox_mode == "all-xyz":
            pts = corners
        else:
            raise NotImplementedError(bbox_mode)

        if view_shared:
            masks_per_view = [np.ones(len(boxes), bool)]
        else:
            # projection uses gravity-center boxes (box_center_shift 0.5,0.5,0.5)
            proj_corners = box_corners(boxes, origin=(0.5, 0.5, 0.5))
            masks_per_view = []
            for v in range(n_cam):
                if use_3d_filter:
                    cc = trans_box_corners_to_view(
                        proj_corners, lidar2camera[b, v],
                        None if img_aug_matrix is None else img_aug_matrix[b, v],
                        proj=False)
                    keep = ensure_positive_z(cc)
                else:
                    cc = trans_box_corners_to_view(
                        proj_corners, lidar2image[b, v],
                        None if img_aug_matrix is None else img_aug_matrix[b, v],
                        proj=True)
                    keep = ensure_canvas(cc, canvas_size)
                if is_train and bbox_add_ratio > 0 and rng.random() < bbox_add_ratio:
                    # randomly re-add some filtered boxes (reference
                    # random_0_to_1, dataset/utils.py:85-91)
                    off = np.where(~keep)[0]
                    rng.shuffle(off)
                    keep = keep.copy()
                    keep[off[:bbox_add_num]] = True
                masks_per_view.append(keep)

        for v, keep in enumerate(masks_per_view):
            idx = np.where(keep)[0][:max_len]
            k = len(idx)
            if k == 0:
                continue
            any_box = True
            out_boxes[b, v, :k] = pts[idx]
            out_classes[b, v, :k] = labels[idx]
            out_masks[b, v, :k] = True

    if not any_box:
        return None
    return {"bboxes": out_boxes, "classes": out_classes, "masks": out_masks}
