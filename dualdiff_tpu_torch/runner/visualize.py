"""Box and BEV-map visualisers, numpy only.

Port of ``dualdiff_tpu/runner/visualize.py``.  Boxes are projected with the
port's ``ops/boxes.py`` exactly as the JAX package projects them (corners
about the box centre, the view's ``lidar2image`` after the image-aug
matrix, a box skipped when any corner lies behind the camera, an edge
skipped when an end is not finite), and each of the 12 edges from its
truncated integer end points is drawn as a 1-px anti-aliased line in the
class colour.  The JAX package draws with OpenCV's ``cv2.line(...,
LINE_AA)``; here a line is Xiaolin Wu's: each step along the major axis
splits the colour between the two pixels the line passes between, by
distance.  The pixels lie within one pixel of OpenCV's, not bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..ops.boxes import box_corners, trans_box_corners_to_view

__all__ = ["box_segments", "draw_line_aa", "draw_boxes_on_view",
           "draw_boxes_on_views", "render_bev_map"]

# 12 box edges as corner-index pairs (corner index = 4x + 2y + z)
_EDGES = [
    (0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3),
    (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7),
]

_CLASS_COLORS = [
    (0, 150, 245), (135, 60, 0), (0, 255, 255), (255, 255, 0),
    (160, 32, 240), (255, 120, 50), (255, 127, 0), (255, 192, 203),
    (255, 0, 0), (255, 240, 150),
]

Segment = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int, int]]


def box_segments(boxes: np.ndarray, labels: np.ndarray,
                 lidar2image: np.ndarray,
                 img_aug_matrix: Optional[np.ndarray] = None
                 ) -> List[Segment]:
    """The edges to draw of one view: ((x0, y0), (x1, y1), colour), end
    points truncated to int as the JAX visualiser passes them to OpenCV."""
    if len(boxes) == 0:
        return []
    corners = box_corners(boxes, origin=(0.5, 0.5, 0.5))
    proj = trans_box_corners_to_view(corners, lidar2image, img_aug_matrix,
                                     proj=True)
    out = []
    for i in range(len(boxes)):
        if not np.all(proj[i, :, 2] > 0):  # any corner behind: skip box
            continue
        pts = proj[i, :, :2]
        color = _CLASS_COLORS[int(labels[i]) % len(_CLASS_COLORS)]
        for a, b in _EDGES:
            pa, pb = pts[a], pts[b]
            if not (np.isfinite(pa).all() and np.isfinite(pb).all()):
                continue
            out.append(((int(pa[0]), int(pa[1])), (int(pb[0]), int(pb[1])),
                        color))
    return out


def draw_line_aa(img: np.ndarray, p0, p1, color) -> None:
    """Draw a 1-px anti-aliased line from ``p0`` to ``p1`` (integer
    (x, y)) into the uint8 ``img`` (H, W, 3) in place: Xiaolin Wu's
    algorithm, clipped to the image (only the major-axis steps inside it
    are walked)."""
    h, w = img.shape[:2]
    (x0, y0), (x1, y1) = p0, p1
    steep = abs(y1 - y0) > abs(x1 - x0)
    if steep:  # walk y
        x0, y0, x1, y1 = y0, x0, y1, x1
    if x0 > x1:
        x0, y0, x1, y1 = x1, y1, x0, y0
    major, minor = (h, w) if steep else (w, h)
    lo, hi = max(x0, 0), min(x1, major - 1)
    if lo > hi:
        return
    grad = (y1 - y0) / (x1 - x0) if x1 != x0 else 0.0
    xs = np.arange(lo, hi + 1)
    ys = y0 + grad * (xs - x0)
    base = np.floor(ys)
    frac = ys - base
    col = np.asarray(color, np.float64)
    for off, a in ((0, 1.0 - frac), (1, frac)):
        yy = (base + off).astype(np.int64)
        sel = (yy >= 0) & (yy < minor) & (a > 0)
        r, c = (xs[sel], yy[sel]) if steep else (yy[sel], xs[sel])
        alpha = a[sel][:, None]
        img[r, c] = np.floor(img[r, c] * (1.0 - alpha) + col * alpha
                             + 0.5).astype(np.uint8)


def draw_boxes_on_view(
    image: np.ndarray,  # (H, W, 3) uint8
    boxes: np.ndarray,  # (N, 7)
    labels: np.ndarray,  # (N,)
    lidar2image: np.ndarray,  # 4x4
    img_aug_matrix: Optional[np.ndarray] = None,
) -> np.ndarray:
    """A copy of ``image`` with the boxes' edges drawn as 1-px lines."""
    img = np.array(image, np.uint8)
    for p0, p1, color in box_segments(boxes, labels, lidar2image,
                                      img_aug_matrix):
        draw_line_aa(img, p0, p1, color)
    return img


def draw_boxes_on_views(images, boxes, labels, lidar2image,
                        img_aug_matrix=None):
    """(N_cam, H, W, 3) images -> same with boxes drawn per view."""
    out = []
    for v in range(len(images)):
        aug = None if img_aug_matrix is None else img_aug_matrix[v]
        out.append(draw_boxes_on_view(images[v], boxes, labels,
                                      lidar2image[v], aug))
    return np.stack(out)


# reference map_visualizer.py COLORS (:13-45), priority render order (:49-60)
_MAP_COLORS = [
    (164, 184, 196), (158, 158, 158), (35, 105, 38), (250, 100, 0),
    (120, 85, 72), (229, 230, 49), (119, 11, 32), (0, 60, 100),
]


def render_bev_map(masks: np.ndarray) -> np.ndarray:
    """(C>=8, H, W) binary masks -> (H, W, 3) uint8 color render."""
    c, h, w = masks.shape
    out = np.full((h, w, 3), 240, np.uint8)
    for ci in range(min(c, len(_MAP_COLORS))):
        out[masks[ci] > 0] = _MAP_COLORS[ci]
    return out
