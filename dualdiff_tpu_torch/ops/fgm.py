"""FGM (foreground-aware masking) heatmap, the aug-loss weight map.

Port of ``fgm_heatmap`` from ``dualdiff_tpu/ops/fgm.py``: project each box's
8 corners into the latent grid, build its convex hull as the intersection of
the supporting half-planes over all corner pairs, test every grid point in
parallel, weight an instance by ``1 - area / (w * h)`` and take the max over
instances.  As in the reference:

* corners with camera z <= 0 are left out;
* projected coordinates are truncated toward zero;
* grid points are the integer pixel coordinates;
* a hull needs at least 3 valid corners and one supporting edge.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["fgm_heatmap"]

_EPS = 1e-6


def _project_corners(corners, lidar2image, resolution, image_size):
    w, h = resolution
    iw, ih = image_size
    hom = torch.cat([corners, torch.ones_like(corners[..., :1])], dim=-1)
    # (..., L, 8, 4) @ (..., 1, 4, 4)^T
    cam = hom @ lidar2image.transpose(-1, -2)[..., None, :, :]
    z = cam[..., 2]
    zc = z.clamp(1e-5, 1e5)
    x = cam[..., 0] / zc * (w / iw)
    y = cam[..., 1] / zc * (h / ih)
    return torch.trunc(x), torch.trunc(y), z > 0


def _hull_mask(x, y, valid, resolution):
    """(..., h, w) inside-convex-hull masks.  A grid point is inside the
    hull iff it lies on the non-negative side of every supporting directed
    edge (i, j): one with every valid corner on its non-negative side."""
    w, h = resolution
    pts = torch.stack([x, y], dim=-1)  # (..., 8, 2)
    pi = pts[..., :, None, :]
    e = pts[..., None, :, :] - pi  # (..., 8, 8, 2) edge i -> j
    nx, ny = -e[..., 1], e[..., 0]  # normal to the left of i -> j
    dkx = pts[..., None, None, :, 0] - pi[..., 0:1]  # (..., i, j, k)
    dky = pts[..., None, None, :, 1] - pi[..., 1:2]
    side = nx[..., None] * dkx + ny[..., None] * dky
    vk = valid[..., None, None, :]
    support = ((side >= -_EPS) | ~vk).all(dim=-1)  # (..., i, j)
    vij = valid[..., :, None] & valid[..., None, :]
    degen = (e * e).sum(-1) < _EPS  # coincident corners
    support = support & vij & ~degen

    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=x.dtype, device=x.device),
        torch.arange(w, dtype=x.dtype, device=x.device), indexing="ij")
    gside = (nx[..., None, None] * (gx - pi[..., 0:1][..., None])
             + ny[..., None, None] * (gy - pi[..., 1:2][..., None]))
    ok = (gside >= -_EPS) | ~support[..., None, None]
    inside = ok.flatten(-4, -3).all(dim=-3)  # (..., h, w)
    has_hull = (valid.sum(-1) >= 3) & support.flatten(-2).any(-1)
    return inside & has_hull[..., None, None]


def fgm_heatmap(bboxes: torch.Tensor, masks: torch.Tensor,
                lidar2image: torch.Tensor, resolution: Tuple[int, int],
                image_size: Tuple[int, int] = (1600, 900)) -> torch.Tensor:
    """bboxes (B, N, L, 8, 3) lidar-frame corners, masks (B, N, L),
    lidar2image (B, N, 4, 4), ``resolution`` (w, h) of the latent grid ->
    (B, N, h, w) float32 heatmap."""
    w, h = resolution
    x, y, valid = _project_corners(bboxes.float(), lidar2image.float(),
                                   resolution, image_size)
    m = masks.bool()
    inside = _hull_mask(x, y, valid & m[..., None], resolution)
    area = inside.sum(dim=(-2, -1)).float()
    weight = 1.0 - area / float(w * h)
    heat = inside.float() * weight[..., None, None]
    heat = heat * m[..., None, None].float()
    return heat.amax(dim=2)
