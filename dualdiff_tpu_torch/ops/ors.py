"""ORS, occupancy ray-shape sampling, as a batched gather.

Port of ``dualdiff_tpu/ops/ors.py``: per latent pixel, a ray from the camera
is sampled at ``sample_point`` depths 0.2 m apart and each sample reads the
semantic label of its Occ3D voxel.  The depth axis doubles as the 320
conditioning channels the ControlNet consumes raw.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["occupancy_ray_sample", "filter_fg_bg", "FREE_CLASS"]

FREE_CLASS = 17  # Occ3D 'not occupied'


def occupancy_ray_sample(occ_labels: torch.Tensor, cam_K: torch.Tensor,
                         cam_T: torch.Tensor, out_hw: Tuple[int, int],
                         image_hw: Tuple[int, int] = (896, 1600),
                         sample_point: int = 320,
                         sample_step: float = 0.2) -> torch.Tensor:
    """occ_labels (B, 200, 200, 16), cam_K (B, N, 3, 3) intrinsics,
    cam_T (B, N, 4, 4) camera->ego -> (B, N, h, w, sample_point) int64
    labels 0..17 (out-of-volume samples are free space, 17)."""
    B, n_cam = cam_K.shape[:2]
    h, w = out_hw
    ih, iw = image_hw
    # output pixel (x, y) reads full-resolution pixel (x / ratio, y / ratio)
    u = (np.arange(w) / (w / iw)).astype(np.float32)
    v = (np.arange(h) / (h / ih)).astype(np.float32)
    uu, vv = np.meshgrid(u, v)
    pix = torch.from_numpy(
        np.stack([uu, vv, np.ones_like(uu)], -1).reshape(-1, 3)).to(
            cam_K.device)  # (h*w, 3)

    k_inv = torch.linalg.inv(cam_K.float())
    rot = cam_T[..., :3, :3].float()
    t = cam_T[..., :3, 3].float()
    d = torch.einsum("bnij,pj->bnpi",
                     torch.einsum("bnij,bnjk->bnik", rot, k_inv), pix)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    steps = torch.arange(sample_point, dtype=torch.float32,
                         device=d.device) * sample_step
    # (B, N, P, S, 3)
    pts = t[:, :, None, None, :] + \
        steps[None, None, None, :, None] * d[:, :, :, None, :]

    # Occ3D grid: x, y in [-40, 40] m over 200 voxels, z in [-1, 5.4] m
    # over 16; nearest voxel with align_corners=False
    gx = pts[..., 0] / 40.0
    gy = pts[..., 1] / 40.0
    gz = (pts[..., 2] / 40.0) * 40.0 / 3.2 - 2.2 / 3.2
    ix = torch.floor((gx + 1.0) * 100.0).long()
    iy = torch.floor((gy + 1.0) * 100.0).long()
    iz = torch.floor((gz + 1.0) * 8.0).long()
    oob = (ix < 0) | (ix >= 200) | (iy < 0) | (iy >= 200) | (iz < 0) | \
        (iz >= 16)
    flat = (ix.clamp(0, 199) * 200 + iy.clamp(0, 199)) * 16 + iz.clamp(0, 15)
    vol = occ_labels.reshape(B, -1).long()
    sem = torch.gather(vol, 1, flat.reshape(B, -1)).reshape(flat.shape)
    sem = torch.where(oob, torch.full_like(sem, FREE_CLASS), sem)
    return sem.reshape(B, n_cam, h, w, sample_point)


def filter_fg_bg(sem: torch.Tensor, keep_fg: bool, keep_bg: bool,
                 fg_max_class: int = 10,
                 bg_min_class: int = 11) -> torch.Tensor:
    """Foreground/background class filtering, then labels / 17 in float32."""
    out = sem
    if not keep_fg:
        out = torch.where(out <= fg_max_class, FREE_CLASS, out)
    if not keep_bg:
        out = torch.where(out >= bg_min_class, FREE_CLASS, out)
    return out.float() / float(FREE_CLASS)
