"""Batch tensors and per-branch conditioning for generation and training.

Port of ``prepare_batch`` and ``compute_branch_conds`` from
``dualdiff_tpu/runner/trainer.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.ors import filter_fg_bg, occupancy_ray_sample

__all__ = ["prepare_batch", "to_device", "compute_branch_conds"]

_KEYS = ("pixel_values", "bev_map", "camera_param", "input_ids",
         "uncond_ids", "occ_labels", "occ_cam_K", "occ_cam_T",
         "latent_moments", "ors_rays")


def prepare_batch(batch: Dict, device) -> Dict:
    """Collate output -> flat dict of tensors on ``device`` (drops meta),
    including the FGM aug-loss inputs ``fgm_bboxes``, ``fgm_masks`` and
    ``fgm_lidar2image`` when the batch has them, and the conditioning
    cache's ``latent_moments`` and ``ors_rays`` when it has them.  A
    ``collate_video`` batch is already flat (clips x frames on the batch
    dim); its ``num_frames`` and ``clip_batch`` meta keys are dropped too."""
    to = lambda a: torch.as_tensor(np.asarray(a), device=device)
    out = {k: to(batch[k]) for k in _KEYS if k in batch}
    for i, br in enumerate(batch["branches"]):
        if br["cond"] is not None:
            out[f"cond_{i}"] = to(br["cond"])
        if br["bboxes_3d"] is not None:
            out[f"boxes_{i}"] = {k: to(v) for k, v in br["bboxes_3d"].items()}
    if "fgm" in batch:
        for k in ("bboxes", "masks", "lidar2image"):
            out[f"fgm_{k}"] = to(batch["fgm"][k])
    return out


def to_device(batch: Dict, device) -> Dict:
    """A ``prepare_batch`` dict (tensors, and dicts of them) on ``device``;
    a host tensor in pinned memory copies asynchronously."""
    return {k: to_device(v, device) if isinstance(v, dict)
            else v.to(device, non_blocking=True) for k, v in batch.items()}


def compute_branch_conds(models: Dict, batch: Dict,
                         latent_hw: Tuple[int, int],
                         image_hw: Tuple[int, int]) -> List[Optional[torch.Tensor]]:
    """Each branch's conditioning tensor.  ORS branches (``occ_3d``) sample
    their ray tensor on the device; its depth axis doubles as the
    conditioning channels, so sample_point == block_out_channels[0].  A
    batch that carries precomputed ``ors_rays`` (the trainer's
    conditioning cache) skips the sampling: only ``filter_fg_bg`` runs."""
    conds = []
    rays = batch.get("ors_rays")
    sample_point = int(models["unet"].block_out_channels[0])
    for i, spec in enumerate(models["specs"]):
        cond = batch.get(f"cond_{i}")
        if spec.cond_kind == "occ_3d":
            if rays is None:
                rays = occupancy_ray_sample(
                    batch["occ_labels"], batch["occ_cam_K"],
                    batch["occ_cam_T"], latent_hw, image_hw,
                    sample_point=sample_point)
            cond = filter_fg_bg(rays, spec.occ_fg, spec.occ_bg)
        conds.append(cond)
    return conds
