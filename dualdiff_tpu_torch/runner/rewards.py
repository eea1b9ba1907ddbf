"""RGD reward models (DualDiff+ stage 2, arXiv 2505.01857).

Port of ``dualdiff_tpu/runner/rewards.py``.  The reward guides the denoised
prediction toward faithful foreground objects and temporally consistent
motion; the trainer subtracts ``reward_weight * mean(reward)`` from the
loss.

Layout: images are NCHW ``(B*N, 3, H, W)``, as the port's VAE decodes them
(the JAX rewards take NHWC ``(B*N, H, W, 3)``); every reward reduces over
the same elements per image, so the scores are the JAX package's.  Clips
fold into the batch dim frame-outer, camera-inner.

* ``mse_proxy_reward``: negative pixel MSE per image.
* ``fgm_foreground_reward``: negative MSE weighted by ``1 + fg_boost *
  heat``, normalised to mean 1 per image; ``heat`` is the FGM box heatmap
  rasterised at 1/8 of the image size and upsampled nearest by 8.
* ``temporal_consistency_reward``: negative MSE between the predicted and
  the ground-truth frame-to-frame differences, one score per clip repeated
  over its images.  Under a mesh ``Split`` the clip's other frames are
  gathered from the frame group (``gather_runs``: the differences cross
  the ranks' boundary, and a prefix of each clip leaves the ranks runs of
  different lengths) and its other cameras' partial sums added over the
  view group (``all_sum``), so every rank of a clip reads the same score.
* ``make_rgd_reward(cfg)``: the combination ``video.rgd`` selects.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.fgm import fgm_heatmap
from ..parallel.collectives import Split, all_sum, as_split, gather_runs

__all__ = ["mse_proxy_reward", "fgm_foreground_reward",
           "temporal_consistency_reward", "make_rgd_reward"]


def mse_proxy_reward(pred: torch.Tensor, gt: torch.Tensor,
                     batch: Dict) -> torch.Tensor:
    """Negative pixel MSE, one score per image (B*N,)."""
    return -((pred.float() - gt.float()) ** 2).mean(dim=(1, 2, 3))


def _image_heat(batch: Dict, hw: Tuple[int, int]) -> torch.Tensor:
    """The FGM heatmap at (h/8, w/8) upsampled nearest to (h, w) ->
    (B*N, h, w).  ``nearest-exact`` (half-pixel centres) is
    ``jax.image.resize(..., "nearest")``."""
    h, w = hw
    heat = fgm_heatmap(batch["fgm_bboxes"], batch["fgm_masks"],
                       batch["fgm_lidar2image"], (w // 8, h // 8))
    heat = heat.flatten(0, 1)[:, None]
    return F.interpolate(heat, size=(h, w), mode="nearest-exact")[:, 0]


def fgm_foreground_reward(pred: torch.Tensor, gt: torch.Tensor, batch: Dict,
                          fg_boost: float = 4.0) -> torch.Tensor:
    """Foreground-fidelity reward: negative MSE with per-pixel weight
    ``1 + fg_boost * heat`` normalised to mean 1 per image, (B*N,)."""
    pred, gt = pred.float(), gt.float()
    wgt = 1.0 + fg_boost * _image_heat(batch, tuple(pred.shape[2:]))
    wgt = wgt / wgt.mean(dim=(1, 2), keepdim=True)
    return -(((pred - gt) ** 2) * wgt[:, None]).mean(dim=(1, 2, 3))


def temporal_consistency_reward(pred: torch.Tensor, gt: torch.Tensor,
                                frames: int, n_cam: int,
                                split: Optional[Split] = None
                                ) -> torch.Tensor:
    """Motion-fidelity reward: negative MSE between the predicted and the
    ground-truth frame differences of each clip, repeated over the clip's
    ``frames * n_cam`` images, (B*N,).  ``split``: ``pred`` and ``gt``
    hold this rank's ``n_cam`` cameras of a run of frames, whose length
    may differ between the ranks of the frame group (see the module
    docstring)."""
    split = split or as_split(n_cam)
    rows, img = pred.shape[0] // n_cam, pred.shape[1:]
    both = torch.stack([pred.float(), gt.float()], dim=1)
    full, j0 = gather_runs(both.reshape(rows, n_cam, 2, *img),
                           split.frame_group)
    if full.shape[0] % frames:
        raise ValueError(f"{full.shape[0]} frames are not whole clips of "
                         f"{frames}")
    d = torch.diff(full.reshape(-1, frames, *full.shape[1:]), dim=1)
    part = all_sum(((d[:, :, :, 0] - d[:, :, :, 1]) ** 2).sum(
        dim=(1, 2, 3, 4, 5)), split.view_group)
    score = -part / ((frames - 1) * split.n_cam * img.numel())
    return score[[(j0 + i) // frames for i in range(rows)]] \
        .repeat_interleave(n_cam)


def make_rgd_reward(cfg):
    """reward(pred, gt, batch, split=None) -> (B*N,): ``video.rgd.reward``
    (``fgm_foreground``, or ``mse_proxy``, which a batch without FGM inputs
    also takes) plus ``video.rgd.temporal_weight`` times the temporal term
    over ``video.rgd.reward_frames`` (else ``video.num_frames``) frames per
    clip, the frames the trainer hands the reward."""
    rgd = cfg.video.rgd
    name = str(rgd.get("reward", "fgm_foreground"))
    fg_boost = float(rgd.get("fg_boost", 4.0))
    t_weight = float(rgd.get("temporal_weight", 0.5))
    frames = int(rgd.get("reward_frames") or cfg.video.num_frames)

    def reward(pred, gt, batch, split: Optional[Split] = None):
        if name == "fgm_foreground" and "fgm_bboxes" in batch:
            r = fgm_foreground_reward(pred, gt, batch, fg_boost=fg_boost)
        else:
            r = mse_proxy_reward(pred, gt, batch)
        if t_weight > 0 and frames > 1:
            n_cam = batch["camera_param"].shape[1]
            r = r + t_weight * temporal_consistency_reward(pred, gt, frames,
                                                           n_cam, split)
        return r

    return reward
