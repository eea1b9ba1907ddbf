"""DualDiff+ video training: stage 1 (ST-Attn / temporal) and stage 2 (RGD).

Port of ``dualdiff_tpu/runner/video_trainer.py``.  A clip dataset's item is
a list of frame samples; ``collate_video`` flattens clips x frames into the
image path's batch dim, frame outer, so the conditioning stack runs per
frame and only the UNet's video modules see the frames.  One timestep per
clip.

* Stage 1 (``video_16f``): ``only_new`` plus both ControlNets train, with
  ST-Attn and temporal attention in every UNet transformer block.
* Stage 2 (``rgd_stage2``, ``video.rgd.enable``): only the LoRA adapters of
  the UNet's attn1 / attn2 train (``trainable_state=lora_only``), and the
  loss subtracts ``video.rgd.reward_weight`` times the reward of the decoded
  denoised prediction (``make_rgd_reward``: the FGM foreground reward plus
  the temporal-consistency reward).

Checkpoints, resume and export are the image trainer's: stage 2's
checkpoint holds only the LoRA trainables' optimizer state, and its export
carries the adapters under the JAX exporter's names
(``to_out.0_lora_*``).

Parallelism is the image trainer's: ``runner.train_batch_size`` counts
clips, and the frame-flattened rows (clips x frames, clip-major) divide
over ``data`` as the JAX rule splits them: a rank holds whole clips, or a
run of one clip's frames when the clips are fewer than the data ranks
(the frame split: ``Mesh.split`` forms the frame groups, and ST-Attn,
the temporal attention and the temporal reward gather the clip's other
frames from them).  Each rank's draws are its rows of the global draws
(one timestep per clip).

Flip augmentation is clip-consistent: one draw per clip, applied to every
frame.  The conditioning cache keys each row by (clip, frame, flipped);
stage 2 keeps the pixels in a cached batch for the reward.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..data.augment import random_flip_3d_with_views
from ..data.video import collate_video
from .rewards import make_rgd_reward
from .trainer import MultiviewTrainer, make_loss_fn

__all__ = ["VideoTrainer"]


class VideoTrainer(MultiviewTrainer):
    """``VideoTrainer(cfg, clips).run(max_steps, on_metrics)`` trains on the
    card; ``device="cpu"`` runs the plain path.  ``cfg.use_video`` must be
    set, so that the factory builds the video UNet (with LoRA when
    ``video.rgd.enable``).  Stage 2's metrics add ``reward``."""

    def __init__(self, cfg, train_set, device=None,
                 models: Optional[Dict] = None, mesh=None):
        if not cfg.get("use_video"):
            raise ValueError("VideoTrainer needs use_video=true")
        self.frames = int(cfg.video.num_frames)
        super().__init__(cfg, train_set, device=device, models=models,
                         mesh=mesh)

    def _make_loss_fn(self):
        rgd = self.cfg.video.rgd
        kw = {}
        if bool(rgd.enable):
            kw = dict(reward_fn=make_rgd_reward(self.cfg),
                      reward_weight=float(rgd.reward_weight),
                      reward_frames=int(rgd.get("reward_frames") or 0))
        return make_loss_fn(self.models, self.cfg, self.schedule,
                            self.latent_hw, self.image_hw, frames=self.frames,
                            cached_cond=self.cache_cond, split=self.split,
                            **kw)

    def _collate_items(self, items, rng, pre_augmented: bool = False) -> Dict:
        if not pre_augmented:
            items, _ = self._augment_items(items, rng)
        return collate_video(items, self.cfg, self.tokenizer, rng=rng)

    def _augment_items(self, items, rng):
        """-> (clips, flipped flags): one draw of ``rng`` per clip decides
        its flip, applied to every frame (``flip_ratio=1.0``), so the frames
        ST-Attn couples stay one scene; no draw at ``flip_ratio`` 0."""
        flip = self._flip_ratio()
        if flip <= 0:
            return items, [False] * len(items)
        out, flags = [], []
        for clip in items:
            do = bool(rng.random() < flip)
            if do:
                clip = [random_flip_3d_with_views(fr, rng, flip_ratio=1.0)
                        for fr in clip]
            out.append(clip)
            flags.append(do)
        return out, flags

    def _cond_keys(self, idxs, flips) -> list:
        """One key per row, frame outer per clip as ``collate_video`` lays
        them out: (clip, frame, flipped)."""
        return [(i, f, fl) for i, fl in zip(idxs, flips)
                for f in range(self.frames)]
