"""Video (clip) dataset and collate for DualDiff+ clip generation.

The port's copy of ``dualdiff_tpu/data/video.py`` (numpy only).

Clip batch layout: frame OUTER, camera INNER.  Every per-frame tensor
flattens (clips, frames) into the image path's batch dim, so the image
conditioning stack is reused as it is; only the UNet's temporal modules see
the frame structure (its ``num_frames``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .collate import collate_fn
from .synthetic import SyntheticNuScenes

__all__ = ["SyntheticNuScenesVideo", "ClipDataset", "collate_video"]


class ClipDataset:
    """Group a frame-level dataset into fixed-length clips of consecutive
    indices (nuScenes keyframes are time-ordered)."""

    def __init__(self, frames, num_frames: int = 16,
                 stride: Optional[int] = None):
        self.frames = frames
        self.num_frames = num_frames
        self.stride = stride or num_frames

    def __len__(self):
        n = (len(self.frames) - self.num_frames) // self.stride + 1
        return max(n, 0)

    def __getitem__(self, idx: int) -> List[Dict]:
        start = idx * self.stride
        return [self.frames[start + i] for i in range(self.num_frames)]


class SyntheticNuScenesVideo(ClipDataset):
    """Synthetic clips: ``num_clips * num_frames`` consecutive synthetic
    samples of one seed."""

    def __init__(self, num_clips: int = 4, num_frames: int = 8,
                 image_size=(224, 400), seed: int = 0):
        frames = SyntheticNuScenes(
            num_samples=num_clips * num_frames, image_size=image_size,
            seed=seed)
        super().__init__(frames, num_frames=num_frames)


def collate_video(clips: Sequence[List[Dict]], cfg, tokenizer,
                  is_train: bool = True,
                  rng: Optional[np.random.Generator] = None) -> Dict:
    """Collate a batch of clips: one ``collate_fn`` over the frames, clip
    by clip, frame outer.  Adds the ``num_frames`` and ``clip_batch``
    meta keys."""
    rng = rng or np.random.default_rng()
    flat = [frame for clip in clips for frame in clip]
    batch = collate_fn(flat, cfg, tokenizer, is_train=is_train, rng=rng)
    batch["num_frames"] = len(clips[0])
    batch["clip_batch"] = len(clips)
    return batch
