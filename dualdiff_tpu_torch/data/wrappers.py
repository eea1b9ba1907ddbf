"""Dataset wrappers and the config-driven dataset constructor.

Port of ``dualdiff_tpu/data/wrappers.py`` (numpy and the standard library).
``build_dataset`` builds ``SyntheticNuScenes`` (seed + 1 off the train
split) and, with ``use_video``, groups it into clips (``ClipDataset``).
The nuScenes reader is not ported yet (ROADMAP Queue 1 #6): its dataset
type is refused by name.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Sequence

import numpy as np

__all__ = ["ListSetWrapper", "FolderSetWrapper", "build_dataset"]


class ListSetWrapper:
    """Index-subset view of a dataset."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    def sample_meta(self):
        inner = self.dataset.sample_meta()
        return [inner[i] for i in self.indices]


class FolderSetWrapper:
    """Samples stored one file per item: ``.npz`` (read with numpy) or
    ``.pkl``, in sorted file-name order."""

    def __init__(self, folder: str):
        self.files = sorted(
            os.path.join(folder, f) for f in os.listdir(folder)
            if f.endswith((".pkl", ".npz")))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i) -> Dict:
        path = self.files[i]
        if path.endswith(".npz"):
            return dict(np.load(path, allow_pickle=True))
        with open(path, "rb") as f:
            return pickle.load(f)


def build_dataset(cfg, split: str = "train"):
    """The dataset ``cfg.dataset`` names for ``split``; with ``use_video``
    grouped into clips of ``video.num_frames`` frames."""
    ds = _build_frames(cfg, split)
    if cfg.get("use_video"):
        from .video import ClipDataset

        return ClipDataset(ds, num_frames=int(cfg.video.num_frames))
    return ds


def _build_frames(cfg, split: str):
    d = cfg.dataset
    kind = str(d.dataset_type)
    if kind == "SyntheticNuScenes":
        from .synthetic import SyntheticNuScenes

        return SyntheticNuScenes(
            num_samples=int(d.get("num_samples", 64)),
            image_size=tuple(d.image_size),
            seed=int(cfg.seed) + (0 if split == "train" else 1),
        )
    raise NotImplementedError(
        f"dataset_type {kind!r}: the nuScenes reader (data/nuscenes.py) is "
        f"not ported yet (ROADMAP Queue 1 #6); the port builds "
        f"'SyntheticNuScenes' (dataset=Nuscenes_synthetic)")
