"""Dataset wrappers and the config-driven dataset constructor.

Port of ``dualdiff_tpu/data/wrappers.py`` (numpy and the standard library).
``build_dataset`` builds ``SyntheticNuScenes`` (seed + 1 off the train
split) or the nuScenes reader (``data/nuscenes.py``) from ``cfg.dataset``
and, with ``use_video``, groups it into clips (``ClipDataset``).
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


def build_dataset(cfg, split: str = "train", load_images: bool = True,
                  load_bev: bool = True):
    """The dataset ``cfg.dataset`` names for ``split``; with ``use_video``
    grouped into clips of ``video.num_frames`` frames.  ``load_images`` and
    ``load_bev`` reach the nuScenes reader (the FID tool's pairing reads
    neither)."""
    ds = _build_frames(cfg, split, load_images, load_bev)
    if cfg.get("use_video"):
        from .video import ClipDataset

        return ClipDataset(ds, num_frames=int(cfg.video.num_frames))
    return ds


def _build_frames(cfg, split: str, load_images: bool = True,
                  load_bev: bool = True):
    d = cfg.dataset
    kind = str(d.dataset_type)
    if kind == "SyntheticNuScenes":
        from .synthetic import SyntheticNuScenes

        return SyntheticNuScenes(
            num_samples=int(d.get("num_samples", 64)),
            image_size=tuple(d.image_size),
            seed=int(cfg.seed) + (0 if split == "train" else 1),
        )
    from .collate import branch_specs_from_cfg
    from .nuscenes import NuScenesDataset

    # a config whose branches never condition on bev_map may run without a
    # mask cache (warn-once zeros); bev_map-conditioned training must not
    missing_bev = d.get("missing_bev") or (
        "error" if any(s.cond_kind == "bev_map"
                       for s in branch_specs_from_cfg(cfg)) else "zeros")
    split_cfg = d.data[split]
    cache = d.dataset_cache_file
    cache_file = cache[0 if split == "train" else 1] \
        if isinstance(cache, list) else cache
    return NuScenesDataset(
        ann_file=str(split_cfg.ann_file),
        dataset_root=str(d.dataset_root),
        object_classes=list(d.object_classes),
        image_size=tuple(d.image_size),
        resize_ratio=float(d.augment2d.resize[0][0]),
        view_order=list(d.view_order),
        cache_file=cache_file,
        occ_proj_root=d.get("occ_proj_root"),
        occ3d_root=d.get("occ3d_root"),
        map_vec_root=d.get("map_vec_root"),
        visibility_threshold=int(d.visibility_threshold),
        load_images=load_images,
        missing_bev=str(missing_bev),
        load_bev=load_bev,
        point_cloud_range=d.get("point_cloud_range"),
        aux_data=list(d.get("aux_data") or []),
    )
