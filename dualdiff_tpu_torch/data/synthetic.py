"""Synthetic nuScenes-schema dataset.

Generates deterministic samples with the exact schema the real
``NuScenesDataset`` reader emits, so the full train/generate stack (collate,
conditioning, trainer, pipeline, bench) runs end-to-end in environments
without the nuScenes assets (this container has no dataset and no egress).
Geometry is a plausible 6-camera surround rig; boxes are placed in front of
cameras so visibility filters exercise their real paths.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["SyntheticNuScenes"]

LOCATIONS = ["singapore-onenorth", "boston-seaport", "singapore-queenstown"]
DESCRIPTIONS = [
    "clear day, light traffic", "rain, wet road", "night, street lights",
    "cloudy, many pedestrians",
]


def _camera_rig(rng: np.random.Generator, n_cam: int = 6):
    """6 surround cameras: yaw every 60deg, nuScenes-like intrinsics."""
    intrinsics = np.zeros((n_cam, 4, 4))
    cam2lidar = np.zeros((n_cam, 4, 4))
    for i in range(n_cam):
        fx = 1266.0 + rng.normal(0, 5)
        K = np.eye(4)
        K[0, 0], K[1, 1] = fx, fx
        K[0, 2], K[1, 2] = 800.0, 450.0
        intrinsics[i] = K
        yaw = np.deg2rad(60.0 * i - 110.0)
        # camera axes in lidar frame: z forward, x right, y down
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        R = np.stack([right, down, fwd], axis=1)  # cam->lidar rotation
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = fwd * 1.0 + np.array([0, 0, 1.6])
        cam2lidar[i] = T
    return intrinsics, cam2lidar


class SyntheticNuScenes:
    """len/getitem dataset; sample dict schema == real reader's."""

    def __init__(
        self,
        num_samples: int = 64,
        image_size: Tuple[int, int] = (224, 400),
        n_cam: int = 6,
        max_boxes: int = 24,
        with_occ_3d: bool = True,
        with_occ_image: bool = True,
        with_map_vec: bool = True,
        seed: int = 0,
    ):
        self.num_samples = num_samples
        self.image_size = tuple(image_size)
        self.n_cam = n_cam
        self.max_boxes = max_boxes
        self.with_occ_3d = with_occ_3d
        self.with_occ_image = with_occ_image
        self.with_map_vec = with_map_vec
        self.seed = seed

    def __len__(self) -> int:
        return self.num_samples

    def sample_meta(self):
        """[(token, scene)] without building samples (scene-ratio protocol,
        ``data/scenes.py``)."""
        return [(f"synthetic-{self.seed}-{i:06d}", f"scene-{i // 8:04d}")
                for i in range(self.num_samples)]

    def __getitem__(self, idx: int) -> Dict:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        h, w = self.image_size
        n_cam = self.n_cam
        intrinsics, cam2lidar = _camera_rig(rng, n_cam)
        lidar2camera = np.linalg.inv(cam2lidar)
        lidar2image = intrinsics @ lidar2camera
        # image aug: nuScenes 900x1600 -> resize w/1600 -> top-crop to (h, w)
        scale = w / 1600.0
        aug = np.eye(4)
        aug[0, 0] = aug[1, 1] = scale
        aug[1, 3] = h - 900.0 * scale  # top crop shifts y
        img_aug_matrix = np.tile(aug, (n_cam, 1, 1))

        n_box = int(rng.integers(3, self.max_boxes))
        centers = np.stack([
            rng.uniform(-35, 35, n_box),
            rng.uniform(-35, 35, n_box),
            rng.uniform(-1.0, 0.5, n_box),
        ], axis=1)
        dims = rng.uniform([1.5, 3.0, 1.4], [2.2, 5.5, 2.2], (n_box, 3))[:, [0, 1, 2]]
        yaw = rng.uniform(-np.pi, np.pi, (n_box, 1))
        gt_boxes = np.concatenate([centers, dims, yaw], axis=1).astype(np.float32)
        gt_labels = rng.integers(0, 10, n_box).astype(np.int64)

        img = rng.normal(0, 0.3, (n_cam, h, w, 3)).astype(np.float32).clip(-1, 1)
        masks_bev = (rng.random((18, 200, 200)) > 0.9).astype(np.uint8)
        visibility = rng.integers(1, 5, n_box).astype(np.int64)
        # aux channels through the real raster core (schema parity with the
        # reference's gt_aux_bev, pipeline.py:88-174)
        from .bev_raster import BEVRasterizer

        aux_bev = BEVRasterizer().rasterize_aux(
            gt_boxes, visibility.astype(np.float32))

        token = f"synthetic-{self.seed}-{idx:06d}"
        scene = f"scene-{idx // 8:04d}"  # 8-frame synthetic scenes
        cams = ["CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
                "CAM_BACK_RIGHT", "CAM_BACK", "CAM_BACK_LEFT"][:n_cam]
        sample = {
            "token": token,
            "scene": scene,
            "filenames": [f"samples/{c}/{token}_{c}.jpg" for c in cams],
            "location": LOCATIONS[idx % len(LOCATIONS)],
            "description": DESCRIPTIONS[idx % len(DESCRIPTIONS)],
            "timeofday": "day" if idx % 3 else "night",
            "img": img,
            "gt_bboxes_3d": gt_boxes,
            "gt_labels_3d": gt_labels,
            "gt_masks_bev": masks_bev,
            "gt_aux_bev": aux_bev,
            "visibility": visibility,
            "camera_intrinsics": intrinsics.astype(np.float32),
            "lidar2camera": lidar2camera.astype(np.float32),
            "camera2lidar": cam2lidar.astype(np.float32),
            "lidar2image": lidar2image.astype(np.float32),
            "img_aug_matrix": img_aug_matrix.astype(np.float32),
        }
        if self.with_occ_3d:
            occ = np.full((200, 200, 16), 17, np.uint8)
            # carve some ground (bg class 11) and box voxels (fg classes)
            occ[:, :, :2] = 11
            for c, l in zip(centers, gt_labels):
                ix = int((c[0] + 40) / 80 * 200)
                iy = int((c[1] + 40) / 80 * 200)
                if 0 <= ix < 198 and 0 <= iy < 198:
                    occ[ix:ix + 3, iy:iy + 3, 2:6] = (l % 10) + 1
            sample["occ_labels"] = occ
            sample["occ_cam_K"] = intrinsics[:, :3, :3].astype(np.float32)
            sample["occ_cam_T"] = cam2lidar.astype(np.float32)
        if self.with_occ_image:
            sample["occ_proj_image"] = rng.uniform(
                0, 1, (h, w * n_cam, 3)).astype(np.float32)
        if self.with_map_vec:
            n_vec = int(rng.integers(2, 12))
            pts = rng.uniform(-40, 40, (n_vec, 8, 2))
            vecs = np.concatenate(
                [pts, np.zeros((n_vec, 8, 1))], axis=-1).astype(np.float32)
            sample["map_vec_boxes"] = vecs
            sample["map_vec_classes"] = rng.integers(0, 3, n_vec).astype(np.int64)
        return sample
