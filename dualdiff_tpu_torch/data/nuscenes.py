"""nuScenes reader over the infos pkl (``tools/create_data.py``'s schema).

The port's copy of ``dualdiff_tpu/data/nuscenes.py`` (numpy, with PIL, h5py
and the nuscenes-devkit as lazy imports in the branches that need them).
Each sample: the six camera images, decoded in one native batch
(``data/native.py``) resized by ``augment2d.resize`` and bottom-cropped to
``image_size``, or through this module's own bilinear resize and crop for a
non-JPEG or a failed decode; the camera matrices (a quaternion
``sensor2lidar_rotation`` turned into a rotation); the boxes, filtered by
visibility and, with ``point_cloud_range``, by range; the (18, 200, 200)
BEV masks from the h5 cache (``tools/prepare_map_aux.py``), else rasterised
live through the devkit's map expansion, else refused (``missing_bev=error``)
or zeros (``missing_bev=zeros``, for configs whose branches never condition
on ``bev_map``); the aux raster; and, under ``occ_proj_root``,
``occ3d_root`` and ``map_vec_root``, the occupancy panorama, the Occ3D
labels and the map vectors of each token.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

__all__ = ["NuScenesDataset", "read_rgb"]


def read_rgb(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8, decoded by PIL: the reader's own
    decode, and the FID and FVD tools' for every image, as the JAX tools
    decode."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _quat_to_rot(q: Sequence[float]) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    s = 2.0 / n if n > 0 else 0.0
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ])


class NuScenesDataset:
    def __init__(
        self,
        ann_file: str,
        dataset_root: str = "data/nuscenes/",
        object_classes: Sequence[str] = (),
        image_size: Tuple[int, int] = (224, 400),
        resize_ratio: float = 0.25,
        view_order: Sequence[str] = (
            "CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
            "CAM_BACK_RIGHT", "CAM_BACK", "CAM_BACK_LEFT"),
        cache_file: Optional[str] = None,
        occ_proj_root: Optional[str] = None,
        occ3d_root: Optional[str] = None,
        map_vec_root: Optional[str] = None,
        visibility_threshold: int = 1,
        load_images: bool = True,
        missing_bev: str = "error",  # error | zeros
        load_bev: bool = True,
        point_cloud_range: Optional[Sequence[float]] = None,
        aux_data: Optional[Sequence[str]] = None,
    ):
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        self.infos = data["infos"] if isinstance(data, dict) else data
        if isinstance(data, dict) and "metadata" in data:
            log.info("nuscenes infos version: %s", data["metadata"])
        self.infos = sorted(self.infos, key=lambda e: e["timestamp"]) \
            if self.infos and "timestamp" in self.infos[0] else self.infos
        self.dataset_root = dataset_root
        self.object_classes = list(object_classes)
        self.image_size = tuple(image_size)
        self.resize_ratio = resize_ratio
        self.view_order = list(view_order)
        self.cache_file = cache_file
        self.occ_proj_root = occ_proj_root
        self.occ3d_root = occ3d_root
        self.map_vec_root = map_vec_root
        self.visibility_threshold = visibility_threshold
        self.load_images = load_images
        assert missing_bev in ("error", "zeros"), missing_bev
        self.missing_bev = missing_bev
        self.load_bev = load_bev
        self.point_cloud_range = (
            None if point_cloud_range is None else list(point_cloud_range))
        self.aux_data = list(aux_data or [])
        self._h5 = None
        self._nusc_maps = {}  # location -> NuScenesMap (live-raster path)
        self._live_memo = {}  # token -> (C, 200, 200) uint8
        self._aux_memo = {}  # token -> (C_aux, 200, 200) f32
        self._warned_zero_bev = False

    def __len__(self) -> int:
        return len(self.infos)

    def sample_meta(self):
        """[(token, scene)] from the infos, with no image read (the scene
        sub-sampling of ``data/scenes.py``).  Infos without a ``scene``
        field group by ``scene_token``, else by location."""
        return [(info["token"],
                 str(info.get("scene") or info.get("scene_token")
                     or info.get("location", "scene-unknown")))
                for info in self.infos]

    # ------------------------------------------------------------------
    def _load_image(self, path: str) -> np.ndarray:
        """This reader's own decode: PIL's bilinear resize by the ratio,
        then the bottom crop, in [-1, 1]."""
        from PIL import Image

        h, w = self.image_size
        img = Image.open(os.path.join(self.dataset_root, path)).convert("RGB")
        iw, ih = img.size
        rw, rh = int(iw * self.resize_ratio), int(ih * self.resize_ratio)
        img = img.resize((rw, rh), Image.BILINEAR)
        left = max((rw - w) // 2, 0)
        top = max(rh - h, 0)  # keep the bottom rows
        img = img.crop((left, top, left + w, top + h))
        arr = np.asarray(img, np.float32) / 255.0
        return arr * 2.0 - 1.0

    def _aug_matrix(self, iw: int, ih: int) -> np.ndarray:
        h, w = self.image_size
        rw, rh = int(iw * self.resize_ratio), int(ih * self.resize_ratio)
        m = np.eye(4)
        m[0, 0] = m[1, 1] = self.resize_ratio
        m[0, 3] = -max((rw - w) // 2, 0)
        m[1, 3] = -(max(rh - h, 0))
        return m

    def _h5_file(self):
        import h5py

        if self._h5 is None:
            self._h5 = h5py.File(self.cache_file, "r")
        return self._h5

    def _bev_masks(self, info: Dict, boxes7d: np.ndarray,
                   labels: np.ndarray) -> np.ndarray:
        """(18, 200, 200) BEV masks: the h5 cache, else the live raster,
        else zeros (``missing_bev=zeros``) or an error."""
        token = info["token"]
        if self.cache_file:
            h5 = self._h5_file()
            if token in h5:
                return self._unpack(np.asarray(h5[token]))
        live = self._live_bev_masks(info, boxes7d, labels)
        if live is not None:
            return live
        if self.missing_bev == "zeros":
            if not self._warned_zero_bev:
                self._warned_zero_bev = True
                log.warning(
                    "BEV mask cache miss for %s and live rasterization "
                    "unavailable — returning ZERO masks (missing_bev=zeros; "
                    "no branch conditions on bev_map in this config).", token)
            return np.zeros((18, 200, 200), np.uint8)
        raise RuntimeError(
            f"BEV masks unavailable for sample {token}: not in cache "
            f"({self.cache_file!r}) and live rasterization needs the "
            "nuscenes-devkit map expansion plus ego2global/lidar2ego in the "
            "infos pkl (re-run tools/create_data.py) — refusing to train on "
            "all-zero map conditioning. Prebuild the cache with "
            "tools/prepare_map_aux.py or set dataset.missing_bev=zeros if "
            "the bev_map branch is unused.")

    def _live_bev_masks(self, info: Dict, boxes7d: np.ndarray,
                        labels: np.ndarray) -> Optional[np.ndarray]:
        """The raster of the devkit's map around the sample's pose, and its
        boxes (needs the map expansion and the pose matrices in the
        infos).  Memoised per token."""
        token = info["token"]
        if token in self._live_memo:
            return self._live_memo[token]
        loc = info.get("location")
        if not loc or "ego2global" not in info or "lidar2ego" not in info:
            return None
        try:
            from nuscenes.map_expansion.map_api import NuScenesMap
        except ImportError:
            return None
        from .bev_raster import (BEVRasterizer, MAP_CLASSES,
                                 bottom_corners_from_boxes7d,
                                 extract_map_geoms)
        if loc not in self._nusc_maps:
            try:
                self._nusc_maps[loc] = NuScenesMap(self.dataset_root, loc)
            except Exception as e:  # map expansion not on disk
                log.warning("live BEV raster disabled: %s", e)
                self._nusc_maps[loc] = None
        nmap = self._nusc_maps[loc]
        if nmap is None:
            return None
        rast = BEVRasterizer()
        l2g = np.asarray(info["ego2global"]) @ np.asarray(info["lidar2ego"])
        cx, cy = l2g[:2, 3]
        yaw = np.arctan2(l2g[1, 0], l2g[0, 0])
        geoms = extract_map_geoms(nmap, MAP_CLASSES, (cx, cy), 75.0)
        geoms = {
            name: {kind: [rast.world_to_lidar(p, (cx, cy), yaw) for p in lst]
                   for kind, lst in g.items()}
            for name, g in geoms.items()
        }
        out = rast.rasterize_map(geoms)
        # the object channels take every box of the class list, before the
        # visibility filter, as the cache tool does
        rast.rasterize_objects(
            bottom_corners_from_boxes7d(boxes7d), labels, out=out)
        self._live_memo[token] = out
        return out

    def _bev_aux(self, info: Dict, boxes7d: np.ndarray) -> np.ndarray:
        """The object aux raster (visibility, center offset, center ohw,
        height): the h5 cache's ``aux/<token>``, else rasterised from the
        infos' boxes."""
        token = info["token"]
        if token in self._aux_memo:
            return self._aux_memo[token]
        if self.cache_file:
            h5 = self._h5_file()
            key = f"aux/{token}"
            if key in h5:
                return np.asarray(h5[key], np.float32)
        from .bev_raster import BEVRasterizer

        vis = np.asarray(info.get(
            "visibility", np.zeros(len(boxes7d))), np.float32)
        out = BEVRasterizer().rasterize_aux(
            boxes7d, vis[: len(boxes7d)], self.aux_data)
        self._aux_memo[token] = out
        return out

    @staticmethod
    def _unpack(packed: np.ndarray, channels: int = 18) -> np.ndarray:
        """Bit-packed words -> (C, 200, 200) uint8 (native where built,
        else numpy); an unpacked uint8 cache entry passes through."""
        if packed.dtype == np.uint8 and packed.ndim == 3:
            return packed[:channels]
        from . import native

        out = native.unpack_masks(packed.astype(np.uint32), channels)
        if out is not None:
            return out
        bits = ((packed[None] >> np.arange(channels)[:, None, None]) & 1)
        return bits.astype(np.uint8)

    # ------------------------------------------------------------------
    def __getitem__(self, idx: int) -> Dict:
        info = self.infos[idx]
        token = info["token"]
        n_cam = len(self.view_order)

        intrinsics = np.zeros((n_cam, 4, 4))
        cam2lidar = np.zeros((n_cam, 4, 4))
        imgs = []
        aug_ms = []
        occ_K = np.zeros((n_cam, 3, 3), np.float32)
        occ_T = np.tile(np.eye(4, dtype=np.float32), (n_cam, 1, 1))
        for i, cam_name in enumerate(self.view_order):
            cam = info["cams"][cam_name]
            K = np.eye(4)
            K[:3, :3] = np.asarray(cam["cam_intrinsic"] if "cam_intrinsic" in cam
                                   else cam["camera_intrinsics"])
            intrinsics[i] = K
            T = np.eye(4)
            rot = np.asarray(cam["sensor2lidar_rotation"])
            if rot.shape == (4,):
                rot = _quat_to_rot(rot)
            T[:3, :3] = rot
            T[:3, 3] = np.asarray(cam["sensor2lidar_translation"])
            cam2lidar[i] = T
            occ_K[i] = K[:3, :3]
            occ_T[i] = T
            if self.load_images:
                path = cam["data_path"]
                full = path if os.path.isabs(path) else os.path.join(
                    self.dataset_root, path)
                imgs.append(full)  # decoded in one native batch below
                aug_ms.append(None)
            else:
                aug_ms.append(self._aug_matrix(1600, 900))
        if self.load_images:
            from . import native

            decoded = native.load_images_batch(
                imgs, self.resize_ratio, *self.image_size)
            if decoded is None:  # a non-JPEG, a failed decode, no library
                from PIL import Image

                sizes = []
                arrs = []
                for full in imgs:
                    with Image.open(full) as im:
                        sizes.append(im.size)
                    arrs.append(self._load_image(full))
                decoded = np.stack(arrs)
                aug_ms = [self._aug_matrix(iw, ih) for iw, ih in sizes]
            else:
                # the native path assumes the nuScenes 1600x900 frame
                aug_ms = [self._aug_matrix(1600, 900)] * n_cam
            imgs = decoded

        lidar2camera = np.linalg.inv(cam2lidar)
        lidar2image = intrinsics @ lidar2camera

        boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))), np.float32)
        names = info.get("gt_names", [])
        labels = np.array([
            self.object_classes.index(n) if n in self.object_classes else -1
            for n in names], np.int64)
        # the BEV raster takes the cache tool's class list and every box, so
        # a live raster equals a prebuilt cache
        from .bev_raster import OBJECT_CLASSES as BEV_OBJECT_CLASSES

        bev_labels = np.array([
            BEV_OBJECT_CLASSES.index(n) if n in BEV_OBJECT_CLASSES else -1
            for n in names], np.int64)
        masks_bev = (self._bev_masks(info, boxes, bev_labels) if self.load_bev
                     else np.zeros((18, 200, 200), np.uint8))
        aux_bev = (self._bev_aux(info, boxes)
                   if self.load_bev and self.aux_data else None)
        if "visibility" in info and self.visibility_threshold > 0:
            vis = np.asarray(info["visibility"], np.int64)
            keep = vis >= self.visibility_threshold
            boxes, labels = boxes[keep[: len(boxes)]], labels[keep[: len(labels)]]
        keep = labels >= 0
        boxes, labels = boxes[keep], labels[keep]
        if self.point_cloud_range is not None:
            from .augment import object_range_filter

            boxes, labels, _ = object_range_filter(
                boxes, labels, self.point_cloud_range)

        sample = {
            "token": token,
            "filenames": [info["cams"][c]["data_path"]
                          for c in self.view_order],
            "location": info.get("location", "unknown"),
            "description": info.get("description", ""),
            "timeofday": info.get("timeofday", ""),
            "gt_bboxes_3d": boxes[:, :7],
            "gt_labels_3d": labels,
            "gt_masks_bev": masks_bev,
            "camera_intrinsics": intrinsics.astype(np.float32),
            "lidar2camera": lidar2camera.astype(np.float32),
            "camera2lidar": cam2lidar.astype(np.float32),
            "lidar2image": lidar2image.astype(np.float32),
            "img_aug_matrix": np.stack(aug_ms).astype(np.float32),
        }
        if aux_bev is not None:
            sample["gt_aux_bev"] = aux_bev
        if self.load_images:
            sample["img"] = np.asarray(imgs, np.float32)

        if self.occ_proj_root:  # the six-view occupancy panorama
            for ext in (".npy", ".png"):
                p = os.path.join(self.occ_proj_root, token + ext)
                if os.path.exists(p):
                    if ext == ".npy":
                        sample["occ_proj_image"] = np.load(p).astype(
                            np.float32)
                    else:
                        from PIL import Image

                        sample["occ_proj_image"] = (
                            np.asarray(Image.open(p), np.float32) / 255.0)
                    break
        if self.occ3d_root:  # the Occ3D volume for ORS
            p = os.path.join(self.occ3d_root, token, "labels.npz")
            if os.path.exists(p):
                sample["occ_labels"] = np.load(p)["semantics"].astype(np.uint8)
                sample["occ_cam_K"] = occ_K
                sample["occ_cam_T"] = occ_T
        if self.map_vec_root:  # vectorised map polylines
            p = os.path.join(self.map_vec_root, token + ".pkl")
            if os.path.exists(p):
                with open(p, "rb") as f:
                    vec, cls = pickle.load(f)
                vec = np.asarray(vec, np.float32)
                if vec.ndim == 3 and vec.shape[-1] == 2:  # append z = 0
                    vec = np.concatenate(
                        [vec, np.zeros((*vec.shape[:2], 1), np.float32)], -1)
                sample["map_vec_boxes"] = vec
                sample["map_vec_classes"] = np.asarray(cls, np.int64)
        return sample
