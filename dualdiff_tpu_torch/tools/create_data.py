"""Offline data prep: build ``nuscenes_infos_{train,val}.pkl``; the JAX
package's ``tools/create_data.py`` for the port.

    python -m dualdiff_tpu_torch.tools.create_data --dataroot data/nuscenes \
        --version v1.0-trainval --out data/nuscenes_infos

Needs the nuscenes-devkit and the dataset on disk, imported when the tool
runs (it says so when they are missing).  The pickles are the JAX tool's,
field for field, and what ``data.nuscenes.NuScenesDataset`` reads per
sample: token, scene, timestamp, location, description, timeofday,
cams{name: data_path, cam_intrinsic, sensor2lidar_rotation,
sensor2lidar_translation}, lidar2ego, ego2global, gt_boxes (N, 7)
(bottom-centre x, y, z, l, w, h, yaw in the lidar frame), gt_names,
visibility; ``{"infos": [...], "metadata": {"version": ...}}``.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

VIEW_ORDER = [
    "CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
    "CAM_BACK_RIGHT", "CAM_BACK", "CAM_BACK_LEFT",
]


def quaternion_to_matrix(q):
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


def create_nuscenes_infos(dataroot: str, version: str, out_dir: str):
    NuScenes, splits = _devkit()

    nusc = NuScenes(version=version, dataroot=dataroot, verbose=True)
    if "mini" in version:
        train_scenes, val_scenes = splits.mini_train, splits.mini_val
    else:
        train_scenes, val_scenes = splits.train, splits.val
    scene_name = {s["token"]: s["name"] for s in nusc.scene}
    scene_desc = {s["token"]: s["description"] for s in nusc.scene}
    scene_log = {s["token"]: nusc.get("log", s["log_token"])
                 for s in nusc.scene}

    train_infos, val_infos = [], []
    for sample in nusc.sample:
        scene_t = sample["scene_token"]
        name = scene_name[scene_t]
        lidar_sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        cs_lidar = nusc.get("calibrated_sensor",
                            lidar_sd["calibrated_sensor_token"])
        l2e_r = quaternion_to_matrix(cs_lidar["rotation"])
        l2e_t = np.array(cs_lidar["translation"])

        cams = {}
        for cam in VIEW_ORDER:
            sd = nusc.get("sample_data", sample["data"][cam])
            cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
            # sensor->lidar via shared ego frame at (approximately) the same
            # timestamp (keyframes), reference nuscenes_converter.py:232-249
            s2e_r = quaternion_to_matrix(cs["rotation"])
            s2e_t = np.array(cs["translation"])
            s2l_r = l2e_r.T @ s2e_r
            s2l_t = l2e_r.T @ (s2e_t - l2e_t)
            cams[cam] = {
                "data_path": sd["filename"],
                "cam_intrinsic": np.array(cs["camera_intrinsic"]),
                "sensor2lidar_rotation": s2l_r,
                "sensor2lidar_translation": s2l_t,
            }

        ego_pose = nusc.get("ego_pose", lidar_sd["ego_pose_token"])
        e2g_r = quaternion_to_matrix(ego_pose["rotation"])
        e2g_t = np.array(ego_pose["translation"])
        l2e = np.eye(4)
        l2e[:3, :3], l2e[:3, 3] = l2e_r, l2e_t
        e2g = np.eye(4)
        e2g[:3, :3], e2g[:3, 3] = e2g_r, e2g_t

        boxes, names, vis = [], [], []
        for ann_t in sample["anns"]:
            ann = nusc.get("sample_annotation", ann_t)
            box = nusc.get_box(ann_t)
            # move into lidar frame
            center = l2e_r.T @ (e2g_r.T @ (box.center - e2g_t) - l2e_t)
            rot = l2e_r.T @ e2g_r.T @ quaternion_to_matrix(
                list(box.orientation))
            yaw = np.arctan2(rot[1, 0], rot[0, 0])
            w, l, h = box.wlh
            # bottom-center origin; dims ordered (x_size=l, y_size=w, h) with
            # the DIRECT box yaw (mmdet3d-1.0 convention, matching
            # ops/boxes.py::box_corners — not the legacy (w,l,h, -yaw-pi/2))
            boxes.append([*center[:2], center[2] - h / 2, l, w, h, yaw])
            names.append(_map_name(ann["category_name"]))
            vis.append(int(ann["visibility_token"]))
        info = {
            "token": sample["token"],
            "scene": name,  # scene-ratio sub-sampling (data/scenes.py)
            "timestamp": sample["timestamp"],
            "location": scene_log[scene_t]["location"],
            "description": scene_desc[scene_t],
            "timeofday": "night" if "night" in scene_desc[scene_t].lower()
            else "day",
            "cams": cams,
            # pose matrices for live BEV rasterization (data/bev_raster.py)
            "lidar2ego": l2e.astype(np.float32),
            "ego2global": e2g.astype(np.float32),
            "gt_boxes": np.array(boxes, np.float32).reshape(-1, 7),
            "gt_names": names,
            "visibility": np.array(vis, np.int64),
        }
        (train_infos if name in train_scenes else
         val_infos if name in val_scenes else []).append(info)

    os.makedirs(out_dir, exist_ok=True)
    for split, infos in (("train", train_infos), ("val", val_infos)):
        path = os.path.join(out_dir, f"nuscenes_infos_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"infos": infos, "metadata": {"version": version}}, f)
        print(f"wrote {len(infos)} infos -> {path}")


def _devkit():
    """The nuscenes-devkit's ``NuScenes`` and ``splits``, imported on use:
    the port does not ship the devkit."""
    try:
        from nuscenes import NuScenes
        from nuscenes.utils import splits
    except ImportError as e:
        raise SystemExit(
            f"create_data needs the nuscenes-devkit (pip install "
            f"nuscenes-devkit) and the dataset on disk: {e}") from e
    return NuScenes, splits


_NAME_MAP = {
    "vehicle.car": "car", "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle", "vehicle.bus": "bus",
    "vehicle.trailer": "trailer", "movable_object.barrier": "barrier",
    "vehicle.motorcycle": "motorcycle", "vehicle.bicycle": "bicycle",
    "human.pedestrian": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
}


def _map_name(category: str) -> str:
    for prefix, name in _NAME_MAP.items():
        if category.startswith(prefix):
            return name
    return "ignore"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", default="data/nuscenes")
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--out", default="data/nuscenes_infos")
    a = ap.parse_args(argv)
    create_nuscenes_infos(a.dataroot, a.version, a.out)


if __name__ == "__main__":
    main()
