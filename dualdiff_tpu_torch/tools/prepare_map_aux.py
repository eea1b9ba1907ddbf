"""Offline h5 cache of BEV map + object masks per sample token; the JAX
package's ``tools/prepare_map_aux.py`` for the port.

    python -m dualdiff_tpu_torch.tools.prepare_map_aux \
        --dataroot data/nuscenes --infos data/nuscenes_infos_train.pkl \
        --out data/map_aux_train.h5

Needs h5py and the nuscenes-devkit with its map expansion on disk,
imported when the tool runs (it says so when they are missing).  The cache
is the JAX tool's, dataset for dataset (no format the JAX package lacks):

* ``<token>``: (18, 200, 200) uint8 {0, 1}, 8 map + 10 object masks,
  gzip-compressed;
* ``aux/<token>``: (8, 200, 200) float32 class-agnostic object channels
  [visibility | center_offset x2 | center_ohw x4 | height], gzip, unless
  ``--no-aux`` (the reader rasterizes them live on a miss).
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..data.bev_raster import (MAP_CLASSES, OBJECT_CLASSES, BEVRasterizer,
                               bottom_corners_from_boxes7d,
                               extract_map_geoms)


def rasterize_sample(nusc, nusc_maps, info, xbound, ybound):
    """(8 map + 10 object, H, W) uint8 BEV masks around the lidar pose.

    The geometry is ``data.bev_raster``'s (devkit-free); this wrapper only
    reads the devkit's map geometry and the pose.
    """
    rast = BEVRasterizer(xbound, ybound)

    sample = nusc.get("sample", info["token"])
    lidar_sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
    ego = nusc.get("ego_pose", lidar_sd["ego_pose_token"])
    cs = nusc.get("calibrated_sensor", lidar_sd["calibrated_sensor_token"])
    scene = nusc.get("scene", sample["scene_token"])
    log = nusc.get("log", scene["log_token"])
    from pyquaternion import Quaternion

    # boxes in infos are LIDAR-frame: the map patch must use the lidar2global
    # pose/yaw, not the ego pose (reference pipeline.py:246-260) — ego->lidar
    # carries the sensor mount rotation.
    e2g = np.eye(4)
    e2g[:3, :3] = Quaternion(ego["rotation"]).rotation_matrix
    e2g[:3, 3] = ego["translation"]
    l2e = np.eye(4)
    l2e[:3, :3] = Quaternion(cs["rotation"]).rotation_matrix
    l2e[:3, 3] = cs["translation"]
    l2g = e2g @ l2e
    cx, cy = l2g[:2, 3]
    yaw = np.arctan2(l2g[1, 0], l2g[0, 0])
    radius = max(abs(b) for b in (*xbound[:2], *ybound[:2])) * 1.5

    geoms = extract_map_geoms(nusc_maps[log["location"]], MAP_CLASSES,
                              (cx, cy), radius)
    geoms = {
        name: {kind: [rast.world_to_lidar(pts, (cx, cy), yaw) for pts in lst]
               for kind, lst in g.items()}
        for name, g in geoms.items()
    }
    out = rast.rasterize_map(geoms)

    # objects: infos already carry lidar-frame 7-dof boxes + mapped names
    boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))), np.float32)
    labels = np.array([
        OBJECT_CLASSES.index(n) if n in OBJECT_CLASSES else -1
        for n in info.get("gt_names", [])], np.int64)
    rast.rasterize_objects(bottom_corners_from_boxes7d(boxes), labels, out=out)
    return out


def _imports():
    """h5py and the devkit's ``NuScenes`` / ``NuScenesMap``, imported on
    use: the port ships neither."""
    try:
        import h5py
        from nuscenes import NuScenes
        from nuscenes.map_expansion.map_api import NuScenesMap
    except ImportError as e:
        raise SystemExit(
            f"prepare_map_aux needs h5py and the nuscenes-devkit with its "
            f"map expansion (pip install h5py nuscenes-devkit): {e}") from e
    return h5py, NuScenes, NuScenesMap


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", default="data/nuscenes")
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--infos", required=True, help="nuscenes_infos_*.pkl")
    ap.add_argument("--out", required=True, help="output .h5")
    ap.add_argument("--xbound", nargs=3, type=float, default=[-50, 50, 0.5])
    ap.add_argument("--ybound", nargs=3, type=float, default=[-50, 50, 0.5])
    ap.add_argument("--no-aux", action="store_true",
                    help="skip the aux/<token> float32 channel group")
    ap.add_argument("--aux-data", nargs="*", default=[
        "visibility", "center_offset", "center_ohw", "height"])
    args = ap.parse_args(argv)

    h5py, NuScenes, NuScenesMap = _imports()

    nusc = NuScenes(version=args.version, dataroot=args.dataroot)
    locations = ["singapore-onenorth", "singapore-hollandvillage",
                 "singapore-queenstown", "boston-seaport"]
    nusc_maps = {loc: NuScenesMap(args.dataroot, loc) for loc in locations}
    with open(args.infos, "rb") as f:
        data = pickle.load(f)
    infos = data["infos"] if isinstance(data, dict) else data

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with h5py.File(args.out, "w") as h5:
        for i, info in enumerate(infos):
            masks = rasterize_sample(nusc, nusc_maps, info,
                                     args.xbound, args.ybound)
            h5.create_dataset(info["token"], data=masks, compression="gzip")
            # round-trip check (reference prepare_map_aux.py:69-71)
            assert (h5[info["token"]][()] == masks).all()
            if not args.no_aux:
                boxes = np.asarray(
                    info.get("gt_boxes", np.zeros((0, 7))), np.float32)
                vis = np.asarray(
                    info.get("visibility", np.zeros(len(boxes))), np.float32)
                aux = BEVRasterizer(args.xbound, args.ybound).rasterize_aux(
                    boxes, vis[: len(boxes)], args.aux_data)
                h5.create_dataset(f"aux/{info['token']}", data=aux,
                                  compression="gzip")
            if i % 100 == 0:
                print(f"{i}/{len(infos)}", flush=True)
    print(f"wrote {len(infos)} masks -> {args.out}")


if __name__ == "__main__":
    main()
