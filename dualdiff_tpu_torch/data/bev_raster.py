"""Devkit-free BEV rasterization core (pure numpy + cv2 geometry).

Factored out of ``tools/prepare_map_aux.py`` so the raster math — the
lidar→canvas transform, polygon/line fill, and the 8-map + 10-object
channel layout — is unit-testable with synthetic polygons and boxes,
without the nuscenes-devkit or map assets on disk.

Matches the reference's live rasterization
(``MD/magicdrive/dataset/pipeline.py:26-330``): the canvas is centered on
the ego/lidar pose with row ~ lidar x and col ~ lidar y (the reference's
``lidar2canvas`` matrix at ``pipeline.py:70-74`` followed by the
``transpose(0, 2, 1)`` at ``:216,291``), one channel per map class then one
per object class, uint8 {0,1} masks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "MAP_CLASSES", "OBJECT_CLASSES", "AUX_DATA_CH", "BEVRasterizer",
    "bottom_corners_from_boxes7d", "extract_map_geoms",
]

# auxiliary per-pixel object channels (reference ``pipeline.py:43-48``);
# channel count per kind, laid out in the order of the dataset's
# ``aux_data`` config list
AUX_DATA_CH = {
    "visibility": 1,
    "center_offset": 2,
    "center_ohw": 4,
    "height": 1,
}

MAP_CLASSES = [
    "drivable_area", "ped_crossing", "walkway", "stop_line",
    "carpark_area", "road_divider", "lane_divider", "road_block",
]
OBJECT_CLASSES = [
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
]

# Map layers rendered as polylines rather than filled polygons (the devkit
# stores dividers as line geometry).
LINE_LAYERS = frozenset({"road_divider", "lane_divider"})


def bottom_corners_from_boxes7d(boxes7d: np.ndarray) -> np.ndarray:
    """(M, 7) lidar-frame boxes -> (M, 4, 2) bottom-face corner polygons.

    Uses ``ops.boxes.box_corners`` (corner index = 4x + 2y + z); the bottom
    face is the z=0 bit, ordered as a cycle.  Reference picks corners
    ``[0, 3, 7, 4]`` of the torch box convention
    (``pipeline.py:187``); the cycle below is the same face in our indexing.
    """
    from ..ops.boxes import box_corners

    if len(boxes7d) == 0:
        return np.zeros((0, 4, 2), np.float32)
    corners = box_corners(np.asarray(boxes7d, np.float64))  # (M, 8, 3)
    return corners[:, [0, 2, 6, 4], :2].astype(np.float32)


def extract_map_geoms(
    nusc_map,
    map_classes: Sequence[str],
    center_xy: Sequence[float],
    radius: float,
) -> Dict[str, Dict[str, List[np.ndarray]]]:
    """Pull world-frame polygon/line geometry near ``center_xy`` from a
    nuscenes-devkit ``NuScenesMap`` (shared by ``tools/prepare_map_aux.py``
    and the reader's live-raster path; reference extracts the same layers
    via ``get_map_mask``, ``MD/magicdrive/dataset/pipeline.py:279-290``).
    """
    cx, cy = float(center_xy[0]), float(center_xy[1])
    patch = (cx - radius, cy - radius, cx + radius, cy + radius)
    geoms: Dict[str, Dict[str, List[np.ndarray]]] = {}
    for name in map_classes:
        polys: List[np.ndarray] = []
        lines: List[np.ndarray] = []
        try:
            records = nusc_map.get_records_in_patch(
                patch, [name], mode="intersect")[name]
            records = [nusc_map.get(name, t) for t in records]
        except Exception:  # older devkit: fall back to the full table
            records = getattr(nusc_map, name, [])
        for rec in records:
            for ptok in rec.get("polygon_tokens", []):
                poly = nusc_map.extract_polygon(ptok)
                polys.append(np.array(poly.exterior.coords))
            if "polygon_token" in rec:
                poly = nusc_map.extract_polygon(rec["polygon_token"])
                polys.append(np.array(poly.exterior.coords))
            elif "line_token" in rec:
                line = nusc_map.extract_line(rec["line_token"])
                lines.append(np.array(line.coords))
        geoms[name] = {"polygons": polys, "lines": lines}
    return geoms


class BEVRasterizer:
    """Rasterize lidar-frame map geometry + object boxes onto a BEV canvas.

    ``xbound``/``ybound`` are ``(min, max, step)`` in meters (defaults give
    the reference's 200x200 @ 0.5m canvas).
    """

    def __init__(
        self,
        xbound: Sequence[float] = (-50.0, 50.0, 0.5),
        ybound: Sequence[float] = (-50.0, 50.0, 0.5),
        map_classes: Sequence[str] = MAP_CLASSES,
        object_classes: Sequence[str] = OBJECT_CLASSES,
        line_width: int = 2,
    ):
        self.xbound = tuple(xbound)
        self.ybound = tuple(ybound)
        self.map_classes = list(map_classes)
        self.object_classes = list(object_classes)
        self.line_width = int(line_width)
        self.canvas_size = (
            int(round((xbound[1] - xbound[0]) / xbound[2])),  # rows ~ x
            int(round((ybound[1] - ybound[0]) / ybound[2])),  # cols ~ y
        )

    @property
    def num_channels(self) -> int:
        return len(self.map_classes) + len(self.object_classes)

    # ------------------------------------------------------------------
    def lidar_to_canvas(self, pts: np.ndarray) -> np.ndarray:
        """(N, 2) lidar-frame xy [m] -> (N, 2) int32 cv2 points (col, row).

        row = (x - xmin) / xstep, col = (y - ymin) / ystep — ego at the
        canvas center for symmetric bounds, front (+x) toward growing rows.
        """
        pts = np.asarray(pts, np.float64)
        rows = (pts[:, 0] - self.xbound[0]) / self.xbound[2]
        cols = (pts[:, 1] - self.ybound[0]) / self.ybound[2]
        return np.stack([cols, rows], 1).round().astype(np.int32)

    @staticmethod
    def world_to_lidar(pts: np.ndarray, ego_xy: Sequence[float],
                       yaw: float) -> np.ndarray:
        """(N, 2) world/global xy -> lidar/ego frame (rotate by -yaw about
        the ego position)."""
        pts = np.asarray(pts, np.float64)
        c, s = np.cos(-yaw), np.sin(-yaw)
        x = (pts[:, 0] - ego_xy[0]) * c - (pts[:, 1] - ego_xy[1]) * s
        y = (pts[:, 0] - ego_xy[0]) * s + (pts[:, 1] - ego_xy[1]) * c
        return np.stack([x, y], 1)

    # ------------------------------------------------------------------
    def rasterize_map(
        self,
        map_geoms: Dict[str, Dict[str, List[np.ndarray]]],
        out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Static map channels.

        ``map_geoms[class_name]`` is ``{"polygons": [(N,2)...],
        "lines": [(N,2)...]}`` with points in the LIDAR frame [m].
        Returns (C_map, H, W) uint8 (or fills ``out[:C_map]``).
        """
        import cv2

        h, w = self.canvas_size
        if out is None:
            out = np.zeros((self.num_channels, h, w), np.uint8)
        for ci, name in enumerate(self.map_classes):
            geom = map_geoms.get(name)
            if not geom:
                continue
            for poly in geom.get("polygons", ()):  # filled areas
                if len(poly) >= 3:
                    cv2.fillPoly(out[ci], [self.lidar_to_canvas(poly)], 1)
            for line in geom.get("lines", ()):  # divider-style polylines
                if len(line) >= 2:
                    cv2.polylines(out[ci], [self.lidar_to_canvas(line)],
                                  False, 1, self.line_width)
        return out

    def rasterize_objects(
        self,
        corners: np.ndarray,
        labels: np.ndarray,
        out: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Dynamic object channels from (M, 4, 2) lidar-frame bottom-face
        corner polygons + (M,) labels indexing ``object_classes``
        (reference ``pipeline.py:176-200`` ``_project_dynamic_bbox``).
        Out-of-range labels are skipped."""
        import cv2

        h, w = self.canvas_size
        if out is None:
            out = np.zeros((self.num_channels, h, w), np.uint8)
        base = len(self.map_classes)
        for poly, lab in zip(np.asarray(corners, np.float64),
                             np.asarray(labels, np.int64)):
            if 0 <= lab < len(self.object_classes):
                cv2.fillPoly(out[base + lab], [self.lidar_to_canvas(poly)], 1)
        return out

    def aux_channels(self, aux_data: Sequence[str]) -> int:
        return sum(AUX_DATA_CH[a] for a in aux_data)

    def lidar_to_canvas_f(self, pts: np.ndarray) -> np.ndarray:
        """(N, 2) lidar xy [m] -> (N, 2) float (row, col) canvas coords
        (continuous — the aux vectors are measured in these units)."""
        pts = np.asarray(pts, np.float64)
        rows = (pts[:, 0] - self.xbound[0]) / self.xbound[2]
        cols = (pts[:, 1] - self.ybound[0]) / self.ybound[2]
        return np.stack([rows, cols], 1)

    def rasterize_aux(
        self,
        boxes7d: np.ndarray,
        visibility: Optional[np.ndarray] = None,
        aux_data: Sequence[str] = ("visibility", "center_offset",
                                   "center_ohw", "height"),
    ) -> np.ndarray:
        """Class-agnostic per-pixel object aux channels
        (reference ``_get_dynamic_aux_bbox``, ``pipeline.py:88-174``):

        * ``visibility`` (1): the box's nuScenes visibility level;
        * ``center_offset`` (2): pixel - box-bottom-center, canvas units,
          components (row ~ lidar x, col ~ lidar y);
        * ``center_ohw`` (4): |center->front-mid|, |center->left-mid| in
          canvas units + the unit center->front direction (row, col);
        * ``height`` (1): the box's 3D height [m].

        Boxes fill in order (later boxes overwrite overlaps, like the
        reference's per-instance loop).  Returns (C_aux, H, W) float32.
        """
        import cv2

        from ..ops.boxes import box_corners

        h, w = self.canvas_size
        out = np.zeros((self.aux_channels(aux_data), h, w), np.float32)
        boxes7d = np.asarray(boxes7d, np.float64)
        if len(boxes7d) == 0:
            return out
        corners = box_corners(boxes7d)  # (M, 8, 3); index = 4x + 2y + z
        bottom = corners[:, [0, 2, 6, 4], :2]  # bottom-face cycle
        center = boxes7d[:, :2]  # origin (0.5, 0.5, 0) => xy IS bottom center
        front_mid = corners[:, [4, 6], :2].mean(1)  # +x bottom edge
        left_mid = corners[:, [2, 6], :2].mean(1)  # +y bottom edge
        rr, cc = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        for i in range(len(boxes7d)):
            stamp = np.zeros((h, w), np.uint8)
            cv2.fillPoly(stamp, [self.lidar_to_canvas(bottom[i])], 1)
            m = stamp > 0
            if not m.any():
                continue
            c = self.lidar_to_canvas_f(center[i: i + 1])[0]
            f = self.lidar_to_canvas_f(front_mid[i: i + 1])[0]
            l = self.lidar_to_canvas_f(left_mid[i: i + 1])[0]
            ch = 0
            if "visibility" in aux_data:
                out[ch][m] = float(visibility[i]) \
                    if visibility is not None else 0.0
                ch += 1
            if "center_offset" in aux_data:
                out[ch][m] = rr[m] - c[0]
                out[ch + 1][m] = cc[m] - c[1]
                ch += 2
            if "center_ohw" in aux_data:
                fv = f - c
                nrm = np.linalg.norm(fv)
                v = fv / (nrm + 1e-6)
                vals = (nrm, np.linalg.norm(l - c), v[0], v[1])
                for k, val in enumerate(vals):
                    out[ch + k][m] = val
                ch += 4
            if "height" in aux_data:
                out[ch][m] = boxes7d[i, 5]
                ch += 1
        return out

    def rasterize(
        self,
        map_geoms: Dict[str, Dict[str, List[np.ndarray]]],
        boxes7d: np.ndarray,
        labels: np.ndarray,
    ) -> np.ndarray:
        """Full (C_map + C_obj, H, W) uint8 raster from lidar-frame map
        geometry + (M, 7) lidar-frame gt boxes."""
        out = self.rasterize_map(map_geoms)
        return self.rasterize_objects(
            bottom_corners_from_boxes7d(boxes7d), labels, out=out)
