"""Validation during training: generate samples, write image grids.

Port of ``dualdiff_tpu/runner/validator.py``: for each
``runner.validation_index`` item, the generation pipeline runs
``runner.validation_times`` times and each result becomes a 6-view grid
(boxes drawn with ``runner.validation_show_box``), written with the ground
truth's grid by a writer.  The JAX package writes to TensorBoard; the
port's ``RunWriter`` writes PNGs and JSON lines (no tensorboardX).

One ``BEVControlNetPipeline`` over the trainer's live modules is built and
reused.  Its constructor puts the modules in eval mode in place, so
``validate`` puts each module back in the mode it found; it runs under
``torch.no_grad()`` and reads no optimizer state, so the trainer's
gradients, master copies, accumulators and generator stay as they were.
Each generation draws from its own ``torch.Generator``, seeded as the JAX
package seeds its ``PRNGKey``.
"""

from __future__ import annotations

import json
import logging
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..data.collate import collate_fn
from ..pipeline.bev_controlnet import BEVControlNetPipeline
from ..utils.image_io import write_png

__all__ = ["concat_6_views", "RunWriter", "Validator"]

log = logging.getLogger(__name__)


def concat_6_views(imgs: np.ndarray, oneline: bool = False) -> np.ndarray:
    """(6, H, W, 3) -> single grid image (2 x 3 views, or one line)."""
    if oneline:
        return np.concatenate(list(imgs), axis=1)
    top = np.concatenate(list(imgs[:3]), axis=1)
    bottom = np.concatenate(list(imgs[3:]), axis=1)
    return np.concatenate([top, bottom], axis=0)


class RunWriter:
    """What the JAX tools write to TensorBoard, as files under
    ``log_root``: ``add_image(tag, hwc, step)`` a PNG
    ``val/step-<step>/<tag less its "val/">.png`` (float images in [0, 1]
    rounded to uint8), ``add_json(step, name, obj)`` ``obj`` as
    ``val/step-<step>/<name>.json``, ``add_scalars(step, {name: value},
    **more)`` one JSON line ``{"step": step, name: value, ..., **more}`` of
    ``metrics.jsonl``."""

    def __init__(self, log_root: str):
        self.log_root = log_root
        self.metrics_path = os.path.join(log_root, "metrics.jsonl")

    def _path(self, step: int, name: str) -> str:
        path = os.path.join(self.log_root, "val", f"step-{step}",
                            name.replace("/", "_"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    def add_image(self, tag: str, img: np.ndarray, step: int) -> str:
        name = tag.split("/", 1)[1] if tag.startswith("val/") else tag
        path = self._path(step, name + ".png")
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.floor(np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
        write_png(path, img)
        return path

    def add_json(self, step: int, name: str, obj) -> str:
        path = self._path(step, name + ".json")
        with open(path, "w") as f:
            json.dump(obj, f)
        return path

    def add_scalars(self, step: int, scalars: Dict[str, float],
                    **more) -> None:
        row = {"step": int(step)}
        row.update({k: float(v) if math.isfinite(float(v)) else str(v)
                    for k, v in scalars.items()})
        row.update(more)
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(row) + "\n")


def _networks(models: Dict):
    return [models["unet"], models["vae"], models["text_encoder"],
            *models["controlnets"]]


class Validator:
    def __init__(self, cfg, val_dataset, tokenizer):
        self.cfg = cfg
        self.val_dataset = val_dataset
        self.tokenizer = tokenizer
        self._pipe = None

    def validate(self, trainer, writer=None, step: int = 0,
                 max_items: Optional[int] = None):
        """-> the grids (H, W, 3) float32 in [0, 1], in the order written:
        per item, each of its ``validation_times`` generations."""
        nets = _networks(trainer.models)
        modes = [(m, m.training) for net in nets for m in net.modules()]
        try:
            with torch.no_grad():
                return self._validate(trainer, writer, step, max_items)
        finally:
            for m, training in modes:
                m.training = training

    def _validate(self, trainer, writer, step, max_items):
        cfg = self.cfg
        if self._pipe is None:
            self._pipe = BEVControlNetPipeline(cfg, trainer.models,
                                               trainer.schedule,
                                               device=trainer.device)
        else:
            for net in _networks(trainer.models):
                net.eval()
        pipe = self._pipe
        indices = list(cfg.runner.validation_index)[: max_items or None]
        times = int(cfg.runner.validation_times)
        show_box = bool(cfg.runner.validation_show_box)
        outs = []
        for idx in indices:
            if idx >= len(self.val_dataset):
                continue
            sample = self.val_dataset[idx]
            batch = collate_fn([sample], cfg, self.tokenizer, is_train=False,
                               rng=np.random.default_rng(int(cfg.seed)))
            for t in range(times):
                seed = int(cfg.seed) + (t if bool(
                    cfg.runner.validation_seed_global) else idx * 100 + t)
                gen = torch.Generator(device=trainer.device).manual_seed(seed)
                imgs = pipe(batch, generator=gen).cpu().numpy()
                views = (imgs[0] * 255).astype(np.uint8)
                if show_box and len(sample.get("gt_bboxes_3d", [])):
                    from .visualize import draw_boxes_on_views

                    views = draw_boxes_on_views(
                        views, sample["gt_bboxes_3d"],
                        sample["gt_labels_3d"], sample["lidar2image"],
                        sample.get("img_aug_matrix"))
                grid = concat_6_views(views.astype(np.float32) / 255.0)
                outs.append(grid)
                if writer is not None:
                    writer.add_image(f"val/{idx}_gen{t}", grid, step)
            if writer is not None and "img" in sample:
                gt = (sample["img"] * 0.5 + 0.5).clip(0, 1)
                writer.add_image(f"val/{idx}_gt", concat_6_views(gt), step)
        log.info("validation at step %d: %d grids", step, len(outs))
        return outs
