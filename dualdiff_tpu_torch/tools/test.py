"""Generate image grids from a checkpoint: the JAX package's
``tools/test.py`` for the port.

    python -m dualdiff_tpu_torch.tools.test \
        resume_from_checkpoint=<run>/checkpoint-<n> log_root=<out>

The config is recomposed from the run's ``hydra/overrides.json`` with this
call's words after them (they win).  For each ``runner.validation_index``
item it writes ``<log_root>/test_out/<idx>_gen.png`` (the 2 x 3 grid of
the generated views; seed ``cfg.seed``) and ``<idx>_ori.png`` (the
sample's images), and prints the generation's attention kernel launches
(``launches {wrapper: n}``).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ..data.collate import collate_fn
from ..data.wrappers import build_dataset
from ..ops.attention import reset_launch_counts, take_launch_counts
from ..pipeline.bev_controlnet import BEVControlNetPipeline
from ..runner.trainer import MultiviewTrainer
from ..runner.validator import concat_6_views
from ..utils.config import compose
from ..utils.image_io import to_uint8, write_png


def compose_from_checkpoint(overrides):
    """The config of ``overrides``, after the saved words of the run that
    holds ``resume_from_checkpoint`` (when it has them)."""
    resume = next((o.split("=", 1)[1] for o in overrides
                   if o.startswith("resume_from_checkpoint=")), None)
    saved = []
    if resume:
        run_dir = os.path.dirname(os.path.abspath(resume))
        p = os.path.join(run_dir, "hydra", "overrides.json")
        if os.path.exists(p):
            with open(p) as f:
                saved = json.load(f) or []
    cfg, _ = compose(saved + list(overrides))
    return cfg


def main(argv=None):
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = compose_from_checkpoint(overrides)
    out_dir = os.path.join(str(cfg.log_root or "."), "test_out")
    os.makedirs(out_dir, exist_ok=True)

    val_set = build_dataset(cfg, "test")
    trainer = MultiviewTrainer(cfg, val_set, device=cfg.get("device"))
    if cfg.resume_from_checkpoint:
        trainer.load_checkpoint(str(cfg.resume_from_checkpoint))
    pipe = BEVControlNetPipeline(cfg, trainer.models, trainer.schedule,
                                 device=trainer.device)
    reset_launch_counts()

    for idx in cfg.runner.validation_index:
        if idx >= len(val_set):
            continue
        sample = val_set[idx]
        batch = collate_fn([sample], cfg, trainer.tokenizer, is_train=False,
                           rng=np.random.default_rng(int(cfg.seed)))
        gen = torch.Generator(device=trainer.device).manual_seed(
            int(cfg.seed))
        imgs = pipe(batch, generator=gen).cpu().numpy()
        print(f"launches {json.dumps(take_launch_counts())}", flush=True)
        write_png(os.path.join(out_dir, f"{idx}_gen.png"),
                  to_uint8(concat_6_views(imgs[0])))
        if "img" in sample:
            ori = to_uint8((sample["img"] * 0.5 + 0.5).clip(0, 1))
            write_png(os.path.join(out_dir, f"{idx}_ori.png"),
                      concat_6_views(ori))
        print(f"saved {out_dir}/{idx}_gen.png")


if __name__ == "__main__":
    main()
