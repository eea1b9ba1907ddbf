"""Generate the validation set for downstream evaluation and FID: the JAX
package's ``tools/val_set_gen.py`` for the port.

    python -m dualdiff_tpu_torch.tools.val_set_gen \
        resume_from_checkpoint=<run>/checkpoint-<n> log_root=<out> \
        gen_naming=original gen_shard=0 gen_num_shards=2

Writes ``<log_root>/val_set_gen/samples/<camera>/`` per view, resized to
``dataset.back_resize`` (PIL's bicubic) and padded by ``dataset.back_pad``
(``postprocess``): ``gen_naming=token`` names each ``<token>_<camera>.png``,
``original`` each after the sample's real file, ``.jpg`` included (a
baseline JPEG at PIL's defaults).  Item ``i`` of the split is generated
with seed ``cfg.seed + i`` by shard ``i % gen_num_shards``; a sample whose
files all exist is skipped (resume); ``fid.ratio`` picks the tokens by
scene (``data/scenes.py``).  Each generation prints its attention kernel
launches (``launches {wrapper: n}``).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ..data.collate import collate_fn
from ..data.scenes import sample_tokens_by_scene
from ..data.wrappers import build_dataset
from ..ops.attention import reset_launch_counts, take_launch_counts
from ..pipeline.bev_controlnet import BEVControlNetPipeline
from ..runner.trainer import MultiviewTrainer
from ..utils.config import compose
from ..utils.image_io import pad, resize_bicubic, to_uint8, write_jpeg, \
    write_png


def postprocess(img: np.ndarray, back_resize, back_pad) -> np.ndarray:
    """(H, W, 3) float [0, 1] -> uint8 at the original nuScenes geometry:
    a bicubic resize to ``back_resize`` (h, w), then ``back_pad`` (left,
    top, right, bottom) black pixels (for 224x400 content: 1600x896 and 4
    black rows on top)."""
    return pad(resize_bicubic(to_uint8(img), back_resize), back_pad)


def save_image(path: str, img: np.ndarray) -> None:
    """JPEG for a ``.jpg`` / ``.jpeg`` name, else PNG (as PIL's ``save``
    picks the format by extension)."""
    if path.lower().endswith((".jpg", ".jpeg")):
        write_jpeg(path, img)
    else:
        write_png(path, img)


def main(argv=None):
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg, _ = compose(overrides)
    out_root = os.path.join(str(cfg.log_root or "."), "val_set_gen",
                            "samples")
    os.makedirs(out_root, exist_ok=True)
    shard = int(cfg.get("gen_shard", 0))
    num_shards = int(cfg.get("gen_num_shards", 1))

    val_set = build_dataset(cfg, "val")
    trainer = MultiviewTrainer(cfg, val_set, device=cfg.get("device"))
    if cfg.resume_from_checkpoint:
        trainer.load_checkpoint(str(cfg.resume_from_checkpoint))
    pipe = BEVControlNetPipeline(cfg, trainer.models, trainer.schedule,
                                 device=trainer.device)
    reset_launch_counts()

    view_order = list(cfg.dataset.view_order)
    back_resize = tuple(cfg.dataset.back_resize)
    back_pad = tuple(cfg.dataset.back_pad)
    naming = str(cfg.get("gen_naming", "token"))
    flags = sample_tokens_by_scene(
        val_set, float((cfg.get("fid") or {}).get("ratio", -1)),
        int(cfg.seed))
    meta = val_set.sample_meta() if flags is not None else None
    done = skipped = 0
    for idx in range(shard, len(val_set), num_shards):
        if flags is not None and not flags.get(meta[idx][0], False):
            continue  # token not picked by the scene-ratio protocol
        sample = val_set[idx]
        token = sample["token"]
        if naming == "original" and "filenames" in sample:
            paths = [os.path.join(out_root, cam,
                                  os.path.basename(sample["filenames"][v]))
                     for v, cam in enumerate(view_order)]
        else:
            paths = [os.path.join(out_root, cam, f"{token}_{cam}.png")
                     for cam in view_order]
        if all(os.path.exists(p) for p in paths):  # resume
            skipped += 1
            continue
        batch = collate_fn([sample], cfg, trainer.tokenizer, is_train=False,
                           rng=np.random.default_rng(int(cfg.seed) + idx))
        gen = torch.Generator(device=trainer.device).manual_seed(
            int(cfg.seed) + idx)
        imgs = pipe(batch, generator=gen).cpu().numpy()
        print(f"launches {json.dumps(take_launch_counts())}", flush=True)
        for v, p in enumerate(paths):
            os.makedirs(os.path.dirname(p), exist_ok=True)
            save_image(p, postprocess(imgs[0, v], back_resize, back_pad))
        done += 1
        if done % 10 == 0:
            print(f"[shard {shard}/{num_shards}] generated {done}, "
                  f"skipped {skipped}", flush=True)
    print(f"[shard {shard}/{num_shards}] DONE: {done} generated, "
          f"{skipped} skipped -> {out_root}")


if __name__ == "__main__":
    main()
