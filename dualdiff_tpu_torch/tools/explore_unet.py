"""Per-block UNet feature maps: the JAX package's ``tools/explore_unet.py``
for the port.

    python -m dualdiff_tpu_torch.tools.explore_unet +exp=224x400 \
        dataset=Nuscenes_synthetic explore_t=500 explore_out=./unet_features

One denoising forward of the UNet, with every ControlNet's residuals
summed as in generation, under ``models.layers.capture``.  For each block
output (``down_block_<i>_out``, ``mid_block_out``, ``up_block_<i>_out``)
it writes ``<explore_out>/<name>.view<v>.png`` for every view (the
channel mean, min-max scaled, upscaled 8x by nearest neighbour) and all of
them, channels-last (B*N, h, w, C) float32 as the JAX tool saves them, to
``block_features.npz``.  ``device=cpu`` runs the plain path.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..runner.explore import Probe, open_probe
from ..utils.image_io import resize_nearest, write_png


def feature_png(feat: np.ndarray, out_path: str, upscale: int = 8) -> None:
    """(H, W, C) block output -> channel-mean grey PNG."""
    amap = np.asarray(feat, np.float32).mean(-1)
    amap = (amap - amap.min()) / (np.ptp(amap) + 1e-8)
    img = (amap * 255).astype(np.uint8)
    write_png(out_path, resize_nearest(
        img, (img.shape[0] * upscale, img.shape[1] * upscale)))


def run(probe: Probe, out_dir: str):
    """The block features of ``probe`` into ``out_dir``.  -> {block:
    (B*N, h, w, C) float32}."""
    os.makedirs(out_dir, exist_ok=True)
    inter = probe.unet(*probe.residuals())
    raw, saved = {}, 0
    for name in inter:
        if not name.endswith("_out"):  # block outputs only
            continue
        feat = inter[name].float().permute(0, 2, 3, 1).cpu().numpy()
        raw[name] = feat
        for v in range(min(probe.N, feat.shape[0])):
            feature_png(feat[v], os.path.join(out_dir,
                                              f"{name}.view{v}.png"))
            saved += 1
    np.savez_compressed(os.path.join(out_dir, "block_features.npz"), **raw)
    print(f"saved {saved} block feature maps ({len(raw)} blocks) "
          f"to {out_dir}")
    return raw


def main(argv=None):
    return run(*open_probe(argv if argv is not None else sys.argv[1:],
                           "./unet_features"))


if __name__ == "__main__":
    main()
