"""Attention-map introspection: the JAX package's
``tools/explore_attn.py`` for the port.

    python -m dualdiff_tpu_torch.tools.explore_attn +exp=224x400 \
        dataset=Nuscenes_synthetic explore_t=500 explore_out=./attn_maps

One denoising forward of ControlNet 0 and of the UNet (with ControlNet
0's residuals) under ``models.layers.capture``; for every
cross-attention (``attn2``) it writes ``<explore_out>/<controlnet|unet>.
<path>.png``: the first row's head-mean attention of every query on
context token 0 (the camera token), laid out as the latent grid,
min-max scaled and upscaled to the image size by nearest neighbour (the
JAX tool's grey PNGs, the same names; ``device=cpu`` runs the plain
path).  Outside the capture nothing changes, so every kernel of the
card's generation still runs it.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..runner.explore import Probe, open_probe
from ..utils.image_io import resize_nearest, write_png


def attention_map(probs: np.ndarray, latent_hw) -> np.ndarray:
    """(B', H, Lq, Lk) probabilities -> the (8 lh, 8 lw) uint8 map of the
    JAX tool, or None where its reshape fails (it skips those)."""
    lh, lw = latent_hw
    spatial = probs[0].mean(0)[:, 0].reshape(-1)
    side = int(np.sqrt(spatial.size / (lw / lh)))
    cols = spatial.size // side if side else 0
    if cols == 0 or spatial.size % cols:
        return None
    img = spatial.reshape(-1, cols)
    img = (img - img.min()) / (np.ptp(img) + 1e-8)
    return resize_nearest((img * 255).astype(np.uint8), (lh * 8, lw * 8))


def run(probe: Probe, out_dir: str):
    """The maps of ``probe`` into ``out_dir``.  -> {"controlnet" |
    "unet": the capture dict of that network}."""
    os.makedirs(out_dir, exist_ok=True)
    downs, mid, kv, inter_cn = probe.controlnet(0, captured=True)
    inter_unet = probe.unet(downs, mid, kv)
    saved = 0
    for tag, inter in (("controlnet", inter_cn), ("unet", inter_unet)):
        for key in sorted(inter):
            name = ".".join(p for p in key.split("/") if p != "attn_probs")
            if "attn2" not in name:  # cross-attention maps only
                continue
            img = attention_map(inter[key].float().cpu().numpy(),
                                probe.latent_hw)
            if img is None:
                continue
            write_png(os.path.join(out_dir, f"{tag}.{name}.png"), img)
            saved += 1
    print(f"saved {saved} cross-attention maps to {out_dir}")
    return {"controlnet": inter_cn, "unet": inter_unet}


def main(argv=None):
    return run(*open_probe(argv if argv is not None else sys.argv[1:],
                           "./attn_maps"))


if __name__ == "__main__":
    main()
