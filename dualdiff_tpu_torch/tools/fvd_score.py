"""FVD scoring: the JAX package's ``tools/fvd_score.py`` for the port.

    python -m dualdiff_tpu_torch.tools.fvd_score --real DIR_A --gen DIR_B \\
        [--frames 16] [--feature logits|pool] [--size 224] [--device cpu]

Each directory holds clips: ``<clip>.npz`` (array ``frames``, (T, H, W, 3)
uint8 or float) or one subdirectory of ordered frame images (PNG or JPEG,
decoded by PIL through ``data/nuscenes.read_rgb``) per clip.  Each frame is resized to size x
size (PIL's bilinear, exact).  With ``pretrained/i3d_pretrained_400.pt``
(``--i3d``) this is canonical FVD over I3D features
(``metrics/i3d.py``); without it, the labelled frame-feature statistics
over the FID Inception (``tools/fid_score.build_extractor``), projected to
512 dimensions.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..data.nuscenes import read_rgb
from ..metrics.fvd import (build_i3d_extractor, clip_features_from_frames,
                           fvd_from_features, i3d_features)
from ..utils.image_io import resize_bilinear

IMG_EXTS = (".png", ".jpg", ".jpeg")


def _resize01(f: np.ndarray, hw) -> np.ndarray:
    """A [0, 1] frame through uint8 (truncated) and PIL's bilinear resize."""
    return resize_bilinear((f * 255).astype(np.uint8), hw).astype(
        np.float32) / 255.0


def load_clips(root: str, frames: int, size: int) -> np.ndarray:
    """-> (N, frames, size, size, 3) in [-1, 1]."""
    clips = []
    for entry in sorted(os.listdir(root)):
        path = os.path.join(root, entry)
        if entry.endswith(".npz"):
            arr = np.load(path)["frames"]
        elif os.path.isdir(path):
            fs = sorted(f for f in os.listdir(path)
                        if f.lower().endswith(IMG_EXTS))
            if not fs:
                continue
            arr = np.stack([read_rgb(os.path.join(path, f)) for f in fs])
        else:
            continue
        if len(arr) < frames:
            continue
        arr = arr[:frames].astype(np.float32)
        if arr.max() > 1.5:  # uint8 range
            arr = arr / 255.0
        if arr.shape[1:3] != (size, size):  # I3D's square input
            arr = np.stack([_resize01(f, (size, size)) for f in arr])
        clips.append(arr * 2.0 - 1.0)
    if not clips:
        raise FileNotFoundError(f"no clips with >= {frames} frames in {root}")
    return np.stack(clips)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", required=True)
    ap.add_argument("--gen", required=True)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--feature", default="logits",
                    choices=["logits", "pool"])
    ap.add_argument("--i3d", default="pretrained/i3d_pretrained_400.pt")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    real = load_clips(args.real, args.frames, args.size)
    gen = load_clips(args.gen, args.frames, args.size)

    extract, label = build_i3d_extractor(args.i3d, args.feature, args.device)
    if extract is not None:
        fr = i3d_features(real, extract)
        fg = i3d_features(gen, extract)
    else:  # labelled fallback: frame-level Inception features -> clip stats
        from .fid_score import build_extractor

        fextract, fsize, flabel = build_extractor(device=args.device)
        label = f"fallback({flabel})"

        def frame_feats(clips):
            n, t = clips.shape[:2]
            flat = clips.reshape(n * t, *clips.shape[2:]) * 0.5 + 0.5
            feats = []
            for i in range(0, len(flat), 16):
                x = np.clip(np.stack([_resize01(f, fsize)
                                      for f in flat[i:i + 16]]), 0, 1)
                feats.append(fextract(x))
            return np.concatenate(feats).reshape(n, t, -1)

        fr = clip_features_from_frames(frame_feats(real))
        fg = clip_features_from_frames(frame_feats(gen))
        if fr.shape[1] > 1024:
            # a fixed random projection keeps the sqrtm tractable (6144^2
            # covariances take minutes); deterministic, fallback only
            proj = np.random.default_rng(0).standard_normal(
                (fr.shape[1], 512)).astype(np.float32) / np.sqrt(fr.shape[1])
            fr, fg = fr @ proj, fg @ proj
            label += "+proj512"

    fvd = fvd_from_features(fr, fg)
    print(f"FVD[{label}] ({len(real)} real vs {len(gen)} generated clips, "
          f"{args.frames} frames): {fvd:.4f}")
    return fvd


if __name__ == "__main__":
    main()
