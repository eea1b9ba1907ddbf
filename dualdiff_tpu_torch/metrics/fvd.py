"""FVD: the Frechet distance over per-clip features.

The port of ``dualdiff_tpu/metrics/fvd.py``.  The metric is separate from
the feature extractor:

* ``build_i3d_extractor`` loads I3D (``metrics/i3d.py``) from
  ``i3d_pretrained_400.pt`` where the file is there: canonical FVD;
* without it, clip features come from frame features (the FID Inception's
  pool3): ``[mean_t(f), std_t(f), mean_t(|df/dt|)]``, appearance and
  dynamics.  Relative comparisons only, labelled, not comparable to
  published FVD numbers.
"""

from __future__ import annotations

import os
import sys
from typing import Callable

import numpy as np
import torch

from .fid import compute_statistics, frechet_distance

__all__ = ["clip_features_from_frames", "fvd_from_features",
           "build_i3d_extractor", "i3d_features"]


def build_i3d_extractor(
    weights_path: str = "pretrained/i3d_pretrained_400.pt",
    feature: str = "logits",  # logits (canonical 400-d) | pool (1024-d)
    device=None,
):
    """-> (extract_fn, label): extract_fn takes a (B, T, H, W, 3) tensor in
    [-1, 1] to (B, d) features on ``device`` (the card unless "cpu"); or
    (None, 'fallback') where the weights file is absent."""
    from .. import resolve_device
    from .i3d import InceptionI3d, load_i3d

    if not os.path.exists(weights_path):
        print("# WARNING: I3D weights not found; FVD falls back to "
              "frame-feature statistics (relative comparisons only)",
              file=sys.stderr)
        return None, "fallback"
    device = resolve_device(device)
    model = InceptionI3d()
    load_i3d(model, torch.load(weights_path, map_location="cpu",
                               weights_only=True))
    model = model.to(device)
    idx = 0 if feature == "logits" else 1

    @torch.no_grad()
    def extract(clips):
        return model(clips.to(device))[idx]

    return extract, f"i3d_{feature}"


def i3d_features(clips: np.ndarray, extract: Callable,
                 batch: int = 4) -> np.ndarray:
    """(N, T, H, W, 3) clips in [-1, 1] -> (N, d) I3D features."""
    acts = []
    for i in range(0, len(clips), batch):
        x = torch.from_numpy(np.ascontiguousarray(clips[i:i + batch],
                                                  np.float32))
        acts.append(extract(x).float().cpu().numpy())
    return np.concatenate(acts)


def clip_features_from_frames(frame_feats: np.ndarray) -> np.ndarray:
    """(n_clips, n_frames, d) frame features -> (n_clips, 3d) clip features."""
    mean = frame_feats.mean(1)
    std = frame_feats.std(1)
    vel = np.abs(np.diff(frame_feats, axis=1)).mean(1)
    return np.concatenate([mean, std, vel], axis=-1)


def fvd_from_features(real: np.ndarray, generated: np.ndarray) -> float:
    """Frechet distance between clip-feature distributions."""
    return frechet_distance(*compute_statistics(real),
                            *compute_statistics(generated))
