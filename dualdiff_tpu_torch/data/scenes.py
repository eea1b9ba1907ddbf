"""Scene-level token sub-sampling for the FID / generation protocol.

The port's copy of ``dualdiff_tpu/data/scenes.py`` (standard library only):
group the split's samples by scene and pick per scene, so the scored or
generated token set follows the reference protocol (``fid.ratio``).

Semantics:
  * ratio == -1 -> ``None`` (use the whole split)
  * ratio ==  0 -> only the FIRST frame of each scene
  * 0 < ratio < 1 -> ``int(scene_len * ratio)`` random picks per scene
  * ratio >= 1 -> ``int(ratio)`` random picks per scene
Randomness comes from ``random.Random(seed)``.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

__all__ = ["sample_tokens_by_scene", "dataset_sample_meta"]


def dataset_sample_meta(dataset) -> List[Tuple[str, str]]:
    """[(token, scene_id)] for every sample, without loading images.

    Datasets expose ``sample_meta()``; wrappers forward it.  Raises if the
    dataset cannot enumerate tokens cheaply."""
    meta = getattr(dataset, "sample_meta", None)
    if meta is None:
        raise TypeError(
            f"{type(dataset).__name__} has no sample_meta(); scene-ratio "
            "sub-sampling needs token/scene enumeration")
    return list(meta())


def sample_tokens_by_scene(dataset, ratio_or_num: float,
                           seed: int = 0) -> Optional[Dict[str, bool]]:
    """Dict[token, picked] over the dataset's samples, or None for 'use all'
    (``ratio_or_num == -1``)."""
    ratio_or_num = float(ratio_or_num)
    if ratio_or_num == -1:
        return None
    by_scene: Dict[str, List[str]] = {}
    for token, scene in dataset_sample_meta(dataset):
        by_scene.setdefault(scene, []).append(token)
    rng = random.Random(int(seed))
    flags: Dict[str, bool] = {}
    for scene in by_scene:  # insertion order = dataset order (deterministic)
        tokens = by_scene[scene]
        if ratio_or_num == 0:
            picked = tokens[:1]
        else:
            n = (int(ratio_or_num) if ratio_or_num >= 1
                 else int(len(tokens) * ratio_or_num))
            picked = rng.sample(tokens, min(n, len(tokens)))
        for t in tokens:
            flags[t] = False
        for t in picked:
            flags[t] = True
    return flags
