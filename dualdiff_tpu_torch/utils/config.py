"""Composed experiment configs as JSON, with attribute access.

The JAX package composes its YAML configs at run time, which needs PyYAML.
The port instead ships each composed config it runs as a JSON file under
``dualdiff_tpu_torch/configs/`` (the ``to_dict`` of the JAX loader's output;
a test keeps the two equal) and reads it with the standard library.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterable

__all__ = ["ConfigNode", "load_config", "FLAGSHIP", "HD_256X704",
           "HD_432X768", "VIDEO_16F", "RGD_STAGE2", "FUSIONP", "BASELINE",
           "DUAL_BRANCH", "DUAL_BRANCH_8PTS", "OCC_BG", "OCC_BG_FUSION",
           "OCC_BG_AUGLOSS", "OCC_BG_AUGLOSS_FUSION", "OCC_BG_AUGTEXT",
           "OCC_BG_CAMTEMB", "OCC_BG_CAMTEMB_FUSION", "OCC_BG_ADAPTER",
           "OCC_BG_TONE", "OCC_FG", "OCC_FG_40PTS", "OCC3D",
           "DRIVE_WM_192X384", "EXP_CONFIGS"]

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "configs")
# +exp=dual_branch_augloss_fusion dataset=Nuscenes_synthetic
# runner.pipeline_param.bbox_max_length=80
FLAGSHIP = "dual_branch_augloss_fusion_224x400"
# +exp-hd=256x704 / +exp-hd=432x768 (the flagship at HD, bench.py's
# BENCH_OVERLAY geometries) with FLAGSHIP's other overrides
HD_256X704 = "dual_branch_augloss_fusion_256x704"
HD_432X768 = "dual_branch_augloss_fusion_432x768"
# +exp=video_16f dataset=Nuscenes_synthetic
# runner.pipeline_param.bbox_max_length=80
# runner.pipeline_param.vae_slicing=12
# runner.pipeline_param.sequential_cfg=true
VIDEO_16F = "video_16f_224x400"
# +exp=rgd_stage2 with VIDEO_16F's other overrides (DualDiff+ stage 2: LoRA
# on the UNet's attn1 / attn2, the RGD reward)
RGD_STAGE2 = "rgd_stage2_224x400"
# +exp=occ_bg_fusionp with FLAGSHIP's other overrides: one ControlNet on the
# occupancy image with per-view boxes and two-stage SFA+
FUSIONP = "occ_bg_fusionp_224x400"
# Every other shipped configs/exp/<exp>.yaml, each +exp=<exp> with
# FLAGSHIP's other overrides:
# +exp=224x400: the MagicDrive-style baseline, one ControlNet on the BEV map
BASELINE = "baseline_224x400"
# both ControlNets (occupancy image; ORS + 40-point map vectors), no aug loss
# or SFA
DUAL_BRANCH = "dual_branch_224x400"
# the flagship with 8-point map vectors
DUAL_BRANCH_8PTS = "dual_branch_augloss_fusion_8pts_224x400"
# the occupancy-image branch alone, and its ablations: SFA, the FGM aug
# loss, per-view class-list captions, the camera token in the time
# embedding, the box adapter, tone guidance
OCC_BG = "occ_bg_224x400"
OCC_BG_FUSION = "occ_bg_fusion_224x400"
OCC_BG_AUGLOSS = "occ_bg_augloss_224x400"
OCC_BG_AUGLOSS_FUSION = "occ_bg_augloss_fusion_224x400"
OCC_BG_AUGTEXT = "occ_bg_augtext_224x400"
OCC_BG_CAMTEMB = "occ_bg_camtemb_224x400"
OCC_BG_CAMTEMB_FUSION = "occ_bg_camtemb_fusion_224x400"
OCC_BG_ADAPTER = "occ_bg_adapter_224x400"
OCC_BG_TONE = "occ_bg_tone_224x400"
# ORS foreground rays (+ 8- or 40-point map vectors) and ORS on both
OCC_FG = "occ_fg_224x400"
OCC_FG_40PTS = "occ_fg_40pts_224x400"
OCC3D = "occ3d_224x400"
# +exp-drive-wm=192x384: occ_bg at Drive-WM's 192x384
DRIVE_WM_192X384 = "drive_wm_192x384"
# the overlay each of those configs composes
EXP_CONFIGS = {
    "+exp=224x400": BASELINE, "+exp=dual_branch": DUAL_BRANCH,
    "+exp=dual_branch_augloss_fusion_8pts": DUAL_BRANCH_8PTS,
    "+exp=occ_bg": OCC_BG, "+exp=occ_bg_fusion": OCC_BG_FUSION,
    "+exp=occ_bg_augloss": OCC_BG_AUGLOSS,
    "+exp=occ_bg_augloss_fusion": OCC_BG_AUGLOSS_FUSION,
    "+exp=occ_bg_augtext": OCC_BG_AUGTEXT,
    "+exp=occ_bg_camtemb": OCC_BG_CAMTEMB,
    "+exp=occ_bg_camtemb_fusion": OCC_BG_CAMTEMB_FUSION,
    "+exp=occ_bg_adapter": OCC_BG_ADAPTER, "+exp=occ_bg_tone": OCC_BG_TONE,
    "+exp=occ_fg": OCC_FG, "+exp=occ_fg_40pts": OCC_FG_40PTS,
    "+exp=occ3d": OCC3D, "+exp-drive-wm=192x384": DRIVE_WM_192X384,
}


class ConfigNode(dict):
    """dict with attribute access; nested dicts are wrapped on the way in."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for k, v in dict(*args, **kwargs).items():
            self[k] = v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))


def _wrap(value: Any) -> Any:
    if isinstance(value, dict) and not isinstance(value, ConfigNode):
        return ConfigNode(value)
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


def _parse_value(text: str) -> Any:
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        return text


def load_config(name: str = FLAGSHIP,
                overrides: Iterable[str] = ()) -> ConfigNode:
    """Load ``configs/<name>.json`` and apply dotted ``a.b.c=value``
    overrides (values parsed as JSON, else kept as strings)."""
    with open(os.path.join(CONFIG_DIR, name + ".json")) as f:
        cfg = ConfigNode(json.load(f))
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"bad override (need key=value): {ov}")
        key, value = ov.split("=", 1)
        *parents, leaf = key.split(".")
        node = cfg
        for p in parents:
            node = node[p]
        node[leaf] = _parse_value(value)
    return cfg
