"""Composed experiment configs as JSON, with attribute access.

The JAX package composes its YAML configs at run time, which needs PyYAML.
The port instead ships each composed config it runs as a JSON file under
``dualdiff_tpu_torch/configs/`` (the ``to_dict`` of the JAX loader's output;
a test keeps the two equal) and reads it with the standard library.

``compose(argv)`` takes the JAX CLI's words: ``+exp=...`` (and
``+exp-hd=...``, ``+exp-drive-wm=...``) picks the shipped JSON through
``EXP_CONFIGS``; ``runner=debug`` lays ``configs/runner_debug.json`` (the
keys of ``configs/runner/debug.yaml``) over the runner;
``dataset=Nuscenes_synthetic`` is what every JSON holds already, and
``dataset=Nuscenes``, ``Nuscenes_cache`` and ``Nuscenes_map_cache_box``
swap in the nuScenes reader's groups (``group``:
``configs/dataset_Nuscenes.json`` and what each group's YAML sets over
it, the overlay's own dataset keys kept); ``fid=default`` /
``fid=data_gen`` set the FID group and ``--config-name test_fid`` lays the
FID preset (``configs/test_fid.json``) over the config; dotted
``a.b=value`` overrides as ``load_config``, which makes the nodes they
name (the reader's roots ``dataset.occ_proj_root``, ``occ3d_root``,
``map_vec_root``, ``missing_bev``, and ``fid.rootb``, which no YAML
sets).  The JSONs are composed, so an override does not re-run the YAML's interpolations: ``load_config``
re-derives the interpolated keys (``LINKS``) from their sources after the
overrides.  The JSONs carry the operating point each was composed at
(``runner.pipeline_param.bbox_max_length=80``; the clip configs also
``vae_slicing=12`` and ``sequential_cfg=true``), which a composition of the
same words by the JAX loader lacks.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterable, List, Tuple

__all__ = ["ConfigNode", "load_config", "FLAGSHIP", "HD_256X704",
           "HD_432X768", "VIDEO_16F", "RGD_STAGE2", "FUSIONP", "BASELINE",
           "DUAL_BRANCH", "DUAL_BRANCH_8PTS", "OCC_BG", "OCC_BG_FUSION",
           "OCC_BG_AUGLOSS", "OCC_BG_AUGLOSS_FUSION", "OCC_BG_AUGTEXT",
           "OCC_BG_CAMTEMB", "OCC_BG_CAMTEMB_FUSION", "OCC_BG_ADAPTER",
           "OCC_BG_TONE", "OCC_FG", "OCC_FG_40PTS", "OCC3D",
           "DRIVE_WM_192X384", "VARIANTS", "EXP_CONFIGS", "LINKS",
           "GROUPS", "PRESETS", "apply_overrides", "compose", "group",
           "save_config"]

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
VARIANTS = {
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
# every overlay the port's CLI takes (``compose``) -> its composed config;
# the HD overlays chain the flagship's (``configs/exp-hd/*.yaml``)
EXP_CONFIGS = {
    "+exp=dual_branch_augloss_fusion": FLAGSHIP,
    "+exp-hd=256x704": HD_256X704, "+exp-hd=432x768": HD_432X768,
    "+exp=occ_bg_fusionp": FUSIONP, "+exp=video_16f": VIDEO_16F,
    "+exp=rgd_stage2": RGD_STAGE2, **VARIANTS,
}
# group swaps compose takes -> the JSONs each lays, in order, as the YAML
# group's defaults chain: runner=debug is an overlay of the runner (the keys
# of configs/runner/debug.yaml); the dataset groups are
# configs/dataset/Nuscenes.yaml composed (dataset_Nuscenes.json) with what
# each YAML of the chain sets over it (Nuscenes_map_cache_box sets nothing
# over Nuscenes_cache); data_gen sets nothing over fid/default.yaml
_NUSCENES_CACHE = ("dataset_Nuscenes", "dataset_Nuscenes_cache")
GROUPS = {("runner", "debug"): ("runner_debug",),
          ("dataset", "Nuscenes"): ("dataset_Nuscenes",),
          ("dataset", "Nuscenes_synthetic"): ("dataset_Nuscenes",
                                              "dataset_Nuscenes_synthetic"),
          ("dataset", "Nuscenes_cache"): _NUSCENES_CACHE,
          ("dataset", "Nuscenes_map_cache_box"): _NUSCENES_CACHE,
          ("fid", "default"): ("fid_default",),
          ("fid", "data_gen"): ("fid_default",)}
# --config-name presets compose takes -> the JSON of the keys each lays
# over the config (configs/test_fid.yaml: the fid group and its log root)
PRESETS = {"test_fid": "test_fid"}
# the YAML interpolations, target <- source: (target, source, format)
LINKS = (
    ("model.unet.neighboring_view_pair", "dataset.neighboring_view_pair",
     None),
    ("model.unet.crossview_attn_type", "model.crossview_attn_type", None),
    ("model.unet.img_size", "dataset.image_size", None),
    ("model.controlnet.bbox_embedder_param.mode", "model.bbox_mode", None),
    ("projname", "model.name", None),
    ("dataset.data.train.ann_file", "dataset.dataset_process_root",
     "{}nuscenes_infos_train.pkl"),
    ("dataset.data.val.ann_file", "dataset.dataset_process_root",
     "{}nuscenes_infos_val.pkl"),
    ("dataset.data.test.ann_file", "dataset.dataset_process_root",
     "{}nuscenes_infos_val.pkl"),
)


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


_MISSING = object()


def _get(cfg, dotted: str):
    node = cfg
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return _MISSING
        node = node[part]
    return node


def _set(cfg, dotted: str, value) -> None:
    """Set ``dotted``, making each missing (or non-dict) parent a node, as
    the JAX loader's ``set_path`` does."""
    *parents, leaf = dotted.split(".")
    node = cfg
    for p in parents:
        if not isinstance(node.get(p), dict):
            node[p] = ConfigNode()
        node = node[p]
    node[leaf] = value


def _derive(source, fmt):
    return json.loads(json.dumps(source)) if fmt is None \
        else fmt.format(source)


def load_config(name: str = FLAGSHIP,
                overrides: Iterable[str] = ()) -> ConfigNode:
    """Load ``configs/<name>.json`` and apply dotted ``a.b.c=value``
    overrides (``apply_overrides``)."""
    with open(os.path.join(CONFIG_DIR, name + ".json")) as f:
        cfg = ConfigNode(json.load(f))
    apply_overrides(cfg, overrides)
    return cfg


def apply_overrides(cfg: ConfigNode, overrides: Iterable[str]) -> None:
    """Dotted ``a.b.c=value`` overrides in place (values parsed as JSON,
    else kept as strings).  Each interpolated key of ``LINKS`` that its
    source still gives follows the overridden source, unless it is
    overridden itself."""
    live = [(t, s, fmt) for t, s, fmt in LINKS
            if _get(cfg, s) is not _MISSING
            and _get(cfg, t) == _derive(_get(cfg, s), fmt)]
    keys = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"bad override (need key=value): {ov}")
        key, value = ov.split("=", 1)
        _set(cfg, key, _parse_value(value))
        keys.append(key)
    for target, source, fmt in live:
        if not any(k == target or target.startswith(k + ".")
                   for k in keys):
            _set(cfg, target, _derive(_get(cfg, source), fmt))


def _read(name: str):
    with open(os.path.join(CONFIG_DIR, name + ".json")) as f:
        return json.load(f)


def group(key: str, value: str) -> dict:
    """The JSONs of the group swap ``key=value`` (``GROUPS``) laid in
    order."""
    out = {}
    for name in GROUPS[(key, value)]:
        _merge(out, _read(name))
    return out


def _config_name(argv: List[str]) -> Tuple[str, List[str]]:
    """Strip ``--config-name NAME`` (``--config-name=NAME``, ``-cn``)
    from the words.  -> (NAME or None, the other words)."""
    name, rest, i = None, [], 0
    while i < len(argv):
        word = argv[i]
        if word in ("--config-name", "-cn"):
            if i + 1 >= len(argv):
                raise ValueError(f"{word} needs a value")
            name, i = argv[i + 1], i + 2
            continue
        if word.startswith(("--config-name=", "-cn=")):
            name = word.split("=", 1)[1]
        else:
            rest.append(word)
        i += 1
    return name, rest


def _diff(node: dict, base: dict) -> dict:
    """The keys of ``node`` that ``base`` lacks or holds otherwise,
    recursively: what an overlay laid over ``base``."""
    out = {}
    for k, v in node.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            sub = _diff(v, base[k])
            if sub:
                out[k] = sub
        elif k not in base or base[k] != v:
            out[k] = v
    return out


def compose(argv: Iterable[str]) -> Tuple[ConfigNode, List[str]]:
    """-> (the config of a CLI's words, the words).  ``+exp=...`` words
    pick the shipped JSON (``EXP_CONFIGS``; the flagship's when none is
    given; ``+exp=dual_branch_augloss_fusion`` with an ``+exp-hd=...`` the
    HD one); ``--config-name test_fid`` lays its preset (``PRESETS``);
    group swaps (``GROUPS``) apply before the dotted overrides, as the JAX
    loader applies them first: ``runner=debug`` over the config's runner,
    a dataset group in place of the config's dataset with the overlay's own
    dataset keys (what the config holds beyond ``Nuscenes_synthetic``'s;
    no shipped overlay sets a key to that group's own value, and a test
    holds every overlay with every dataset group against the JAX loader)
    laid back over it, a fid group in place of ``fid``.  Any other group
    swap, overlay or ``--config-name`` raises ``ValueError``."""
    argv = list(argv)
    preset, words = _config_name(argv)
    if preset is not None and preset not in PRESETS:
        raise ValueError(f"--config-name {preset}: the port composes from "
                         f"its shipped JSON configs and takes the presets "
                         f"{sorted(PRESETS)}")
    overlays, groups, dotted = [], [], []
    for word in words:
        if word.startswith("-"):
            raise ValueError(f"{word!r}: the port takes no option but "
                             f"--config-name")
        if "=" not in word:
            raise ValueError(f"bad override (need key=value): {word}")
        key, value = word.split("=", 1)
        if key.startswith("+"):
            overlays.append(word)
        elif "." not in key and (key, value) in GROUPS:
            groups.append((key, value))
        elif "." not in key and key in ("runner", "dataset", "model",
                                        "accelerator", "fid"):
            raise ValueError(
                f"{word!r}: the port takes the group swaps "
                f"{sorted(f'{k}={v}' for k, v in GROUPS)} and the "
                f"overlays {sorted(EXP_CONFIGS)}, then dotted a.b=value "
                f"overrides")
        else:
            dotted.append(word)
    hd = [o for o in overlays if o.startswith("+exp-hd=")]
    if hd and overlays in (hd, ["+exp=dual_branch_augloss_fusion"] + hd):
        overlays = hd
    if len(overlays) > 1 or any(o not in EXP_CONFIGS for o in overlays):
        raise ValueError(f"overlays {overlays}: the port takes one of "
                         f"{sorted(EXP_CONFIGS)} (an +exp-hd=... may follow "
                         f"+exp=dual_branch_augloss_fusion)")
    cfg = load_config(EXP_CONFIGS[overlays[0]] if overlays else FLAGSHIP)
    if preset is not None:
        _merge(cfg, _read(PRESETS[preset]))
    for key, value in groups:
        swap = group(key, value)
        if key == "runner":
            _merge(cfg[key], swap)
        elif key == "dataset":
            _merge(swap, _diff(cfg[key], group("dataset",
                                               "Nuscenes_synthetic")))
            cfg[key] = swap
        else:
            cfg[key] = swap
    apply_overrides(cfg, dotted)
    return cfg, argv


def _merge(node: dict, overlay: dict) -> None:
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(node.get(k), dict):
            _merge(node[k], v)
        else:
            node[k] = v


def save_config(cfg, path: str) -> None:
    """``cfg`` as indented JSON at ``path`` (its directory made)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)
        f.write("\n")
