"""The port's offline tools and presets against the JAX package's: the
``explore_config`` / ``test_config`` presets, the explore CLIs' files, the
weight CLIs (import, export, their round trip) and ``create_data`` /
``prepare_map_aux`` on a nuscenes-devkit stub (a copy of
``tests/test_offline_prep.py``'s)."""

import json
import os
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.runner.weight_import import export_params
from dualdiff_tpu.utils.config import load_config as jax_load_config
from dualdiff_tpu.utils.config import to_dict
from dualdiff_tpu_torch.data.nuscenes import _quat_to_rot
from dualdiff_tpu_torch.runner.weights import (EXPORT_FILE, MULTIVIEW_MODULES,
                                              load_pretrained_dir,
                                              read_checkpoint,
                                              save_model_dir)
from dualdiff_tpu_torch.utils.config import (EXP_CONFIGS, PRESETS, _diff,
                                             compose)
from dualdiff_tpu_torch.utils.image_io import read_png

BAKED = ["runner.pipeline_param.bbox_max_length=80"]
CLIP_BAKED = ["runner.pipeline_param.vae_slicing=12",
              "runner.pipeline_param.sequential_cfg=true"]
# the words tests/test_explore_tool.py gives the JAX CLIs, on the CPU
EXPLORE_WORDS = ["+exp=224x400", "runner=debug", "dataset=Nuscenes_synthetic",
                 "dataset.image_size=[32,48]", "dataset.num_samples=2",
                 "tiny_models=true", "device=cpu"]
TINY_WORDS = EXPLORE_WORDS[:3] + ["dataset.image_size=[32,48]",
                                  "tiny_models=true", "device=cpu"]


def _jax_full(words, name="config"):
    return json.loads(json.dumps(to_dict(jax_load_config(
        tp.CONFIG_DIR, name=name, overrides=words))))


# ------------------------------------------------------------------ presets


@pytest.mark.parametrize("preset", ["explore_config", "test_config"])
def test_preset_composes_as_the_jax_loader(preset):
    """The preset's JSON is what its YAML lays over the root config, and
    ``--config-name <preset>`` with every overlay the CLI takes, with
    ``runner=debug`` (which replaces the preset's runner keys in the JAX
    loader) and with a dataset group composes as the JAX loader does."""
    with open(os.path.join(os.path.dirname(__file__), "..",
                           "dualdiff_tpu_torch", "configs",
                           PRESETS[preset] + ".json")) as f:
        assert json.load(f) == _diff(_jax_full([], preset), _jax_full([]))
    for overlay in sorted(EXP_CONFIGS):
        baked = BAKED + (CLIP_BAKED if overlay in ("+exp=video_16f",
                                                   "+exp=rgd_stage2") else [])
        exp = ["+exp=dual_branch_augloss_fusion"] \
            if overlay.startswith("+exp-hd") else []
        for extra in (["dataset=Nuscenes_synthetic"],
                      ["runner=debug", "dataset=Nuscenes_synthetic"],
                      ["dataset=Nuscenes", "explore_t=250"]):
            cfg, _ = compose(["--config-name", preset, overlay] + extra)
            assert cfg == _jax_full(exp + [overlay] + extra + baked,
                                    preset), (overlay, extra)
    cfg, _ = compose([f"--config-name={preset}"])
    if preset == "explore_config":
        assert (cfg.explore_t, cfg.explore_out) == (500, "./attn_maps")
        assert cfg.runner.train_batch_size == 1
    else:
        assert cfg.runner.validation_show_box is True


# ------------------------------------------------------------ explore CLIs


def test_explore_clis_write_the_jax_tools_files(tmp_path):
    """The words ``tests/test_explore_tool.py`` gives the JAX CLIs: the
    attention tool writes a grey PNG per cross-attention map it can lay out
    (``<controlnet|unet>.<JAX path>.png``, the map of
    ``attention_map``), the UNet tool the nine blocks' PNGs for every view
    and ``block_features.npz`` with the JAX tool's keys, channels-last."""
    from dualdiff_tpu_torch.tools import explore_attn as ea
    from dualdiff_tpu_torch.tools import explore_unet as eu

    out = str(tmp_path / "maps")
    inter = ea.main(EXPLORE_WORDS + [f"explore_out={out}",
                                     f"log_root={tmp_path / 'run'}"])
    want = {}
    for tag, store in inter.items():
        for key, probs in store.items():
            if "attn2" not in key:
                continue
            assert probs.dtype == torch.float32
            img = ea.attention_map(probs.numpy(), (4, 6))
            if img is not None:
                want[f"{tag}.{key[:-len('/attn_probs')].replace('/', '.')}"
                     f".png"] = img
    assert want and sorted(os.listdir(out)) == sorted(want)
    assert any(n.startswith("unet.down_blocks_0.attentions_0."
                            "transformer_blocks_0.attn2") for n in want)
    for name, img in want.items():
        got = read_png(os.path.join(out, name))
        assert got.shape == (32, 48) and np.array_equal(got, img), name

    out = str(tmp_path / "feats")
    raw = eu.main(EXPLORE_WORDS + [f"explore_out={out}",
                                   f"log_root={tmp_path / 'run'}"])
    names = [f"down_block_{i}_out" for i in range(4)] + ["mid_block_out"] \
        + [f"up_block_{i}_out" for i in range(4)]
    assert sorted(raw) == sorted(names)
    for feat in raw.values():
        assert feat.shape[0] == 6 and np.isfinite(feat).all()
    assert raw["up_block_3_out"].shape == (6, 4, 6, 32)  # (B*N, h, w, C)
    pngs = [f for f in os.listdir(out) if f.endswith(".png")]
    assert sorted(pngs) == sorted(f"{n}.view{v}.png" for n in names
                                  for v in range(6))
    with np.load(os.path.join(out, "block_features.npz")) as npz:
        assert sorted(npz.files) == sorted(names)
        for n in names:
            np.testing.assert_array_equal(npz[n], raw[n])


# ------------------------------------------------------------- weight CLIs


def _write_diffusers_tree(root, models):
    """A diffusers-layout checkpoint of the tiny models' shapes, seeded
    values: the UNet without the modules DualDiff adds, the VAE under its
    legacy attention names, CLIP with its ``position_ids`` buffer, the
    ControlNet under ``controlnet/``.  -> {dir: {name: array}}."""
    rng = np.random.default_rng(0)
    legacy = {"to_q": "query", "to_k": "key", "to_v": "value",
              "to_out.0": "proj_attn"}
    trees = {}
    for sub, module in (("unet", models["unet"]), ("vae", models["vae"]),
                        ("text_encoder", models["text_encoder"]),
                        ("controlnet", models["controlnets"][0])):
        sd = {}
        for name, t in module.state_dict().items():
            if sub == "unet" and any(m in name.split(".")
                                     for m in MULTIVIEW_MODULES):
                continue
            if sub == "vae":
                for new, old in legacy.items():
                    name = name.replace(f"attentions.0.{new}.",
                                        f"attentions.0.{old}.")
            sd[name] = rng.standard_normal(tuple(t.shape)).astype(
                np.float32) * 0.02
        if sub == "text_encoder":
            sd["text_model.embeddings.position_ids"] = np.arange(
                77, dtype=np.int64)[None]
        os.makedirs(os.path.join(root, sub))
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   os.path.join(root, sub, EXPORT_FILE))
        trees[sub] = sd
    return trees


def _read_dir(root):
    return {name: read_checkpoint(os.path.join(root, name, EXPORT_FILE))
            for name in sorted(os.listdir(root))}


def _assert_dirs_equal(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert sorted(a[name]) == sorted(b[name]), name
        for k, v in a[name].items():
            assert torch.equal(v, b[name][k]), (name, k)


def test_import_equals_load_pretrained_dir_and_round_trips(tmp_path):
    """Import = ``load_pretrained_dir`` of the same directory into fresh
    models, written in the export layout; export -> import -> export is
    bit-equal, and every released tensor comes back as it went in."""
    from dualdiff_tpu_torch.tools import export_weights as ew
    from dualdiff_tpu_torch.tools import import_weights as iw

    cfg, _ = compose(TINY_WORDS)
    src = str(tmp_path / "sd15")
    trees = _write_diffusers_tree(src, iw.fresh_models(cfg))
    imp = str(tmp_path / "imp")
    report = iw.main(["--src", src, "--out", imp] + TINY_WORDS)
    assert report["unet"]["missing"] and all(
        any(m in k.split(".") for m in MULTIVIEW_MODULES)
        for k in report["unet"]["missing"])

    models = iw.fresh_models(cfg)
    load_pretrained_dir(models, src)
    want = {n: dict(m.state_dict())
            for n, m in iw.components(models).items()}
    _assert_dirs_equal(_read_dir(imp), want)

    exp1, imp2, exp2 = (str(tmp_path / n) for n in ("exp1", "imp2", "exp2"))
    ew.main(["--src", imp, "--out", exp1])
    iw.main(["--src", exp1, "--out", imp2] + TINY_WORDS)
    ew.main(["--src", imp2, "--out", exp2])
    got = _read_dir(exp1)
    _assert_dirs_equal(got, _read_dir(exp2))
    renamed = {"query": "to_q", "key": "to_k", "value": "to_v",
               "proj_attn": "to_out.0"}
    for sub, sd in trees.items():
        out = got["controlnet_0" if sub == "controlnet" else sub]
        for k, v in sd.items():
            if k.endswith("position_ids"):
                assert k not in out
                continue
            for old, new in renamed.items():
                k = k.replace(f"attentions.0.{old}.", f"attentions.0.{new}.")
            np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


def test_export_writes_the_jax_exporters_names_and_layouts(tmp_path):
    """The port's weights of the tiny JAX params, exported: per component
    the JAX ``export_params`` tree, name for name and bit for bit; and a
    training checkpoint exports its trainer's ``export_state_dicts`` with
    the frozen VAE and text encoder."""
    from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes
    from dualdiff_tpu_torch.runner.trainer import MultiviewTrainer
    from dualdiff_tpu_torch.tools import export_weights as ew

    s = tp.tiny_setup()
    pm = s["pmodels"]
    src = str(tmp_path / "port")
    save_model_dir({"unet": pm["unet"].state_dict(),
                    "vae": pm["vae"].state_dict(),
                    "text_encoder": pm["text_encoder"].state_dict(),
                    "controlnet_1": pm["controlnets"][1].state_dict()}, src)
    out = str(tmp_path / "out")
    ew.main(["--src", src, "--out", out])
    got = _read_dir(out)
    for name, key, kind in (("unet", "unet", "unet"), ("vae", "vae", "vae"),
                            ("text_encoder", "text_encoder", "clip"),
                            ("controlnet_1", "controlnet_1", "controlnet")):
        want = export_params(s["params"][key], kind)
        assert sorted(got[name]) == sorted(want), name
        for k, v in want.items():
            np.testing.assert_array_equal(got[name][k].numpy(),
                                          np.asarray(v), err_msg=k)

    run = tmp_path / "run"
    cfg, words = compose(TINY_WORDS + [f"log_root={run}"])
    trainer = MultiviewTrainer(cfg, SyntheticNuScenes(
        num_samples=2, image_size=(32, 48)), device="cpu")
    ckpt = trainer.save_checkpoint()
    os.makedirs(run / "hydra")
    with open(run / "hydra" / "overrides.json", "w") as f:
        json.dump(words, f)
    out = str(tmp_path / "ckpt_out")
    ew.main(["--src", ckpt, "--out", out])
    want = trainer.export_state_dicts()
    want["vae"] = trainer.models["vae"].state_dict()
    want["text_encoder"] = trainer.models["text_encoder"].state_dict()
    _assert_dirs_equal(_read_dir(out), want)


# --------------------------------------------- create_data, prepare_map_aux

CAMS = ["CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
        "CAM_BACK_RIGHT", "CAM_BACK", "CAM_BACK_LEFT"]


def _yaw_quat(yaw):
    return (np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2))


class _Box:
    def __init__(self, center, wlh, orientation):
        self.center = np.asarray(center, np.float64)
        self.wlh = np.asarray(wlh, np.float64)
        self.orientation = tuple(orientation)  # wxyz


class _Quaternion:
    """pyquaternion.Quaternion stand-in (rotation_matrix only)."""

    def __init__(self, q):
        self.q = list(q)

    @property
    def rotation_matrix(self):
        return _quat_to_rot(self.q)


class _Polygon:
    def __init__(self, coords):
        self.exterior = types.SimpleNamespace(coords=list(coords))


class _Line:
    def __init__(self, coords):
        self.coords = list(coords)


class _FakeNuScenesMap:
    """One drivable-area polygon and one road-divider line in world
    coordinates near the stub ego pose (100, 50)."""

    def __init__(self, dataroot, location):
        self.location = location

    def get_records_in_patch(self, patch, layers, mode="intersect"):
        table = {"drivable_area": ["da1"], "road_divider": ["rd1"]}
        return {layer: table.get(layer, []) for layer in layers}

    def get(self, layer, token):
        if layer == "drivable_area":
            return {"polygon_tokens": ["p1"]}
        if layer == "road_divider":
            return {"line_token": "l1"}
        raise KeyError(layer)

    def extract_polygon(self, token):
        return _Polygon([(85, 40), (115, 40), (115, 60), (85, 60), (85, 40)])

    def extract_line(self, token):
        return _Line([(90, 50), (110, 50)])


def _build_tables():
    """Two scenes x two keyframes, 6 cams, annotations with known
    geometry."""
    tables = {"sample": {}, "sample_data": {}, "calibrated_sensor": {},
              "ego_pose": {}, "sample_annotation": {}, "log": {}, "scene": {}}
    scenes, samples = [], []
    tables["log"]["log1"] = {"location": "boston-seaport"}
    tables["calibrated_sensor"]["cs_lidar"] = {
        "rotation": (1, 0, 0, 0), "translation": (0.0, 0.0, 1.8)}
    for i, cam in enumerate(CAMS):
        tables["calibrated_sensor"][f"cs_{cam}"] = {
            "rotation": _yaw_quat(np.pi / 3 * i),
            "translation": (1.5, (-1) ** i * 0.5, 1.6),
            "camera_intrinsic": [[1266.0, 0, 800.0],
                                 [0, 1266.0, 450.0], [0, 0, 1.0]]}
    for s_idx, (scene_name, desc) in enumerate(
            [("scene-0001", "Sunny day drive"),
             ("scene-0002", "Rainy night drive")]):
        stok = f"scene{s_idx}"
        tables["scene"][stok] = {"token": stok, "name": scene_name,
                                 "description": desc, "log_token": "log1"}
        scenes.append(tables["scene"][stok])
        for k in range(2):
            tok = f"s{s_idx}{k}"
            ego_t = np.array([100.0 + 20 * k, 50.0, 0.0])
            tables["ego_pose"][f"ep_{tok}"] = {
                "rotation": _yaw_quat(0.0 if k == 0 else np.pi / 2),
                "translation": ego_t}
            tables["sample_data"][f"sd_lidar_{tok}"] = {
                "calibrated_sensor_token": "cs_lidar",
                "ego_pose_token": f"ep_{tok}",
                "filename": f"lidar/{tok}.bin"}
            data = {"LIDAR_TOP": f"sd_lidar_{tok}"}
            for cam in CAMS:
                tables["sample_data"][f"sd_{cam}_{tok}"] = {
                    "calibrated_sensor_token": f"cs_{cam}",
                    "ego_pose_token": f"ep_{tok}",
                    "filename": f"samples/{cam}/{tok}.jpg"}
                data[cam] = f"sd_{cam}_{tok}"
            anns = []
            for a_idx, (center, wlh, name, vis) in enumerate([
                    (ego_t + np.array([10.0, 0.0, 1.0]),
                     (2.0, 4.5, 1.6), "vehicle.car.sedan", "4"),
                    (ego_t + np.array([-5.0, -3.0, 0.9]),
                     (0.6, 0.7, 1.8), "human.pedestrian.adult", "2")]):
                atok = f"ann_{tok}_{a_idx}"
                tables["sample_annotation"][atok] = {
                    "token": atok, "category_name": name,
                    "visibility_token": vis, "_center": center,
                    "_wlh": wlh, "_orientation": _yaw_quat(0.3 * a_idx)}
                anns.append(atok)
            rec = {"token": tok, "scene_token": stok,
                   "timestamp": 1_000_000 + 1000 * (2 * s_idx + k),
                   "data": data, "anns": anns}
            tables["sample"][tok] = rec
            samples.append(rec)
    return tables, scenes, samples


@pytest.fixture()
def devkit_stub(monkeypatch):
    """``nuscenes`` / ``pyquaternion`` stub modules for both packages'
    tools."""
    tables, scenes, samples = _build_tables()

    class _FakeNuScenes:
        def __init__(self, version, dataroot, verbose=False):
            self.version = version
            self.scene = scenes
            self.sample = samples

        def get(self, table, token):
            return tables[table][token]

        def get_box(self, ann_token):
            ann = tables["sample_annotation"][ann_token]
            return _Box(ann["_center"], ann["_wlh"], ann["_orientation"])

    nusc = types.ModuleType("nuscenes")
    nusc.NuScenes = _FakeNuScenes
    utils = types.ModuleType("nuscenes.utils")
    splits = types.ModuleType("nuscenes.utils.splits")
    splits.mini_train = splits.train = ["scene-0001"]
    splits.mini_val = splits.val = ["scene-0002"]
    utils.splits = splits
    nusc.utils = utils
    mapexp = types.ModuleType("nuscenes.map_expansion")
    mapapi = types.ModuleType("nuscenes.map_expansion.map_api")
    mapapi.NuScenesMap = _FakeNuScenesMap
    mapexp.map_api = mapapi
    nusc.map_expansion = mapexp
    pyquat = types.ModuleType("pyquaternion")
    pyquat.Quaternion = _Quaternion
    for name, mod in [("nuscenes", nusc), ("nuscenes.utils", utils),
                      ("nuscenes.utils.splits", splits),
                      ("nuscenes.map_expansion", mapexp),
                      ("nuscenes.map_expansion.map_api", mapapi),
                      ("pyquaternion", pyquat)]:
        monkeypatch.setitem(sys.modules, name, mod)
    return tables


def _tree_equal(a, b, where=""):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _tree_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def test_create_data_and_prepare_map_aux_equal_the_jax_tools(devkit_stub,
                                                             tmp_path):
    """Both packages' tools on the same stub: the info pickles equal field
    for field (types and dtypes too), the h5 caches dataset for dataset:
    the same names, shapes, dtypes, gzip and values."""
    import h5py

    import tools.create_data as jcd
    import tools.prepare_map_aux as jpma
    from dualdiff_tpu_torch.tools import create_data as pcd
    from dualdiff_tpu_torch.tools import prepare_map_aux as ppma

    root = str(tmp_path / "nusc")
    jcd.create_nuscenes_infos(root, "v1.0-mini", str(tmp_path / "j"))
    pcd.main(["--dataroot", root, "--version", "v1.0-mini",
              "--out", str(tmp_path / "p")])
    for split in ("train", "val"):
        loaded = []
        for side in "jp":
            with open(tmp_path / side / f"nuscenes_infos_{split}.pkl",
                      "rb") as f:
                loaded.append(pickle.load(f))
        _tree_equal(*loaded, split)
        assert len(loaded[0]["infos"]) == 2

    infos = str(tmp_path / "p" / "nuscenes_infos_train.pkl")
    args = ["--dataroot", root, "--version", "v1.0-mini", "--infos", infos]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["prepare_map_aux.py"] + args
                   + ["--out", str(tmp_path / "j.h5")])
        jpma.main()
    ppma.main(args + ["--out", str(tmp_path / "p.h5")])

    def datasets(path):
        out = {}
        with h5py.File(path, "r") as h5:
            h5.visititems(lambda name, obj: out.__setitem__(name, (
                obj[()], obj.dtype, obj.compression, obj.compression_opts,
                obj.chunks)) if isinstance(obj, h5py.Dataset) else None)
        return out

    want, got = datasets(tmp_path / "j.h5"), datasets(tmp_path / "p.h5")
    assert sorted(got) == sorted(want) == ["aux/s00", "aux/s01", "s00", "s01"]
    for name, (arr, *meta) in want.items():
        assert got[name][1:] == tuple(meta), name
        np.testing.assert_array_equal(got[name][0], arr, err_msg=name)
    assert got["s00"][0].sum() > 0 and np.abs(got["aux/s00"][0]).sum() > 0


def test_offline_prep_tools_name_what_they_miss(monkeypatch, tmp_path):
    """Without the devkit (and h5py) both tools stop with a message that
    names what to install."""
    from dualdiff_tpu_torch.tools import create_data as pcd
    from dualdiff_tpu_torch.tools import prepare_map_aux as ppma

    for name in ("nuscenes", "nuscenes.utils",
                 "nuscenes.map_expansion.map_api", "h5py"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(SystemExit, match="nuscenes-devkit"):
        pcd.main(["--out", str(tmp_path)])
    with pytest.raises(SystemExit, match="h5py and the nuscenes-devkit"):
        ppma.main(["--infos", "x.pkl", "--out", str(tmp_path / "x.h5")])
