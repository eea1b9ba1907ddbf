"""The port's nuScenes reader (``dualdiff_tpu_torch/data/nuscenes.py``), its
``build_dataset`` and the dataset / fid config groups, against the JAX
package's.

The fixture is ``tests/test_offline_prep.py``'s (imported, not edited): the
devkit stub drives ``tools/create_data.py`` (two scenes of two keyframes,
six cameras) and ``tools/prepare_map_aux.py`` (the h5 mask and aux cache),
and ``_write_images`` writes the 1600 x 900 JPEGs.  Every sample is held
key for key, bit for bit (images, masks, aux raster, boxes, labels, the
five camera matrices, token, file names, the optional roots' arrays) in
each BEV route: the h5 cache (as written, and bit-packed through the
native codec), the live raster under the stub, ``zeros`` and ``error``
without the devkit; and with a non-JPEG image, which both readers decode
through their own PIL path.
"""

import json
import os
import pickle
import sys

import numpy as np
import pytest

from tests import torch_parity as tp
from tests.test_offline_prep import (_run_create_data, _write_images,
                                     devkit_stub)  # noqa: F401 (fixture)
from dualdiff_tpu.data.nuscenes import NuScenesDataset as JaxReader
from dualdiff_tpu.utils.config import load_config as jax_load_config
from dualdiff_tpu.utils.config import to_dict
from dualdiff_tpu_torch.data.nuscenes import NuScenesDataset
from dualdiff_tpu_torch.data.wrappers import build_dataset
from dualdiff_tpu_torch.utils.config import (EXP_CONFIGS, GROUPS, PRESETS,
                                             compose, group)

OBJECTS = ["car", "truck", "construction_vehicle", "bus", "trailer",
           "barrier", "motorcycle", "bicycle", "pedestrian", "traffic_cone"]
AUX = ["visibility", "center_offset", "center_ohw", "height"]
BAKED = ["runner.pipeline_param.bbox_max_length=80"]


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif hasattr(a, "__dataclass_fields__"):
        assert vars(a) == vars(b), path
    else:
        assert a == b, path


@pytest.fixture()
def nusc(devkit_stub, tmp_path, monkeypatch):  # noqa: F811
    """The fixture set: infos, images, the h5 cache (as the tool writes it)
    and the three optional roots.  -> dict of paths."""
    import tools.prepare_map_aux as pma

    out = _run_create_data(tmp_path)
    root = str(tmp_path / "nusc")
    paths = {"root": root, "infos": out + "/",
             "train": os.path.join(out, "nuscenes_infos_train.pkl"),
             "val": os.path.join(out, "nuscenes_infos_val.pkl")}
    infos = []
    for split in ("train", "val"):
        with open(paths[split], "rb") as f:
            infos += pickle.load(f)["infos"]
        h5 = str(tmp_path / f"map_aux_{split}.h5")
        monkeypatch.setattr(sys, "argv", [
            "prepare_map_aux.py", "--dataroot", root, "--version",
            "v1.0-mini", "--infos", paths[split], "--out", h5])
        pma.main()
        paths[f"h5_{split}"] = h5
    _write_images(root, infos)
    rng = np.random.default_rng(3)
    occ_proj, occ3d, vec = (str(tmp_path / d) for d in
                            ("occ_proj", "occ3d", "map_vec"))
    for d in (occ_proj, occ3d, vec):
        os.makedirs(d)
    for i, info in enumerate(infos):
        tok = info["token"]
        if i % 2:  # a png panorama for every other token
            from PIL import Image

            Image.fromarray(rng.integers(0, 255, (224, 2400, 3), np.uint8)) \
                .save(os.path.join(occ_proj, tok + ".png"))
        else:
            np.save(os.path.join(occ_proj, tok + ".npy"),
                    rng.random((224, 2400, 3)).astype(np.float32))
        os.makedirs(os.path.join(occ3d, tok))
        np.savez(os.path.join(occ3d, tok, "labels.npz"),
                 semantics=rng.integers(0, 18, (200, 200, 16), np.uint8))
        pts = 3 if i % 2 else 2  # (n, 20, 2) gets z = 0 appended
        with open(os.path.join(vec, tok + ".pkl"), "wb") as f:
            pickle.dump((rng.normal(0, 20, (4, 20, pts)).astype(np.float32),
                         rng.integers(0, 3, 4)), f)
    paths.update(occ_proj=occ_proj, occ3d=occ3d, map_vec=vec)
    return paths


def _both(ann_file, **kw):
    kw.setdefault("object_classes", OBJECTS)
    return NuScenesDataset(ann_file, **kw), JaxReader(ann_file, **kw)


def _all_equal(port, jax):
    assert len(port) == len(jax) > 0
    assert port.sample_meta() == jax.sample_meta()
    for i in range(len(port)):
        _tree_equal(port[i], jax[i], f"sample {i}")


def test_samples_equal_from_the_h5_cache_with_the_optional_roots(nusc):
    for split in ("train", "val"):
        port, jax = _both(nusc[split], dataset_root=nusc["root"],
                          cache_file=nusc[f"h5_{split}"], aux_data=AUX,
                          occ_proj_root=nusc["occ_proj"],
                          occ3d_root=nusc["occ3d"],
                          map_vec_root=nusc["map_vec"])
        _all_equal(port, jax)
        s = port[0]
        assert s["img"].shape == (6, 224, 400, 3)
        assert s["gt_masks_bev"].shape == (18, 200, 200)
        assert s["gt_masks_bev"].any() and s["gt_aux_bev"].any()
        assert {"occ_proj_image", "occ_labels", "occ_cam_K", "occ_cam_T",
                "map_vec_boxes", "map_vec_classes"} <= set(s)
        assert {port[i]["map_vec_boxes"].shape[-1]
                for i in range(len(port))} == {3}


def test_samples_equal_from_a_bit_packed_cache(nusc, tmp_path):
    """A cache of packed uint32 words: both readers unpack it (the port
    through its own native codec) to the tool's masks."""
    import h5py

    from dualdiff_tpu_torch.data import native

    packed = str(tmp_path / "packed.h5")
    with h5py.File(nusc["h5_train"], "r") as src, \
            h5py.File(packed, "w") as dst:
        for tok in src:
            if tok != "aux":
                dst[tok] = native.pack_masks(src[tok][()])
    port, jax = _both(nusc["train"], dataset_root=nusc["root"],
                      cache_file=packed, load_images=False)
    _all_equal(port, jax)
    with h5py.File(nusc["h5_train"], "r") as src:
        np.testing.assert_array_equal(port[0]["gt_masks_bev"],
                                      src[port.infos[0]["token"]][()])


def test_samples_equal_from_the_live_raster(nusc):
    port, jax = _both(nusc["val"], dataset_root=nusc["root"],
                      load_images=False, aux_data=AUX,
                      point_cloud_range=[-8, -8, -5, 8, 8, 3])
    _all_equal(port, jax)
    assert port[0]["gt_masks_bev"].any()
    assert len(port[0]["gt_bboxes_3d"]) < len(port.infos[0]["gt_boxes"])


@pytest.mark.parametrize("missing_bev", ["zeros", "error"])
def test_without_cache_or_devkit(nusc, monkeypatch, missing_bev):
    """No cache and no map expansion (as on the card): zeros, or both
    readers refuse the sample."""
    monkeypatch.setitem(sys.modules, "nuscenes.map_expansion.map_api", None)
    port, jax = _both(nusc["train"], dataset_root=nusc["root"],
                      missing_bev=missing_bev)
    if missing_bev == "zeros":
        _all_equal(port, jax)
        assert not port[0]["gt_masks_bev"].any()
    else:
        for ds in (port, jax):
            with pytest.raises(RuntimeError, match="BEV masks unavailable"):
                ds[0]


def test_a_non_jpeg_image_takes_the_readers_own_path(nusc, tmp_path):
    """One camera as PNG: the native batch refuses the set and both
    readers resize and crop through PIL, with the image's own aug
    matrices; the other samples stay on the native decode."""
    from PIL import Image

    with open(nusc["train"], "rb") as f:
        data = pickle.load(f)
    cam = data["infos"][0]["cams"]["CAM_BACK"]
    src = os.path.join(nusc["root"], cam["data_path"])
    cam["data_path"] = cam["data_path"][:-4] + ".png"
    Image.open(src).resize((2000, 1000)).save(
        os.path.join(nusc["root"], cam["data_path"]))
    ann = str(tmp_path / "png_infos.pkl")
    with open(ann, "wb") as f:
        pickle.dump(data, f)
    port, jax = _both(ann, dataset_root=nusc["root"], load_bev=False)
    _all_equal(port, jax)
    tok = data["infos"][0]["token"]
    s = next(port[i] for i in range(len(port)) if port[i]["token"] == tok)
    np.testing.assert_array_equal(s["img_aug_matrix"][4, :2, 3],
                                  [-(500 - 400) // 2, -(250 - 224)])


def test_build_dataset_equals_the_jax_one(nusc):
    """``compose(["dataset=Nuscenes_cache", ...roots])`` against the JAX
    ``build_dataset`` of ``load_config`` with the same words: the
    flagship (no branch on bev_map: ``missing_bev`` resolves to zeros) and
    ``+exp=224x400`` (bev_map: error, so the cache serves it)."""
    from dualdiff_tpu.data.wrappers import build_dataset as jax_build

    roots = [f"dataset.dataset_root={nusc['root']}",
             f"dataset.dataset_process_root={nusc['infos']}",
             "dataset.dataset_cache_file=" + json.dumps(
                 [nusc["h5_train"], nusc["h5_val"]]),
             f"dataset.occ_proj_root={nusc['occ_proj']}",
             f"dataset.occ3d_root={nusc['occ3d']}",
             f"dataset.map_vec_root={nusc['map_vec']}"]
    for exp in ("+exp=dual_branch_augloss_fusion", "+exp=224x400"):
        words = [exp, "dataset=Nuscenes_cache"] + roots
        cfg, _ = compose(words)
        jcfg = jax_load_config(tp.CONFIG_DIR, overrides=words + BAKED)
        assert cfg == json.loads(json.dumps(to_dict(jcfg)))
        for split in ("train", "val"):
            got, want = build_dataset(cfg, split), jax_build(jcfg, split)
            assert got.missing_bev == want.missing_bev == (
                "zeros" if "fusion" in exp else "error")
            _all_equal(got, want)


def test_the_flagship_runs_without_cache_or_devkit(nusc, monkeypatch):
    """``dataset=Nuscenes`` with the flagship's roots and no mask cache,
    the devkit's map expansion absent: zeros for the unused bev_map, and
    the batch collates as the JAX one; ``+exp=224x400`` raises."""
    from dualdiff_tpu.data.collate import collate_fn as jax_collate
    from dualdiff_tpu.data.tokenizer import HashTokenizer as JaxTok
    from dualdiff_tpu.data.wrappers import build_dataset as jax_build
    from dualdiff_tpu_torch.data.collate import collate_fn
    from dualdiff_tpu_torch.data.tokenizer import HashTokenizer

    monkeypatch.setitem(sys.modules, "nuscenes.map_expansion.map_api", None)
    words = ["dataset=Nuscenes", f"dataset.dataset_root={nusc['root']}",
             f"dataset.dataset_process_root={nusc['infos']}",
             f"dataset.occ_proj_root={nusc['occ_proj']}",
             f"dataset.occ3d_root={nusc['occ3d']}",
             f"dataset.map_vec_root={nusc['map_vec']}"]
    cfg, _ = compose(words)
    jcfg = jax_load_config(tp.CONFIG_DIR, overrides=[
        "+exp=dual_branch_augloss_fusion"] + words + BAKED)
    got, want = build_dataset(cfg, "train"), jax_build(jcfg, "train")
    samples = [got[0], got[1]]
    _tree_equal(samples, [want[0], want[1]])
    batch = collate_fn(samples, cfg, HashTokenizer(),
                       rng=np.random.default_rng(0))
    jbatch = jax_collate([want[0], want[1]], jcfg, JaxTok(),
                         rng=np.random.default_rng(0))
    _tree_equal(batch, jbatch)
    assert batch["pixel_values"].shape[:2] == (2, 6)
    bev, _ = compose(["+exp=224x400"] + words)
    with pytest.raises(RuntimeError, match="BEV masks unavailable"):
        build_dataset(bev, "train")[0]


@pytest.mark.parametrize("key", [k for k in sorted(GROUPS)
                                 if k[0] != "runner"])
def test_group_json_equals_the_composed_yaml(key):
    """The JSONs of a group swap laid in order (``config.group``) are
    ``configs/<group>/<name>.yaml`` as the JAX loader composes it under the
    root config (runner_debug.json, which lays only debug.yaml's own keys,
    is held by test_torch_tools)."""
    name, value = key
    want = _jax_full([f"{name}={value}"], "test_fid" if name == "fid"
                     else "config")[name]
    assert group(name, value) == want


@pytest.mark.parametrize("swap", [v for k, v in sorted(GROUPS)
                                  if k == "dataset"])
@pytest.mark.parametrize("overlay", sorted(EXP_CONFIGS))
def test_every_overlay_composes_with_each_dataset_group_as_jax(overlay,
                                                               swap):
    """``compose`` keeps the overlay's own dataset keys over the swapped
    group, as the JAX loader lays the overlay after its group swaps: held
    for every overlay the CLI takes and every dataset group (configs only;
    no dataset is built)."""
    baked = BAKED + (["runner.pipeline_param.vae_slicing=12",
                      "runner.pipeline_param.sequential_cfg=true"]
                     if overlay in ("+exp=video_16f", "+exp=rgd_stage2")
                     else [])
    cfg, _ = compose([overlay, f"dataset={swap}"])
    assert cfg == _jax_full([overlay, f"dataset={swap}"] + baked)


def _jax_full(words, name="config"):
    return json.loads(json.dumps(to_dict(jax_load_config(
        tp.CONFIG_DIR, name=name, overrides=words))))


def test_test_fid_preset_composes_as_the_jax_loader():
    """``--config-name test_fid`` with the dataset groups, ``fid=...`` and
    the roots no YAML sets, and the preset's JSON = what test_fid.yaml
    adds to the root config."""
    preset = _jax_full([], "test_fid")
    base = _jax_full([])
    with open(os.path.join(os.path.dirname(__file__), "..",
                           "dualdiff_tpu_torch", "configs",
                           PRESETS["test_fid"] + ".json")) as f:
        assert json.load(f) == {k: v for k, v in preset.items()
                                if base.get(k) != v}
    for words in (["dataset=Nuscenes", "fid.rootb=/gen", "fid.ratio=0.5"],
                  ["fid=data_gen", "dataset=Nuscenes_map_cache_box",
                   "dataset.missing_bev=zeros"],
                  ["+exp=video_16f", "dataset=Nuscenes", "runner=debug",
                   "runner.pipeline_param.vae_slicing=12",
                   "runner.pipeline_param.sequential_cfg=true"]):
        exp = [] if words[0].startswith("+") else [
            "+exp=dual_branch_augloss_fusion"]
        for cn in (["--config-name", "test_fid"], ["--config-name=test_fid"]):
            cfg, taken = compose(cn + words)
            assert taken == cn + words
            assert cfg == _jax_full(exp + words + BAKED, "test_fid")
    # the dotted roots make their nodes, as the JAX loader's set_path does
    cfg, _ = compose(["fid.rootb=/gen", "dataset.occ3d_root=/o"])
    assert cfg.fid == {"rootb": "/gen"} and cfg.dataset.occ3d_root == "/o"
    assert cfg == _jax_full(["+exp=dual_branch_augloss_fusion",
                             "dataset=Nuscenes_synthetic", "fid.rootb=/gen",
                             "dataset.occ3d_root=/o"] + BAKED)
    with pytest.raises(ValueError, match="presets"):
        compose(["--config-name", "test_config"])
