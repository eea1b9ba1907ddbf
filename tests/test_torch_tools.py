"""The port's entry points and what they stand on, against the JAX
package: ``utils/config.compose``, ``utils/common.load_module``, the data
wrappers, scene sampling and prefetch, ``utils/image_io`` (against PIL),
``runner/visualize`` (against the JAX visualiser and cv2), the validator,
and the ``train``, ``test`` and ``val_set_gen`` tools end to end on the
CPU at the tiny sizes (``tiny_models=true``, 32x48, ``device=cpu``), as
``tests/test_cli_test_tool.py`` and ``tests/test_val_set_gen.py`` run the
JAX tools.

Tolerances: configs, datasets, scene picks, the box segments, PNG files,
the bicubic resize and ``postprocess`` are held exactly (PIL's 8-bit
resampling is reproduced in its fixed point).  The port's JPEG, decoded by
PIL, lies within a mean of 1 level of PIL's own quality-75 encode decoded
(0.36-0.63 read on smooth-plus-noise images; the DCTs differ: float here,
libjpeg's integer one there), and its error against the source within 0.1
level of PIL's.  The drawn box pixels lie within one pixel of cv2's
``LINE_AA`` pixels, both ways (the one use of cv2).
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.utils.config import load_config as jax_load_config
from dualdiff_tpu.utils.config import to_dict
from dualdiff_tpu_torch.data.prefetch import prefetch_map
from dualdiff_tpu_torch.data.wrappers import FolderSetWrapper, \
    ListSetWrapper, build_dataset
from dualdiff_tpu_torch.utils import image_io
from dualdiff_tpu_torch.utils.config import EXP_CONFIGS, compose, \
    load_config, save_config

TINY = ["runner=debug", "dataset=Nuscenes_synthetic",
        "dataset.image_size=[32,48]", "tiny_models=true"]
# what each shipped JSON was composed with beyond its overlay
BAKED = ["dataset=Nuscenes_synthetic",
         "runner.pipeline_param.bbox_max_length=80"]
BAKED_CLIPS = BAKED + ["runner.pipeline_param.vae_slicing=12",
                       "runner.pipeline_param.sequential_cfg=true"]


def _jax(words):
    return json.loads(json.dumps(to_dict(jax_load_config(
        tp.CONFIG_DIR, overrides=list(words)))))


# ---------------------------------------------------------------- configs --

def test_compose_equals_the_jax_composition():
    """``+exp=224x400 runner=debug dataset=Nuscenes_synthetic
    dataset.image_size=[32,48] tiny_models=true`` and the flagship: the
    JAX side adds the baked-in ``bbox_max_length=80``.  The interpolated
    ``model.unet.img_size`` follows the overridden image size."""
    words = ["+exp=224x400"] + TINY
    cfg, taken = compose(words)
    assert taken == words
    assert cfg == _jax(words + BAKED[1:])
    assert cfg.model.unet.img_size == [32, 48]
    cfg, _ = compose(["+exp=dual_branch_augloss_fusion"])
    assert cfg == _jax(["+exp=dual_branch_augloss_fusion"] + BAKED)
    assert compose([])[0] == cfg  # the flagship by default


@pytest.mark.parametrize("overlay", sorted(EXP_CONFIGS))
def test_every_cli_overlay_composes_as_jax_under_runner_debug(overlay):
    baked = BAKED_CLIPS if overlay in ("+exp=video_16f", "+exp=rgd_stage2") \
        else BAKED
    cfg, _ = compose([overlay, "runner=debug", "dataset=Nuscenes_synthetic"])
    assert cfg == _jax([overlay, "runner=debug"] + baked)


def test_hd_overlay_after_the_flagship_and_the_links():
    cfg, _ = compose(["+exp=dual_branch_augloss_fusion", "+exp-hd=432x768"])
    assert cfg == _jax(["+exp=dual_branch_augloss_fusion",
                        "+exp-hd=432x768"] + BAKED)
    words = ["model.name=other", "dataset.dataset_process_root=/data/",
             "model.bbox_mode=center", "dataset.image_size=[64,96]",
             "model.unet.crossview_attn_type=literal"]
    cfg = load_config(overrides=words)
    want = _jax(["+exp=dual_branch_augloss_fusion"] + BAKED + words)
    assert cfg == want
    assert cfg.projname == "other" and cfg.model.unet.img_size == [64, 96]
    assert cfg.dataset.data.val.ann_file == "/data/nuscenes_infos_val.pkl"


@pytest.mark.parametrize("words", [
    ["dataset=Nuscenes_other"], ["runner=default"], ["model=other"],
    ["+exp=224x400", "+exp=occ_bg"], ["+exp=unknown"],
    ["+exp-hd=256x704", "+exp=dual_branch_augloss_fusion"],
    ["--config-name", "test_config"]])
def test_compose_refuses_what_it_does_not_take(words):
    with pytest.raises(ValueError):
        compose(words)


def test_save_config_and_load_module(tmp_path):
    from dualdiff_tpu_torch.runner.trainer import MultiviewTrainer
    from dualdiff_tpu_torch.runner.video_trainer import VideoTrainer
    from dualdiff_tpu_torch.utils.common import load_module

    cfg, _ = compose(["+exp=video_16f"])
    save_config(cfg, str(tmp_path / "hydra" / "config.json"))
    assert json.load(open(tmp_path / "hydra" / "config.json")) == cfg
    assert load_module(str(cfg.model.runner_module)) is VideoTrainer
    assert load_module(str(load_config().model.runner_module)) \
        is MultiviewTrainer


# ------------------------------------------------------------------- data --

def _tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("video", [False, True])
def test_build_dataset_equals_the_jax_one(split, video):
    from dualdiff_tpu.data.wrappers import build_dataset as jax_build

    words = (["+exp=video_16f", "video.num_frames=2"] if video else []) + [
        "dataset=Nuscenes_synthetic", "dataset.image_size=[32,48]",
        "dataset.num_samples=5"]
    got = build_dataset(compose(words)[0], split)
    want = jax_build(jax_load_config(tp.CONFIG_DIR, overrides=words), split)
    assert len(got) == len(want) == (2 if video else 5)
    for i in range(len(got)):
        _tree_equal(got[i], want[i])


def test_build_dataset_refuses_the_nuscenes_reader():
    """The reader is ported (``tests/test_torch_nuscenes.py``): without its
    infos pkl on disk it refuses the split."""
    cfg, _ = compose(["dataset.dataset_type=NuScenesDataset"])
    with pytest.raises(FileNotFoundError, match="nuscenes_infos_train.pkl"):
        build_dataset(cfg, "train")


@pytest.mark.parametrize("ratio", [-1, 0, 0.5, 2])
def test_sample_tokens_by_scene_equals_the_jax_one(ratio):
    from dualdiff_tpu.data.scenes import sample_tokens_by_scene as jax_pick
    from dualdiff_tpu_torch.data.scenes import sample_tokens_by_scene
    from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes

    ds = ListSetWrapper(SyntheticNuScenes(num_samples=29), range(3, 27))
    assert sample_tokens_by_scene(ds, ratio, 7) == jax_pick(ds, ratio, 7)


def test_prefetch_map_keeps_order():
    import random
    import time

    def slow(i):
        time.sleep(random.random() * 0.01)
        return i * i

    for workers, depth in ((0, 2), (1, 1), (3, 2), (4, 8)):
        assert list(prefetch_map(slow, range(20), workers, depth)) == \
            [i * i for i in range(20)]


def test_folder_set_wrapper_reads_npz_and_pkl(tmp_path):
    np.savez(tmp_path / "b.npz", x=np.arange(3), y=np.ones((2, 2)))
    with open(tmp_path / "a.pkl", "wb") as f:
        pickle.dump({"token": "t"}, f)
    (tmp_path / "c.txt").write_text("not a sample")
    ds = FolderSetWrapper(str(tmp_path))
    assert len(ds) == 2 and ds[0] == {"token": "t"}
    np.testing.assert_array_equal(ds[1]["x"], np.arange(3))
    np.testing.assert_array_equal(ds[1]["y"], np.ones((2, 2)))


# -------------------------------------------------------------- image I/O --

def _image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 17.0 + c) * np.cos(yy / 11.0)
                    for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 20, (h, w, 3)), 0, 255) \
        .astype(np.uint8)


def test_write_png_reads_back_bit_equal(tmp_path):
    from PIL import Image

    img = _image(17, 23)
    image_io.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  img)
    np.testing.assert_array_equal(image_io.read_png(str(tmp_path / "a.png")),
                                  img)


@pytest.mark.parametrize("shape", [(66, 96), (17, 23), (224, 400)])
def test_write_jpeg_decodes_close_to_pils_encode(tmp_path, shape):
    import io

    from PIL import Image

    img = _image(*shape)
    path = str(tmp_path / "a.jpg")
    image_io.write_jpeg(path, img)
    assert image_io.jpeg_size(path) == shape
    ours = np.asarray(Image.open(path).convert("RGB")).astype(int)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    pil = np.asarray(Image.open(buf).convert("RGB")).astype(int)
    assert np.abs(ours - pil).mean() <= 1.0
    assert abs(np.abs(ours - img).mean() - np.abs(pil - img).mean()) <= 0.1


@pytest.mark.parametrize("src,size", [((32, 48), (64, 96)),
                                      ((100, 80), (37, 51)),
                                      ((224, 400), (896, 1600))])
def test_resize_bicubic_equals_pil(src, size):
    from PIL import Image

    img = (np.random.default_rng(1).random((*src, 3)) * 255).astype(np.uint8)
    want = Image.fromarray(img).resize(size[::-1], Image.BICUBIC)
    np.testing.assert_array_equal(image_io.resize_bicubic(img, size),
                                  np.asarray(want))


@pytest.mark.parametrize("src,back_resize,back_pad", [
    ((32, 48), (64, 96), (0, 2, 0, 0)),
    ((224, 400), (896, 1600), (0, 4, 0, 0))])
def test_postprocess_equals_the_jax_one(src, back_resize, back_pad):
    """The full-scale case is ``tests/test_val_set_gen.py``'s: 400x224 ->
    1600x896 and 4 black rows on top."""
    from tools.val_set_gen import postprocess as jax_postprocess
    from dualdiff_tpu_torch.tools.val_set_gen import postprocess

    img = np.random.default_rng(0).random((*src, 3)).astype(np.float32)
    got = postprocess(img, back_resize, back_pad)
    want = np.asarray(jax_postprocess(img, back_resize, back_pad))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------- visualise, validate --

def _sample_views(n=2):
    from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes

    ds = SyntheticNuScenes(num_samples=n, image_size=(224, 400))
    return [(ds[i], v) for i in range(n) for v in range(6)]


def test_box_segments_equal_the_jax_visualisers():
    """The JAX visualiser's ``cv2.line`` calls, recorded, are the port's
    segments; ``render_bev_map`` equals the JAX one."""
    import cv2

    from dualdiff_tpu.runner import visualize as jax_vis
    from dualdiff_tpu_torch.runner import visualize as vis

    img = np.zeros((224, 400, 3), np.uint8)
    for s, v in _sample_views():
        calls = []
        real = cv2.line
        cv2.line = lambda im, p0, p1, color, *a: calls.append(
            (tuple(p0), tuple(p1), tuple(color)))
        try:
            jax_vis.draw_boxes_on_view(img, s["gt_bboxes_3d"],
                                       s["gt_labels_3d"], s["lidar2image"][v],
                                       s["img_aug_matrix"][v])
        finally:
            cv2.line = real
        assert vis.box_segments(s["gt_bboxes_3d"], s["gt_labels_3d"],
                                s["lidar2image"][v],
                                s["img_aug_matrix"][v]) == calls
    masks = (np.random.default_rng(0).random((18, 20, 30)) > 0.8)
    np.testing.assert_array_equal(vis.render_bev_map(masks),
                                  jax_vis.render_bev_map(masks))


def test_drawn_pixels_lie_within_a_pixel_of_cv2s():
    from scipy.ndimage import binary_dilation

    from dualdiff_tpu.runner.visualize import draw_boxes_on_view as jax_draw
    from dualdiff_tpu_torch.runner.visualize import draw_boxes_on_view

    img = np.full((224, 400, 3), 60, np.uint8)
    near = np.ones((3, 3), bool)
    drawn = 0
    for s, v in _sample_views():
        args = (s["gt_bboxes_3d"], s["gt_labels_3d"], s["lidar2image"][v],
                s["img_aug_matrix"][v])
        ours = (draw_boxes_on_view(img, *args) != img).any(-1)
        cv = (jax_draw(img, *args) != img).any(-1)
        assert not (ours & ~binary_dilation(cv, near)).any()
        assert not (cv & ~binary_dilation(ours, near)).any()
        drawn += int(ours.sum())
    assert drawn > 1000


def test_concat_6_views_equals_the_jax_one():
    from dualdiff_tpu.runner.validator import concat_6_views as jax_concat
    from dualdiff_tpu_torch.runner.validator import concat_6_views

    views = np.random.default_rng(0).random((6, 4, 5, 3))
    for oneline in (False, True):
        np.testing.assert_array_equal(concat_6_views(views, oneline),
                                      jax_concat(views, oneline))


@pytest.mark.parametrize("show_box", [False, True])
def test_validate_grids_equal_direct_pipeline_calls(tmp_path, show_box):
    """Two items, two generations each (``validation_seed_global`` off:
    seed ``seed + 100 idx + t``): each grid, and each PNG the writer
    wrote, is that of a direct pipeline call with that seed, with the
    boxes drawn when ``validation_show_box``."""
    from dualdiff_tpu_torch.data.collate import collate_fn
    from dualdiff_tpu_torch.pipeline.bev_controlnet import \
        BEVControlNetPipeline
    from dualdiff_tpu_torch.runner.trainer import MultiviewTrainer
    from dualdiff_tpu_torch.runner.validator import RunWriter, Validator, \
        concat_6_views
    from dualdiff_tpu_torch.runner.visualize import draw_boxes_on_views

    cfg, _ = compose(["+exp=224x400"] + TINY + [
        "runner.validation_index=[0,1]", "runner.validation_times=2",
        f"runner.validation_show_box={str(show_box).lower()}",
        "dataset.num_samples=2"])
    train = build_dataset(cfg, "train")
    val = build_dataset(cfg, "val")
    trainer = MultiviewTrainer(cfg, train, device="cpu")
    writer = RunWriter(str(tmp_path))
    grids = Validator(cfg, val, trainer.tokenizer).validate(trainer, writer,
                                                           step=3)
    pipe = BEVControlNetPipeline(cfg, trainer.models, device="cpu")
    n = 0
    for idx in (0, 1):
        s = val[idx]
        batch = collate_fn([s], cfg, trainer.tokenizer, is_train=False,
                           rng=np.random.default_rng(int(cfg.seed)))
        for t in range(2):
            gen = torch.Generator().manual_seed(int(cfg.seed) + idx * 100 + t)
            views = (pipe(batch, generator=gen)[0].numpy() * 255) \
                .astype(np.uint8)
            if show_box:
                views = draw_boxes_on_views(views, s["gt_bboxes_3d"],
                                            s["gt_labels_3d"],
                                            s["lidar2image"],
                                            s["img_aug_matrix"])
            np.testing.assert_array_equal(
                grids[n], concat_6_views(views.astype(np.float32) / 255.0))
            png = image_io.read_png(str(tmp_path / "val" / "step-3"
                                        / f"{idx}_gen{t}.png"))
            np.testing.assert_array_equal(png, concat_6_views(views))
            n += 1
    assert n == len(grids) == 4
    assert (tmp_path / "val" / "step-3" / "1_gt.png").exists()


# ------------------------------------------------------------------ tools --

def _train(log_root, *extra):
    from dualdiff_tpu_torch.tools import train

    train.main(["+exp=224x400"] + TINY + [
        "dataset.num_samples=2", "try_run=true", "device=cpu",
        "runner.gradient_accumulation_steps=2", f"log_root={log_root}",
        *extra])


def test_train_then_test_tool(tmp_path):
    """``train`` with ``runner=debug try_run=true`` at k = 2 writes a
    checkpoint, ``hydra/overrides.json``, the export dirs, a validation
    grid and a ``metrics.jsonl`` line per step; ``test`` recomposes from
    the checkpoint's run (only the checkpoint and the output on its words)
    and writes the 2 x 3 grid of 32x48 views."""
    from dualdiff_tpu_torch.runner.weights import load_pretrained_dir
    from dualdiff_tpu_torch.tools import test as test_tool

    run = tmp_path / "run"
    _train(run)
    assert sorted(os.listdir(run)) == ["checkpoint-2", "controlnet", "hydra",
                                       "metrics.jsonl", "train.log", "unet",
                                       "val"]
    words = json.load(open(run / "hydra" / "overrides.json"))
    assert words[0] == "+exp=224x400" and f"log_root={run}" in words
    assert json.load(open(run / "hydra" / "config.json"))[
        "runner"]["gradient_accumulation_steps"] == 2
    lines = [json.loads(x) for x in open(run / "metrics.jsonl")]
    assert [x["step"] for x in lines] == [1, 2]
    assert all(np.isfinite(x["train/loss"]) for x in lines)
    grid = image_io.read_png(str(run / "val" / "step-2" / "0_gen0.png"))
    assert grid.shape == (64, 144, 3)
    state = torch.load(run / "checkpoint-2" / "trainer_state.pt",
                       weights_only=True)
    assert state["step"] == 2 and state["optimizer"]["count"] == 1
    cfg, _ = compose(words)
    from dualdiff_tpu_torch.runner.factory import build_models

    report = load_pretrained_dir(build_models(cfg, tiny=True, device="cpu"),
                                 str(run))
    assert report["unet"]["missing"] == []
    assert report["controlnet_0"]["missing"] == []

    out = tmp_path / "out"
    test_tool.main([f"resume_from_checkpoint={run}/checkpoint-2",
                    f"log_root={out}", "runner.validation_index=[0]"])
    gen = image_io.read_png(str(out / "test_out" / "0_gen.png"))
    ori = image_io.read_png(str(out / "test_out" / "0_ori.png"))
    assert gen.shape == ori.shape == (64, 144, 3)


def test_compose_from_checkpoint_reads_saved_overrides(tmp_path):
    from dualdiff_tpu_torch.tools.test import compose_from_checkpoint

    run = tmp_path / "run"
    (run / "hydra").mkdir(parents=True)
    (run / "checkpoint-5").mkdir()
    with open(run / "hydra" / "overrides.json", "w") as f:
        json.dump(["+exp=224x400", "dataset=Nuscenes_synthetic",
                   "dataset.image_size=[32,48]"], f)
    cfg = compose_from_checkpoint(
        [f"resume_from_checkpoint={run / 'checkpoint-5'}", "seed=7"])
    assert list(cfg.dataset.image_size) == [32, 48]
    assert int(cfg.seed) == 7 and cfg.task_id == "224x400"


def _val_set_gen(log_root, naming, *extra):
    from dualdiff_tpu_torch.tools import val_set_gen

    val_set_gen.main(["+exp=224x400"] + TINY + [
        "dataset.back_resize=[64,96]", "dataset.back_pad=[0,2,0,0]",
        "dataset.num_samples=3", "device=cpu", f"log_root={log_root}",
        f"gen_naming={naming}", *extra])
    return log_root / "val_set_gen" / "samples"


def test_val_set_gen_original_naming_and_resume(tmp_path):
    """``samples/CAM_X/<original basename>.jpg`` at back_resize + back_pad
    (96 x 66, the top two rows near black after JPEG), and a rerun skips
    every sample (no file rewritten)."""
    from PIL import Image

    root = _val_set_gen(tmp_path, "original")
    cfg, _ = compose(["dataset.image_size=[32,48]", "dataset.num_samples=3"])
    val = build_dataset(cfg, "val")
    cams = list(cfg.dataset.view_order)
    for v, cam in enumerate(cams):
        files = sorted(os.listdir(root / cam))
        assert files == sorted(os.path.basename(val[i]["filenames"][v])
                               for i in range(3))
        path = str(root / cam / files[0])
        assert image_io.jpeg_size(path) == (66, 96)
        arr = np.asarray(Image.open(path))
        assert arr.shape == (66, 96, 3) and float(arr[:2].mean()) < 25.0
    mtimes = {p: os.path.getmtime(p) for cam in cams
              for p in (root / cam).iterdir()}
    _val_set_gen(tmp_path, "original")
    assert {p: os.path.getmtime(p) for p in mtimes} == mtimes
    assert sum(len(os.listdir(root / cam)) for cam in cams) == 18


def test_val_set_gen_token_naming_shards_partition(tmp_path):
    """Shards 0 and 1 of 2 write disjoint token sets that together are the
    split's; names ``<token>_<cam>.png`` at 96 x 66."""
    cfg, _ = compose(["dataset.image_size=[32,48]", "dataset.num_samples=3"])
    val = build_dataset(cfg, "val")
    cams = list(cfg.dataset.view_order)
    seen = []
    for shard in (0, 1):
        root = _val_set_gen(tmp_path / str(shard), "token",
                            f"gen_shard={shard}", "gen_num_shards=2")
        for cam in cams:
            names = sorted(os.listdir(root / cam))
            assert all(n.endswith(f"_{cam}.png") for n in names)
        seen.append({n[:-len(f"_{cams[0]}.png")]
                     for n in os.listdir(root / cams[0])})
        png = image_io.read_png(str(root / cams[0] / sorted(
            os.listdir(root / cams[0]))[0]))
        assert png.shape == (66, 96, 3) and not png[:2].any()
    assert len(seen[0]) == 2 and len(seen[1]) == 1
    assert seen[0] | seen[1] == {val[i]["token"] for i in range(3)}


@pytest.mark.parametrize("tool", ["train", "test", "val_set_gen"])
def test_tools_run_on_the_card_unless_told_cpu(tmp_path, monkeypatch, tool):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"dualdiff_tpu_torch.tools.{tool}").main
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["+exp=224x400"] + TINY + [f"log_root={tmp_path}"])
