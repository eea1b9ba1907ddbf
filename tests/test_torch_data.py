"""The port's copies of the JAX package's numpy-only modules, and its JSON
config, against the originals."""

import json

import numpy as np

from tests import torch_parity as tp
from dualdiff_tpu.data.collate import collate_fn as jax_collate
from dualdiff_tpu.data.synthetic import SyntheticNuScenes as JaxSynthetic
from dualdiff_tpu.data.tokenizer import HashTokenizer as JaxTok
from dualdiff_tpu.utils.config import to_dict
from dualdiff_tpu_torch.data.collate import collate_fn
from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes
from dualdiff_tpu_torch.data.tokenizer import HashTokenizer
from dualdiff_tpu_torch.data.video import (SyntheticNuScenesVideo,
                                           collate_video)
from dualdiff_tpu_torch.utils.config import (FUSIONP, RGD_STAGE2, VIDEO_16F,
                                             load_config)


def test_json_config_equals_composed_yaml():
    """dualdiff_tpu_torch/configs/<flagship>.json is the JAX loader's
    composition of the flagship overrides, as JSON."""
    want = json.loads(json.dumps(to_dict(tp.jax_config())))
    assert dict(load_config()) == want


def test_video_json_config_equals_composed_yaml():
    """configs/video_16f_224x400.json is the JAX loader's composition of
    ``bench.py::main_video``'s overrides (``tests/torch_parity.VIDEO``)."""
    want = json.loads(json.dumps(to_dict(tp.jax_config(video=True))))
    cfg = load_config(VIDEO_16F)
    assert dict(cfg) == want
    assert cfg.use_video and cfg.video.num_frames == 16
    assert cfg.runner.pipeline_param.sequential_cfg
    assert cfg.runner.pipeline_param.vae_slicing == 12


def test_rgd_json_config_equals_composed_yaml():
    """configs/rgd_stage2_224x400.json is the JAX loader's composition of
    ``+exp=rgd_stage2`` with the clip operating point's other overrides
    (``tests/torch_parity.RGD``); it differs from the stage-1 config only in
    the task, the trainable state and RGD."""
    want = json.loads(json.dumps(to_dict(tp.jax_config(video="rgd"))))
    cfg = load_config(RGD_STAGE2)
    assert dict(cfg) == want
    assert cfg.video.rgd.enable and cfg.video.lora_rank == 16
    assert cfg.model.unet.trainable_state == "lora_only"
    stage1 = load_config(VIDEO_16F)
    stage1["task_id"] = "rgd_stage2"
    stage1.video.rgd["enable"] = True
    stage1.model.unet["trainable_state"] = "lora_only"
    assert stage1 == cfg


def test_fusionp_json_config_equals_composed_yaml():
    """configs/occ_bg_fusionp_224x400.json is the JAX loader's composition
    of ``+exp=occ_bg_fusionp`` with the flagship's other overrides
    (``tests/torch_parity.FUSIONP``): one ControlNet on the occupancy image
    with per-view boxes, SFA+ in place of SFA, no aug loss, batch 1."""
    want = json.loads(json.dumps(to_dict(tp.jax_config(fusionp=True))))
    cfg = load_config(FUSIONP)
    assert dict(cfg) == want
    assert cfg.task_id == "occ_bg_fusionp"
    c = cfg.model.controlnet
    assert c.use_txt_con_fusionp and not c.use_txt_con_fusion
    assert not cfg.use_dual_controlnet and not cfg.use_aug_loss
    assert cfg.runner.train_batch_size == 1
    assert cfg.runner.bbox_add_ratio == 0.0
    assert cfg.dataset.image_size == [224, 400]


def test_sd15_key_lists_equal_the_originals():
    """dualdiff_tpu_torch/runner/sd15_keys.py is a copy of the JAX
    package's: the same keys and shapes for every variant."""
    from dualdiff_tpu.runner import sd15_keys as jax_keys
    from dualdiff_tpu_torch.runner import sd15_keys as port_keys

    for fn, flags in (("sd15_unet_keys", [{}]),
                      ("sd15_vae_keys", [{"legacy_attn": False},
                                         {"legacy_attn": True}]),
                      ("sd15_clip_keys", [{"with_position_ids": False},
                                          {"with_position_ids": True}])):
        for kw in flags:
            want = getattr(jax_keys, fn)(**kw)
            assert getattr(port_keys, fn)(**kw) == want, (fn, kw)
    assert len(port_keys.sd15_unet_keys()) == 686
    assert len(port_keys.sd15_vae_keys()) == 248
    assert len(port_keys.sd15_clip_keys()) == 196


def test_config_overrides():
    cfg = load_config(overrides=["runner.mixed_precision=fp32",
                                 "dataset.image_size=[256, 128]"])
    assert cfg.runner.mixed_precision == "fp32"
    assert cfg.dataset.image_size == [256, 128]
    assert cfg.runner.pipeline_param.bbox_max_length == 80


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif hasattr(a, "__dataclass_fields__"):
        assert vars(a) == vars(b), path
    else:
        assert a == b, path


def test_synthetic_samples_and_collate_equal():
    cfg = tp.jax_config()
    h, w = cfg.dataset.image_size
    jds = JaxSynthetic(num_samples=2, image_size=(h, w), seed=int(cfg.seed))
    pds = SyntheticNuScenes(num_samples=2, image_size=(h, w),
                            seed=int(cfg.seed))
    for i in range(2):
        _assert_tree_equal(pds[i], jds[i], f"sample {i}")
    want = jax_collate([jds[0], jds[1]], cfg, JaxTok(), is_train=False,
                       rng=np.random.default_rng(0))
    got = collate_fn([pds[0], pds[1]], load_config(), HashTokenizer(),
                     is_train=False, rng=np.random.default_rng(0))
    _assert_tree_equal(got, want)


def test_synthetic_clips_and_collate_video_equal():
    """Two clips of three frames: the same frames, frame-outer flattening
    and ``num_frames`` / ``clip_batch`` keys as the JAX package's copies."""
    from dualdiff_tpu.data.video import SyntheticNuScenesVideo as JaxVideo
    from dualdiff_tpu.data.video import collate_video as jax_collate_video

    cfg = tp.jax_config(["dataset.image_size=[256, 128]"], video=True)
    jds = JaxVideo(num_clips=2, num_frames=3, image_size=(256, 128))
    pds = SyntheticNuScenesVideo(num_clips=2, num_frames=3,
                                 image_size=(256, 128))
    assert len(pds) == len(jds) == 2
    clips = [pds[0], pds[1]]
    for i in range(2):
        _assert_tree_equal(clips[i], jds[i], f"clip {i}")
    want = jax_collate_video([jds[0], jds[1]], cfg, JaxTok(),
                             rng=np.random.default_rng(0))
    got = collate_video(clips, load_config(VIDEO_16F, [
        "dataset.image_size=[256, 128]"]), HashTokenizer(),
                        rng=np.random.default_rng(0))
    assert got["num_frames"] == 3 and got["clip_batch"] == 2
    assert got["pixel_values"].shape[0] == 6
    _assert_tree_equal(got, want)


def test_augment_equals_the_original():
    """dualdiff_tpu_torch/data/augment.py is a copy of the JAX package's:
    the same flip of a synthetic sample (views reordered, images, boxes,
    cameras and BEV masks mirrored) and the same range filter."""
    from dualdiff_tpu.data import augment as jax_augment
    from dualdiff_tpu_torch.data import augment

    sample = SyntheticNuScenes(num_samples=1, image_size=(256, 128))[0]
    for ratio, seed in ((1.0, 0), (0.5, 3), (0.0, 0)):
        want = jax_augment.random_flip_3d_with_views(
            sample, np.random.default_rng(seed), ratio)
        got = augment.random_flip_3d_with_views(
            sample, np.random.default_rng(seed), ratio)
        assert (got is sample) == (want is sample)
        _assert_tree_equal(got, want)
    assert augment.random_flip_3d_with_views(
        sample, np.random.default_rng(0), 1.0) is not sample
    pcr = [-20.0, -20.0, -5.0, 20.0, 20.0, 3.0]
    boxes = np.asarray(sample["gt_bboxes_3d"], np.float32)
    for a, b in zip(augment.object_range_filter(boxes,
                                                sample["gt_labels_3d"], pcr),
                    jax_augment.object_range_filter(
                        boxes, sample["gt_labels_3d"], pcr)):
        np.testing.assert_array_equal(a, b)
