"""The port's conditioning cache and flip augmentation against the JAX
package's.

The tiny flagship models of ``tiny_setup`` (same weights on both sides,
float32) at 256x128.  One seeded training batch (one sample, FGM inputs
included) goes through the JAX package's ``make_precompute_cond`` and its
``make_loss_fn(cached_cond=True)`` in one jitted function, and through the
port's precompute and cached loss with the draws the JAX loss takes from
the same key (``tp.jax_draws``).

Tolerances: the moments within 1e-5 of their largest magnitude and the ray
labels bit-equal; the port's cached loss within ``LOSS_RTOL`` (1e-5
relative, ``test_torch_trainer.py``'s) of JAX's.  The port's cached and
uncached losses with the same draws are bit-equal, gradients too: the
posterior sample is the same function of the same moments
(``AutoencoderKL.sample``).

The trainer's cache (keys, hits, the cap, what a cached batch keeps) and
``_augment_items`` are held to the JAX trainer's behaviour at
``flip_ratio=0.5``, as ``tests/test_train_pipeline.py`` and
``tests/test_video.py`` hold the JAX package's.
"""

import types

import jax
import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.data.collate import collate_fn as jax_collate
from dualdiff_tpu.data.synthetic import SyntheticNuScenes as JaxSynthetic
from dualdiff_tpu.data.video import SyntheticNuScenesVideo as JaxVideo
from dualdiff_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from dualdiff_tpu.runner.train_state import partition_params as jax_partition
from dualdiff_tpu.runner.train_state import \
    trainable_predicate as jax_predicate
from dualdiff_tpu.runner.trainer import MultiviewTrainer as JaxTrainer
from dualdiff_tpu.runner.trainer import make_loss_fn as jax_make_loss_fn
from dualdiff_tpu.runner.trainer import \
    make_precompute_cond as jax_make_precompute
from dualdiff_tpu.runner.trainer import prepare_batch as jax_prepare_batch
from dualdiff_tpu.runner.video_trainer import VideoTrainer as JaxVideoTrainer
from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes
from dualdiff_tpu_torch.data.video import SyntheticNuScenesVideo
from dualdiff_tpu_torch.diffusion.schedule import DiffusionSchedule
from dualdiff_tpu_torch.runner.conds import prepare_batch
from dualdiff_tpu_torch.runner.factory import build_models
from dualdiff_tpu_torch.runner.train_state import (named_roots,
                                                   partition_params,
                                                   trainable_predicate)
from dualdiff_tpu_torch.runner.trainer import (MultiviewTrainer,
                                               make_loss_fn,
                                               make_precompute_cond)
from dualdiff_tpu_torch.runner.video_trainer import VideoTrainer

KIND = {"unet": "unet", "controlnet_0": "controlnet",
        "controlnet_1": "controlnet", "vae": "vae", "text_encoder": "clip"}
LOSS_RTOL = 1e-5
RAW = ("pixel_values", "occ_labels", "occ_cam_K", "occ_cam_T")
FLIP = ["dataset.augment3d.flip_ratio=0.5"]


def _cached(batch, pre):
    """A batch with its raw conditioning inputs swapped for ``pre``."""
    out = {k: v for k, v in batch.items() if k not in RAW}
    out.update(pre)
    return out


@pytest.fixture(scope="module")
def case():
    tiny = tp.tiny_setup()
    jcfg, pcfg = tiny["jcfg"], tiny["pcfg"]
    h, w = jcfg.dataset.image_size
    latent_hw = (h // 8, w // 8)
    occ_hw = tuple(jcfg.model.get("ors_frame_hw", (896, 1600)))
    ds = JaxSynthetic(num_samples=2, image_size=(h, w), seed=0)
    batch = jax_collate([ds[0]], jcfg, tiny["tokenizer"], is_train=True,
                        rng=np.random.default_rng(0))
    key = jax.random.PRNGKey(2)

    trainable, frozen = jax_partition(tiny["params"],
                                      jax_predicate("only_new"))
    jpre = jax_make_precompute(tiny["jmodels"], latent_hw, occ_hw)
    jloss = jax_make_loss_fn(tiny["jmodels"], jcfg, JSchedule.create(),
                             latent_hw, occ_hw, cached_cond=True)

    def precompute_and_loss(trainable, frozen, batch, key):
        pre = jpre(frozen, batch)
        return pre, jloss(trainable, frozen, _cached(batch, pre), key)[1]

    jpre_out, jmetrics = jax.jit(precompute_and_loss)(
        trainable, frozen, jax_prepare_batch(batch), key)

    models = build_models(pcfg, tiny=True, device="cpu")
    for root, module in named_roots(models):
        tp.load_port(module, tiny["params"][root], KIND[root])
    partition_params(models, trainable_predicate())
    pbatch = prepare_batch(batch, "cpu")
    pre = make_precompute_cond(models, latent_hw, occ_hw)(pbatch)
    schedule = DiffusionSchedule.create()
    draws = tp.jax_draws(key, jcfg, 1, latent_hw, frames=1)
    runs = {}
    for cached in (False, True):
        for p in models["unet"].parameters():
            p.grad = None
        for cn in models["controlnets"]:
            for p in cn.parameters():
                p.grad = None
        loss, metrics = make_loss_fn(models, pcfg, schedule, latent_hw,
                                     occ_hw, cached_cond=cached)(
            _cached(pbatch, pre) if cached else pbatch, draws)
        loss.backward()
        grads = {f"{root}/{n}": p.grad.clone()
                 for root, module in named_roots(models)
                 for n, p in module.named_parameters()
                 if p.requires_grad and p.grad is not None}
        runs[cached] = (metrics, grads)
    return {"jpre": jpre_out, "jmetrics": jmetrics, "pre": pre,
            "runs": runs}


def test_precompute_matches_jax(case):
    """Moments (the port's NCHW against JAX's NHWC) within 1e-5 of their
    largest magnitude; int8 ray labels bit-equal."""
    want = np.asarray(case["jpre"]["latent_moments"])
    got = case["pre"]["latent_moments"].permute(0, 1, 3, 4, 2).numpy()
    assert got.shape == want.shape == (1, 6, 32, 16, 8)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    rays = case["pre"]["ors_rays"]
    assert rays.dtype == torch.int8
    np.testing.assert_array_equal(rays.numpy(),
                                  np.asarray(case["jpre"]["ors_rays"]))


def test_cached_loss_equals_uncached_loss(case):
    """Same draws, float32: the cached loss and its metrics are the
    uncached ones bit for bit, and so is every trainable gradient."""
    (m_off, g_off), (m_on, g_on) = case["runs"][False], case["runs"][True]
    for name in ("loss", "mse", "aug_loss"):
        assert torch.equal(m_on[name], m_off[name]), name
    assert set(g_on) == set(g_off) and len(g_on) > 100
    differ = [k for k in g_on if not torch.equal(g_on[k], g_off[k])]
    assert not differ, differ[:5]


def test_cached_loss_matches_jax(case):
    metrics = case["runs"][True][0]
    for name in ("loss", "mse", "aug_loss"):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(case["jmetrics"][name]),
                                   rtol=LOSS_RTOL, err_msg=name)


def _trainer(video=False, extra=()):
    """A tiny port trainer on the CPU, cache on, flip 0.5, batches of 2
    samples (1 clip of 2 frames for clips) over 4 samples (2 clips)."""
    if video:
        cfg = tp.port_config(tp.TINY_VIDEO_OVERRIDES + FLIP + [
            "runner.cache_conditioning=true"] + list(extra), video=video)
        data = SyntheticNuScenesVideo(num_clips=2, num_frames=2,
                                      image_size=(256, 128))
        return VideoTrainer(cfg, data, device="cpu", models=build_models(
            cfg, tiny=True, device="cpu"))
    cfg = tp.port_config(tp.TINY_OVERRIDES + FLIP + [
        "runner.cache_conditioning=true", "runner.train_batch_size=2"]
        + list(extra))
    data = SyntheticNuScenes(num_samples=4, image_size=(256, 128), seed=0)
    return MultiviewTrainer(cfg, data, device="cpu", models=build_models(
        cfg, tiny=True, device="cpu"))


def _count_precompute(trainer):
    calls = {"n": 0}
    real = trainer._precompute

    def counting(batch):
        calls["n"] += 1
        return real(batch)

    trainer._precompute = counting
    return calls


def _epoch(trainer, epoch):
    return [trainer._build_batch(p) for p in trainer._batch_plan(epoch)]


@pytest.mark.parametrize("kind", ["image", "video", "rgd"])
def test_epoch_repeat_is_served_from_the_cache(kind):
    """The JAX package's epoch-repeat hit test: a second pass over the same
    plan (so the same flips) runs no precompute and serves the same entries
    bit for bit; int8 rays, no occupancy, and no pixels unless the RGD
    reward reads them.  Clips key each frame."""
    trainer = _trainer(video={"image": False, "video": True,
                              "rgd": "rgd"}[kind])
    calls = _count_precompute(trainer)
    first = _epoch(trainer, 7)
    n_first = calls["n"]
    assert n_first == len(first) > 0
    second = _epoch(trainer, 7)
    assert calls["n"] == n_first
    rows = 2  # two samples, or one clip of two frames
    assert len(trainer._cond_cache) == rows * len(first)
    if kind != "image":
        assert all(len(k) == 3 for k in trainer._cond_cache)
    for b1, b2 in zip(first, second):
        assert b1["latent_moments"].shape[0] == rows
        assert torch.equal(b1["latent_moments"], b2["latent_moments"])
        assert torch.equal(b1["ors_rays"], b2["ors_rays"])
        assert b1["ors_rays"].dtype == torch.int8
        assert not any(k in b1 for k in RAW[1:])
        assert ("pixel_values" in b1) == (kind == "rgd")


def test_cache_stops_filling_at_its_cap():
    """``runner.cond_cache_max_mb=0``: the first batch's entries go in and
    fill the cache; later batches recompute every epoch, the first is
    served."""
    trainer = _trainer(extra=["runner.cond_cache_max_mb=0"])
    calls = _count_precompute(trainer)
    plans = list(trainer._batch_plan(0))
    assert len(plans) == 2
    for _ in range(2):
        for plan in plans:
            trainer._build_batch(plan)
    assert trainer._cond_cache_full and len(trainer._cond_cache) == 2
    assert calls["n"] == 3  # first batch once, second batch twice


def _equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("video", [False, True])
def test_augment_items_match_jax(video):
    """Images and clips on one numpy generator each: the same flags and
    the same arrays as the JAX trainers' ``_augment_items``; a clip's
    frames all share its flip."""
    extra = tp.TINY_VIDEO_OVERRIDES + FLIP
    if video:
        jax_cls, port = JaxVideoTrainer, _trainer(video=True)
        clips = JaxVideo(num_clips=4, num_frames=2, image_size=(256, 128))
        items = [clips[i] for i in range(len(clips))]
        jcfg = tp.jax_config(extra, video=True)
        jself = types.SimpleNamespace(cfg=jcfg)
    else:
        jax_cls, port = JaxTrainer, _trainer()
        samples = SyntheticNuScenes(num_samples=8, image_size=(256, 128))
        items = [samples[i] for i in range(len(samples))]
        jself = types.SimpleNamespace(cfg=tp.jax_config(tp.TINY_OVERRIDES
                                                        + FLIP))
    want, wflags = jax_cls._augment_items(jself, items,
                                          np.random.default_rng(3))
    got, flags = port._augment_items(items, np.random.default_rng(3))
    assert flags == wflags and 0 < sum(flags) < len(flags)
    _equal(got, want)
    if video:
        for clip, src, fl in zip(got, items, flags):
            assert all((fr is not s) == fl for fr, s in zip(clip, src))
