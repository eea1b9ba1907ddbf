"""DualDiff+ video training stage 2 (RGD, LoRA) in the port against the JAX
package.

The tiny RGD model sets of ``tiny_video_setup("rgd")`` (same weights on both
sides; LoRA of rank 16 on every UNet attn1 / attn2, B drawn at a tenth of a
projection's scale so that every adapter carries signal) on one 2-frame
clip x 6 views at 256x128, remat on, only the LoRA leaves trainable.  The
clip's batch goes through ``jax.value_and_grad(make_loss_fn(..., frames=2,
reward_fn=make_rgd_reward(cfg), reward_weight=1))``, computed once for the
module, and through the port's loss with the same draws (as
``test_torch_video_trainer.py``): the reward decodes the denoised
prediction with the VAE under grad.

Tolerances (both sides float32, the order of sums differs): loss, mse,
aug_loss and reward within 1e-5 relative; every LoRA gradient within 1e-4
of its tensor's largest magnitude plus 1e-5 of the UNet's largest gradient,
as ``test_torch_trainer.py``.  The rewards alone, on shared random images:
1e-5 relative (float32 means over 10^5-10^6 pixels).  LoRA with B = 0:
equal to the plain attention bit for bit (the adapter adds an exact 0).
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tests import torch_parity as tp
from dualdiff_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from dualdiff_tpu.runner import rewards as JR
from dualdiff_tpu.runner.train_state import partition_params as jax_partition
from dualdiff_tpu.runner.train_state import \
    trainable_predicate as jax_predicate
from dualdiff_tpu.runner.trainer import make_loss_fn as jax_make_loss_fn
from dualdiff_tpu.runner.trainer import prepare_batch as jax_prepare_batch
from dualdiff_tpu_torch.diffusion.schedule import DiffusionSchedule
from dualdiff_tpu_torch.models.layers import Attention
from dualdiff_tpu_torch.ops import attention as A
from dualdiff_tpu_torch.runner import rewards as R
from dualdiff_tpu_torch.runner.conds import prepare_batch
from dualdiff_tpu_torch.runner.factory import build_models
from dualdiff_tpu_torch.runner.train_state import (named_roots,
                                                   partition_params,
                                                   trainable_predicate)
from dualdiff_tpu_torch.runner.trainer import make_loss_fn
from dualdiff_tpu_torch.runner.weights import _torch_name, from_jax

KIND = {"unet": "unet", "controlnet_0": "controlnet",
        "controlnet_1": "controlnet", "vae": "vae", "text_encoder": "clip"}
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5
LOSS_RTOL = 1e-5
FRAMES = tp.FRAMES


@pytest.fixture(scope="module")
def tiny():
    return tp.tiny_video_setup("rgd")


def _port_models(tiny):
    models = build_models(tiny["pcfg"], tiny=True, device="cpu")
    for root, module in named_roots(models):
        tp.load_port(module, tiny["params"][root], KIND[root])
    partition_params(models, trainable_predicate("lora_only"))
    return models


@pytest.fixture(scope="module")
def step(tiny):
    jcfg, pcfg = tiny["jcfg"], tiny["pcfg"]
    h, w = jcfg.dataset.image_size
    latent_hw = (h // 8, w // 8)
    occ_hw = tuple(jcfg.model.get("ors_frame_hw", (896, 1600)))
    key = jax.random.PRNGKey(6)

    trainable, frozen = jax_partition(tiny["params"],
                                      jax_predicate("lora_only"))
    loss_fn = jax_make_loss_fn(tiny["jmodels"], jcfg, JSchedule.create(),
                               latent_hw, occ_hw, frames=FRAMES,
                               reward_fn=JR.make_rgd_reward(jcfg),
                               reward_weight=1.0)
    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(trainable, frozen,
                                jax_prepare_batch(tiny["batch"]), key)
    draws = tp.jax_draws(key, jcfg, FRAMES, latent_hw)

    models = _port_models(tiny)
    calls = {fn.__name__: 0 for fn in A.KERNEL_WRAPPERS}
    with pytest.MonkeyPatch.context() as mp:
        tp.count_calls(mp, calls)
        loss, metrics = make_loss_fn(
            models, pcfg, DiffusionSchedule.create(), latent_hw, occ_hw,
            frames=FRAMES, reward_fn=R.make_rgd_reward(pcfg),
            reward_weight=1.0)(prepare_batch(tiny["batch"], "cpu"), draws)
        loss.backward()
    return {"jmetrics": jmetrics, "jgrads": jgrads, "metrics": metrics,
            "models": models, "calls": calls, "draws": draws,
            "jtrainable": trainable}


def test_stage2_loss_and_reward_match_jax(step):
    for name in ("loss", "mse", "aug_loss", "reward"):
        np.testing.assert_allclose(float(step["metrics"][name]),
                                   float(step["jmetrics"][name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    m = step["metrics"]
    assert float(m["reward"]) < 0.0
    assert float(m["loss"]) == pytest.approx(
        float(m["mse"] + m["aug_loss"] - m["reward"]), rel=1e-6)


def test_stage2_every_lora_gradient_matches_jax(step):
    want = from_jax(tp.flat(step["jgrads"]["unet"]), "unet")
    assert set(step["jgrads"]) == {"unet"}
    got = {n: p.grad for n, p in step["models"]["unet"].named_parameters()
           if p.requires_grad}
    assert set(got) == set(want) and len(got) == 16 * 10  # 4 A + 4 B x 2
    assert all("_lora_" in n and g is not None for n, g in got.items())
    floor = GRAD_FLOOR * max(w.abs().max().item() for w in want.values())
    for name, g in got.items():
        w = want[name].float()
        tol = GRAD_RTOL * w.abs().max().item() + floor
        err = (g - w).abs().max().item()
        assert err <= tol, (name, err, tol)


def test_stage2_kernel_calls_match_chip_smoke_derivation(step):
    """Every UNet attention is differentiated through LoRA; the frozen
    ControlNets take the inference kernel once each."""
    assert step["calls"] == chip_smoke.video_train_launches_per_step(
        layers=1, n_controlnets=2, remat=True, lora=True, tokens=512)
    assert step["calls"]["packed_attention_fwd"] == 4


def test_lora_only_partition_equals_jax(tiny, step):
    """Leaf for leaf the JAX predicate's trainable set, names mapped by
    ``from_jax``'s naming (``to_out.0_lora_*`` -> ``to_out_0_lora_*``)."""
    want = {f"{root}/{_torch_name(tuple(rest), KIND[root])}"
            for root, *rest in (k.split("/")
                                for k in tp.flat(step["jtrainable"]))}
    trainable, frozen = partition_params(_port_models(tiny),
                                         trainable_predicate("lora_only"))
    assert set(trainable) == want
    assert any(k.endswith("to_out_0_lora_b.weight") for k in trainable)
    assert not any(k.startswith("controlnet") for k in trainable)
    assert all(not p.requires_grad for p in frozen.values())


def _images(seed, n=2 * 6, hw=(256, 128)):
    """(NHWC numpy for the JAX rewards, NCHW torch for the port's)."""
    x = np.random.default_rng(seed).uniform(-1, 1, (n, *hw, 3))
    x = x.astype(np.float32)
    return x, tp.nhwc_to_nchw(x)


@pytest.mark.parametrize("name", ["mse_proxy", "fgm_foreground", "temporal",
                                  "make_rgd_reward"])
def test_rewards_match_jax(tiny, name):
    (jp, pp), (jg, pg) = _images(1), _images(2)
    jbatch = jax_prepare_batch(tiny["batch"])
    pbatch = prepare_batch(tiny["batch"], "cpu")
    want, got = {
        "mse_proxy": lambda: (JR.mse_proxy_reward(jp, jg, jbatch),
                              R.mse_proxy_reward(pp, pg, pbatch)),
        "fgm_foreground": lambda: (
            JR.fgm_foreground_reward(jp, jg, jbatch, fg_boost=4.0),
            R.fgm_foreground_reward(pp, pg, pbatch, fg_boost=4.0)),
        "temporal": lambda: (
            JR.temporal_consistency_reward(jp, jg, FRAMES, 6),
            R.temporal_consistency_reward(pp, pg, FRAMES, 6)),
        "make_rgd_reward": lambda: (
            JR.make_rgd_reward(tiny["jcfg"])(jp, jg, jbatch),
            R.make_rgd_reward(tiny["pcfg"])(pp, pg, pbatch)),
    }[name]()
    assert got.shape == (12,)
    tp.assert_close(got, want, rtol=1e-5, atol=0, what=name)
    if name == "fgm_foreground":  # the boxes weight the error
        plain = R.mse_proxy_reward(pp, pg, pbatch)
        assert not torch.allclose(got, plain, rtol=1e-3)


def test_reward_frames_prefix(tiny, step):
    """``video.rgd.reward_frames=1``: the reward sees the first frame of the
    clip only (its 6 decoded images, its ground truth and its FGM rows), and
    ``make_rgd_reward`` folds the temporal term over 1 frame, i.e. drops
    it; the reward then equals the JAX reward on the same prefix."""
    pcfg = tp.port_config(tp.TINY_VIDEO_OVERRIDES
                          + ["video.rgd.reward_frames=1"], video="rgd")
    jcfg = tp.jax_config(tp.TINY_VIDEO_OVERRIDES
                         + ["video.rgd.reward_frames=1"], video="rgd")
    h, w = pcfg.dataset.image_size
    batch = prepare_batch(tiny["batch"], "cpu")
    seen = {}

    def reward_fn(images, gt, rbatch):
        seen.update(images=images, gt=gt, batch=rbatch)
        return R.make_rgd_reward(pcfg)(images, gt, rbatch)

    with torch.no_grad():
        _, metrics = make_loss_fn(
            step["models"], pcfg, DiffusionSchedule.create(), (h // 8, w // 8),
            (896, 1600), frames=FRAMES, reward_fn=reward_fn,
            reward_weight=1.0, reward_frames=1)(batch, step["draws"])
    assert seen["images"].shape == (6, 3, h, w)
    px = batch["pixel_values"]  # (frames, 6, H, W, 3)
    assert torch.equal(seen["gt"], px[0].permute(0, 3, 1, 2))
    for key in ("fgm_bboxes", "fgm_masks", "fgm_lidar2image"):
        assert torch.equal(seen["batch"][key], batch[key][:1])
    fg = R.fgm_foreground_reward(seen["images"], seen["gt"], seen["batch"])
    assert float(metrics["reward"]) == pytest.approx(float(fg.mean()),
                                                     rel=1e-6)
    jbatch = {k: v[:1] if k.startswith("fgm_") else v
              for k, v in jax_prepare_batch(tiny["batch"]).items()}
    want = JR.make_rgd_reward(jcfg)(
        seen["images"].permute(0, 2, 3, 1).numpy(),
        seen["gt"].permute(0, 2, 3, 1).numpy(), jbatch)
    assert float(metrics["reward"]) == pytest.approx(float(want.mean()),
                                                     rel=1e-5)


@pytest.mark.parametrize("kv_dim", [None, 96])
def test_lora_with_zero_b_equals_plain_attention(kv_dim):
    """A fresh adapter (B = 0, A at PyTorch's default init) leaves the
    attention exactly as it is without one; the adapters are bias-free.
    Self-attention of 600 tokens takes the kernel route, cross-attention
    (20 context tokens) einsum."""
    torch.manual_seed(0)
    plain = Attention(32, heads=4, kv_dim=kv_dim)
    lora = Attention(32, heads=4, kv_dim=kv_dim, lora_rank=16)
    missing, unexpected = lora.load_state_dict(plain.state_dict(),
                                               strict=False)
    assert not unexpected and len(missing) == 8
    assert all(n.endswith("_lora_a.weight") or n.endswith("_lora_b.weight")
               for n in missing)
    assert all(not bool(getattr(lora, f"{p}_lora_b").weight.any())
               and bool(getattr(lora, f"{p}_lora_a").weight.any())
               and getattr(lora, f"{p}_lora_a").bias is None
               for p in ("to_q", "to_k", "to_v", "to_out_0"))
    x = torch.randn(2, 600, 32)
    ctx = None if kv_dim is None else torch.randn(2, 20, kv_dim)
    with torch.no_grad():
        torch.testing.assert_close(lora(x, ctx), plain(x, ctx), rtol=0,
                                   atol=0)
