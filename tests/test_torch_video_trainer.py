"""DualDiff+ video training stage 1 in the port against the JAX package.

The tiny video model sets of ``tiny_video_setup`` (same weights on both
sides; ST-Attn and temporal attention, 2 frames) on one 2-frame clip x 6
views at 256x128, remat on as in the ``video_16f`` config, ``only_new`` plus
both ControlNets trainable.  The clip's batch goes through
``jax.value_and_grad(make_loss_fn(..., frames=2))``, computed once for the
module, and through the port's loss with the same draws: the test splits
the same ``jax.random`` key as the JAX loss and hands the port the VAE
posterior noise, the training noise, the per-clip timestep repeated over
the frames (drawn with shape ``(B // frames,)``) and the CFG uncond switch.

Tolerances (both sides float32, the order of sums differs): loss, mse and
aug_loss within 1e-5 relative; every trainable gradient within 1e-4 of its
tensor's largest magnitude plus 1e-5 of the network's largest gradient, as
``test_torch_trainer.py`` (the floor covers tensors whose exact gradient is
zero).  The frame-axis recompute: value and gradients equal to the plain
einsum bit for bit (the same operations, replayed).
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tests import torch_parity as tp
from dualdiff_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from dualdiff_tpu.runner.train_state import partition_params as jax_partition
from dualdiff_tpu.runner.train_state import \
    trainable_predicate as jax_predicate
from dualdiff_tpu.runner.trainer import make_loss_fn as jax_make_loss_fn
from dualdiff_tpu.runner.trainer import prepare_batch as jax_prepare_batch
from dualdiff_tpu_torch.data.video import SyntheticNuScenesVideo
from dualdiff_tpu_torch.diffusion.schedule import DiffusionSchedule
from dualdiff_tpu_torch.ops import attention as A
from dualdiff_tpu_torch.runner.conds import prepare_batch
from dualdiff_tpu_torch.runner.factory import build_models
from dualdiff_tpu_torch.runner.train_state import (named_roots,
                                                   partition_params,
                                                   trainable_predicate)
from dualdiff_tpu_torch.runner.trainer import make_draws, make_loss_fn
from dualdiff_tpu_torch.runner.video_trainer import VideoTrainer
from dualdiff_tpu_torch.runner.weights import from_jax

KIND = {"unet": "unet", "controlnet_0": "controlnet",
        "controlnet_1": "controlnet", "vae": "vae", "text_encoder": "clip"}
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5
LOSS_RTOL = 1e-5
FRAMES, N_CAM = tp.FRAMES, 6


@pytest.fixture(scope="module")
def step():
    tiny = tp.tiny_video_setup()
    jcfg, pcfg = tiny["jcfg"], tiny["pcfg"]
    h, w = jcfg.dataset.image_size
    latent_hw = (h // 8, w // 8)
    occ_hw = tuple(jcfg.model.get("ors_frame_hw", (896, 1600)))
    batch = tiny["batch"]
    assert "fgm" in batch and batch["num_frames"] == FRAMES
    key = jax.random.PRNGKey(4)

    trainable, frozen = jax_partition(tiny["params"],
                                      jax_predicate("only_new"))
    loss_fn = jax_make_loss_fn(tiny["jmodels"], jcfg, JSchedule.create(),
                               latent_hw, occ_hw, frames=FRAMES)
    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(trainable, frozen, jax_prepare_batch(batch),
                                key)
    draws = tp.jax_draws(key, jcfg, FRAMES, latent_hw)

    models = build_models(pcfg, tiny=True, device="cpu")
    for root, module in named_roots(models):
        tp.load_port(module, tiny["params"][root], KIND[root])
    partition_params(models, trainable_predicate("only_new"))
    calls = {fn.__name__: 0 for fn in A.KERNEL_WRAPPERS}
    with pytest.MonkeyPatch.context() as mp:
        tp.count_calls(mp, calls)
        loss, metrics = make_loss_fn(models, pcfg, DiffusionSchedule.create(),
                                     latent_hw, occ_hw, frames=FRAMES)(
            prepare_batch(batch, "cpu"), draws)
        loss.backward()
    return {"jmetrics": jmetrics, "jgrads": jgrads, "metrics": metrics,
            "models": models, "calls": calls, "draws": draws}


def test_stage1_loss_matches_jax(step):
    for name in ("loss", "mse", "aug_loss"):
        np.testing.assert_allclose(float(step["metrics"][name]),
                                   float(step["jmetrics"][name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    assert "reward" not in step["metrics"]


@pytest.mark.parametrize("root", ["unet", "controlnet_0", "controlnet_1"])
def test_stage1_every_trainable_gradient_matches_jax(step, root):
    want = from_jax(tp.flat(step["jgrads"][root]), KIND[root])
    module = dict(named_roots(step["models"]))[root]
    got = {n: p.grad for n, p in module.named_parameters()
           if p.requires_grad}
    assert set(got) == set(want)
    assert all(g is not None for g in got.values())
    if root == "unet":  # the video modules train too
        assert any("attn_temporal" in n for n in got)
    floor = GRAD_FLOOR * max(w.abs().max().item() for w in want.values())
    for name, g in got.items():
        w = want[name].float()
        tol = GRAD_RTOL * w.abs().max().item() + floor
        err = (g - w).abs().max().item()
        assert err <= tol, (name, err, tol)


def test_stage1_kernel_calls_match_chip_smoke_derivation(step):
    """Tiny models: one layer per block, two ControlNets, remat on; the
    512-query ST-Attn (1024 keys) is under the cap at this size."""
    assert step["calls"] == chip_smoke.video_train_launches_per_step(
        layers=1, n_controlnets=2, remat=True, lora=False, tokens=512)


def test_stage1_over_the_cap_takes_the_capped_training_forward(step):
    """With the cap lowered (as the full-width 1400 x 2800 ST-Attn is over
    it) the differentiated ST-Attn takes ``packed_attention_capped_lse_fwd``
    and the frozen first one ``packed_attention_capped_fwd``, as derived;
    the loss and gradients are those of the whole-tile route (the two plain
    versions are one function)."""
    tiny = tp.tiny_video_setup()
    pcfg = tiny["pcfg"]
    h, w = pcfg.dataset.image_size
    models = build_models(pcfg, tiny=True, device="cpu")
    for root, module in named_roots(models):
        tp.load_port(module, tiny["params"][root], KIND[root])
    partition_params(models, trainable_predicate("only_new"))
    calls = {fn.__name__: 0 for fn in A.KERNEL_WRAPPERS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(A, "T_SCORE_CAP", 2 ** 18)
        tp.count_calls(mp, calls)
        loss, _ = make_loss_fn(models, pcfg, DiffusionSchedule.create(),
                               (h // 8, w // 8), (896, 1600), frames=FRAMES)(
            prepare_batch(tiny["batch"], "cpu"), step["draws"])
        loss.backward()
        assert calls == chip_smoke.video_train_launches_per_step(
            1, 2, True, False, 512)
    assert calls["packed_attention_capped_lse_fwd"] == 4
    assert calls["packed_attention_capped_fwd"] == 2
    assert loss.item() == pytest.approx(float(step["metrics"]["loss"]),
                                        rel=1e-6)
    want = dict(step["models"]["unet"].named_parameters())
    for name, p in models["unet"].named_parameters():
        if p.requires_grad:
            torch.testing.assert_close(p.grad, want[name].grad, rtol=1e-4,
                                       atol=1e-6)


def test_make_draws_repeats_one_timestep_per_clip():
    """``frames > 1``: (clips,) timesteps drawn and repeated frame by frame
    (``jnp.repeat``, not tile): clip c's frames hold t[c]."""
    cfg = tp.port_config(tp.TINY_VIDEO_OVERRIDES, video=True)
    d = make_draws(torch.Generator().manual_seed(5), cfg, 3 * FRAMES, N_CAM,
                   (32, 16), 1000, frames=FRAMES)
    t = d["timesteps"]
    assert t.shape == (3 * FRAMES,)
    assert torch.equal(t, t[::FRAMES].repeat_interleave(FRAMES))
    assert len(set(t[::FRAMES].tolist())) > 1


@pytest.mark.parametrize("f", [2, 16])
def test_frame_axis_recompute_equals_plain_einsum(f):
    """Under grad, frame-axis self-attention (lq == lk <= 32) runs inside
    ``torch.utils.checkpoint``: only q, k, v are saved and the einsum is
    replayed in the backward.  Value and gradients equal the plain
    einsum's exactly."""
    rng = np.random.default_rng(f)
    q, k, v, g = (tp.t(rng.normal(size=(300, f, 64)).astype(np.float32))
                  for _ in range(4))
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    out = A.attention_packed(*ins, heads=4)
    out.backward(g)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = A._einsum_packed(*ref, 16 ** -0.5, 4)
    want.backward(g)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    for a, b in zip(ins, ref):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)


def test_frame_axis_recompute_saves_no_probabilities():
    """The recompute saves q, k and v and no (B, H, f, f) probability
    tensor: the saved tensors of the graph hold nothing of that shape."""
    q, k, v = (torch.randn(50, 2, 32, requires_grad=True) for _ in range(3))
    shapes = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: shapes.append(tuple(t.shape)) or t, lambda t: t):
        A.attention_packed(q, k, v, heads=4).sum().backward()
    assert (50, 4, 2, 2) not in shapes
    plain = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: plain.append(tuple(t.shape)) or t, lambda t: t):
        A._einsum_packed(q, k, v, 8 ** -0.5, 4).sum().backward()
    assert (50, 4, 2, 2) in plain


def test_video_trainer_one_step_on_cpu():
    """``VideoTrainer(device="cpu")``: one step of stage 1 on 2-frame
    clips; finite metrics, the frozen parameters unchanged.  The first
    step's learning rate is 0, so a constant schedule is set to see the
    trainables move."""
    cfg = tp.port_config(tp.TINY_VIDEO_OVERRIDES
                         + ["runner.lr_scheduler=constant"], video=True)
    clips = SyntheticNuScenesVideo(num_clips=2, num_frames=FRAMES,
                                   image_size=(256, 128))
    models = build_models(cfg, tiny=True, device="cpu")
    trainer = VideoTrainer(cfg, clips, device="cpu", models=models)
    assert trainer.frames == FRAMES
    before = {k: p.detach().clone() for k, p in
              {**trainer.trainable, **trainer.frozen}.items()}
    last = trainer.run(max_steps=1)
    assert trainer.step == 1
    for key in ("loss", "mse", "aug_loss", "grad_norm", "step_time_s"):
        assert np.isfinite(last[key]), key
    assert "reward" not in last and last["grad_norm"] > 0.0
    assert all(torch.equal(p, before[k]) for k, p in trainer.frozen.items())
    assert sum(not torch.equal(p, before[k])
               for k, p in trainer.trainable.items()) > 0.5 * len(
                   trainer.trainable)
    with pytest.raises(ValueError, match="use_video"):
        VideoTrainer(tp.port_config(tp.TINY_OVERRIDES), clips, device="cpu",
                     models=models)
