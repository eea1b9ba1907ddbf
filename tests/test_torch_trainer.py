"""The port's training loss, gradients and trainer against the JAX package.

The tiny flagship models of ``tiny_setup`` (same weights on both sides) at
256x128, whose 32x16 = 512-token top level reaches the port's training
``Function`` (``PackedAttention``: its plain versions on the CPU), with remat
on as in the flagship config.  One seeded training batch (FGM inputs
included) goes through ``jax.value_and_grad(make_loss_fn(...))``, computed
once for the module, and through the port's loss with the same draws: the
test splits the same ``jax.random`` key as the JAX loss does and hands the
port the VAE posterior noise, the training noise, the timesteps and the CFG
uncond switch (transposed to NCHW).

Tolerances (both sides float32; the order of sums differs through three
networks, remat and two attention implementations): loss, mse and aug_loss
within 1e-5 relative; every trainable gradient within 1e-4 of its tensor's
largest magnitude (7e-6 measured) plus 1e-5 of the network's largest
gradient.  The second term covers tensors whose exact gradient is zero,
where both sides hold rounding noise: a conv bias before a GroupNorm of one
channel per group (the tiny models' 32-channel level) cancels exactly.
"""

import math

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tests import torch_parity as tp
from dualdiff_tpu.data.collate import collate_fn
from dualdiff_tpu.data.synthetic import SyntheticNuScenes
from dualdiff_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from dualdiff_tpu.runner.train_state import partition_params as jax_partition
from dualdiff_tpu.runner.train_state import \
    trainable_predicate as jax_predicate
from dualdiff_tpu.runner.trainer import make_loss_fn as jax_make_loss_fn
from dualdiff_tpu.runner.trainer import prepare_batch as jax_prepare_batch
from dualdiff_tpu.runner.trainer import sample_uncond_switch
from dualdiff_tpu_torch.data.tokenizer import build_tokenizer
from dualdiff_tpu_torch.diffusion.schedule import DiffusionSchedule
from dualdiff_tpu_torch.ops import attention as A
from dualdiff_tpu_torch.runner.conds import prepare_batch
from dualdiff_tpu_torch.runner.factory import build_models
from dualdiff_tpu_torch.runner.train_state import (named_roots,
                                                   partition_params,
                                                   trainable_predicate)
from dualdiff_tpu_torch.runner.trainer import (MultiviewTrainer, make_loss_fn,
                                               set_category_tokens)
from dualdiff_tpu_torch.runner.weights import from_jax

KIND = {"unet": "unet", "controlnet_0": "controlnet",
        "controlnet_1": "controlnet", "vae": "vae", "text_encoder": "clip"}
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5
LOSS_RTOL = 1e-5


def _jax_draws(key, cfg, B, N, latent_hw):
    """The draws ``make_loss_fn``'s loss takes from ``key`` (its
    ``jax.random.split(rng, 5)``), in the port's NCHW layout."""
    h, w = latent_hw
    r_vae, r_noise, r_t, r_drop, _ = jax.random.split(key, 5)
    c = cfg.model.controlnet
    nchw = lambda x: tp.t(x).permute(*range(x.ndim - 3), -1, -3, -2)
    return {
        "vae_noise": nchw(jax.random.normal(r_vae, (B * N, h, w, 4))),
        "noise": nchw(jax.random.normal(r_noise, (B, N, h, w, 4))),
        "noise_offset": None,  # runner.noise_offset is 0
        "timesteps": tp.t(jax.random.randint(r_t, (B,), 0, 1000)),
        "uncond_switch": tp.t(sample_uncond_switch(
            r_drop, B, N, float(c.drop_cond_ratio), int(c.drop_cam_num))),
    }


@pytest.fixture(scope="module")
def step():
    tiny = tp.tiny_setup()
    jcfg, pcfg = tiny["jcfg"], tiny["pcfg"]
    h, w = jcfg.dataset.image_size
    latent_hw = (h // 8, w // 8)
    occ_hw = tuple(jcfg.model.get("ors_frame_hw", (896, 1600)))
    ds = SyntheticNuScenes(num_samples=2, image_size=(h, w), seed=0)
    batch = collate_fn([ds[0]], jcfg, tiny["tokenizer"], is_train=True,
                       rng=np.random.default_rng(0))
    assert "fgm" in batch
    key = jax.random.PRNGKey(2)

    trainable, frozen = jax_partition(tiny["params"],
                                      jax_predicate("only_new"))
    loss_fn = jax_make_loss_fn(tiny["jmodels"], jcfg, JSchedule.create(),
                               latent_hw, occ_hw)
    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(trainable, frozen, jax_prepare_batch(batch),
                                key)
    draws = _jax_draws(key, jcfg, 1, 6, latent_hw)

    models = build_models(pcfg, tiny=True, device="cpu")
    for root, module in named_roots(models):
        tp.load_port(module, tiny["params"][root], KIND[root])
    partition_params(models, trainable_predicate())
    calls = {fn.__name__: 0 for fn in A.KERNEL_WRAPPERS}
    with pytest.MonkeyPatch.context() as mp:
        for fn in A.KERNEL_WRAPPERS:  # count what the routing calls
            def counted(*a, _fn=fn, **kw):
                calls[_fn.__name__] += 1
                return _fn(*a, **kw)
            mp.setattr(A, fn.__name__, counted)
        loss, metrics = make_loss_fn(models, pcfg, DiffusionSchedule.create(),
                                     latent_hw, occ_hw)(
            prepare_batch(batch, "cpu"), draws)
        loss.backward()
    return {"jmetrics": jmetrics, "jgrads": jgrads, "metrics": metrics,
            "models": models, "calls": calls, "draws": draws,
            "latent_hw": latent_hw}


def test_loss_and_metrics_match_jax(step):
    for name in ("loss", "mse", "aug_loss"):
        np.testing.assert_allclose(float(step["metrics"][name]),
                                   float(step["jmetrics"][name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    assert float(step["metrics"]["aug_loss"]) > 0.0


@pytest.mark.parametrize("root", ["unet", "controlnet_0", "controlnet_1"])
def test_every_trainable_gradient_matches_jax(step, root):
    want = from_jax(tp.flat(step["jgrads"][root]), KIND[root])
    module = dict(named_roots(step["models"]))[root]
    got = {n: p.grad for n, p in module.named_parameters()
           if p.requires_grad}
    assert set(got) == set(want)
    assert all(g is not None for g in got.values())
    floor = GRAD_FLOOR * max(w.abs().max().item() for w in want.values())
    for name, g in got.items():
        w = want[name].float()
        tol = GRAD_RTOL * w.abs().max().item() + floor
        err = (g - w).abs().max().item()
        assert err <= tol, (name, err, tol)


def test_training_step_reaches_the_training_kernels(step):
    """The routing of one loss + backward matches the launch counts that
    ``chip_smoke.py`` derives from the code (tiny models: 1 layer per
    block, two ControlNets, remat on)."""
    assert step["calls"] == chip_smoke.train_launches_per_step(
        layers=1, n_controlnets=2, remat=True,
        levels=chip_smoke.model_levels(step["models"]["unet"],
                                       step["latent_hw"]))


def test_leaf_grad_errors_reads_each_leaf():
    """``chip_smoke.leaf_grad_errors``, the per-leaf gate of the card's
    training reference: a leaf read against its own norm plus a floor of
    ``LEAF_FLOOR`` times its network's largest; a leaf missing, or without
    a gradient, on one side reads inf.  float64 vectors of two elements:
    1e-12."""
    F = chip_smoke.LEAF_FLOOR
    vec = lambda *x: torch.tensor(x, dtype=torch.float64)
    want = {"unet/a": vec(3.0, 4.0), "unet/zero": vec(0.0, 0.0),
            "controlnet_0/b": vec(0.0, 2.0), "controlnet_0/none": None}
    got = dict(want)
    assert all(e == 0.0 for e in
               chip_smoke.leaf_grad_errors(want, got).values())
    got.update({"unet/a": vec(3.0, 2.0), "unet/zero": vec(0.0, 5.0 * F),
                "controlnet_0/b": None})
    del got["controlnet_0/none"]
    errs = chip_smoke.leaf_grad_errors(want, got)
    assert abs(errs["unet/a"] - 2.0 / (5.0 + 5.0 * F)) < 1e-12
    assert abs(errs["unet/zero"] - 1.0) < 1e-12  # 5F against the floor 5F
    assert errs["controlnet_0/b"] == math.inf
    assert errs["controlnet_0/none"] == math.inf


def test_trainer_two_steps_on_cpu():
    """``MultiviewTrainer(device="cpu")``: two steps at a constant LR move
    every trainable that got a gradient and leave every frozen parameter
    as it was."""
    cfg = tp.port_config(tp.TINY_OVERRIDES + ["runner.lr_scheduler=constant"])
    ds = SyntheticNuScenes(num_samples=2, image_size=(256, 128), seed=0)
    models = build_models(cfg, tiny=True, device="cpu")
    set_category_tokens(models, build_tokenizer(
        str(cfg.model.pretrained_model_name_or_path)),
        list(cfg.dataset.object_classes))
    trainer = MultiviewTrainer(cfg, ds, device="cpu", models=models)
    before = {k: p.detach().clone() for k, p in
              {**trainer.trainable, **trainer.frozen}.items()}
    seen = []
    last = trainer.run(2, lambda s, m: seen.append((s, m)))
    assert [s for s, _ in seen] == [1, 2] and trainer.step == 2
    for key in ("loss", "mse", "aug_loss", "grad_norm", "step_time_s"):
        assert np.isfinite(last[key]), key
    assert last["grad_norm"] > 0.0
    assert all(torch.equal(p, before[k]) for k, p in trainer.frozen.items())
    moved = [not torch.equal(p, before[k])
             for k, p in trainer.trainable.items()]
    assert sum(moved) > 0.9 * len(moved)
