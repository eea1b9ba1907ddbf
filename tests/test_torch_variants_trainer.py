"""The variants' training loss and gradients against the JAX package, and
the fresh trainer's box-adapter init.

The combined tiny set: ``+exp=occ_bg`` with the box adapter, the camera
token in the time embedding and tone guidance all on
(``tests/torch_parity.VARIANTS_TRAIN``), same weights on both sides, at
256x128 (the 512-token top level reaches the training ``Function``), remat
on.  One seeded training batch goes through one jitted
``jax.value_and_grad(make_loss_fn(...))`` and through the port's loss with
the JAX draws (``tp.jax_draws``) of a key whose CFG switch drops the
sample, so the uncond camera enters the context while the time embedding
takes the conditional camera token.

Tolerances as ``test_torch_trainer.py`` (float32 on both sides): loss, mse
and tone within 1e-5 relative; every trainable gradient within 1e-4 of its
tensor's largest magnitude plus 1e-5 of the network's largest gradient
(measured 2.6e-6 and 2.3e-6 of that limit's first term in the UNet and
the ControlNet).
"""

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
from dualdiff_tpu_torch.data.synthetic import \
    SyntheticNuScenes as PortSynthetic
from dualdiff_tpu_torch.diffusion.schedule import DiffusionSchedule
from dualdiff_tpu_torch.models.layers import Attention
from dualdiff_tpu_torch.ops import attention as A
from dualdiff_tpu_torch.runner import trainer as PT
from dualdiff_tpu_torch.runner.conds import prepare_batch
from dualdiff_tpu_torch.runner.factory import build_models
from dualdiff_tpu_torch.runner.train_state import (named_roots,
                                                   partition_params,
                                                   trainable_predicate)
from dualdiff_tpu_torch.runner.trainer import make_loss_fn
from dualdiff_tpu_torch.runner.weights import from_jax

KIND = {"unet": "unet", "controlnet_0": "controlnet"}
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5
LOSS_RTOL = 1e-5
# a key whose uncond switch (drop_cond_ratio 0.25) drops the sample
KEY = 6
ADAPTER = ("to_k_box", "to_v_box", "to_k_cls", "to_v_cls")


@pytest.fixture(scope="module")
def step():
    tiny = tp.tiny_setup(exp="+exp=occ_bg", extra=tp.VARIANTS_TRAIN)
    jcfg, pcfg = tiny["jcfg"], tiny["pcfg"]
    h, w = jcfg.dataset.image_size
    latent_hw = (h // 8, w // 8)
    occ_hw = tuple(jcfg.model.get("ors_frame_hw", (896, 1600)))
    ds = SyntheticNuScenes(num_samples=2, image_size=(h, w), seed=0)
    batch = collate_fn([ds[0]], jcfg, tiny["tokenizer"], is_train=True,
                       rng=np.random.default_rng(0))
    key = jax.random.PRNGKey(KEY)
    trainable, frozen = jax_partition(tiny["params"],
                                      jax_predicate("only_new"))
    loss_fn = jax_make_loss_fn(tiny["jmodels"], jcfg, JSchedule.create(),
                               latent_hw, occ_hw)
    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(trainable, frozen, jax_prepare_batch(batch),
                                key)
    draws = tp.jax_draws(key, jcfg, 1, latent_hw, frames=1)
    models = tiny["pmodels"]
    partition_params(models, trainable_predicate())
    calls = {fn.__name__: 0 for fn in A.KERNEL_WRAPPERS}
    with pytest.MonkeyPatch.context() as mp:
        tp.count_calls(mp, calls)
        loss, metrics = make_loss_fn(models, pcfg, DiffusionSchedule.create(),
                                     latent_hw, occ_hw)(
            prepare_batch(batch, "cpu"), draws)
        loss.backward()
    return {"jmetrics": jmetrics, "jgrads": jgrads, "metrics": metrics,
            "models": models, "calls": calls, "draws": draws,
            "latent_hw": latent_hw}


def test_variant_loss_and_tone_match_jax(step):
    assert float(step["draws"]["uncond_switch"].sum()) > 0
    for name in ("loss", "mse", "tone"):
        np.testing.assert_allclose(float(step["metrics"][name]),
                                   float(step["jmetrics"][name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    assert float(step["metrics"]["tone"]) > 0.0


@pytest.mark.parametrize("root", ["unet", "controlnet_0"])
def test_every_trainable_gradient_matches_jax(step, root):
    """Every trainable leaf, the adapter's projections and ``adm_proj_0`` /
    ``adm_proj_2`` among them, each with a gradient."""
    want = from_jax(tp.flat(step["jgrads"][root]), KIND[root])
    module = dict(named_roots(step["models"]))[root]
    got = {n: p.grad for n, p in module.named_parameters()
           if p.requires_grad}
    assert set(got) == set(want)
    assert all(g is not None for g in got.values())
    if root == "controlnet_0":
        new = [n for n in got if n.split(".")[-2] in ADAPTER
               or n.startswith("adm_proj_")]
        assert len(new) == 4 * 4 + 4  # 4 attn2 x 4 projections; 2 linears
        assert all(got[n].abs().max() > 0 for n in new)
    floor = GRAD_FLOOR * max(w.abs().max().item() for w in want.values())
    for name, g in got.items():
        w = want[name].float()
        tol = GRAD_RTOL * w.abs().max().item() + floor
        err = (g - w).abs().max().item()
        assert err <= tol, (name, err, tol)


def test_variant_step_reaches_the_training_kernels(step):
    """The adapter moves the ControlNet's attn2 to the 78 text keys and the
    box attention to einsum, tone guidance adds a decode: the launches stay
    ``chip_smoke.train_launches_per_step``'s for one ControlNet."""
    assert step["calls"] == chip_smoke.train_launches_per_step(
        layers=1, n_controlnets=1, remat=True,
        levels=chip_smoke.model_levels(step["models"]["unet"],
                                       step["latent_hw"]))


def test_fresh_trainer_copies_the_adapter_and_trains_it(monkeypatch):
    """A fresh ``MultiviewTrainer`` (tiny models) starts every adapter
    projection as its base projection, bit for bit, and two steps at a
    constant learning rate move them."""
    cfg = tp.port_config(tp.TINY_OVERRIDES + ["runner.lr_scheduler=constant"],
                         exp="+exp=occ_bg_adapter")
    monkeypatch.setattr(PT, "build_models", lambda c, device=None:
                        build_models(c, tiny=True, device=device))
    trainer = PT.MultiviewTrainer(
        cfg, PortSynthetic(num_samples=2, image_size=(256, 128), seed=0),
        device="cpu")
    cn, = trainer.models["controlnets"]
    attn = [m for m in cn.modules()
            if isinstance(m, Attention) and m.box_adapter]
    assert len(attn) == 4
    for a in attn:
        assert torch.equal(a.to_k_box.weight, a.to_k.weight)
        assert torch.equal(a.to_k_cls.weight, a.to_k.weight)
        assert torch.equal(a.to_v_box.weight, a.to_v.weight)
        assert torch.equal(a.to_v_cls.weight, a.to_v.weight)
    before = {k: p.detach().clone() for k, p in trainer.trainable.items()
              if k.split(".")[-2] in ADAPTER}
    last = trainer.run(2)
    assert np.isfinite(last["loss"]) and last["grad_norm"] > 0
    assert len(before) == 16
    assert all(not torch.equal(trainer.trainable[k], v)
               for k, v in before.items())
