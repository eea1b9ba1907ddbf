"""The ``occ_bg_fusionp`` training loss and gradients against the JAX package.

The single-branch tiny set of ``tiny_setup(fusionp=True)`` (one ControlNet
on the occupancy image with per-view boxes and SFA+, no aug loss; same
weights on both sides) at 256x128, remat on as in the config.
``FLASH_MIN_LEN`` is lowered to the 32x16 = 512-token condition map, so that
the differentiated SFA+ stage 2 goes through ``FlashAttention`` (its plain
versions on the CPU) as it does at 224x400.  One seeded training batch goes
through ``jax.value_and_grad(make_loss_fn(...))``, computed once for the
module, and through the port's loss with JAX's own draws injected
(``tests/torch_parity.jax_draws``, one frame per row).

Tolerances (both sides float32): loss and mse within 1e-5 relative; every
trainable gradient within 1e-4 of its tensor's largest magnitude plus 1e-5
of the network's largest gradient (the floor covers exact zeros, as in
``test_torch_trainer.py``).
"""

import jax
import numpy as np
import pytest

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
from dualdiff_tpu_torch.diffusion.schedule import DiffusionSchedule
from dualdiff_tpu_torch.ops import attention as A
from dualdiff_tpu_torch.runner.conds import prepare_batch
from dualdiff_tpu_torch.runner.factory import build_models
from dualdiff_tpu_torch.runner.train_state import (named_roots,
                                                   partition_params,
                                                   trainable_predicate)
from dualdiff_tpu_torch.runner.trainer import make_loss_fn
from dualdiff_tpu_torch.runner.weights import from_jax

KIND = {"unet": "unet", "controlnet_0": "controlnet", "vae": "vae",
        "text_encoder": "clip"}
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-5
LOSS_RTOL = 1e-5
TOKENS = 32 * 16


@pytest.fixture(scope="module")
def step():
    tiny = tp.tiny_setup(fusionp=True)
    jcfg, pcfg = tiny["jcfg"], tiny["pcfg"]
    assert not jcfg.use_aug_loss and not jcfg.use_dual_controlnet
    h, w = jcfg.dataset.image_size
    latent_hw = (h // 8, w // 8)
    occ_hw = tuple(jcfg.model.get("ors_frame_hw", (896, 1600)))
    ds = SyntheticNuScenes(num_samples=2, image_size=(h, w), seed=0)
    batch = collate_fn([ds[0]], jcfg, tiny["tokenizer"], is_train=True,
                       rng=np.random.default_rng(0))
    key = jax.random.PRNGKey(5)

    trainable, frozen = jax_partition(tiny["params"],
                                      jax_predicate("only_new"))
    loss_fn = jax_make_loss_fn(tiny["jmodels"], jcfg, JSchedule.create(),
                               latent_hw, occ_hw)
    (_, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(trainable, frozen, jax_prepare_batch(batch),
                                key)
    draws = tp.jax_draws(key, jcfg, 1, latent_hw, frames=1)

    models = build_models(pcfg, tiny=True, device="cpu")
    for root, module in named_roots(models):
        tp.load_port(module, tiny["params"][root], KIND[root])
    partition_params(models, trainable_predicate())
    calls = {fn.__name__: 0 for fn in A.KERNEL_WRAPPERS}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(A, "FLASH_MIN_LEN", TOKENS)
        tp.count_calls(mp, calls)
        loss, metrics = make_loss_fn(models, pcfg, DiffusionSchedule.create(),
                                     latent_hw, occ_hw)(
            prepare_batch(batch, "cpu"), draws)
        loss.backward()
        expect = chip_smoke.train_launches_per_step(
            layers=1, n_controlnets=1, remat=True, fusionp=True,
            levels=chip_smoke.model_levels(models["unet"], latent_hw))
    return {"jmetrics": jmetrics, "jgrads": jgrads, "metrics": metrics,
            "models": models, "calls": calls, "expect": expect}


def test_loss_and_metrics_match_jax(step):
    assert "aug_loss" not in step["metrics"]
    for name in ("loss", "mse"):
        np.testing.assert_allclose(float(step["metrics"][name]),
                                   float(step["jmetrics"][name]),
                                   rtol=LOSS_RTOL, err_msg=name)


@pytest.mark.parametrize("root", ["unet", "controlnet_0"])
def test_every_trainable_gradient_matches_jax(step, root):
    want = from_jax(tp.flat(step["jgrads"][root]), KIND[root])
    module = dict(named_roots(step["models"]))[root]
    got = {n: p.grad for n, p in module.named_parameters()
           if p.requires_grad}
    assert set(got) == set(want)
    assert all(g is not None for g in got.values())
    if root == "controlnet_0":  # SFA+'s six projections train
        sfa = {n for n in got if n.startswith("txt_con_fusionp.")}
        assert {n.split(".")[1] for n in sfa} == {
            "to_q_occ", "to_k_occ", "to_v_occ", "to_k_txt", "to_v_txt",
            "to_out"}
    floor = GRAD_FLOOR * max(w.abs().max().item() for w in want.values())
    for name, g in got.items():
        w = want[name].float()
        tol = GRAD_RTOL * w.abs().max().item() + floor
        err = (g - w).abs().max().item()
        assert err <= tol, (name, err, tol)


def test_training_step_reaches_the_split_training_kernels(step):
    """The routing of one loss + backward matches the launch counts that
    ``chip_smoke.py`` derives from the code (tiny models: 1 layer per
    block, one ControlNet, remat on): SFA+ stage 2 through
    ``FlashAttention`` once, outside the remat blocks."""
    assert step["calls"] == step["expect"]
    assert step["calls"]["flash_attention_lse_fwd"] == 1
    assert step["calls"]["flash_attention_bwd_dq"] == 1
    assert step["calls"]["flash_attention_bwd_dkv"] == 1
