"""The attn4 forms and connectors of the port's UNet against the JAX package.

Every form of the JAX ``BasicTransformerBlock._multiview_attn`` other than
the ring with the zero-init linear connector (held by
``test_torch_models.py``): ``concat`` (each view over ``[kv_left |
kv_right]``), ``self`` (one attention over a sample's ``6 * L`` tokens),
``add`` over non-ring pairs (each view with ``(i - 2) % 6`` and ``(i + 2)
% 6``: the stacked ``[q; q]`` over the gathered neighbours), and the ring
with the ``gated`` connector (``tanh(alpha) * x``) and with none.

The tiny UNet of ``build_models(tiny=True)`` at 256x128, float32, weights
drawn for the JAX init's param tree and loaded into the port through
``from_jax`` with ``strict=True``; two samples of six views, so that the
``self`` form's attention stays within its sample.  The JAX reference is
the fused path (``apply`` without ``mutable=["intermediates"]``; the explore
path differs by 0.29 on a tiny block).  At 512 tokens (and 6 x 512, 6 x 128
for ``self``) the port's attention runs through its kernel wrappers' plain
versions.

Tolerances: eps within 1e-4 absolute (about 60 layers deep, float32 on both
sides; ``test_torch_models.py::test_unet``'s).  The ``self`` form's loss
(the mean squared eps against a seeded target) within 1e-5 relative, and
every parameter's gradient within 1e-4 of its tensor's largest magnitude
plus 1e-5 of the network's largest gradient, as in
``test_torch_trainer.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.runner.factory import build_models as jax_build
from dualdiff_tpu.runner.weight_import import export_params
from dualdiff_tpu_torch.models.layers import (BasicTransformerBlock,
                                              GatedConnector, Linear)
from dualdiff_tpu_torch.runner.factory import build_models
from dualdiff_tpu_torch.runner.weights import from_jax

ROWS = 2 * 6  # two samples of six views
NON_RING = tuple(((i - 2) % 6, (i + 2) % 6) for i in range(6))
FORMS = {
    "concat": (["model.unet.neighboring_attn_type=concat"], None),
    "self": (["model.unet.neighboring_attn_type=self"], None),
    "add_non_ring": ([], NON_RING),
    "gated": (["model.unet.zero_module_type=gated"], None),
    "none": (["model.unet.zero_module_type=none"], None),
}
EPS_ATOL = 1e-4
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-5


def _inputs():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(ROWS, 32, 16, 4)).astype(np.float32)
    kv = rng.normal(size=(ROWS, 158, 96)).astype(np.float32)
    ts = np.repeat(np.array([421, 77], np.int32), 6)
    return x, ts, kv


def _jax_unet(form):
    extra, pairs = FORMS[form]
    jm = jax_build(tp.jax_config(tp.TINY_OVERRIDES + extra),
                   tiny=True)["unet"]
    return jm.clone(neighboring_view_pair=pairs) if pairs else jm


@functools.lru_cache(maxsize=None)
def _params(connector):
    """Seeded params of the JAX UNet with this connector.  The attn4 form
    does not change the param tree (attn4 is one ``Attention`` in every
    form), so the forms with one connector share it."""
    jm = jax_build(tp.jax_config(tp.TINY_OVERRIDES + tp.NO_REMAT + [
        f"model.unet.zero_module_type={connector}"]), tiny=True)["unet"]
    x, ts, kv = _inputs()
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ts),
        jnp.asarray(kv), n_cam=6))["params"]
    return tp.random_params(shapes, seed=3)


@functools.lru_cache(maxsize=None)
def _models(form):
    """(JAX UNet, its seeded params, the port's UNet with them loaded)."""
    extra, pairs = FORMS[form]
    pcfg = tp.port_config(tp.TINY_OVERRIDES + extra + (
        [f"dataset.neighboring_view_pair.{i}={list(p)}"
         for i, p in enumerate(pairs)] if pairs else []))
    params = _params(form if form in ("gated", "none") else "zero_linear")
    pm = build_models(pcfg, tiny=True, device="cpu")["unet"]
    tp.load_port(pm, params, "unet")
    return _jax_unet(form), params, pm


@functools.lru_cache(maxsize=None)
def _jax_self():
    """The ``self`` form's eps, loss and gradient from one jitted
    ``value_and_grad`` (the forward test's reference is its eps)."""
    jm, params, _ = _models("self")
    x, ts, kv = _inputs()
    target = _target()

    def jax_loss(p):
        eps = jm.apply({"params": p}, x, ts, kv, n_cam=6)
        return jnp.mean((eps - target) ** 2), eps

    (loss, eps), grads = jax.jit(jax.value_and_grad(jax_loss,
                                                    has_aux=True))(params)
    return eps, loss, grads


def _target():
    return np.random.default_rng(8).normal(
        size=_inputs()[0].shape).astype(np.float32)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_unet_forward_matches_jax(form):
    jm, params, pm = _models(form)
    x, ts, kv = _inputs()
    want = _jax_self()[0] if form == "self" else jax.jit(
        lambda p, *a: jm.apply({"params": p}, *a, n_cam=6))(params, x, ts, kv)
    with torch.no_grad():
        got = pm(tp.nhwc_to_nchw(x), tp.t(ts), tp.t(kv), n_cam=6)
    tp.assert_close(got.permute(0, 2, 3, 1), want, 0, EPS_ATOL, what=form)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_weights_cover_every_form(form):
    """``from_jax`` names each form's leaves as the JAX exporter does (the
    gated connector's ``alpha``, no connector at all with ``none``), and
    the port's UNet has exactly those parameters."""
    _, params, pm = _models(form)
    names = set(from_jax(tp.flat(params), "unet"))
    assert names == set(export_params(params, "unet"))
    assert names == set(pm.state_dict())
    block = pm.down_blocks[0].attentions[0].transformer_blocks[0]
    connectors = {n for n in names if ".connector." in n}
    if form == "gated":
        assert isinstance(block.connector, GatedConnector)
        assert connectors and all(n.endswith(".connector.alpha")
                                  for n in connectors)
    elif form == "none":
        assert block.connector is None and not connectors
    else:
        assert isinstance(block.connector, Linear)
    assert block.neighboring_attn_type == (
        form if form in ("concat", "self") else "add")


@pytest.mark.parametrize("kind", ["add", "concat", "self"])
def test_only_self_builds_without_pairs(kind):
    """``add`` and ``concat`` attend over ``neighboring_view_pair``: a block
    without one raises (the JAX block fails on it) rather than taking the
    camera ring; ``self`` needs no pairs."""
    build = lambda: BasicTransformerBlock(32, 4, 96, multiview=True,
                                          neighboring_attn_type=kind)
    if kind == "self":
        assert build().neighboring_view_pair is None
    else:
        with pytest.raises(ValueError, match="neighboring_view_pair"):
            build()


def test_self_form_loss_and_gradient_match_jax():
    """The ``self`` form under grad, remat on as in the config: the mean
    squared eps against a seeded target and its gradient for every UNet
    parameter, against ``jax.value_and_grad``."""
    _, _, pm = _models("self")
    x, ts, kv = _inputs()
    target = _target()
    _, want_loss, jgrads = _jax_self()
    assert pm.remat
    eps = pm(tp.nhwc_to_nchw(x), tp.t(ts), tp.t(kv), n_cam=6)
    loss = ((eps.permute(0, 2, 3, 1) - tp.t(target)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss),
                               rtol=LOSS_RTOL)
    want = from_jax(tp.flat(jgrads), "unet")
    got = {n: p.grad for n, p in pm.named_parameters()}
    assert set(got) == set(want) and all(g is not None
                                         for g in got.values())
    floor = GRAD_FLOOR * max(w.abs().max().item() for w in want.values())
    for name, g in got.items():
        w = want[name].float()
        err = (g - w).abs().max().item()
        assert err <= GRAD_RTOL * w.abs().max().item() + floor, (name, err)
    assert any(".attn4." in n and got[n].abs().max() > 0 for n in got)


@pytest.mark.parametrize("form", ["self", "add_non_ring", "concat"])
def test_training_step_launches_what_chip_smoke_derives(monkeypatch, form):
    """One loss + backward of the tiny flagship set with the attn4 form
    (port only, seeded random weights, remat on, the attention math
    stubbed) makes the calls ``chip_smoke.train_launches_per_step``
    derives per level: ``self`` at 6 x 512 tokens over the score cap and
    at 6 x 128 (a level whose own tokens take einsum) on the whole-K
    training forward, ``concat`` at 512 x 1024."""
    import chip_smoke
    from dualdiff_tpu_torch.data.collate import collate_fn
    from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes
    from dualdiff_tpu_torch.data.tokenizer import HashTokenizer
    from dualdiff_tpu_torch.diffusion.schedule import DiffusionSchedule
    from dualdiff_tpu_torch.runner.conds import prepare_batch
    from dualdiff_tpu_torch.runner.factory import randomize_weights
    from dualdiff_tpu_torch.runner.train_state import (named_roots,
                                                       partition_params,
                                                       trainable_predicate)
    from dualdiff_tpu_torch.runner.trainer import make_draws, make_loss_fn

    extra, pairs = FORMS[form]
    cfg = tp.port_config(tp.TINY_OVERRIDES + extra + (
        [f"dataset.neighboring_view_pair.{i}={list(p)}"
         for i, p in enumerate(pairs)] if pairs else []))
    h, w = cfg.dataset.image_size
    models = build_models(cfg, tiny=True, device="cpu")
    for _, m in named_roots(models):
        randomize_weights(m, 0)
    partition_params(models, trainable_predicate())
    ds = SyntheticNuScenes(num_samples=2, image_size=(h, w), seed=0)
    batch = collate_fn([ds[0]], cfg, HashTokenizer(), is_train=True,
                       rng=np.random.default_rng(0))
    latent_hw = (h // 8, w // 8)
    draws = make_draws(torch.Generator().manual_seed(0), cfg, 1, 6,
                       latent_hw, 1000)
    calls = dict.fromkeys(chip_smoke.REPLACES, 0)
    tp.count_routing(monkeypatch, calls)
    loss, _ = make_loss_fn(models, cfg, DiffusionSchedule.create(),
                           latent_hw, tuple(cfg.model.get("ors_frame_hw")))(
        prepare_batch(batch, "cpu"), draws)
    loss.backward()
    unet = models["unet"]
    form_name = chip_smoke.attn4_form(unet)
    assert form_name == {"add_non_ring": "add"}.get(form, form)
    expect = chip_smoke.train_launches_per_step(
        layers=1, n_controlnets=2, remat=True,
        levels=chip_smoke.model_levels(unet, latent_hw), attn4=form_name)
    assert calls == expect
    if form == "self":
        assert expect["packed_attention_capped_lse_fwd"] == 3 * 2
        # attn1 (the first frozen) and attn2 of the UNet's three blocks
        # and the two ControlNets' at 512 tokens, attn4 at 6 x 512 and 6 x 128
        assert expect["packed_attention_bwd_dq"] == (3 - 1 + 2) + (3 + 2) \
            + 3 + 3
