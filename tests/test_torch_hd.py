"""HD (``+exp-hd=256x704`` and ``432x768``): the port's composed configs,
and one tiny generation at 256x704 against the JAX pipeline.

At 256x704 the tiny models' top latent level has 32x88 = 2816 tokens, over
``T_SCORE_CAP`` (``up128(2816)^2`` > 2^21), and their second level 16x44 =
704 tokens at d = 16, over ``PACKED_MIN_LQ``: both levels reach the port's
kernel wrappers (their plain versions on the CPU), with attn1 on the capped
route and attn4 on the ring wrapper at the top, where the JAX package's
``_flash_packed_nbr`` takes its stacked route (``_nbr_stacked``).  The
wrappers the routing calls, in a generation and in one training step, are
the ones ``chip_smoke.py`` derives per latent level.  Tolerance 2e-4
absolute on images in [0, 1]: float32 on both sides (5.5e-6 measured), as
``tests/test_torch_pipeline.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests import torch_parity as tp
from dualdiff_tpu.data.collate import collate_fn
from dualdiff_tpu.data.synthetic import SyntheticNuScenes
from dualdiff_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from dualdiff_tpu.pipeline.bev_controlnet import \
    BEVControlNetPipeline as JaxPipeline
from dualdiff_tpu.runner.factory import build_models as jax_build
from dualdiff_tpu.utils.config import load_config as jax_load_config
from dualdiff_tpu.utils.config import to_dict
from dualdiff_tpu_torch.diffusion.schedule import DiffusionSchedule
from dualdiff_tpu_torch.ops import attention as A
from dualdiff_tpu_torch.pipeline.bev_controlnet import BEVControlNetPipeline
from dualdiff_tpu_torch.runner.conds import prepare_batch
from dualdiff_tpu_torch.runner.factory import build_models
from dualdiff_tpu_torch.runner.train_state import (partition_params,
                                                   trainable_predicate)
from dualdiff_tpu_torch.runner.trainer import make_draws, make_loss_fn
from dualdiff_tpu_torch.utils.config import (HD_256X704, HD_432X768,
                                             load_config)

HD = ["dataset.image_size=[256, 704]"]
# the tiny models: block_out_channels (32, 64, 64, 64), 4 heads, 1 layer
TINY_CHANNELS, TINY_HEADS = (32, 64, 64, 64), 4


@pytest.mark.parametrize("name, geometry", [(HD_256X704, "256x704"),
                                            (HD_432X768, "432x768")])
def test_hd_json_config_equals_composed_yaml(name, geometry):
    """configs/dual_branch_augloss_fusion_<geometry>.json is the JAX
    loader's composition of ``+exp-hd=<geometry>`` with the flagship's
    other overrides (``bench.py``'s ``BENCH_OVERLAY``)."""
    jcfg = jax_load_config(tp.CONFIG_DIR, overrides=[f"+exp-hd={geometry}"]
                           + tp.FLAGSHIP[1:])
    want = json.loads(json.dumps(to_dict(jcfg)))
    cfg = load_config(name)
    assert dict(cfg) == want
    h, w = (int(x) for x in geometry.split("x"))
    assert cfg.dataset.image_size == [h, w] and cfg.task_id == geometry
    assert cfg.runner.train_batch_size == 1
    assert cfg.use_dual_controlnet and cfg.use_aug_loss


def _levels(latent_hw):
    return chip_smoke.attention_levels(latent_hw, TINY_CHANNELS, TINY_HEADS)


def test_tiny_hd_levels_reach_the_kernels_over_the_cap():
    """Both upper levels reach the kernels; the top one over the cap, where
    the JAX package's ring takes ``_nbr_stacked``
    (``_flash_packed_nbr``: ``lq_p * lq_p > _T_SCORE_CAP``)."""
    from dualdiff_tpu.ops import attention as JA

    levels = _levels((32, 88))
    assert levels == [(2816, 8), (704, 16), (176, 16)]
    assert A.over_score_cap(2816, 2816) and not A.over_score_cap(704, 704)
    assert -(-2816 // 128) * 128 * (-(-2816 // 128) * 128) > JA._T_SCORE_CAP
    with pytest.raises(NotImplementedError, match="mid block"):
        chip_smoke.attention_levels((200, 200), TINY_CHANNELS, TINY_HEADS)


def test_tiny_hd_pipeline_matches_jax(monkeypatch):
    """1 UniPC step, CFG 2, one sample at 256x704 on ``tiny_setup``'s
    weights and JAX's initial noise (the sampler's later steps are
    ``tests/test_torch_sampler.py``'s and the 256x128 pipelines'; each step
    here costs both sides about 23 s of CPU); the wrappers the routing
    calls are the ones ``chip_smoke.py`` derives per level: 5 capped (the
    top level's attn1 in 3 UNet and 2 ControlNet blocks), 15 whole-K (the
    top level's attn2 and the second level's attn1 and attn2), 6 rings (3
    UNet blocks at each of the two levels)."""
    tiny = tp.tiny_setup()
    jcfg = tp.jax_config(tp.TINY_OVERRIDES + HD +
                         ["runner.pipeline_param.num_inference_steps=1"])
    pcfg = tp.port_config(tp.TINY_OVERRIDES + HD +
                          ["runner.pipeline_param.num_inference_steps=1"])
    h, w = jcfg.dataset.image_size
    ds = SyntheticNuScenes(num_samples=2, image_size=(h, w), seed=0)
    batch = collate_fn([ds[0]], jcfg, tiny["tokenizer"], is_train=False,
                       rng=np.random.default_rng(0))
    key = jax.random.PRNGKey(3)
    want = np.asarray(JaxPipeline(jcfg, jax_build(jcfg, tiny=True),
                                  tiny["params"], JSchedule.create())(
        batch, key))
    _, r_lat = jax.random.split(key)
    lat0 = jax.random.normal(r_lat, (1, 1, h // 8, w // 8, 4), jnp.float32)

    calls = {fn.__name__: 0 for fn in A.KERNEL_WRAPPERS}
    tp.count_calls(monkeypatch, calls)
    pipe = BEVControlNetPipeline(pcfg, tiny["pmodels"], device="cpu")
    got = pipe(batch, latents=tp.t(lat0))
    assert got.shape == (1, 6, h, w, 3)
    tp.assert_close(got, want, 0, 2e-4)
    expect = chip_smoke.generate_launches_per_generation(
        layers=1, n_controlnets=2, steps=1, levels=_levels((h // 8, w // 8)))
    assert calls == expect
    assert (expect["packed_attention_capped_fwd"],
            expect["packed_attention_fwd"],
            expect["packed_attention_nbr_fwd"]) == (5, 15, 6)


def _count_without_math(mp, calls):
    """Every kernel wrapper of the port's attention module (through the
    monkeypatch ``mp``) counts its calls in ``calls`` and returns zeros of
    its outputs' shapes: the routing alone, without the plain versions'
    float32 scores (a training step at 2816 tokens spends most of its CPU
    time there)."""
    def zeros(name, q, k, v, heads, *a, **kw):
        if name.endswith("_lse_fwd"):
            return (torch.zeros_like(q), q.new_zeros(
                q.shape[0] * heads, q.shape[1], dtype=torch.float32))
        if name.endswith("_bwd_dq"):
            return torch.zeros_like(q)
        if name.endswith("_bwd_dkv"):
            return torch.zeros_like(k), torch.zeros_like(v)
        return torch.zeros_like(q)

    for fn in A.KERNEL_WRAPPERS:
        def counted(*a, _name=fn.__name__, **kw):
            calls[_name] += 1
            return zeros(_name, *a, **kw)
        mp.setattr(A, fn.__name__, counted)


def test_tiny_hd_training_step_launches_what_chip_smoke_derives(
        monkeypatch):
    """One loss + backward of the tiny models at 256x704 (port only, remat
    on, the attention math stubbed): the top level's attn1 and attn4 under
    grad take the capped training forward, its frozen first attn1 the
    capped inference one, and the second level the whole-K training
    forward, as derived per level."""
    cfg = tp.port_config(tp.TINY_OVERRIDES + HD)
    h, w = cfg.dataset.image_size
    tiny = tp.tiny_setup()
    models = build_models(cfg, tiny=True, device="cpu")
    tp._load_port_models(models, tiny["params"])
    partition_params(models, trainable_predicate())
    ds = SyntheticNuScenes(num_samples=2, image_size=(h, w), seed=0)
    batch = collate_fn([ds[0]], tp.jax_config(tp.TINY_OVERRIDES + HD),
                       tiny["tokenizer"], is_train=True,
                       rng=np.random.default_rng(0))
    latent_hw = (h // 8, w // 8)
    draws = make_draws(torch.Generator().manual_seed(0), cfg, 1, 6,
                       latent_hw, 1000)
    calls = {fn.__name__: 0 for fn in A.KERNEL_WRAPPERS}
    _count_without_math(monkeypatch, calls)
    loss, _ = make_loss_fn(models, cfg, DiffusionSchedule.create(),
                           latent_hw, tuple(cfg.model.get("ors_frame_hw")))(
        prepare_batch(batch, "cpu"), draws)
    loss.backward()
    assert torch.isfinite(loss)
    expect = chip_smoke.train_launches_per_step(
        layers=1, n_controlnets=2, remat=True, levels=_levels(latent_hw))
    assert calls == expect
    assert expect["packed_attention_capped_lse_fwd"] > 0
    assert expect["packed_attention_capped_fwd"] == 2


def _attn_args(b, lq, lk, c, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, n, c, generator=g) for n in (lq, lk, lk)]


@pytest.mark.parametrize("kind", ["fwd", "ring", "lse", "dq", "dkv"])
def test_phase_3_plain_versions_by_rows_equal_them_on_all_rows(
        monkeypatch, kind):
    """``chip_smoke.by_rows``, which phase 3 uses to keep HD's float32
    scores in memory: with a budget of two rows' scores, the plain
    versions on slices of rows (whole rings of 3 views for the ring; lse
    and delta sliced by the rows' heads) equal them on all 7 rows."""
    b, lq, lk, c, heads, n_cam = 6 if kind == "ring" else 7, 33, 40, 16, 2, 0
    if kind == "ring":
        lk, n_cam = lq, 3
    monkeypatch.setattr(chip_smoke, "PLAIN_SCORE_BYTES",
                        chip_smoke._score_bytes(2, heads, lq, lk))
    q, k, v = _attn_args(b, lq, lk, c)
    do = torch.randn(b, lq, c, generator=torch.Generator().manual_seed(1))
    if kind in ("dq", "dkv"):
        o, lse = A.attention_packed_lse_plain(q, k, v, heads)
        args = (q, k, v, do, lse, A.attention_delta(o, do, heads), heads)
    else:
        args = (q, k, v, heads) + ((n_cam,) if n_cam else ())
    fn = {"fwd": A.attention_packed_plain,
          "ring": A.attention_packed_neighbors_plain,
          "lse": A.attention_packed_lse_plain,
          "dq": A.attention_packed_bwd_dq_plain,
          "dkv": A.attention_packed_bwd_dkv_plain}[kind]
    chunked = chip_smoke.by_rows(fn, b, heads, lq, lk, n_cam)
    assert chunked is not fn  # more than one slice
    want, got = fn(*args), chunked(*args)
    for w, g in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (want, got))):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
