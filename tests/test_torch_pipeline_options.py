"""The pipeline's generation options against the JAX ``BEVControlNetPipeline``:
DDIM, the ControlNet cache (``cn_cache_interval``), given-view pinning and
per-call overrides.

Tiny flagship models at 256x128 (``tiny_setup``: the same weights on both
sides), float32, the seed-0 synthetic batch, the JAX pipeline's initial
noise from its key (as ``test_torch_pipeline.py``).  Two JAX pipeline calls:

* DDIM-4 with ``cn_cache_interval=2`` (the ControlNets at steps 0 and 2,
  reused at 1 and 3);
* UniPC with views 0 and 3 pinned to seeded latents and the overrides
  ``num_inference_steps=2, guidance_scale=3.5``; the pinned views' noise at
  each timestep is the JAX pipeline's own draw (``fold_in`` of its key's
  second split by the timestep), passed in as ``pin_noise``.

Tolerance 2e-4 absolute on images in [0, 1], ``test_torch_pipeline.py``'s:
float32 on both sides.  The other tests hold the port to the JAX pipeline's
rules without a JAX call: the ControlNets run ``ceil(steps / k)`` times a
generation, on images and on clips (the cache with sequential CFG raises
the JAX pipeline's ``ValueError``: ``test_torch_pipeline.py``); an
overridden call without
``conditioning_scale`` runs at 1.0; pinning moves the unpinned views too.
"""

import math
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.diffusion.samplers import unipc_timesteps
from dualdiff_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from dualdiff_tpu.pipeline.bev_controlnet import \
    BEVControlNetPipeline as JaxPipeline
from dualdiff_tpu_torch.data.tokenizer import HashTokenizer
from dualdiff_tpu_torch.data.video import SyntheticNuScenesVideo, collate_video
from dualdiff_tpu_torch.pipeline.bev_controlnet import BEVControlNetPipeline
from dualdiff_tpu_torch.runner.factory import build_models, randomize_weights

ATOL = 2e-4
PINNED = (0, 3)
CACHE = ["runner.pipeline_param.scheduler=ddim",
         "runner.pipeline_param.cn_cache_interval=2",
         "runner.pipeline_param.num_inference_steps=4"]


def _lat0(key, h, w):
    """The JAX pipeline's initial noise (its key's first split)."""
    _, r_lat = jax.random.split(key)
    return jax.random.normal(r_lat, (1, 1, h // 8, w // 8, 4), jnp.float32)


def test_ddim_with_the_controlnet_cache_matches_jax():
    s = tp.tiny_setup()
    jcfg = tp.jax_config(tp.TINY_OVERRIDES + CACHE)
    pcfg = tp.port_config(tp.TINY_OVERRIDES + CACHE)
    h, w = jcfg.dataset.image_size
    key = jax.random.PRNGKey(4)
    want = np.asarray(JaxPipeline(jcfg, s["jmodels"], s["params"],
                                  JSchedule.create())(s["batch"], key))
    got = BEVControlNetPipeline(pcfg, s["pmodels"], device="cpu")(
        s["batch"], latents=tp.t(_lat0(key, h, w)))
    tp.assert_close(got, want, 0, ATOL)


def test_pinned_views_with_overrides_match_jax():
    s = tp.tiny_setup()
    cfg = s["jcfg"]
    h, w = cfg.dataset.image_size
    shape = (1, 6, h // 8, w // 8, 4)
    gt = np.random.default_rng(12).normal(size=shape).astype(np.float32)
    mask = np.zeros((1, 6), np.float32)
    mask[:, PINNED] = 1.0
    key = jax.random.PRNGKey(6)
    overrides = {"num_inference_steps": 2, "guidance_scale": 3.5}
    want = np.asarray(JaxPipeline(cfg, s["jmodels"], s["params"],
                                  JSchedule.create())(
        s["batch"], key, conditional_latents=jnp.asarray(gt),
        conditional_mask=jnp.asarray(mask), **overrides))
    # the pinned views' noise as the JAX pipeline draws it: rng, r_lat =
    # split(key); rng, r_cl = split(rng); normal(fold_in(r_cl, t))
    rng, _ = jax.random.split(key)
    _, r_cl = jax.random.split(rng)
    pin_noise = {int(t): tp.t(jax.random.normal(
        jax.random.fold_in(r_cl, int(t)), shape, jnp.float32))
        for t in unipc_timesteps(overrides["num_inference_steps"])}
    got = BEVControlNetPipeline(s["pcfg"], s["pmodels"], device="cpu")(
        s["batch"], latents=tp.t(_lat0(key, h, w)),
        conditional_latents=tp.t(gt), conditional_mask=tp.t(mask),
        pin_noise=pin_noise, **overrides)
    tp.assert_close(got, want, 0, ATOL)


def _counting(monkeypatch, models):
    """Count every ControlNet forward that computes residuals."""
    calls = []
    for cn in models["controlnets"]:
        forward = cn.forward

        def counted(*a, _fwd=forward, **kw):
            if not kw.get("precompute_only"):
                calls.append(1)
            return _fwd(*a, **kw)
        monkeypatch.setattr(cn, "forward", counted)
    return calls


@pytest.mark.parametrize("k,steps", [(0, 3), (2, 3), (2, 4), (3, 5)])
def test_controlnets_run_at_every_kth_step(monkeypatch, k, steps):
    """Images: each ControlNet runs ``ceil(steps / k)`` times a generation
    (every step without the cache), once on the whole CFG batch.  The
    kernel wrappers' math is stubbed: the count is what is checked."""
    s = tp.tiny_setup()
    cfg = tp.port_config(tp.TINY_OVERRIDES + [
        f"runner.pipeline_param.cn_cache_interval={k}",
        f"runner.pipeline_param.num_inference_steps={steps}"])
    pipe = BEVControlNetPipeline(cfg, s["pmodels"], device="cpu")
    tp.count_routing(monkeypatch, Counter())
    calls = _counting(monkeypatch, s["pmodels"])
    out = pipe(s["batch"], generator=torch.Generator().manual_seed(0))
    evals = math.ceil(steps / k) if k > 1 else steps
    assert len(calls) == 2 * evals
    assert torch.isfinite(out).all()


def test_the_cache_on_clips():
    """Clips (half-block CFG): the cache runs the ControlNets at steps 0
    and 2 of 3 on the whole CFG batch of the clip's frames; at an interval
    beyond the steps only step 0's residuals serve, which differs from the
    uncached clip.  The kernel wrappers' math is stubbed: the counts and
    the cache's effect are what is checked."""
    cfg = tp.port_config(tp.TINY_VIDEO_OVERRIDES + [
        "runner.pipeline_param.sequential_cfg=false"], video=True)
    models = build_models(cfg, tiny=True, device="cpu")
    for m in (models["unet"], models["vae"], models["text_encoder"],
              *models["controlnets"]):
        randomize_weights(m, 0)
    clips = SyntheticNuScenesVideo(num_clips=1, num_frames=2,
                                   image_size=(256, 128))
    batch = collate_video([clips[0]], cfg, HashTokenizer(),
                          rng=np.random.default_rng(0))
    lat = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 1, 32, 16, 4)).astype(np.float32))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        tp.count_routing(mp, Counter())
        calls = _counting(mp, models)
        for k in (0, 2, 4):
            cfg.runner.pipeline_param["cn_cache_interval"] = k
            pipe = BEVControlNetPipeline(cfg, models, device="cpu")
            del calls[:]
            out[k] = pipe(batch, latents=lat)
            assert len(calls) == 2 * (math.ceil(3 / k) if k else 3)
    assert out[2].shape == (2, 6, 256, 128, 3)
    assert all(torch.isfinite(o).all() for o in out.values())
    assert (out[4] - out[0]).abs().max() > 1e-6


def test_overrides_and_the_conditioning_scale_default():
    """An overridden call without ``conditioning_scale`` runs at 1.0, not at
    the config's ``controlnet_conditioning_scale``, as the JAX pipeline
    (its ``_jit_for`` default); an unknown override or scheduler raises."""
    s = tp.tiny_setup()
    cfg = tp.port_config(tp.TINY_OVERRIDES + [
        "runner.pipeline_param.controlnet_conditioning_scale=0.5"])
    pipe = BEVControlNetPipeline(cfg, s["pmodels"], device="cpu")
    assert pipe.settings({}) == {
        "num_inference_steps": 3, "guidance_scale": 2.0,
        "scheduler": "unipc", "conditioning_scale": 0.5}
    assert pipe.settings({"guidance_scale": 3.5}) == {
        "num_inference_steps": 3, "guidance_scale": 3.5,
        "scheduler": "unipc", "conditioning_scale": 1.0}
    assert pipe.settings({"scheduler": "ddim", "conditioning_scale": 0.7,
                          "num_inference_steps": 9})["conditioning_scale"] \
        == 0.7
    with pytest.raises(TypeError, match="unknown overrides"):
        pipe.settings({"eta": 0.5})
    with pytest.raises(ValueError, match="scheduler"):
        pipe.settings({"scheduler": "euler"})
    with pytest.raises(ValueError, match="scheduler"):
        BEVControlNetPipeline(tp.port_config(tp.TINY_OVERRIDES + [
            "runner.pipeline_param.scheduler=euler"]), s["pmodels"],
            device="cpu")


def test_pinning_draws_from_the_generator_and_moves_unpinned_views():
    """Without ``pin_noise`` the pinned views' noise comes from the call's
    generator (the same seed, the same images); pinning changes the unpinned
    views too (attn4 is live), as the JAX package's test asserts."""
    s = tp.tiny_setup()
    h, w = s["jcfg"].dataset.image_size
    pipe = BEVControlNetPipeline(s["pcfg"], s["pmodels"], device="cpu")
    gt = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, 6, h // 8, w // 8, 4)).astype(np.float32))
    mask = torch.tensor([[1.0, 0, 0, 1, 0, 0]])
    run = lambda **kw: pipe(s["batch"], num_inference_steps=1,
                            generator=torch.Generator().manual_seed(1), **kw)
    plain = run()
    a = run(conditional_latents=gt, conditional_mask=mask)
    b = run(conditional_latents=gt, conditional_mask=mask)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    unpinned = [1, 2, 4, 5]
    assert (a[:, unpinned] - plain[:, unpinned]).abs().max() > 1e-6


def _tiny_models(extra):
    """The tiny flagship set with seeded random weights (port only) under
    the overrides ``extra`` -> (config, models, seed-0 batch)."""
    from dualdiff_tpu_torch.data.collate import collate_fn
    from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes
    from dualdiff_tpu_torch.runner.train_state import named_roots

    cfg = tp.port_config(tp.TINY_OVERRIDES + list(extra))
    h, w = cfg.dataset.image_size
    models = build_models(cfg, tiny=True, device="cpu")
    for _, m in named_roots(models):
        randomize_weights(m, 0)
    ds = SyntheticNuScenes(num_samples=1, image_size=(h, w), seed=0)
    batch = collate_fn([ds[0]], cfg, HashTokenizer(), is_train=False,
                       rng=np.random.default_rng(0))
    return cfg, models, batch


NON_RING = [f"dataset.neighboring_view_pair.{i}=[{(i - 2) % 6}, "
            f"{(i + 2) % 6}]" for i in range(6)]
GENERATIONS = {
    "ring, cache 2": (["runner.pipeline_param.cn_cache_interval=2"], 2),
    "ring, DDIM, cache 3": (["runner.pipeline_param.scheduler=ddim",
                             "runner.pipeline_param.cn_cache_interval=3",
                             "runner.pipeline_param.num_inference_steps=4"],
                            3),
    "self": (["model.unet.neighboring_attn_type=self"], 0),
    "concat": (["model.unet.neighboring_attn_type=concat"], 0),
    "add over other pairs": (NON_RING, 0),
}


@pytest.mark.parametrize("case", list(GENERATIONS))
def test_generation_launches_what_chip_smoke_derives(monkeypatch, case):
    """One tiny generation's kernel calls (the attention math stubbed) per
    wrapper equal ``chip_smoke.generate_launches_per_generation`` with the
    attn4 form and the cache: the ControlNets' attn1 and attn2 at
    ``ceil(steps / k)`` evaluations, ``self`` at 6 x 512 over the score cap
    and at 6 x 128, ``concat`` at 512 x 1024, ``add`` over other pairs on
    ``packed_attention_fwd`` with the ring kernel idle."""
    import chip_smoke

    extra, k = GENERATIONS[case]
    cfg, models, batch = _tiny_models(extra)
    calls = dict.fromkeys(chip_smoke.REPLACES, 0)
    tp.count_routing(monkeypatch, calls)
    BEVControlNetPipeline(cfg, models, device="cpu")(
        batch, generator=torch.Generator().manual_seed(0))
    unet = models["unet"]
    steps = int(cfg.runner.pipeline_param.num_inference_steps)
    form = chip_smoke.attn4_form(unet)
    assert form == {"self": "self", "concat": "concat",
                    "add over other pairs": "add"}.get(case, "ring")
    expect = chip_smoke.generate_launches_per_generation(
        layers=1, n_controlnets=2, steps=steps,
        levels=chip_smoke.model_levels(unet, (32, 16)), attn4=form,
        cn_cache=k)
    assert calls == expect
    # the UNet's 3 blocks every step, the two ControlNets' one block at
    # ceil(steps / k) evaluations: attn1 and attn2 each
    if k:
        assert expect["packed_attention_fwd"] == 2 * (
            3 * steps + 2 * math.ceil(steps / k))
