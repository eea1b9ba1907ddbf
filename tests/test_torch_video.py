"""DualDiff+ clip generation in the port against the JAX package.

Float32 on the CPU, the same weights (``from_jax``, ``strict=True``) and the
same seeded inputs on both sides:

* the video ``BasicTransformerBlock`` (ST-Attn + temporal attention + the
  attn4 camera ring) and the tiny video UNet, tolerance 1e-5 (both sides in
  float32, differing in the order of sums);
* the tiny clip pipeline (2 frames x 6 views at 256x128, 3 UniPC steps,
  CFG 2, sequential CFG) against the JAX pipeline with its initial latents
  injected, tolerance 2e-4 absolute on images in [0, 1], as
  ``test_torch_pipeline.py``; the JAX pipeline is called once per module;
* the port's sequential-CFG, VAE-sliced output equals its batched-CFG,
  unsliced output exactly, and its kernel calls per clip are those that
  ``chip_smoke.video_launches_per_clip`` derives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests import torch_parity as tp
from dualdiff_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from dualdiff_tpu.models import layers as JL
from dualdiff_tpu.pipeline.bev_controlnet import \
    BEVControlNetPipeline as JaxPipeline
from dualdiff_tpu_torch.models import layers as PL
from dualdiff_tpu_torch.ops import attention as A
from dualdiff_tpu_torch.pipeline.bev_controlnet import BEVControlNetPipeline
from dualdiff_tpu_torch.runner.factory import build_models

RTOL = ATOL = 1e-5
RING = ((5, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 0))


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.fixture(scope="module")
def tiny():
    return tp.tiny_video_setup()


@pytest.mark.parametrize("tokens", [24, 512])
def test_video_transformer_block_matches_jax(tokens):
    """Two clips of three frames x 6 views: ST-Attn K/V from the first and
    the previous frame, attn4 on the camera ring, temporal attention over
    the frames.  At 512 tokens attn1 (1024 keys) routes through the kernel
    wrappers' plain versions, at 24 through einsum."""
    f, n = 3, 6
    rows = 2 * f * n
    x = _rng(1).normal(size=(rows, tokens, 32)).astype(np.float32)
    ctx = _rng(2).normal(size=(rows, 20, 96)).astype(np.float32)
    jm = JL.BasicTransformerBlock(
        dim=32, heads=4, cross_attention_dim=96, n_cam=n, multiview=True,
        neighboring_view_pair=RING, st_attn=True, temporal=True,
        num_frames=f)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x,
                                            ctx))["params"]
    params = tp.random_params(shapes, seed=tokens)
    want = jax.jit(jm.apply)({"params": params}, x, ctx)
    pm = tp.load_port(PL.BasicTransformerBlock(
        32, 4, 96, multiview=True, st_attn=True, temporal=True,
        num_frames=f, neighboring_view_pair=RING), params, "unet")
    with torch.no_grad():
        got = pm(tp.t(x), tp.t(ctx), n_cam=n)
    tp.assert_close(got, want, RTOL, ATOL)


def test_video_unet_matches_jax(tiny):
    """One clip of 2 frames x 6 views with ControlNet residuals."""
    jm, pm = tiny["jmodels"]["unet"], tiny["pmodels"]["unet"]
    rows = 2 * 6
    x = _rng(7).normal(size=(rows, 32, 16, 4)).astype(np.float32)
    kv = _rng(8).normal(size=(rows, 158, 96)).astype(np.float32)
    # the tiny UNet's skip connections (see test_torch_models.test_unet)
    shapes = [(32, 16, 32), (32, 16, 32), (16, 8, 32), (16, 8, 64),
              (8, 4, 64), (8, 4, 64), (4, 2, 64), (4, 2, 64)]
    downs = [_rng(9 + i).normal(size=(rows, *s)).astype(np.float32)
             for i, s in enumerate(shapes)]
    mid = _rng(30).normal(size=(rows, 4, 2, 64)).astype(np.float32)
    ts = np.full((rows,), 421, np.int32)
    want = jax.jit(lambda *a: jm.apply(
        {"params": a[0]}, *a[1:4], down_block_additional_residuals=a[4],
        mid_block_additional_residual=a[5], n_cam=6))(
            tiny["params"]["unet"], x, ts, kv, downs, mid)
    with torch.no_grad():
        got = pm(tp.nhwc_to_nchw(x), tp.t(ts), tp.t(kv),
                 down_block_additional_residuals=[tp.nhwc_to_nchw(d)
                                                  for d in downs],
                 mid_block_additional_residual=tp.nhwc_to_nchw(mid),
                 n_cam=6)
    tp.assert_close(got, np.transpose(np.asarray(want), (0, 3, 1, 2)),
                    RTOL, ATOL)


def _port_run(tiny, extra, lat0):
    cfg = tp.port_config(tp.TINY_VIDEO_OVERRIDES + extra, video=True)
    return BEVControlNetPipeline(cfg, tiny["pmodels"], device="cpu")(
        tiny["batch"], latents=lat0)


@pytest.fixture(scope="module")
def runs(tiny):
    """The JAX clip (its config: sequential CFG, VAE slicing 12 of 12
    images), the port's with sequential CFG and VAE slicing 5 (ST-Attn sent
    to the capped wrapper by a lowered cap, kernel calls counted) and the
    port's with batched CFG, unsliced."""
    cfg = tiny["jcfg"]
    h, w = cfg.dataset.image_size
    key = jax.random.PRNGKey(3)
    want = np.asarray(JaxPipeline(cfg, tiny["jmodels"], tiny["params"],
                                  JSchedule.create())(tiny["batch"], key))
    # the JAX pipeline's initial noise (bev_controlnet.py:264-267): one map
    # per frame, shared by the views
    _, r_lat = jax.random.split(key)
    lat0 = tp.t(jax.random.normal(r_lat, (2, 1, h // 8, w // 8, 4),
                                  jnp.float32))
    calls = {fn.__name__: 0 for fn in A.KERNEL_WRAPPERS}
    with pytest.MonkeyPatch.context() as mp:
        # 512 x 1024 keys is under the cap at this size; 2^18 sends it to
        # packed_attention_capped_fwd, which the full-width clip takes
        mp.setattr(A, "T_SCORE_CAP", 2 ** 18)
        for fn in A.KERNEL_WRAPPERS:
            def counted(*a, _fn=fn, **kw):
                calls[_fn.__name__] += 1
                return _fn(*a, **kw)
            mp.setattr(A, fn.__name__, counted)
        sequential = _port_run(tiny, ["runner.pipeline_param.vae_slicing=5"],
                               lat0)
        expect = chip_smoke.video_launches_per_clip(
            layers=1, n_controlnets=2, steps=3, sequential_cfg=True,
            tokens=512)
    batched = _port_run(tiny, ["runner.pipeline_param.sequential_cfg=false",
                               "runner.pipeline_param.vae_slicing=0"], lat0)
    return {"want": want, "sequential": sequential, "batched": batched,
            "calls": calls, "expect": expect}


def test_tiny_video_pipeline_matches_jax(runs):
    got = runs["sequential"]
    assert got.shape == (2, 6, 256, 128, 3) and got.dtype == torch.float32
    assert got.min() >= 0 and got.max() <= 1
    tp.assert_close(got, runs["want"], 0, 2e-4)


def test_sequential_cfg_and_vae_slicing_equal_the_batched_path(runs):
    """Sequential CFG splits the video batch into contiguous halves and 5
    does not divide the 12 images: the same numbers, bit for bit."""
    torch.testing.assert_close(runs["sequential"], runs["batched"], rtol=0,
                               atol=0)


def test_clip_kernel_calls_match_chip_smoke_derivation(runs):
    """3 steps x 2 sequential halves; per evaluation the UNet's 3 top-level
    blocks (ST-Attn capped, attn2, attn4 ring) and each ControlNet's one
    (attn1, attn2)."""
    assert runs["calls"] == runs["expect"]
    assert runs["expect"]["packed_attention_capped_fwd"] == 3 * 6


def test_factory_builds_the_video_unet_and_refuses_rgd():
    """The video UNet has ST-Attn and temporal attention; with RGD on
    (stage 2) its attn1 and attn2, and nothing else, carry LoRA adapters of
    ``video.lora_rank``.  With the box adapter on, only the ControlNets
    carry it, as the JAX factory builds them; attn4 ``concat`` builds on
    the video UNet too."""
    cfg = tp.port_config(tp.TINY_VIDEO_OVERRIDES, video=True)
    unet = build_models(cfg, tiny=True, device="cpu")["unet"]
    block = unet.down_blocks[0].attentions[0].transformer_blocks[0]
    assert unet.num_frames == 2 and block.st_attn and block.temporal
    assert not any("lora" in n for n, _ in unet.named_parameters())
    rgd = build_models(tp.port_config(
        tp.TINY_VIDEO_OVERRIDES + ["video.rgd.enable=true"], video=True),
        tiny=True, device="cpu")["unet"]
    block = rgd.down_blocks[0].attentions[0].transformer_blocks[0]
    assert block.attn1.lora_rank == block.attn2.lora_rank == 16
    assert block.attn4.lora_rank == block.attn_temporal.lora_rank == 0
    boxed = build_models(tp.port_config(
        tp.TINY_VIDEO_OVERRIDES + ["use_box_adapter=true"], video=True),
        tiny=True, device="cpu")
    assert all(cn.use_box_adapter for cn in boxed["controlnets"])
    assert not any("_box" in n for n, _ in
                   boxed["unet"].named_parameters())
    concat = build_models(tp.port_config(
        tp.TINY_VIDEO_OVERRIDES
        + ["model.unet.neighboring_attn_type=concat"], video=True),
        tiny=True, device="cpu")["unet"]
    block = concat.down_blocks[0].attentions[0].transformer_blocks[0]
    assert block.neighboring_attn_type == "concat" and block.st_attn
