"""Shared set-up of the PyTorch-port parity tests (``test_torch_*.py``).

The JAX package is the reference.  Both sides get the same inputs, made with
numpy from a seed, and the same weights, exported with ``from_jax`` and
loaded with ``strict=True``.  Everything runs in float32
(``runner.mixed_precision=fp32``), so the comparisons are of the algorithm.

Weights: the JAX init's param tree, traced abstractly for its shapes (running
the tiny init itself compiles for 85 s on a CPU), with every leaf drawn from
a seeded numpy generator.  No leaf is zero, so the attn4 connector, the
ControlNet zero convs and the conditioning ``conv_out`` all contribute.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import pytest
import torch

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
FLAGSHIP = ["+exp=dual_branch_augloss_fusion", "dataset=Nuscenes_synthetic",
            "runner.pipeline_param.bbox_max_length=80"]
# 256x128 -> a 32x16 = 512-token top latent level: the smallest image whose
# attention reaches the port's kernel wrappers (PACKED_MIN_LQ = 512)
TINY_OVERRIDES = ["runner.mixed_precision=fp32", "dataset.image_size=[256, 128]",
                  "runner.pipeline_param.num_inference_steps=3"]

# SFA+ (one ControlNet on the occupancy image, two-stage SFA+) with the
# flagship's other overrides
FUSIONP = ["+exp=occ_bg_fusionp"] + FLAGSHIP[1:]

# the DualDiff+ clip operating point of bench.py::main_video
VIDEO = ["+exp=video_16f", "dataset=Nuscenes_synthetic",
         "runner.pipeline_param.bbox_max_length=80",
         "runner.pipeline_param.vae_slicing=12",
         "runner.pipeline_param.sequential_cfg=true"]
# tiny clips: 2 frames, so ST-Attn at the 512-token level has 1024 keys
TINY_VIDEO_OVERRIDES = TINY_OVERRIDES + ["video.num_frames=2"]
# DualDiff+ stage 2 (RGD, LoRA) with the clip operating point's overrides
RGD = ["+exp=rgd_stage2"] + VIDEO[1:]
# the LoRA B leaves of the tiny RGD UNet, drawn 10x smaller than a random
# projection: a trained adapter is a small perturbation of the projection
LORA_B = {f"{p}_lora_b": 0.1 for p in ("to_q", "to_k", "to_v", "to_out_0")}

# the variants' combined training set, on +exp=occ_bg: the box adapter, the
# camera token in the time embedding and tone guidance
VARIANTS_TRAIN = ("use_box_adapter=true",
                  "model.controlnet.use_cam_in_temb=true",
                  "use_tone_guidance=true")

# the abstract inits that only give the seeded weights their shapes trace
# the models without remat: it would lift every block for nothing, and it
# changes no parameter's path, shape or order
NO_REMAT = ["runner.enable_unet_checkpointing=false",
            "runner.enable_controlnet_checkpointing=false"]

# the port's test modules run 6 to a machine under xdist
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def one_blas_thread():
    """numpy's and scipy's BLAS on one thread for the test (an autouse
    fixture of the modules that import it): scipy's 2048 x 2048 ``sqrtm``
    is one thread of work, and its BLAS pool's idle threads spin on the
    cores the other xdist workers share."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1, user_api="blas"):
        yield


def exp_overrides(overlay):
    """The JAX loader's overrides of a shipped exp overlay
    (``"+exp=<name>"`` or ``"+exp-drive-wm=192x384"``) under the flagship's
    other overrides, which the port's composed JSONs carry."""
    return [overlay] + FLAGSHIP[1:]


def jax_config(extra=(), video=False, fusionp=False, exp=None):
    """``video``: False (the flagship), True (``video_16f``) or ``"rgd"``
    (``rgd_stage2``); ``fusionp``: ``occ_bg_fusionp``; ``exp``: the overlay
    of another shipped exp config (``exp_overrides``)."""
    from dualdiff_tpu.utils.config import load_config

    base = exp_overrides(exp) if exp else RGD if video == "rgd" else \
        VIDEO if video else FUSIONP if fusionp else FLAGSHIP
    return load_config(CONFIG_DIR, overrides=base + list(extra))


def port_config(extra=(), video=False, fusionp=False, exp=None):
    from dualdiff_tpu_torch.utils.config import (EXP_CONFIGS, FLAGSHIP,
                                                 FUSIONP, RGD_STAGE2,
                                                 VIDEO_16F, load_config)

    name = EXP_CONFIGS[exp] if exp else RGD_STAGE2 if video == "rgd" else \
        VIDEO_16F if video else FUSIONP if fusionp else FLAGSHIP
    return load_config(name, overrides=list(extra))


def random_params(tree, seed: int = 0, scale=None):
    """Seeded values for every leaf of a flax param tree (arrays or
    ShapeDtypeStructs): kernels and tables ~ N(0, 1/fan_in), norm scales
    1 + N(0, 0.1^2), other vectors N(0, 0.05^2).  ``scale`` maps a path
    fragment to a factor applied to the leaves under it."""
    import flax

    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in flax.traverse_util.flatten_dict(tree).items():
        shape = tuple(leaf.shape)
        if len(shape) >= 2:
            v = rng.normal(0.0, float(np.prod(shape[:-1])) ** -0.5, shape)
        elif path[-1] == "scale":
            v = 1.0 + rng.normal(0.0, 0.1, shape)
        else:
            v = rng.normal(0.0, 0.05, shape)
        for frag, factor in (scale or {}).items():
            if frag in path:
                v = v * factor
        out[path] = v.astype(np.float32)
    return flax.traverse_util.unflatten_dict(out)


def flat(params):
    """flax tree -> {"a/b/c": numpy leaf}."""
    import flax

    return {"/".join(k): np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(params).items()}


def load_port(module: torch.nn.Module, params, kind: str) -> torch.nn.Module:
    from dualdiff_tpu_torch.runner.weights import from_jax

    module.load_state_dict(from_jax(flat(params), kind), strict=True)
    return module


def tiny_setup(fusionp=False, exp=None, extra=()):
    """Tiny JAX and port model sets with equal weights, the seed-0 synthetic
    batch of 1 sample at 256x128, and the tokenizer; the flagship's, with
    ``fusionp`` the single-branch ``occ_bg_fusionp`` set, or with ``exp``
    that shipped exp overlay's (``"+exp=224x400"``), each under the
    overrides ``extra`` (a tuple) too.  Built once a process for each set,
    however the arguments are spelled."""
    return _tiny_setup(bool(fusionp), exp, tuple(extra))


@functools.lru_cache(maxsize=8)
def _tiny_setup(fusionp, exp, extra):
    from dualdiff_tpu.data.collate import collate_fn
    from dualdiff_tpu.data.synthetic import SyntheticNuScenes
    from dualdiff_tpu.data.tokenizer import HashTokenizer
    from dualdiff_tpu.runner.factory import build_models
    from dualdiff_tpu.runner.trainer import init_full_params, prepare_batch
    from dualdiff_tpu_torch.runner.factory import build_models as port_build

    jcfg = jax_config(TINY_OVERRIDES + list(extra), fusionp=fusionp,
                      exp=exp)
    pcfg = port_config(TINY_OVERRIDES + list(extra), fusionp=fusionp,
                       exp=exp)
    h, w = jcfg.dataset.image_size
    tok = HashTokenizer()
    ds = SyntheticNuScenes(num_samples=2, image_size=(h, w), seed=0)
    batch = collate_fn([ds[0]], jcfg, tok, is_train=False,
                       rng=np.random.default_rng(0))
    jmodels = build_models(jcfg, tiny=True)
    tensors = prepare_batch(batch)
    shape_cfg = jax_config(TINY_OVERRIDES + list(extra) + NO_REMAT,
                           fusionp=fusionp, exp=exp)
    shapes = init_full_params(
        shape_cfg, build_models(shape_cfg, tiny=True), tensors,
        (h // 8, w // 8), tuple(jcfg.model.get("ors_frame_hw", (896, 1600))),
        tok, abstract=True)
    # cam2token reads raw intrinsics (fx ~ 1266): an unscaled random kernel
    # makes the camera token ~400, the cross-attention softmax one-hot, and
    # float rounding alone then flips its winner on either side
    params = random_params(shapes, scale={"cam2token": 0.01})

    pmodels = port_build(pcfg, tiny=True, device="cpu")
    _load_port_models(pmodels, params)
    return {"jcfg": jcfg, "pcfg": pcfg, "jmodels": jmodels,
            "params": params, "pmodels": pmodels, "batch": batch,
            "tokenizer": tok}


def jax_text(setup, jt, keys=("input_ids", "uncond_ids")):
    """The JAX text encoder's hidden states (numpy) of each of ``keys`` of
    the prepared JAX batch ``jt``, from one jitted function: a one-shot
    reference that the op-by-op dispatch makes slower than its compile."""
    import jax

    te = setup["jmodels"]["text_encoder"]
    fn = jax.jit(lambda p, ids: te.apply({"params": p}, ids)[0])
    return [np.asarray(fn(setup["params"]["text_encoder"], jt[k]))
            for k in keys]


def _load_port_models(pmodels, params):
    load_port(pmodels["unet"], params["unet"], "unet")
    for i, cn in enumerate(pmodels["controlnets"]):
        load_port(cn, params[f"controlnet_{i}"], "controlnet")
    load_port(pmodels["vae"], params["vae"], "vae")
    load_port(pmodels["text_encoder"], params["text_encoder"], "clip")


@functools.lru_cache(maxsize=2)
def tiny_video_unet_params(video=True):
    """Seeded weights of the tiny video UNet alone (ST-Attn and temporal
    attention, 2 frames), from its abstractly traced init; ``video="rgd"``:
    the stage-2 UNet, with LoRA on attn1 / attn2 (B scaled by ``LORA_B``)."""
    import jax
    import jax.numpy as jnp

    from dualdiff_tpu.runner.factory import build_models

    unet = build_models(jax_config(TINY_VIDEO_OVERRIDES + NO_REMAT,
                                   video=video), tiny=True)["unet"]
    rows = 2 * 6  # one clip: 2 frames x 6 views
    shapes = jax.eval_shape(lambda: unet.init(
        jax.random.PRNGKey(0), jnp.zeros((rows, 32, 16, 4)),
        jnp.zeros((rows,), jnp.int32), jnp.zeros((rows, 158, 96)),
        n_cam=6))["params"]
    return random_params(shapes, scale=LORA_B)


@functools.lru_cache(maxsize=2)
def tiny_video_setup(video=True):
    """``tiny_setup`` for DualDiff+ clips: the tiny video model sets (ST-Attn
    and temporal attention, 2 frames) with equal weights, clip 0 of the
    seed-0 synthetic clips at 256x128 collated as ``bench.py::main_video``
    collates it (``collate_video``, rng 0), and the tokenizer.  The
    ControlNets, VAE and text encoder are those of ``tiny_setup`` (the
    video config shares them), the UNet's weights ``tiny_video_unet_params``.
    ``video="rgd"``: the RGD stage-2 set (LoRA on the UNet)."""
    from dualdiff_tpu.data.video import SyntheticNuScenesVideo, collate_video
    from dualdiff_tpu.runner.factory import build_models
    from dualdiff_tpu_torch.runner.factory import build_models as port_build

    images = tiny_setup()
    jcfg = jax_config(TINY_VIDEO_OVERRIDES, video=video)
    pcfg = port_config(TINY_VIDEO_OVERRIDES, video=video)
    h, w = jcfg.dataset.image_size
    tok = images["tokenizer"]
    clips = SyntheticNuScenesVideo(num_clips=1, num_frames=2,
                                   image_size=(h, w))
    batch = collate_video([clips[0]], jcfg, tok,
                          rng=np.random.default_rng(0))
    jmodels = build_models(jcfg, tiny=True)
    params = dict(images["params"], unet=tiny_video_unet_params(video))
    pmodels = port_build(pcfg, tiny=True, device="cpu")
    _load_port_models(pmodels, params)
    return {"jcfg": jcfg, "pcfg": pcfg, "jmodels": jmodels,
            "params": params, "pmodels": pmodels, "batch": batch,
            "tokenizer": tok}


FRAMES = 2  # frames per clip of the video training tests


def jax_draws(key, cfg, rows, latent_hw, frames=FRAMES, n_cam=6):
    """The draws the JAX ``make_loss_fn`` loss takes from ``key`` (its
    ``jax.random.split(rng, 5)``) for ``rows`` = clips x frames, in the
    port's NCHW layout: one timestep per clip, repeated over its frames
    (``jnp.repeat``)."""
    import jax

    from dualdiff_tpu.runner.trainer import sample_uncond_switch

    h, w = latent_hw
    r_vae, r_noise, r_t, r_drop, _ = jax.random.split(key, 5)
    c = cfg.model.controlnet
    nchw = lambda x: t(x).permute(*range(x.ndim - 3), -1, -3, -2)
    t_clip = jax.random.randint(r_t, (rows // frames,), 0, 1000)
    return {
        "vae_noise": nchw(jax.random.normal(r_vae, (rows * n_cam, h, w, 4))),
        "noise": nchw(jax.random.normal(r_noise, (rows, n_cam, h, w, 4))),
        "noise_offset": None,  # runner.noise_offset is 0
        "timesteps": t(jax.numpy.repeat(t_clip, frames)),
        "uncond_switch": t(sample_uncond_switch(
            r_drop, rows, n_cam, float(c.drop_cond_ratio),
            int(c.drop_cam_num))),
    }


def count_calls(mp, calls):
    """Wrap every kernel wrapper of the port's attention module (through
    the monkeypatch ``mp``) to count in ``calls`` what the routing calls; on
    the CPU they launch nothing."""
    from dualdiff_tpu_torch.ops import attention as A

    for fn in A.KERNEL_WRAPPERS:
        def counted(*a, _fn=fn, **kw):
            calls[_fn.__name__] += 1
            return _fn(*a, **kw)
        mp.setattr(A, fn.__name__, counted)


def count_routing(mp, calls):
    """Every kernel wrapper (through the monkeypatch ``mp``) counts its
    calls in ``calls`` and returns zeros of its outputs' shapes, as the
    packed wrappers return them: the routing alone, without the plain
    versions' float32 scores."""
    from dualdiff_tpu_torch.ops import attention as A

    def zeros(name, q, k, v, heads, *a, **kw):
        if name.endswith("_lse_fwd"):
            return (torch.zeros_like(q), q.new_zeros(
                q.shape[0] * heads, q.shape[1], dtype=torch.float32))
        if name.endswith("_bwd_dkv"):
            return torch.zeros_like(k), torch.zeros_like(v)
        return torch.zeros_like(q)

    for fn in A.KERNEL_WRAPPERS:
        def counted(*a, _name=fn.__name__, **kw):
            calls[_name] += 1
            return zeros(_name, *a, **kw)
        mp.setattr(A, fn.__name__, counted)


def t(x) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor."""
    return torch.from_numpy(np.array(x))


def nhwc_to_nchw(x) -> torch.Tensor:
    return t(x).permute(0, 3, 1, 2).contiguous()


def assert_close(got, want, rtol, atol, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)
