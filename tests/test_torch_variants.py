"""The shipped ``+exp`` model variants of the port against the JAX package.

``+exp=224x400`` (the MagicDrive-style baseline: one ControlNet on the BEV
map), the box embedder's ``minmax_normalize`` and class tokens, the box
adapter's attention (``+exp=occ_bg_adapter``), the camera token in the
time embedding (``+exp=occ_bg_camtemb``), the MSCN luminance of tone
guidance, ``init_box_adapter_from_base``, the new leaves' weight names, and
the composed JSON of every shipped exp config the port had not carried;
then each of those configs run once on the port alone.

Same float32 weights (``from_jax``, ``strict=True``) and seeded numpy
inputs on both sides.  Tolerances, float32 differing only in the order of
sums: module outputs 2e-5 relative + 2e-5 absolute (BEV-map embedder and
MSCN 1e-6 absolute on outputs under 1: measured 5e-8 and 1.2e-7); the
ControlNet's context tokens and conditioning as ``test_torch_models.py``
holds them, its residuals 1e-4 relative + 1e-4 absolute (measured 1.2e-5 on
magnitudes up to 10); the tiny generation 2e-4 absolute on images in
[0, 1] (measured 2.6e-6).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests import torch_parity as tp
from dualdiff_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from dualdiff_tpu.models import embedders as JE
from dualdiff_tpu.models import layers as JL
from dualdiff_tpu.ops.mscn import mscn_luminance as jax_mscn
from dualdiff_tpu.pipeline.bev_controlnet import \
    BEVControlNetPipeline as JaxPipeline
from dualdiff_tpu.runner import trainer as JT
from dualdiff_tpu.runner.train_state import \
    init_box_adapter_from_base as jax_init_box_adapter
from dualdiff_tpu.runner.weight_import import export_params
from dualdiff_tpu.utils.config import to_dict
from dualdiff_tpu_torch.data.collate import collate_fn
from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes
from dualdiff_tpu_torch.data.tokenizer import HashTokenizer
from dualdiff_tpu_torch.diffusion.schedule import DiffusionSchedule
from dualdiff_tpu_torch.models import embedders as PE
from dualdiff_tpu_torch.models import layers as PL
from dualdiff_tpu_torch.ops import attention as A
from dualdiff_tpu_torch.ops.mscn import mscn_luminance
from dualdiff_tpu_torch.pipeline.bev_controlnet import BEVControlNetPipeline
from dualdiff_tpu_torch.runner import conds as PC
from dualdiff_tpu_torch.runner.factory import build_models, randomize_weights
from dualdiff_tpu_torch.runner.train_state import (init_box_adapter_from_base,
                                                   named_roots)
from dualdiff_tpu_torch.runner.trainer import make_draws, make_loss_fn
from dualdiff_tpu_torch.runner.weights import from_jax, load_pretrained
from dualdiff_tpu_torch.utils.config import VARIANTS, load_config

RTOL = ATOL = 2e-5
BASELINE = "+exp=224x400"
# the two tiny ControlNet sets: the BEV-map baseline, and occ_bg with the
# box adapter, the camera token in the time embedding and tone guidance
SETS = {"bev_map": (BASELINE, ()),
        "adapter_camtemb": ("+exp=occ_bg", tp.VARIANTS_TRAIN)}


def _rng(seed):
    return np.random.default_rng(seed)


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def _init(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                                **kw))["params"]
    return tp.random_params(shapes, seed=seed)


@pytest.mark.parametrize("hw", [(28, 50), (32, 16)], ids=["28x50", "32x16"])
def test_bev_map_embedder_matches_jax(hw):
    """The 200x200 BEV mask -> 28x50 with no resize (224x400 latents), and
    -> 32x16 (the tiny 256x128 set) through the antialiased resize."""
    bev = _rng(0).uniform(size=(2, 200, 200, 8)).astype(np.float32)
    jm = JE.BEVMapConditionEmbedder(32, (4, 8, 8, 8), n_cam=6, target_hw=hw)
    params = _init(jm, bev)
    want = jm.apply({"params": params}, bev)
    pm = PE.BEVMapConditionEmbedder(32, (4, 8, 8, 8), n_cam=6,
                                    map_channels=8)
    pm.load_state_dict({k.split(".", 1)[1]: v for k, v in from_jax(
        tp.flat({"controlnet_cond_embedding": params}),
        "controlnet").items()}, strict=True)
    with torch.no_grad():
        got = pm(tp.t(bev), hw)
    assert got.shape == (12, 32, *hw)
    tp.assert_close(got, _nchw(want), 0, 1e-6)


def test_bbox_embedder_minmax_and_class_tokens():
    """``minmax_normalize`` on box corners at nuScenes scale, and
    ``return_cls``'s masked class tokens (null feature on padded boxes)."""
    boxes = _rng(1).uniform(-60, 60, size=(3, 5, 8, 3)).astype(np.float32)
    classes = np.array([[0, 3, 9, -1, -1]] * 3, np.int64)
    masks = classes >= 0
    kw = dict(class_token_dim=96, proj_dims=(96, 64, 64, 96),
              minmax_normalize=True)
    jm = JE.BBoxEmbedder(**kw)
    params = _init(jm, boxes, classes, masks)
    want, want_cls = jm.apply({"params": params}, boxes, classes, masks,
                              return_cls=True)
    sd = from_jax(tp.flat({"bbox_embedder": params}), "controlnet")
    pm = PE.BBoxEmbedder(**kw)
    pm.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got, got_cls = pm(tp.t(boxes), tp.t(classes), tp.t(masks),
                          return_cls=True)
        plain = pm(tp.t(boxes), tp.t(classes), tp.t(masks))
    tp.assert_close(got, want, RTOL, ATOL)
    tp.assert_close(got_cls, want_cls, RTOL, ATOL)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


@pytest.mark.parametrize("text_len", [77, 20])
def test_box_adapter_attention_matches_jax(text_len):
    """K/V ``[cam + text | 7 boxes | 7 classes]``, 512 queries (the packed
    route for the text); a text length other than CLIP's 77 moves the
    split (``test_models.py::test_controlnet_box_adapter_non77_text``)."""
    n_box, lq = 7, 512
    x = _rng(2).normal(size=(2, lq, 64)).astype(np.float32)
    kv = _rng(3).normal(size=(2, 1 + text_len + 2 * n_box, 96)) \
        .astype(np.float32)
    jm = JL.Attention(64, heads=4, box_adapter=True, num_box_tokens=n_box)
    params = _init(jm, x, kv)
    want = jm.apply({"params": params}, x, kv)
    pm = PL.Attention(64, 4, kv_dim=96, box_adapter=True)
    pm.load_state_dict(from_jax(tp.flat(params), "unet"), strict=True)
    with torch.no_grad():
        got = pm(tp.t(x), tp.t(kv), num_box_tokens=n_box)
        # no box tokens: the text alone, as a block without the adapter
        text_only = pm(tp.t(x), tp.t(kv[:, :1 + text_len]))
    tp.assert_close(got, want, RTOL, ATOL)
    assert (got - text_only).abs().max() > 1e-2


def test_mscn_luminance_matches_jax():
    """NHWC on the JAX side, NCHW here; float32 out of bf16 in too."""
    img = _rng(4).uniform(-1, 1, size=(3, 40, 24, 3)).astype(np.float32)
    got = mscn_luminance(tp.nhwc_to_nchw(img))
    assert got.shape == (3, 40, 24) and got.dtype == torch.float32
    tp.assert_close(got, jax_mscn(img), 0, 1e-6)
    half = mscn_luminance(tp.nhwc_to_nchw(img).bfloat16())
    assert half.dtype == torch.float32


@pytest.mark.parametrize("which", sorted(SETS))
def test_controlnet_precompute_and_encode(which):
    """The tiny ControlNet's step-constant precompute and its per-step
    encode, with a mixed CFG uncond switch: the rows it drops take the
    uncond camera into the context, while ``use_cam_in_temb`` keeps the
    conditional camera token (the precompute's ``cam_tok``)."""
    exp, extra = SETS[which]
    tiny = tp.tiny_setup(exp=exp, extra=extra)
    jm, = tiny["jmodels"]["controlnets"]
    pm, = tiny["pmodels"]["controlnets"]
    params = tiny["params"]
    jt = JT.prepare_batch(tiny["batch"])
    pt = PC.prepare_batch(tiny["batch"], "cpu")
    text, uncond = tp.jax_text(tiny, jt)
    jcond, = JT.compute_branch_conds(tiny["jmodels"], jt, (32, 16),
                                     (896, 1600))
    pcond, = PC.compute_branch_conds(tiny["pmodels"], pt, (32, 16),
                                     (896, 1600))
    lat = _rng(40).normal(size=(1, 6, 32, 16, 4)).astype(np.float32)
    ts = np.array([613], np.int32)
    sw = np.array([[1, 0, 1, 0, 0, 1]], np.float32)
    p = params["controlnet_0"]
    pre_j = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a[:5], bboxes_3d=a[5],
        encoder_hidden_states_uncond=a[6], uncond_switch=a[7],
        precompute_only=True))(p, lat, ts, jt["camera_param"], text, jcond,
                               jt["boxes_0"], uncond, sw)
    out_j = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a[:5], precomputed=a[5], conditioning_scale=0.7))(
            p, lat, ts, jt["camera_param"], text, jcond, pre_j)
    with torch.no_grad():
        pre_p = pm(None, None, pt["camera_param"], tp.t(text), pcond,
                   bboxes_3d=pt["boxes_0"],
                   encoder_hidden_states_uncond=tp.t(uncond),
                   uncond_switch=tp.t(sw), precompute_only=True,
                   latent_hw=(32, 16))
        out_p = pm(tp.t(lat).permute(0, 1, 4, 2, 3), tp.t(ts),
                   pt["camera_param"], tp.t(text), None, precomputed=pre_p,
                   conditioning_scale=0.7)
    assert set(pre_p) == set(pre_j)
    assert ("cam_tok" in pre_p) == (which == "adapter_camtemb")
    n_ctx, n_box = 1 + text.shape[1], jt["boxes_0"]["bboxes"].shape[2]
    adapter = which == "adapter_camtemb"
    assert pre_p["kv"].shape[1] == n_ctx + (2 if adapter else 1) * n_box
    tp.assert_close(pre_p["kv"], pre_j["kv"], RTOL, 1e-4)
    tp.assert_close(pre_p["cond"], _nchw(pre_j["cond"]), RTOL, ATOL)
    if adapter:
        tp.assert_close(pre_p["cam_tok"], pre_j["cam_tok"], RTOL, 1e-4)
    downs_p, mid_p, kv_p = out_p
    downs_j, mid_j, kv_j = out_j
    assert len(downs_p) == len(downs_j)
    for a, b in zip(downs_p, downs_j):
        tp.assert_close(a, _nchw(b), 1e-4, 1e-4)
    tp.assert_close(mid_p, _nchw(mid_j), 1e-4, 1e-4)
    assert kv_p.shape[1] == n_ctx + n_box  # the UNet's: no class tokens
    tp.assert_close(kv_p, kv_j, RTOL, 1e-4)


def test_tiny_baseline_generation_matches_jax(monkeypatch):
    """``+exp=224x400`` end to end: the BEV map through the JAX pipeline
    and the port's, JAX's initial latents, 3 UniPC steps, CFG 2; the
    port's kernel calls and their recorded FLOPs equal ``chip_smoke``'s
    derivations for one ControlNet."""
    s = tp.tiny_setup(exp=BASELINE)
    cfg = s["jcfg"]
    h, w = cfg.dataset.image_size
    assert [sp.cond_kind for sp in s["pmodels"]["specs"]] == ["bev_map"]
    key = jax.random.PRNGKey(3)
    want = np.asarray(JaxPipeline(cfg, s["jmodels"], s["params"],
                                  JSchedule.create())(s["batch"], key))
    _, r_lat = jax.random.split(key)
    lat0 = jax.random.normal(r_lat, (1, 1, h // 8, w // 8, 4), jnp.float32)
    calls = {fn.__name__: 0 for fn in A.KERNEL_WRAPPERS}
    tp.count_calls(monkeypatch, calls)
    pipe = BEVControlNetPipeline(s["pcfg"], s["pmodels"], device="cpu")
    with A.recorded_kernel_flops() as rec:
        got = pipe(s["batch"], latents=tp.t(lat0))
    assert got.shape == (1, 6, h, w, 3)
    tp.assert_close(got, want, 0, 2e-4)
    unet = s["pmodels"]["unet"]
    args = (1, 1, 3, chip_smoke.model_levels(unet, (h // 8, w // 8)))
    assert calls == chip_smoke.generate_launches_per_generation(*args)
    flops = chip_smoke.generate_kernel_flops(
        *args, unet.block_out_channels, 2 * 1 * 6)
    assert rec.by_wrapper == {k: float(v) for k, v in flops.items() if v}


def test_init_box_adapter_from_base_matches_jax():
    """``to_k_box`` / ``to_k_cls`` from ``to_k`` and ``to_v_box`` /
    ``to_v_cls`` from ``to_v`` in every ControlNet attn2, as JAX's tree
    pass; nothing else changes."""
    exp, extra = SETS["adapter_camtemb"]
    tiny = tp.tiny_setup(exp=exp, extra=extra)
    want = jax_init_box_adapter(tiny["params"])
    models = build_models(tiny["pcfg"], tiny=True, device="cpu")
    tp._load_port_models(models, tiny["params"])
    before = models["controlnets"][0].state_dict()
    before = {k: v.clone() for k, v in before.items()}
    copied = init_box_adapter_from_base(models)
    got = models["controlnets"][0].state_dict()
    exp_sd = from_jax(tp.flat(want["controlnet_0"]), "controlnet")
    adapter = [k for k in got if ".to_k_box." in k or ".to_v_box." in k
               or ".to_k_cls." in k or ".to_v_cls." in k]
    assert copied == len(adapter) > 0
    for k, v in got.items():
        torch.testing.assert_close(v, exp_sd[k], rtol=0, atol=0)
        if k not in adapter:
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    blk = models["controlnets"][0].down_blocks[0].attentions[0] \
        .transformer_blocks[0].attn2
    assert torch.equal(blk.to_k_box.weight, blk.to_k.weight)
    assert torch.equal(blk.to_v_cls.weight, blk.to_v.weight)


@pytest.mark.parametrize("which", sorted(SETS))
def test_new_leaves_export_and_load_by_name(which):
    """``from_jax`` equals the JAX exporter (``export_params``) on the
    ControlNet trees with the BEV-map embedder, the camera projection and
    the box adapter, name for name and value for value, and loads
    ``strict=True``; the reference's ``adm_proj.0`` / ``adm_proj.2``
    (``import_controlnet``'s names) load through ``load_pretrained``."""
    exp, extra = SETS[which]
    tiny = tp.tiny_setup(exp=exp, extra=extra)
    params = tiny["params"]["controlnet_0"]
    want = export_params(params, "controlnet")
    got = from_jax(tp.flat(params), "controlnet")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    new = {"bev_map": ["controlnet_cond_embedding.blocks.5.weight"],
           "adapter_camtemb": [
               "adm_proj_0.weight", "adm_proj_2.bias",
               "down_blocks.0.attentions.0.transformer_blocks.0.attn2"
               ".to_k_box.weight",
               "mid_block.attentions.0.transformer_blocks.0.attn2"
               ".to_v_cls.weight"]}[which]
    assert all(k in got for k in new)
    pm, = build_models(tiny["pcfg"], tiny=True, device="cpu")["controlnets"]
    pm.load_state_dict(got, strict=True)
    if which == "adapter_camtemb":
        ref = {k.replace("adm_proj_", "adm_proj."): v for k, v in got.items()}
        assert "adm_proj.0.weight" in ref
        fresh, = build_models(tiny["pcfg"], tiny=True,
                              device="cpu")["controlnets"]
        assert load_pretrained(fresh, ref, "controlnet") == []
        torch.testing.assert_close(fresh.adm_proj_0.weight,
                                   got["adm_proj_0.weight"], rtol=0, atol=0)


@pytest.mark.parametrize("overlay", sorted(VARIANTS))
def test_composed_config_equals_jax(overlay):
    """``dualdiff_tpu_torch/configs/<name>.json`` is the JAX loader's
    composition of ``overlay`` under the flagship's other overrides
    (``tests/torch_parity.exp_overrides``)."""
    want = json.loads(json.dumps(to_dict(tp.jax_config(exp=overlay))))
    assert dict(load_config(VARIANTS[overlay])) == want


@pytest.mark.parametrize("overlay", sorted(VARIANTS))
def test_each_config_builds_and_runs(overlay):
    """Every newly composed config builds its tiny model set on the CPU
    (at 128x64, for time: the models do not depend on the geometry), one
    UniPC step of a generation gives finite images in [0, 1], and one
    training loss is finite with every metric its config asks for."""
    cfg = tp.port_config(tp.TINY_OVERRIDES + [
        "dataset.image_size=[128, 64]",
        "runner.pipeline_param.num_inference_steps=1"], exp=overlay)
    h, w = cfg.dataset.image_size
    models = build_models(cfg, tiny=True, device="cpu")
    for _, m in named_roots(models):
        randomize_weights(m, 0)
    ds = SyntheticNuScenes(num_samples=1, image_size=(h, w), seed=0)
    tok = HashTokenizer()
    gen_batch = collate_fn([ds[0]], cfg, tok, is_train=False,
                             rng=np.random.default_rng(0))
    with torch.no_grad():
        img = BEVControlNetPipeline(cfg, models, device="cpu")(
            gen_batch, generator=torch.Generator().manual_seed(0))
        assert img.shape == (1, 6, h, w, 3)
        assert torch.isfinite(img).all() and 0 <= img.min() <= img.max() <= 1
        batch = PC.prepare_batch(collate_fn(
            [ds[0]], cfg, tok, is_train=True, rng=np.random.default_rng(0)),
            "cpu")
        sched = DiffusionSchedule.create()
        draws = make_draws(torch.Generator().manual_seed(0), cfg, 1, 6,
                           (h // 8, w // 8), sched.num_train_timesteps)
        loss, metrics = make_loss_fn(models, cfg, sched, (h // 8, w // 8),
                                     tuple(cfg.model.ors_frame_hw))(
            batch, draws)
    assert np.isfinite(float(loss))
    assert ("aug_loss" in metrics) == bool(cfg.use_aug_loss)
    assert ("tone" in metrics) == bool(cfg.use_tone_guidance)
