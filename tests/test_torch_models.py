"""Per-module parity of the PyTorch port against the JAX package.

Same float32 weights (``from_jax``, ``strict=True``) and the same seeded
numpy inputs on both sides.  Unless a test says otherwise the tolerance is
2e-5 relative + 2e-5 absolute on outputs of magnitude ~1-10: float32 on both
sides, differing only in the order of sums (and convolution algorithms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.models import embedders as JE
from dualdiff_tpu.models import layers as JL
from dualdiff_tpu.models.norms import GroupNorm as JGroupNorm
from dualdiff_tpu.ops import fourier as JF
from dualdiff_tpu.ops import ors as JO
from dualdiff_tpu.runner import trainer as JT
from dualdiff_tpu_torch.models import embedders as PE
from dualdiff_tpu_torch.models import layers as PL
from dualdiff_tpu_torch.models.norms import GroupNorm as PGroupNorm
from dualdiff_tpu_torch.ops import fourier as PF
from dualdiff_tpu_torch.ops import ors as PO
from dualdiff_tpu_torch.runner import conds as PC
from dualdiff_tpu_torch.runner.weights import from_jax

RTOL = ATOL = 2e-5
RING = ((5, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 0))


def _rng(seed):
    return np.random.default_rng(seed)


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def _init(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                                **kw))["params"]
    return tp.random_params(shapes, seed=seed)


@pytest.fixture(scope="module")
def tiny():
    return tp.tiny_setup()


def test_fourier_and_timestep_embedding():
    x = _rng(0).normal(size=(3, 7, 3)).astype(np.float32)
    tp.assert_close(PF.fourier_embed(tp.t(x)), JF.fourier_embed(x),
                    RTOL, ATOL)
    ts = np.array([0, 1, 250, 999], np.int32)
    tp.assert_close(PF.timestep_embedding(tp.t(ts), 320),
                    JF.timestep_embedding(jnp.asarray(ts), 320),
                    rtol=1e-5, atol=1e-4)  # sin/cos of arguments up to 999


@pytest.mark.parametrize("offset", [0.0, 3.0])
def test_group_norm(offset):
    """Fast variance E[x^2] - E[x]^2 with float32 statistics.  Tolerance
    1e-4: with a mean of 3 the subtraction loses about 3 bits, and the two
    sides sum in different orders."""
    x = (offset + _rng(1).normal(size=(2, 5, 7, 64))).astype(np.float32)
    jm = JGroupNorm(32, epsilon=1e-5)
    params = _init(jm, x)
    want = jm.apply({"params": params}, x)
    pm = tp.load_port(torch.nn.ModuleDict({"norm": PGroupNorm(32, 64, 1e-5)}),
                      {"norm": params}, "unet")["norm"]
    tp.assert_close(pm(tp.nhwc_to_nchw(x)), _nchw(want), 1e-4, 1e-4)


def test_resnet_block():
    x = _rng(2).normal(size=(2, 8, 6, 32)).astype(np.float32)
    temb = _rng(3).normal(size=(2, 128)).astype(np.float32)
    jm = JL.ResnetBlock2D(64)
    params = _init(jm, x, temb)
    want = jm.apply({"params": params}, x, temb)
    pm = tp.load_port(PL.ResnetBlock2D(32, 64, 128), params, "unet")
    with torch.no_grad():
        got = pm(tp.nhwc_to_nchw(x), tp.t(temb))
    tp.assert_close(got, _nchw(want), RTOL, ATOL)


def test_upsample_nearest_matches_jax_resize():
    """4 -> 7 rows and 2 -> 3 columns: jax 'nearest' is torch
    'nearest-exact' (half-pixel centres)."""
    x = _rng(4).normal(size=(2, 4, 2, 16)).astype(np.float32)
    jm = JL.Upsample2D(16)
    params = _init(jm, x, (7, 3))
    want = jm.apply({"params": params}, x, (7, 3))
    pm = tp.load_port(PL.Upsample2D(16), params, "unet")
    with torch.no_grad():
        got = pm(tp.nhwc_to_nchw(x), (7, 3))
    tp.assert_close(got, _nchw(want), RTOL, ATOL)


@pytest.mark.parametrize("tokens", [24, 512])
def test_transformer_block_with_camera_ring(tokens):
    """attn1 / attn2 / attn4 ring + connector / GEGLU.  At 512 tokens the
    port routes attention through the kernel wrappers' plain versions, at
    24 through einsum; the JAX package takes einsum on the CPU."""
    x = _rng(5).normal(size=(6, tokens, 32)).astype(np.float32)
    ctx = _rng(6).normal(size=(6, 20, 96)).astype(np.float32)
    jm = JL.BasicTransformerBlock(dim=32, heads=4, cross_attention_dim=96,
                                  n_cam=6, multiview=True,
                                  neighboring_view_pair=RING)
    params = _init(jm, x, ctx)
    want = jax.jit(jm.apply)({"params": params}, x, ctx)
    pm = tp.load_port(PL.BasicTransformerBlock(32, 4, 96, multiview=True,
                                               neighboring_view_pair=RING),
                      params, "unet")
    with torch.no_grad():
        got = pm(tp.t(x), tp.t(ctx), n_cam=6)
    tp.assert_close(got, want, RTOL, ATOL)


def test_unet(tiny):
    jm, pm = tiny["jmodels"]["unet"], tiny["pmodels"]["unet"]
    params = tiny["params"]["unet"]
    x = _rng(7).normal(size=(6, 32, 16, 4)).astype(np.float32)
    kv = _rng(8).normal(size=(6, 158, 96)).astype(np.float32)
    # skip connections of the tiny UNet (1 layer per block): conv_in,
    # then per level its layer output and its downsample, then the last level
    shapes = [(32, 16, 32), (32, 16, 32), (16, 8, 32), (16, 8, 64),
              (8, 4, 64), (8, 4, 64), (4, 2, 64), (4, 2, 64)]
    downs = [_rng(9 + i).normal(size=(6, *s)).astype(np.float32)
             for i, s in enumerate(shapes)]
    mid = _rng(30).normal(size=(6, 4, 2, 64)).astype(np.float32)
    ts = np.full((6,), 421, np.int32)
    # jit: the unjitted tiny UNet dispatches op by op for 30 s on a CPU
    want = jax.jit(lambda *a: jm.apply(
        {"params": a[0]}, *a[1:4], down_block_additional_residuals=a[4],
        mid_block_additional_residual=a[5], n_cam=6))(
            params, x, ts, kv, downs, mid)
    with torch.no_grad():
        got = pm(tp.nhwc_to_nchw(x), tp.t(ts), tp.t(kv),
                 down_block_additional_residuals=[tp.nhwc_to_nchw(d)
                                                  for d in downs],
                 mid_block_additional_residual=tp.nhwc_to_nchw(mid),
                 n_cam=6)
    tp.assert_close(got, _nchw(want), 1e-4, 1e-4)  # ~60 layers deep


def _branch_inputs(tiny):
    """The tiny batch as JAX and port tensors, text states, conds."""
    jmodels, params = tiny["jmodels"], tiny["params"]
    jt = JT.prepare_batch(tiny["batch"])
    pt = PC.prepare_batch(tiny["batch"], "cpu")
    text, uncond = tp.jax_text(tiny, jt)
    h, w = tiny["jcfg"].dataset.image_size
    conds = JT.compute_branch_conds(jmodels, jt, (h // 8, w // 8),
                                    (896, 1600))
    return jt, pt, text, uncond, conds


@pytest.mark.parametrize("branch", [0, 1])
def test_controlnet_precompute_and_encode(tiny, branch):
    """Branch 0: occupancy image + boxes; branch 1: ORS rays + 40-point map
    vectors; both with SFA fusion and a mixed CFG uncond switch."""
    jt, pt, text, uncond, conds = _branch_inputs(tiny)
    jm = tiny["jmodels"]["controlnets"][branch]
    pm = tiny["pmodels"]["controlnets"][branch]
    params = tiny["params"][f"controlnet_{branch}"]
    lat = _rng(40).normal(size=(1, 6, 32, 16, 4)).astype(np.float32)
    ts = np.array([613], np.int32)
    sw = np.array([[1, 0, 1, 0, 0, 1]], np.float32)
    pt_cond = PC.compute_branch_conds(
        tiny["pmodels"], pt, (32, 16), (896, 1600))[branch]
    pre_j = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a[:5], bboxes_3d=a[5],
        encoder_hidden_states_uncond=a[6], uncond_switch=a[7],
        precompute_only=True))(
            params, lat, ts, jt["camera_param"], text, conds[branch],
            jt.get(f"boxes_{branch}"), uncond, sw)
    with torch.no_grad():
        pre_p = pm(None, None, pt["camera_param"], tp.t(text), pt_cond,
                   bboxes_3d=pt.get(f"boxes_{branch}"),
                   encoder_hidden_states_uncond=tp.t(uncond),
                   uncond_switch=tp.t(sw), precompute_only=True)
    tp.assert_close(pre_p["kv"], pre_j["kv"], RTOL, 1e-4)
    tp.assert_close(pre_p["cond"], _nchw(pre_j["cond"]), RTOL, ATOL)

    downs_j, mid_j, kv_j = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a[:5], precomputed=a[5], conditioning_scale=0.7))(
            params, lat, ts, jt["camera_param"], text, conds[branch], pre_j)
    with torch.no_grad():
        downs_p, mid_p, kv_p = pm(
            tp.t(lat).permute(0, 1, 4, 2, 3), tp.t(ts), pt["camera_param"],
            None, None, precomputed=pre_p, conditioning_scale=0.7)
    assert len(downs_p) == len(downs_j)
    for a, b in zip(downs_p, downs_j):
        tp.assert_close(a, _nchw(b), 1e-4, 1e-4)
    tp.assert_close(mid_p, _nchw(mid_j), 1e-4, 1e-4)
    tp.assert_close(kv_p, kv_j, RTOL, 1e-4)


def test_camera_and_box_embedders():
    cam = _rng(50).normal(size=(2, 6, 3, 7)).astype(np.float32)
    tp.assert_close(PE.embed_camera_param(tp.t(cam)),
                    JE.embed_camera_param(cam), RTOL, ATOL)
    boxes = _rng(51).normal(size=(3, 5, 8, 3)).astype(np.float32)
    classes = np.array([[0, 3, 9, -1, -1]] * 3, np.int64)
    masks = classes >= 0
    jm = JE.BBoxEmbedder(class_token_dim=96, proj_dims=(96, 64, 64, 96))
    params = _init(jm, boxes, classes, masks)
    want = jm.apply({"params": params}, boxes, classes, masks)
    # exported under the ControlNet's prefix, where class_tokens is renamed
    sd = from_jax(tp.flat({"bbox_embedder": params}), "controlnet")
    pm = PE.BBoxEmbedder(class_token_dim=96, proj_dims=(96, 64, 64, 96))
    pm.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = pm(tp.t(boxes), tp.t(classes), tp.t(masks))
    tp.assert_close(got, want, RTOL, ATOL)


def test_occ_image_embedder_and_sfa():
    pano = _rng(60).uniform(size=(1, 32, 6 * 16, 3)).astype(np.float32)
    jm = JE.OccImageConditionEmbedder(32, (4, 8, 8, 8), n_cam=6)
    params = _init(jm, pano)
    want = jm.apply({"params": params}, pano)
    pm = tp.load_port(PE.OccImageConditionEmbedder(32, (4, 8, 8, 8), 6),
                      params, "controlnet")
    with torch.no_grad():
        got = pm(tp.t(pano))
    tp.assert_close(got, _nchw(want), RTOL, ATOL)

    cond = _rng(61).normal(size=(6, 4, 2, 32)).astype(np.float32)
    txt = _rng(62).normal(size=(6, 77, 96)).astype(np.float32)
    js = JE.SFATxtCon(con_dim=32)
    params = _init(js, cond, txt)
    want = js.apply({"params": params}, cond, txt)
    ps = tp.load_port(PE.SFATxtCon(32, 96), params, "controlnet")
    with torch.no_grad():
        got = ps(tp.nhwc_to_nchw(cond), tp.t(txt))
    tp.assert_close(got, _nchw(want), RTOL, ATOL)


def test_ors_and_fg_bg_filter(tiny):
    """Labels are integers from a floor at voxel boundaries: the float32
    ray math may land a sample on the other side of a boundary, so up to
    0.1% of the samples may differ; the seed-0 batch differs in none."""
    b = tiny["batch"]
    args = (b["occ_labels"], b["occ_cam_K"], b["occ_cam_T"])
    want = np.asarray(JO.occupancy_ray_sample(*args, (32, 16),
                                              sample_point=32))
    got = PO.occupancy_ray_sample(*(tp.t(a) for a in args), (32, 16),
                                  sample_point=32).numpy()
    assert got.shape == want.shape
    assert np.mean(got != want) <= 1e-3
    for fg, bg in [(True, False), (False, True), (True, True)]:
        tp.assert_close(PO.filter_fg_bg(tp.t(want), fg, bg),
                        JO.filter_fg_bg(jnp.asarray(want), fg, bg), 0, 0)


def test_clip_text_encoder(tiny):
    jm, pm = tiny["jmodels"]["text_encoder"], tiny["pmodels"]["text_encoder"]
    ids = np.asarray(tiny["tokenizer"](["a rainy night in boston", ""]))
    want_h, want_p = jax.jit(jm.apply)(
        {"params": tiny["params"]["text_encoder"]}, ids)
    with torch.no_grad():
        got_h, got_p = pm(tp.t(ids))
    tp.assert_close(got_h, want_h, RTOL, 1e-4)
    tp.assert_close(got_p, want_p, RTOL, 1e-4)
