"""SFA+ (``occ_bg_fusionp``) in the port against the JAX package.

``SFATxtConPlus`` (two-stage SFA+: the condition map's queries attend to the
text tokens, then that result attends to the map's own keys and values) is
held against the JAX module at the 28x50 = 1400-token condition map of
224x400, where ``multi_head_attention`` sends stage 2 to the split-layout
route (``flash_attention``, its plain versions on the CPU): at the tiny
models' width (32 channels over SFA+'s 8 heads, d = 4) and at SD v1.5's
(320 over 8, d = 40).

The single-branch tiny ``occ_bg_fusionp`` set (one ControlNet on the
occupancy image with per-view boxes, SFA+) runs at 256x128 like the other
parity tests, whose 32x16 = 512-token condition map is under
``FLASH_MIN_LEN``; those tests lower it to 512, so that stage 2 takes the
same route as at 224x400.  The ControlNet's precompute and per-step encode,
and one tiny generation through the JAX pipeline (one jitted call for the
module) against the port's with JAX's initial latents.

Tolerances: float32 on both sides, 2e-5 relative + 2e-5 absolute on the SFA+
output and the precompute, 1e-4 on the encode's residuals (tens of layers
deep), 2e-4 absolute on the [0, 1] images (as ``test_torch_pipeline.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests import torch_parity as tp
from dualdiff_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from dualdiff_tpu.models import embedders as JE
from dualdiff_tpu.pipeline.bev_controlnet import \
    BEVControlNetPipeline as JaxPipeline
from dualdiff_tpu.runner import trainer as JT
from dualdiff_tpu_torch.models import embedders as PE
from dualdiff_tpu_torch.models.layers import GatedConnector
from dualdiff_tpu_torch.ops import attention as A
from dualdiff_tpu_torch.pipeline.bev_controlnet import BEVControlNetPipeline
from dualdiff_tpu_torch.runner import conds as PC
from dualdiff_tpu_torch.runner.factory import build_models

RTOL = ATOL = 2e-5
TOKENS = 32 * 16  # the tiny 256x128 set's condition map


def _rng(seed):
    return np.random.default_rng(seed)


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


@pytest.fixture(scope="module")
def tiny():
    return tp.tiny_setup(fusionp=True)


@pytest.fixture
def flash_at_512(monkeypatch):
    """SFA+ stage 2 of the 256x128 set on the split-layout route, as at
    224x400; counts the calls of every kernel wrapper."""
    monkeypatch.setattr(A, "FLASH_MIN_LEN", TOKENS)
    calls = {fn.__name__: 0 for fn in A.KERNEL_WRAPPERS}
    tp.count_calls(monkeypatch, calls)
    return calls


@pytest.mark.parametrize("b, con_dim, txt_dim", [
    (2, 32, 96),     # the tiny models: d = 4
    (1, 320, 768),   # SD v1.5: d = 40
])
def test_sfa_plus_matches_jax_module(b, con_dim, txt_dim, monkeypatch):
    calls = {fn.__name__: 0 for fn in A.KERNEL_WRAPPERS}
    tp.count_calls(monkeypatch, calls)
    cond = _rng(1).normal(size=(b, 28, 50, con_dim)).astype(np.float32)
    txt = _rng(2).normal(size=(b, 77, txt_dim)).astype(np.float32)
    jm = JE.SFATxtConPlus(con_dim=con_dim)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), cond,
                                            txt))["params"]
    params = tp.random_params(shapes, seed=3)
    want = jax.jit(lambda p, c, t: jm.apply({"params": p}, c, t))(
        params, cond, txt)
    pm = tp.load_port(PE.SFATxtConPlus(con_dim, txt_dim), params,
                      "controlnet")
    with torch.no_grad():
        got = pm(tp.nhwc_to_nchw(cond), tp.t(txt))
    tp.assert_close(got, _nchw(want), RTOL, ATOL)
    # stage 1 (1400 x 77) is einsum, stage 2 (1400 x 1400) the split route
    assert {k: v for k, v in calls.items() if v} == {"flash_attention_fwd": 1}


def test_build_models_accepts_fusionp(tiny):
    cn, = tiny["pmodels"]["controlnets"]
    assert isinstance(cn.txt_con_fusionp, PE.SFATxtConPlus)
    assert cn.txt_con_fusion is None
    assert cn.txt_con_fusionp.heads == 8  # its own, not the UNet's 4
    assert [s.cond_kind for s in tiny["pmodels"]["specs"]] == ["occ_image"]
    # the camera token in the time embedding builds beside SFA+, and so does
    # the gated attn4 connector, which no shipped config reaches
    cfg = tp.port_config(["model.controlnet.use_cam_in_temb=true"],
                         fusionp=True)
    cn, = build_models(cfg, tiny=True, device="cpu")["controlnets"]
    assert cn.use_cam_in_temb and cn.txt_con_fusionp is not None
    cfg = tp.port_config(["model.unet.zero_module_type=gated"], fusionp=True)
    built = build_models(cfg, tiny=True, device="cpu")
    block = built["unet"].down_blocks[0].attentions[0].transformer_blocks[0]
    assert isinstance(block.connector, GatedConnector)
    assert built["controlnets"][0].txt_con_fusionp is not None


def test_controlnet_precompute_and_encode(tiny, flash_at_512):
    """The single branch with SFA+ and a mixed CFG uncond switch."""
    jmodels, params = tiny["jmodels"], tiny["params"]
    jt = JT.prepare_batch(tiny["batch"])
    pt = PC.prepare_batch(tiny["batch"], "cpu")
    text, uncond = tp.jax_text(tiny, jt)
    jm, = jmodels["controlnets"]
    pm, = tiny["pmodels"]["controlnets"]
    lat = _rng(40).normal(size=(1, 6, 32, 16, 4)).astype(np.float32)
    ts = np.array([613], np.int32)
    sw = np.array([[1, 0, 1, 0, 0, 1]], np.float32)
    pre_j = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a[:5], bboxes_3d=a[5],
        encoder_hidden_states_uncond=a[6], uncond_switch=a[7],
        precompute_only=True))(
            params["controlnet_0"], lat, ts, jt["camera_param"], text,
            jt["cond_0"], jt["boxes_0"], uncond, sw)
    with torch.no_grad():
        pre_p = pm(None, None, pt["camera_param"], tp.t(text), pt["cond_0"],
                   bboxes_3d=pt["boxes_0"],
                   encoder_hidden_states_uncond=tp.t(uncond),
                   uncond_switch=tp.t(sw), precompute_only=True)
    assert flash_at_512["flash_attention_fwd"] == 1
    tp.assert_close(pre_p["kv"], pre_j["kv"], RTOL, 1e-4)
    tp.assert_close(pre_p["cond"], _nchw(pre_j["cond"]), RTOL, ATOL)

    downs_j, mid_j, kv_j = jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a[:5], precomputed=a[5], conditioning_scale=0.7))(
            params["controlnet_0"], lat, ts, jt["camera_param"], text,
            jt["cond_0"], pre_j)
    with torch.no_grad():
        downs_p, mid_p, kv_p = pm(
            tp.t(lat).permute(0, 1, 4, 2, 3), tp.t(ts), pt["camera_param"],
            None, None, precomputed=pre_p, conditioning_scale=0.7)
    assert len(downs_p) == len(downs_j)
    for a, b in zip(downs_p, downs_j):
        tp.assert_close(a, _nchw(b), 1e-4, 1e-4)
    tp.assert_close(mid_p, _nchw(mid_j), 1e-4, 1e-4)
    tp.assert_close(kv_p, kv_j, RTOL, 1e-4)


def test_tiny_fusionp_pipeline_matches_jax(tiny, flash_at_512):
    """3 UniPC steps, CFG 2, one sample; the kernel wrappers the routing
    calls are the ones ``chip_smoke.py`` derives for a generation."""
    cfg = tiny["jcfg"]
    h, w = cfg.dataset.image_size
    key = jax.random.PRNGKey(4)
    want = np.asarray(JaxPipeline(cfg, tiny["jmodels"], tiny["params"],
                                  JSchedule.create())(tiny["batch"], key))
    # the JAX pipeline's initial noise (bev_controlnet.py:264-267)
    _, r_lat = jax.random.split(key)
    lat0 = jax.random.normal(r_lat, (1, 1, h // 8, w // 8, 4), jnp.float32)
    pipe = BEVControlNetPipeline(tiny["pcfg"], tiny["pmodels"], device="cpu")
    got = pipe(tiny["batch"], latents=tp.t(lat0))
    assert got.shape == (1, 6, h, w, 3)
    tp.assert_close(got, want, 0, 2e-4)
    steps = int(cfg.runner.pipeline_param.num_inference_steps)
    assert flash_at_512 == chip_smoke.generate_launches_per_generation(
        layers=1, n_controlnets=1, steps=steps, fusionp=True,
        levels=chip_smoke.model_levels(tiny["pmodels"]["unet"],
                                       (h // 8, w // 8)))
    assert flash_at_512["flash_attention_fwd"] == 1
