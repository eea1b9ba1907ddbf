"""End-to-end parity: the JAX ``BEVControlNetPipeline`` and the port's on the
same collated batch, the same weights and the same initial noise.

Tiny models at 256x128 (a 512-token top level, so the port's attention runs
through its kernel wrappers' plain versions), the flagship dual-branch
config in float32, 3 UniPC steps, CFG 2.  The port takes JAX's initial
latents, computed from the key exactly as the JAX pipeline does.  Tolerance
2e-4 absolute on images in [0, 1]: float32 on both sides (measured 4e-6).
The ControlNet cache with sequential CFG raises the JAX pipeline's
``ValueError`` in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.data.collate import collate_fn
from dualdiff_tpu.data.synthetic import SyntheticNuScenes
from dualdiff_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from dualdiff_tpu.pipeline.bev_controlnet import \
    BEVControlNetPipeline as JaxPipeline
from dualdiff_tpu_torch.ops import attention as A
from dualdiff_tpu_torch.pipeline.bev_controlnet import BEVControlNetPipeline


def test_tiny_pipeline_matches_jax():
    s = tp.tiny_setup()
    cfg = s["jcfg"]
    h, w = cfg.dataset.image_size
    key = jax.random.PRNGKey(3)
    want = np.asarray(JaxPipeline(cfg, s["jmodels"], s["params"],
                                  JSchedule.create())(s["batch"], key))
    # the JAX pipeline's initial noise (bev_controlnet.py:264-267)
    _, r_lat = jax.random.split(key)
    lat0 = jax.random.normal(r_lat, (1, 1, h // 8, w // 8, 4), jnp.float32)

    A.reset_launch_counts()
    pipe = BEVControlNetPipeline(s["pcfg"], s["pmodels"], device="cpu")
    got = pipe(s["batch"], latents=tp.t(lat0))
    assert got.shape == (1, 6, h, w, 3) and got.dtype == torch.float32
    tp.assert_close(got, want, 0, 2e-4)
    # CPU tensors never launch a kernel
    assert A.packed_attention_fwd.launches == 0
    assert A.packed_attention_nbr_fwd.launches == 0


def test_seeded_generation_is_deterministic_and_in_range():
    s = tp.tiny_setup()
    pipe = BEVControlNetPipeline(s["pcfg"], s["pmodels"], device="cpu")
    a = pipe(s["batch"], generator=torch.Generator().manual_seed(5))
    b = pipe(s["batch"], generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(a).all() and a.min() >= 0 and a.max() <= 1


def test_sequential_cfg_and_vae_slicing_equal_the_batched_path():
    """Two samples, so that splitting the CFG batch by halves or by row
    stride, not by (uncond, cond) pair, would hand a half another sample's
    or view's conditioning; 5 does not divide the 12 images.  One UniPC
    step: every step splits alike.  The same numbers, bit for bit."""
    s = tp.tiny_setup()
    h, w = s["jcfg"].dataset.image_size
    ds = SyntheticNuScenes(num_samples=2, image_size=(h, w), seed=0)
    batch = collate_fn([ds[0], ds[1]], s["jcfg"], s["tokenizer"],
                       is_train=False, rng=np.random.default_rng(0))
    lat = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 1, h // 8, w // 8, 4)).astype(np.float32))
    out = []
    for seq, slicing in (("false", 0), ("true", 5)):
        cfg = tp.port_config(tp.TINY_OVERRIDES + [
            "runner.pipeline_param.num_inference_steps=1",
            f"runner.pipeline_param.sequential_cfg={seq}",
            f"runner.pipeline_param.vae_slicing={slicing}"])
        out.append(BEVControlNetPipeline(cfg, s["pmodels"], device="cpu")(
            batch, latents=lat))
    assert out[0].shape == (2, 6, h, w, 3)
    torch.testing.assert_close(out[1], out[0], rtol=0, atol=0)


def test_the_cache_with_sequential_cfg_raises_as_in_jax():
    s = tp.tiny_setup()
    extra = ["runner.pipeline_param.cn_cache_interval=2",
             "runner.pipeline_param.sequential_cfg=true"]
    with pytest.raises(ValueError, match="sequential_cfg=false"):
        JaxPipeline(tp.jax_config(tp.TINY_OVERRIDES + extra), s["jmodels"],
                    s["params"], JSchedule.create())
    with pytest.raises(ValueError, match="sequential_cfg=false"):
        BEVControlNetPipeline(tp.port_config(tp.TINY_OVERRIDES + extra),
                              s["pmodels"], device="cpu")
