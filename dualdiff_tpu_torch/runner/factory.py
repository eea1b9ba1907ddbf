"""Model factory: build the module set from a composed config.

Port of ``dualdiff_tpu/runner/factory.py``, remat settings included.
``tiny=True`` uses the JAX package's tiny sizes, which keep every
architectural feature on.  The ControlNets take the config's conditioning
kind (BEV map, occupancy image, ORS rays), ``use_cam_in_temb``, the box
embedder's ``minmax_normalize`` and ``use_box_adapter``; the UNet never
carries the box adapter, as in the JAX factory, and takes attn4's form
and connector (``model.unet.neighboring_attn_type``, ``zero_module_type``)
and the neighbour pairs (``dataset.neighboring_view_pair``).  A ``use_video`` config
builds the DualDiff+ video UNet (ST-Attn and temporal attention,
``video.num_frames`` frames), with LoRA adapters of rank
``video.lora_rank`` on its attn1 and attn2 exactly when
``video.rgd.enable`` (RGD stage 2), as the JAX factory builds it.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .. import resolve_device
from ..data.collate import BranchSpec, branch_specs_from_cfg
from ..models.clip_text import CLIPTextModel
from ..models.controlnet import BEVControlNet
from ..models.unet import UNet2DConditionMultiview
from ..models.vae import AutoencoderKL

__all__ = ["build_models", "randomize_weights", "compute_dtype"]

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32,
           "fp16": torch.float16}


def compute_dtype(cfg) -> torch.dtype:
    return _DTYPES[str(cfg.runner.mixed_precision)]


def _remat_min_tokens(cfg, key: str) -> int:
    """Per-network remat threshold (``unet_remat_min_tokens`` /
    ``controlnet_remat_min_tokens``), falling back to the shared
    ``remat_min_tokens`` when null."""
    v = cfg.runner.get(key, None)
    if v is None:
        v = cfg.runner.get("remat_min_tokens", 0)
    return int(v)


def build_models(cfg, tiny: bool = False, device=None) -> Dict:
    """-> dict(unet, controlnets: list, vae, text_encoder, specs, dtype).

    Modules are float32 on ``device`` (CUDA unless ``device="cpu"``),
    initialised by PyTorch's defaults with the JAX package's zero-init
    leaves at zero; load weights (``runner/weights.py``) or call
    ``randomize_weights``.  The pipeline casts them to ``dtype``."""
    dev = resolve_device(device)
    specs: List[BranchSpec] = branch_specs_from_cfg(cfg)
    u = cfg.model.unet
    c = cfg.model.controlnet
    if tiny:
        chs, layers, heads, xdim = (32, 64, 64, 64), 1, 4, 96
        cond_chs = (4, 8, 8, 8)
        bbox_proj = (96, 64, 64, 96)
    else:
        chs = tuple(u.block_out_channels)
        layers = int(u.layers_per_block)
        heads = int(u.attention_head_dim)
        xdim = int(u.cross_attention_dim)
        cond_chs = tuple(c.conditioning_embedding_out_channels)
        bbox_proj = tuple(c.bbox_embedder_param.proj_dims)
    pairs = tuple(tuple(cfg.dataset.neighboring_view_pair[k])
                  for k in sorted(cfg.dataset.neighboring_view_pair,
                                  key=int))
    video = bool(cfg.get("use_video", False))
    with torch.device(dev):
        unet = UNet2DConditionMultiview(
            block_out_channels=chs, layers_per_block=layers, heads=heads,
            cross_attention_dim=xdim, multiview=True,
            neighboring_view_pair=pairs,
            neighboring_attn_type=str(u.neighboring_attn_type),
            zero_module_type=str(u.zero_module_type),
            st_attn=video and bool(cfg.video.use_st_attn),
            temporal=video and bool(cfg.video.use_temporal_attn),
            num_frames=int(cfg.video.num_frames) if video else 1,
            lora_rank=int(cfg.video.lora_rank)
            if video and cfg.video.rgd.enable else 0,
            remat=bool(cfg.runner.get("enable_unet_checkpointing", False)),
            remat_min_tokens=_remat_min_tokens(cfg, "unet_remat_min_tokens"))
        controlnets = [BEVControlNet(
            block_out_channels=chs, layers_per_block=layers, heads=heads,
            cross_attention_dim=xdim,
            camera_out_dim=xdim if tiny else int(c.camera_out_dim),
            uncond_cam_in_dim=tuple(c.uncond_cam_in_dim),
            cam_num_freqs=int(c.cam_embedder_param.num_freqs),
            cond_embedder=spec.cond_kind,
            map_channels=int(c.map_size[0]),
            conditioning_embedding_out_channels=cond_chs,
            n_cam=len(pairs),
            use_txt_con_fusion=bool(c.use_txt_con_fusion),
            use_txt_con_fusionp=bool(c.use_txt_con_fusionp),
            use_cam_in_temb=bool(c.get("use_cam_in_temb", False)),
            bbox_mode=str(cfg.model.bbox_mode),
            bbox_num_points=spec.map_vec_points if spec.use_map_vec else None,
            bbox_n_classes=int(c.bbox_embedder_param.n_classes),
            bbox_minmax_normalize=bool(
                c.bbox_embedder_param.get("minmax_normalize", False)),
            bbox_proj_dims=bbox_proj,
            bbox_class_token_dim=xdim if tiny else int(
                c.bbox_embedder_param.class_token_dim),
            use_box_adapter=bool(cfg.get("use_box_adapter", False)),
            remat=bool(cfg.runner.get("enable_controlnet_checkpointing",
                                      False)),
            remat_min_tokens=_remat_min_tokens(
                cfg, "controlnet_remat_min_tokens"),
        ) for spec in specs]
        if tiny:
            vae = AutoencoderKL(block_out_channels=(8, 16, 16, 16),
                                layers_per_block=1)
            text = CLIPTextModel(num_layers=2, hidden_size=xdim, num_heads=4,
                                 intermediate_size=4 * xdim)
        else:
            v = cfg.model.vae
            vae = AutoencoderKL(
                block_out_channels=tuple(v.block_out_channels),
                layers_per_block=int(v.layers_per_block),
                latent_channels=int(v.latent_channels),
                scaling_factor=float(v.scaling_factor))
            t = cfg.model.text_encoder
            text = CLIPTextModel(
                vocab_size=int(t.vocab_size), hidden_size=int(t.hidden_size),
                num_layers=int(t.num_layers), num_heads=int(t.num_heads),
                max_position_embeddings=int(t.max_position_embeddings),
                intermediate_size=int(t.intermediate_size))
    return {"unet": unet, "controlnets": controlnets, "vae": vae,
            "text_encoder": text, "specs": specs,
            "dtype": compute_dtype(cfg)}


@torch.no_grad()
def randomize_weights(module: torch.nn.Module, seed: int) -> None:
    """Seeded random weights for a run without a checkpoint: every matrix
    and kernel ~ N(0, 1/fan_in) (flax's lecun-normal), norm scales
    1 + N(0, 0.1^2), every other vector N(0, 0.02^2).  The zero-init leaves
    (attn4 connector, zero convs, conditioning conv_out) get noise too, so
    the branches they gate contribute."""
    gen = None
    for name, p in module.named_parameters():
        if gen is None:
            gen = torch.Generator(device=p.device).manual_seed(seed)
        if p.dim() >= 2:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
        elif name.endswith("weight"):  # GroupNorm / LayerNorm scale
            p.normal_(1.0, 0.1, generator=gen)
        else:
            p.normal_(0.0, 0.02, generator=gen)
