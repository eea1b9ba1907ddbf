"""Generation pipeline: text encode, UniPC denoising with CFG over the
ControlNets and the multiview UNet, VAE decode.

Port of ``dualdiff_tpu/pipeline/bev_controlnet.py`` for the image path
(no video, sequential CFG, ControlNet caching, given-view pinning or VAE
slicing yet).  Kept from the JAX pipeline:

* weights cast to the compute dtype (bf16 by default);
* CFG rows interleaved per sample, (uncond, cond) at (2i, 2i+1); uncond rows
  take the learned uncond camera, the null text and all-null box tokens and
  share the conditioning image;
* step-constant conditioning (embedders, SFA fusion, context tokens) is
  computed once, outside the denoising loop;
* the ControlNets' residuals are summed, and the first ControlNet's context
  tokens are the UNet's cross-attention KV;
* one initial noise map shared by every view;
* decode, then ``/ 2 + 0.5`` clipped to [0, 1].

Images are channels-last, ``(B, N, H, W, 3)``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import resolve_device
from ..diffusion.samplers import unipc_sample
from ..diffusion.schedule import DiffusionSchedule
from ..runner.conds import compute_branch_conds, prepare_batch

__all__ = ["BEVControlNetPipeline"]


class BEVControlNetPipeline:
    def __init__(self, cfg, models: Dict,
                 schedule: Optional[DiffusionSchedule] = None, device=None):
        """``models``: the ``runner.factory.build_models`` dict with weights
        loaded; the modules are moved to ``device`` and cast to
        ``models["dtype"]`` in place."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.models = models
        dtype = models["dtype"]
        for key in ("unet", "vae", "text_encoder"):
            models[key].to(self.device, dtype).eval()
        for cn in models["controlnets"]:
            cn.to(self.device, dtype).eval()
        self.schedule = schedule or DiffusionSchedule.create()
        h, w = cfg.dataset.image_size
        self.latent_hw = (h // 8, w // 8)
        # the frame the ORS intrinsics refer to
        self.image_hw = tuple(cfg.model.get("ors_frame_hw", (896, 1600)))
        pp = cfg.runner.pipeline_param
        for key in ("sequential_cfg", "cn_cache_interval", "vae_slicing"):
            if pp.get(key):
                raise NotImplementedError(
                    f"pipeline_param.{key} is not ported")
        if str(pp.get("scheduler", "unipc")) != "unipc":
            raise NotImplementedError("only the UniPC scheduler is ported")

    @torch.no_grad()
    def __call__(self, batch: Dict,
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """batch: collate output (or its ``prepare_batch`` tensors).
        ``latents``: initial noise (B, 1 or N, h, w, 4), float32; drawn from
        ``generator`` when not given.  -> images (B, N, H, W, 3) in [0, 1],
        float32."""
        models, cfg = self.models, self.cfg
        pp = cfg.runner.pipeline_param
        unet, controlnets = models["unet"], models["controlnets"]
        vae, text_encoder = models["vae"], models["text_encoder"]
        t = prepare_batch(batch, self.device) if "branches" in batch \
            else batch
        cam = t["camera_param"]
        B, N = cam.shape[:2]
        lh, lw = self.latent_hw
        guidance = float(pp.guidance_scale)
        cond_scale = float(pp.controlnet_conditioning_scale)

        text, _ = text_encoder(t["input_ids"])
        uncond, _ = text_encoder(t["uncond_ids"])
        if cfg.use_aug_text:
            text = text.reshape(B, N, *text.shape[1:])
        conds = compute_branch_conds(models, t, self.latent_hw,
                                     self.image_hw)

        def cfg2(u, c):  # interleave (uncond, cond) per sample
            return torch.stack([u, c], dim=1).reshape(2 * B, *u.shape[1:])

        ones = torch.ones(B, N, device=self.device)
        switch = cfg2(ones, torch.zeros_like(ones))  # 1 -> uncond row
        zero_map = bool(pp.get("use_zero_map_as_unconditional", False))
        pre = []
        for i, cn in enumerate(controlnets):
            c = conds[i]
            c2 = None if c is None else cfg2(
                torch.zeros_like(c) if zero_map else c, c)
            bx = t.get(f"boxes_{i}")
            boxes2 = None if bx is None else {
                "bboxes": cfg2(bx["bboxes"], bx["bboxes"]),
                "classes": cfg2(bx["classes"], bx["classes"]),
                "masks": cfg2(torch.zeros_like(bx["masks"]), bx["masks"]),
            }
            pre.append(cn(None, None, cfg2(cam, cam), cfg2(text, text), c2,
                          bboxes_3d=boxes2,
                          encoder_hidden_states_uncond=uncond,
                          uncond_switch=switch, precompute_only=True))
        cam2 = cfg2(cam, cam)

        def model_fn(x: torch.Tensor, step_t: int) -> torch.Tensor:
            # (B, N, h, w, 4) f32 -> per-view NCHW CFG batch
            x2 = cfg2(x, x).permute(0, 1, 4, 2, 3)  # (2B, N, 4, h, w)
            t2 = torch.full((2 * B,), step_t, device=self.device)
            downs = mid = kv = None
            for cn, p in zip(controlnets, pre):
                d, m, k = cn(x2, t2, cam2, None, None, precomputed=p,
                             conditioning_scale=cond_scale)
                if downs is None:
                    downs, mid, kv = d, m, k
                else:
                    downs = [a + b for a, b in zip(downs, d)]
                    mid = mid + m
            eps = unet(x2.reshape(2 * B * N, 4, lh, lw),
                       t2.repeat_interleave(N), kv,
                       down_block_additional_residuals=downs,
                       mid_block_additional_residual=mid, n_cam=N)
            eps = eps.float().reshape(B, 2, N, 4, lh, lw)
            eps = eps.permute(0, 1, 2, 4, 5, 3)
            eps_u, eps_c = eps[:, 0], eps[:, 1]
            return eps_u + guidance * (eps_c - eps_u)

        if latents is None:
            latents = torch.randn((B, 1, lh, lw, 4), generator=generator,
                                  device=self.device)
        lat0 = latents.to(self.device, torch.float32).expand(
            B, N, lh, lw, 4).contiguous()
        lat = unipc_sample(
            self.schedule, model_fn, lat0,
            num_inference_steps=int(pp.num_inference_steps),
            order=int(pp.get("solver_order", 2)),
            final_sigma=str(pp.get("unipc_final_sigma", "zero")))

        flat = lat.reshape(B * N, lh, lw, 4).permute(0, 3, 1, 2)
        imgs = vae.decode(flat).float().permute(0, 2, 3, 1)
        imgs = (imgs / 2 + 0.5).clamp(0.0, 1.0)
        return imgs.reshape(B, N, *imgs.shape[1:])
