"""Generation pipeline: text encode, UniPC denoising with CFG over the
ControlNets and the multiview UNet, VAE decode.

Port of ``dualdiff_tpu/pipeline/bev_controlnet.py`` for the image path and
the DualDiff+ clip path (no ControlNet caching, given-view pinning or DDIM
yet).  Kept from the JAX pipeline:

* weights cast to the compute dtype (bf16 by default);
* the CFG batch layout.  Images: rows interleaved per sample, (uncond, cond)
  at (2i, 2i+1).  Clips (``unet.num_frames > 1``): the uncond and cond halves
  are contiguous half-blocks, so each half is an ordered clip that the
  UNet's ST-Attn and temporal attention fold as (clip, frame, camera);
  interleaving would mix uncond and cond rows in one temporal window.
  Uncond rows take the learned uncond camera, the null text and all-null
  box tokens and share the conditioning image;
* ``sequential_cfg``: the uncond half and the cond half are evaluated one
  after the other (half the activation peak).  Clips split into contiguous
  halves; images split by CFG pair, also for the per-view ``(2B*N, ...)``
  precomputed tensors, so no half takes another row's conditioning;
* step-constant conditioning (embedders, SFA fusion, context tokens, the
  camera token of ``use_cam_in_temb``) is computed once, outside the
  denoising loop;
* the ControlNets' residuals are summed, and the first ControlNet's context
  tokens are the UNet's cross-attention KV;
* one initial noise map per sample (per frame for clips) shared by every
  view;
* decode, in chunks of ``vae_slicing`` images when it is set (the last
  chunk may be short), then ``/ 2 + 0.5`` clipped to [0, 1].

Images are channels-last, ``(B, N, H, W, 3)``; for a clip batch B counts
frames (``collate_video`` flattens clips frame-outer).
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
        if int(pp.get("cn_cache_interval", 0)) > 1:
            raise NotImplementedError(
                "pipeline_param.cn_cache_interval is not ported")
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

        video = unet.num_frames > 1
        if video and B % unet.num_frames:
            raise ValueError(f"{B} frames are not whole clips of "
                             f"{unet.num_frames}")
        if video:
            def cfg2(u, c):  # contiguous [uncond; cond] half-blocks
                return torch.cat([u, c])

            def halves(a):
                return a.chunk(2)
        else:
            def cfg2(u, c):  # interleave (uncond, cond) per sample
                return torch.stack([u, c], dim=1).reshape(2 * B,
                                                          *u.shape[1:])

            def halves(a):
                # by CFG pair: leading dim 2B, or 2B*N for per-view tensors
                e = a.reshape(B, 2, -1, *a.shape[1:])
                return [e[:, i].reshape(-1, *a.shape[1:]) for i in (0, 1)]

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
                          uncond_switch=switch, precompute_only=True,
                          latent_hw=self.latent_hw))
        cam2 = cfg2(cam, cam)

        def evaluate(xb, step_t, cam_b, pre_b):
            """ControlNets + UNet on (nb, N, 4, h, w) -> eps, float32."""
            nb = xb.shape[0]
            tb = torch.full((nb,), step_t, device=self.device)
            downs = mid = kv = None
            for cn, p in zip(controlnets, pre_b):
                # the text only gives the box adapter its context length
                d, m, k = cn(xb, tb, cam_b, text, None, precomputed=p,
                             conditioning_scale=cond_scale)
                if downs is None:
                    downs, mid, kv = d, m, k
                else:
                    downs = [a + b for a, b in zip(downs, d)]
                    mid = mid + m
            eps = unet(xb.reshape(nb * N, 4, lh, lw),
                       tb.repeat_interleave(N), kv,
                       down_block_additional_residuals=downs,
                       mid_block_additional_residual=mid, n_cam=N)
            return eps.float().reshape(nb, N, 4, lh, lw)

        # x: (B, N, h, w, 4) float32; the networks take per-view NCHW
        to_nchw = lambda a: a.permute(0, 1, 4, 2, 3)
        if bool(pp.get("sequential_cfg", False)):
            cam_h = halves(cam2)
            pre_h = [{k: halves(v) for k, v in p.items()} for p in pre]

            def guided_eps(x, step_t):
                eps_u, eps_c = (
                    evaluate(to_nchw(x), step_t, cam_h[i],
                             [{k: v[i] for k, v in p.items()}
                              for p in pre_h]) for i in (0, 1))
                return eps_u + guidance * (eps_c - eps_u)
        else:
            def guided_eps(x, step_t):
                eps_u, eps_c = halves(evaluate(to_nchw(cfg2(x, x)), step_t,
                                               cam2, pre))
                return eps_u + guidance * (eps_c - eps_u)

        def model_fn(x: torch.Tensor, step_t: int) -> torch.Tensor:
            return guided_eps(x, step_t).permute(0, 1, 3, 4, 2)

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
        chunk = int(pp.get("vae_slicing", 0))
        imgs = torch.cat([vae.decode(c) for c in flat.split(chunk)]) \
            if chunk else vae.decode(flat)
        imgs = imgs.float().permute(0, 2, 3, 1)
        imgs = (imgs / 2 + 0.5).clamp(0.0, 1.0)
        return imgs.reshape(B, N, *imgs.shape[1:])
