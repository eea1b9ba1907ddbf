"""Generation pipeline: text encode, UniPC or DDIM denoising with CFG over
the ControlNets and the multiview UNet, VAE decode.

Port of ``dualdiff_tpu/pipeline/bev_controlnet.py`` for the image path and
the DualDiff+ clip path, eager (the JAX package jits the call).  Kept from
the JAX pipeline:

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
  chunk may be short), then ``/ 2 + 0.5`` clipped to [0, 1];
* ``scheduler``: ``unipc`` or ``ddim`` (eta 0: the JAX pipeline does not
  read ``pipeline_param.eta``);
* ``cn_cache_interval = k > 1`` (Faster-Diffusion-style ControlNet
  caching): the ControlNets' residuals are computed on the full CFG batch
  at the steps ``i`` with ``i % k == 0`` and reused until the next such
  step; the UNet runs every step.  With ``sequential_cfg`` it raises, as
  in the JAX package;
* given-view pinning (the reference's GivenViewPipeline):
  ``conditional_latents`` (B, N, h, w, 4) and ``conditional_mask`` (B, N)
  set the masked views of every model input to
  ``add_noise(conditional_latents, noise_t, t)``; the sampler's own state
  is not pinned;
* per-call overrides of ``num_inference_steps``, ``guidance_scale``,
  ``scheduler`` and ``conditioning_scale``.

Images are channels-last, ``(B, N, H, W, 3)``; for a clip batch B counts
frames (``collate_video`` flattens clips frame-outer).

Under a ``mesh`` (``parallel/mesh.py``, more than one rank; the sharded
generation of the JAX package's multi-process run) every batch-sized input
of a call is the global batch, which every rank holds: the initial latents
and the given views' noise are drawn for the global batch from the same
generator state, and each rank denoises and returns its own rows
(``mesh.rows``) and, with ``view > 1``, its own cameras of them
(``mesh.cams``; the given views, their masks and their noise are sliced
the same way), as the JAX output stays partitioned over ``(data, view)``.
attn4 then gathers the other cameras of its rows over the view group
(``Mesh.split``).  A clip batch must give each rank whole clips.  The
tools make no such split: the JAX ``val_set_gen`` has none.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from .. import resolve_device
from ..diffusion.samplers import ddim_sample, unipc_sample
from ..diffusion.schedule import DiffusionSchedule
from ..parallel.mesh import Mesh, shard_batch
from ..runner.conds import compute_branch_conds, prepare_batch, to_device

__all__ = ["BEVControlNetPipeline", "SCHEDULERS", "OVERRIDES"]

SCHEDULERS = ("unipc", "ddim")
# what a call may override (the JAX pipeline's ``**overrides``)
OVERRIDES = ("num_inference_steps", "guidance_scale", "scheduler",
             "conditioning_scale")


def _scheduler(name) -> str:
    if str(name) not in SCHEDULERS:
        raise ValueError(f"scheduler {name!r}: one of {SCHEDULERS}")
    return str(name)


class BEVControlNetPipeline:
    def __init__(self, cfg, models: Dict,
                 schedule: Optional[DiffusionSchedule] = None, device=None,
                 mesh: Optional[Mesh] = None):
        """``models``: the ``runner.factory.build_models`` dict with weights
        loaded; the modules are moved to ``device`` and cast to
        ``models["dtype"]`` in place.  ``mesh``: see the module
        docstring."""
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
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
        _scheduler(pp.get("scheduler", "unipc"))
        self.cn_cache_interval = int(pp.get("cn_cache_interval", 0))
        if self.cn_cache_interval > 1 and bool(
                pp.get("sequential_cfg", False)):
            raise ValueError(
                "pipeline_param.cn_cache_interval>1 requires "
                "sequential_cfg=false (the cached CN residuals are computed "
                "on the full CFG batch)")

    def settings(self, overrides: Mapping) -> Dict:
        """(steps, guidance, scheduler, conditioning scale) of a call:
        the config's, or with any override given, the overridden ones."""
        pp = self.cfg.runner.pipeline_param
        unknown = set(overrides) - set(OVERRIDES)
        if unknown:
            raise TypeError(f"unknown overrides {sorted(unknown)}: the "
                            f"pipeline takes {OVERRIDES}")
        out = {"num_inference_steps": int(pp.num_inference_steps),
               "guidance_scale": float(pp.guidance_scale),
               "scheduler": str(pp.get("scheduler", "unipc")),
               "conditioning_scale": float(pp.controlnet_conditioning_scale)}
        if overrides:
            # as the JAX pipeline: an overridden call that does not give
            # conditioning_scale runs at 1.0, not at the config's
            # controlnet_conditioning_scale
            out = {**out, "conditioning_scale": 1.0, **overrides}
        return {"num_inference_steps": int(out["num_inference_steps"]),
                "guidance_scale": float(out["guidance_scale"]),
                "scheduler": _scheduler(out["scheduler"]),
                "conditioning_scale": float(out["conditioning_scale"])}

    @torch.no_grad()
    def __call__(self, batch: Dict,
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None,
                 conditional_latents: Optional[torch.Tensor] = None,
                 conditional_mask: Optional[torch.Tensor] = None,
                 pin_noise: Optional[Mapping[int, torch.Tensor]] = None,
                 **overrides) -> torch.Tensor:
        """batch: collate output (or its ``prepare_batch`` tensors).
        ``latents``: initial noise (B, 1 or N, h, w, 4), float32; drawn from
        ``generator`` when not given.  ``conditional_latents`` (B, N, h, w,
        4) and ``conditional_mask`` (B, N): given-view pinning; the noise of
        the pinned views at timestep ``t`` is ``pin_noise[t]`` when given,
        else a draw from ``generator`` each step.  ``overrides``: any of
        ``OVERRIDES``.  -> images (B, N, H, W, 3) in [0, 1], float32; under
        a mesh, this rank's rows (and cameras) of the global batch B."""
        models, cfg = self.models, self.cfg
        pp = cfg.runner.pipeline_param
        unet, controlnets = models["unet"], models["controlnets"]
        vae, text_encoder = models["vae"], models["text_encoder"]
        mesh = self.mesh
        t = batch
        if "branches" in batch:
            t = prepare_batch(batch, self.device if mesh is None else "cpu")
        # the global batch's size and this rank's rows (and cameras) of it,
        # for the draws
        B_all, N_all = (int(x) for x in t["camera_param"].shape[:2])
        own = views = slice(None)
        if mesh is not None:
            own = mesh.rows(B_all)
            views = (own, mesh.cams(N_all))
            t = to_device(shard_batch(t, mesh, N_all), self.device)
            if latents is not None:  # one noise a sample, or one a camera
                latents = latents[own if latents.shape[1] == 1 else views]
            conditional_latents, conditional_mask = (
                None if a is None else a[views]
                for a in (conditional_latents, conditional_mask))
            if pin_noise is not None:
                pin_noise = {k: v[views] for k, v in pin_noise.items()}
        cam = t["camera_param"]
        B, N = cam.shape[:2]
        lh, lw = self.latent_hw
        run = self.settings(overrides)
        guidance, cond_scale = run["guidance_scale"], run["conditioning_scale"]

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
        split = None if mesh is None else mesh.split(N_all, B,
                                                     unet.num_frames)
        view0 = 0 if split is None else split.view0
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
                          latent_hw=self.latent_hw, view0=view0))
        cam2 = cfg2(cam, cam)

        def run_cns(xb, step_t, cam_b, pre_b):
            """The ControlNets' summed residuals on (nb, N, 4, h, w) ->
            (downs, mid, the UNet's context tokens)."""
            tb = torch.full((xb.shape[0],), step_t, device=self.device)
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
            return downs, mid, kv

        def run_unet(xb, step_t, residuals):
            """The UNet on (nb, N, 4, h, w) with the ControlNets' residuals
            -> eps, float32."""
            nb = xb.shape[0]
            downs, mid, kv = residuals
            tb = torch.full((nb * N,), step_t, device=self.device)
            eps = unet(xb.reshape(nb * N, 4, lh, lw), tb, kv,
                       down_block_additional_residuals=downs,
                       mid_block_additional_residual=mid,
                       n_cam=N if split is None else split)
            return eps.float().reshape(nb, N, 4, lh, lw)

        # x: (B, N, h, w, 4) float32; the networks take per-view NCHW.
        # fn is the sampler's stateful form, (x, t, i, state) -> (eps,
        # state); the state holds the last refresh's ControlNet residuals
        # and nothing else, so the old set is let go before the new one is
        # computed
        to_nchw = lambda a: a.permute(0, 1, 4, 2, 3)
        guide = lambda eps_u, eps_c: (eps_u + guidance * (eps_c - eps_u)) \
            .permute(0, 1, 3, 4, 2)
        if bool(pp.get("sequential_cfg", False)):
            cam_h = halves(cam2)
            pre_h = [{k: halves(v) for k, v in p.items()} for p in pre]

            def fn(x, step_t, i, state):
                """Uncond half, then cond half (no cache: refused above)."""
                eps = []
                for j in (0, 1):
                    pre_j = [{k: v[j] for k, v in p.items()} for p in pre_h]
                    xb = to_nchw(x)
                    eps.append(run_unet(xb, step_t,
                                        run_cns(xb, step_t, cam_h[j], pre_j)))
                return guide(*eps), state
        else:
            every = max(self.cn_cache_interval, 1)

            def fn(x, step_t, i, cache):
                """The full CFG batch; the ControlNets at the steps ``i``
                with ``i % cn_cache_interval == 0`` (every step without the
                cache)."""
                x2 = to_nchw(cfg2(x, x))
                if i % every == 0:
                    cache["residuals"] = None
                    cache["residuals"] = run_cns(x2, step_t, cam2, pre)
                return guide(*halves(run_unet(x2, step_t,
                                              cache["residuals"]))), cache
        state0 = {"residuals": None}

        if latents is None:
            latents = torch.randn((B_all, 1, lh, lw, 4), generator=generator,
                                  device=self.device)[own]
        lat0 = latents.to(self.device, torch.float32).expand(
            B, N, lh, lw, 4).contiguous()
        if conditional_latents is not None and conditional_mask is not None:
            gt = conditional_latents.to(self.device, torch.float32)
            mask = conditional_mask.to(self.device, torch.float32).reshape(
                B, N, 1, 1, 1)
            base_fn = fn

            def fn(x, step_t, i, state):
                """The model input with the given views pinned to their
                latents noised to ``step_t``."""
                noise = pin_noise[step_t] if pin_noise is not None else \
                    torch.randn((B_all, N_all, *gt.shape[2:]),
                                generator=generator,
                                device=self.device)[views]
                gt_t = self.schedule.add_noise(gt, noise.to(gt.device),
                                               torch.full((B,), step_t,
                                                          device=self.device))
                return base_fn(x * (1 - mask) + gt_t * mask, step_t, i, state)

        steps = run["num_inference_steps"]
        if run["scheduler"] == "ddim":
            lat = ddim_sample(self.schedule, fn, lat0,
                              num_inference_steps=steps, model_state0=state0)
        else:
            lat = unipc_sample(
                self.schedule, fn, lat0, num_inference_steps=steps,
                order=int(pp.get("solver_order", 2)),
                final_sigma=str(pp.get("unipc_final_sigma", "zero")),
                model_state0=state0)
        del state0  # the cached residuals go before the decode

        flat = lat.reshape(B * N, lh, lw, 4).permute(0, 3, 1, 2)
        chunk = int(pp.get("vae_slicing", 0))
        imgs = torch.cat([vae.decode(c) for c in flat.split(chunk)]) \
            if chunk else vae.decode(flat)
        imgs = imgs.float().permute(0, 2, 3, 1)
        imgs = (imgs / 2 + 0.5).clamp(0.0, 1.0)
        return imgs.reshape(B, N, *imgs.shape[1:])
