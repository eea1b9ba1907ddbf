"""BEV ControlNet branch, PyTorch.

Port of ``dualdiff_tpu/models/controlnet.py``: a copy of the SD UNet
encoder with zero-conv output heads, plus the camera token, the
``[cam | text | boxes]`` context assembly, the CFG uncond switch, the BEV-map
(``+exp=224x400``), occupancy-image or raw ORS-ray conditioning and SFA /
SFA+ fusion.  With ``remat`` the encoder's down and mid blocks are
rematerialised in the backward as in the UNet
(``enable_controlnet_checkpointing``).

* ``use_cam_in_temb``: the conditional camera token (also on rows where the
  CFG switch takes the uncond camera into the context, as in the JAX
  package) and the time embedding, concatenated, go through ``adm_proj_0``,
  SiLU and ``adm_proj_2``, whose output replaces the time embedding.
* ``use_box_adapter``: the encoder blocks' attn2 carry the decoupled box
  cross-attention over K/V ``[cam + text | boxes | box classes]``; the
  context tokens returned to the UNet drop the class tokens.  The split
  needs the context length ``n_ctx = 1 + text length``, which the
  per-step call reads from its ``encoder_hidden_states``' shape.

``precompute_only=True`` returns the step-constant tensors (conditioning
feature map, context tokens and, with ``use_cam_in_temb``, the camera
token); passing them back as ``precomputed`` runs only the per-step work
(time tower, encoder blocks, zero convs), which is how the pipeline hoists
conditioning out of the denoising loop.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .embedders import (BBoxEmbedder, BEVMapConditionEmbedder,
                        OccImageConditionEmbedder, SFATxtCon, SFATxtConPlus,
                        embed_camera_param)
from .layers import (Conv2d, Linear, TimestepEmbedding,
                     get_timestep_embedding, remat_call, zero_module)
from .unet import CrossAttnDownBlock2D, DownBlock2D, UNetMidBlock2DCrossAttn

__all__ = ["BEVControlNet"]


class BEVControlNet(nn.Module):
    def __init__(self, in_channels: int = 4,
                 block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, heads: int = 8,
                 cross_attention_dim: int = 768, camera_out_dim: int = 768,
                 uncond_cam_in_dim: Tuple[int, int] = (3, 7),
                 cam_num_freqs: int = 4, cond_embedder: str = "occ_image",
                 map_channels: int = 8,
                 conditioning_embedding_out_channels: Sequence[int] = (
                     16, 32, 96, 256),
                 n_cam: int = 6, use_txt_con_fusion: bool = False,
                 use_txt_con_fusionp: bool = False,
                 use_cam_in_temb: bool = False,
                 bbox_mode: str = "all-xyz",
                 bbox_num_points: Optional[int] = None,
                 bbox_n_classes: int = 10,
                 bbox_minmax_normalize: bool = False,
                 bbox_proj_dims: Sequence[int] = (768, 512, 512, 768),
                 bbox_class_token_dim: int = 768,
                 use_box_adapter: bool = False, remat: bool = False,
                 remat_min_tokens: int = 0):
        super().__init__()
        self.remat = remat
        self.remat_min_tokens = remat_min_tokens
        if cond_embedder not in ("bev_map", "occ_image", "occ_3d"):
            raise ValueError(f"cond_embedder={cond_embedder!r}")
        chs = list(block_out_channels)
        self.block_out_channels = tuple(chs)
        self.cond_embedder = cond_embedder
        self.cam_num_freqs = cam_num_freqs
        self.uncond_cam_in_dim = tuple(uncond_cam_in_dim)
        self.use_box_adapter = use_box_adapter
        temb = chs[0] * 4

        self.cam2token = Linear(3 * (1 + 2 * cam_num_freqs) * 7,
                                camera_out_dim)
        # learned unconditional camera parameters (diffusers keeps it as an
        # embedding table of one row)
        self.uncond_cam = nn.Embedding(
            1, uncond_cam_in_dim[0] * uncond_cam_in_dim[1])
        self.bbox_embedder = BBoxEmbedder(
            n_classes=bbox_n_classes, class_token_dim=bbox_class_token_dim,
            proj_dims=bbox_proj_dims, mode=bbox_mode,
            num_points=bbox_num_points,
            minmax_normalize=bbox_minmax_normalize)
        if cond_embedder == "occ_image":
            self.controlnet_cond_embedding = OccImageConditionEmbedder(
                chs[0], conditioning_embedding_out_channels, n_cam)
        elif cond_embedder == "bev_map":
            self.controlnet_cond_embedding = BEVMapConditionEmbedder(
                chs[0], conditioning_embedding_out_channels, n_cam,
                map_channels)
        else:
            self.controlnet_cond_embedding = None
        # SFA and SFA+ keep their own 8 heads whatever the UNet's head count
        self.txt_con_fusion = SFATxtCon(chs[0], cross_attention_dim) \
            if use_txt_con_fusion else None
        self.txt_con_fusionp = SFATxtConPlus(chs[0], cross_attention_dim) \
            if use_txt_con_fusionp else None

        self.time_embedding = TimestepEmbedding(chs[0], temb)
        if use_cam_in_temb:  # the JAX exporter's flat names
            self.adm_proj_0 = Linear(camera_out_dim + temb, temb)
            self.adm_proj_2 = Linear(temb, temb)
        self.use_cam_in_temb = use_cam_in_temb
        self.conv_in = Conv2d(in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        zero_chs = [chs[0]]
        prev = chs[0]
        for i, ch in enumerate(chs):
            if i < len(chs) - 1:
                self.down_blocks.append(CrossAttnDownBlock2D(
                    prev, ch, temb, layers_per_block, True, heads,
                    cross_attention_dim, box_adapter=use_box_adapter))
                zero_chs += [ch] * (layers_per_block + 1)
            else:
                self.down_blocks.append(DownBlock2D(prev, ch, temb,
                                                    layers_per_block))
                zero_chs += [ch] * layers_per_block
            prev = ch
        self.mid_block = UNetMidBlock2DCrossAttn(
            chs[-1], temb, heads, cross_attention_dim,
            box_adapter=use_box_adapter)
        self.controlnet_down_blocks = nn.ModuleList([
            zero_module(Conv2d(c, c, 1)) for c in zero_chs])
        self.controlnet_mid_block = zero_module(Conv2d(chs[-1], chs[-1], 1))

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                camera_param: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                controlnet_cond: Optional[torch.Tensor],
                bboxes_3d: Optional[Dict[str, torch.Tensor]] = None,
                encoder_hidden_states_uncond: Optional[torch.Tensor] = None,
                uncond_switch: Optional[torch.Tensor] = None,
                conditioning_scale: float = 1.0, guess_mode: bool = False,
                precomputed: Optional[Dict[str, torch.Tensor]] = None,
                precompute_only: bool = False,
                latent_hw: Optional[Tuple[int, int]] = None,
                view0: int = 0):
        """sample (B, N, 4, h, w) noisy latents; timesteps (B,) or (B, N);
        camera_param (B, N, 3, 7); encoder_hidden_states (B, L, D) or
        (B, N, L, D); controlnet_cond: BEV map (B, 200, 200, 8), occ
        panorama (B, H, 6W, 3) or ORS rays (B, N, h, w, 320), channels-last.

        -> (down residuals, mid residual, UNet context tokens), or with
        ``precompute_only`` {"cond": (B*N, C0, h, w), "kv": (B*N, L', D)}
        and, with ``use_cam_in_temb``, "cam_tok" (B*N, D).  ``latent_hw``:
        the BEV-map embedder's output size where ``sample`` is None (a
        precompute).  With ``precomputed`` only ``encoder_hidden_states``'
        length is read (the box adapter's split); without the adapter it
        may be None.  ``view0``: under a view split, the global index of
        this rank's first camera (its ``N`` cameras' slice of the
        panorama)."""
        B, N = camera_param.shape[:2]
        if precomputed is not None:
            n_ctx = None if encoder_hidden_states is None \
                else 1 + encoder_hidden_states.shape[-2]
            return self._encode(sample, timesteps, precomputed["kv"],
                                precomputed["cond"], B, N,
                                conditioning_scale, guess_mode,
                                precomputed.get("cam_tok"), n_ctx)

        cam_tok = self.cam2token(
            embed_camera_param(camera_param, self.cam_num_freqs))  # (B,N,D)
        if encoder_hidden_states.dim() == 3:
            text = encoder_hidden_states[:, None].expand(
                B, N, *encoder_hidden_states.shape[1:])
        else:  # per-view captions
            text = encoder_hidden_states
        with_cam = torch.cat([cam_tok[:, :, None].to(text.dtype), text],
                             dim=2)  # (B, N, L+1, D)

        # CFG: rows with uncond_switch == 1 take the learned uncond camera
        # and the null text
        if uncond_switch is not None and \
                encoder_hidden_states_uncond is not None:
            ucp = self.uncond_cam.weight.reshape(1, 1,
                                                 *self.uncond_cam_in_dim)
            ucam_tok = self.cam2token(
                embed_camera_param(ucp, self.cam_num_freqs))
            utext = encoder_hidden_states_uncond[:, None]  # (1, 1, L, D)
            uncond_with_cam = torch.cat(
                [ucam_tok[:, :, None].to(utext.dtype), utext], dim=2)
            sw = uncond_switch[..., None, None].to(with_cam.dtype)
            with_cam = with_cam * (1.0 - sw) + uncond_with_cam * sw

        states = with_cam.reshape(B * N, *with_cam.shape[2:])
        kv = states
        if bboxes_3d is not None:
            bb = bboxes_3d["bboxes"]  # (B, N or 1, M, P, 3)
            n_box = bb.shape[1]
            toks = self.bbox_embedder(
                bb.reshape(B * n_box, *bb.shape[2:]),
                bboxes_3d["classes"].reshape(B * n_box, -1),
                bboxes_3d["masks"].reshape(B * n_box, -1),
                return_cls=self.use_box_adapter)
            # [box tokens] or, for the adapter, [box tokens | class tokens]
            for emb in toks if self.use_box_adapter else (toks,):
                emb = emb.reshape(B, n_box, *emb.shape[1:])
                if n_box != N:  # view-shared boxes: repeat per camera
                    emb = emb.expand(B, N, *emb.shape[2:])
                kv = torch.cat([kv, emb.reshape(B * N, *emb.shape[2:])
                                .to(states.dtype)], dim=1)

        if self.cond_embedder == "occ_image":
            cond = self.controlnet_cond_embedding(controlnet_cond, view0, N)
        elif self.cond_embedder == "bev_map":
            cond = self.controlnet_cond_embedding(
                controlnet_cond, latent_hw if sample is None
                else tuple(sample.shape[-2:]), N)
        else:  # raw ORS rays: the ray-depth axis is the channel axis
            cond = controlnet_cond.reshape(
                B * N, *controlnet_cond.shape[-3:]).permute(0, 3, 1, 2)
            cond = cond.to(self.conv_in.weight.dtype)
        if self.txt_con_fusion is not None:
            cond = self.txt_con_fusion(cond, states[:, 1:])
        if self.txt_con_fusionp is not None:
            cond = self.txt_con_fusionp(cond, states[:, 1:])
        # the conditional camera token, whatever the CFG switch chose
        cam_flat = cam_tok.reshape(B * N, -1) if self.use_cam_in_temb \
            else None
        if precompute_only:
            out = {"cond": cond, "kv": kv}
            if cam_flat is not None:
                out["cam_tok"] = cam_flat
            return out
        return self._encode(sample, timesteps, kv, cond, B, N,
                            conditioning_scale, guess_mode, cam_flat,
                            states.shape[1])

    def _encode(self, sample, timesteps, kv, cond, B, N, conditioning_scale,
                guess_mode, cam_tok=None, n_ctx=None):
        """Time tower + conv_in + encoder blocks + zero-conv heads: the
        per-step work.  ``kv``: the context tokens, with the box adapter
        ``[cam + text (n_ctx) | boxes | classes]``."""
        chs = self.block_out_channels
        n_box = 0
        if self.use_box_adapter:
            if n_ctx is None:
                raise ValueError("the box adapter needs the context length: "
                                 "pass encoder_hidden_states")
            n_box = (kv.shape[1] - n_ctx) // 2
        emb = self.time_embedding(
            get_timestep_embedding(timesteps.reshape(-1), chs[0]))
        if emb.shape[0] < B * N:
            emb = emb.repeat_interleave(N, dim=0)
        if self.use_cam_in_temb and cam_tok is not None:
            z = torch.cat([cam_tok.to(emb.dtype), emb], dim=-1)
            emb = self.adm_proj_2(F.silu(self.adm_proj_0(z)))
        x = self.conv_in(sample.reshape(B * N, *sample.shape[2:])) + cond
        run = lambda block, *a: remat_call(self.remat, self.remat_min_tokens,
                                           block, *a)
        res_stack = [x]
        for block in self.down_blocks:
            if isinstance(block, CrossAttnDownBlock2D):
                x, res = run(block, x, emb, kv, 1, n_box)
            else:
                x, res = run(block, x, emb)
            res_stack += res
        x = run(self.mid_block, x, emb, kv, 1, n_box)
        if n_box:  # the UNet's context drops the class tokens
            kv = kv[:, :kv.shape[1] - n_box]

        downs = [conv(r) for conv, r in
                 zip(self.controlnet_down_blocks, res_stack)]
        mid = self.controlnet_mid_block(x)
        if guess_mode:
            scales = torch.logspace(-1.0, 0.0, len(downs) + 1).tolist()
            downs = [d * (s * conditioning_scale)
                     for d, s in zip(downs, scales[:-1])]
            mid = mid * (scales[-1] * conditioning_scale)
        else:
            downs = [d * conditioning_scale for d in downs]
            mid = mid * conditioning_scale
        return downs, mid, kv
