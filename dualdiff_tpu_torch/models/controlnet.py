"""BEV ControlNet branch, PyTorch.

Port of ``dualdiff_tpu/models/controlnet.py``: a copy of the SD UNet
encoder with zero-conv output heads, plus the camera token, the
``[cam | text | boxes]`` context assembly, the CFG uncond switch, the
occupancy-image or raw ORS-ray conditioning and SFA / SFA+ fusion.  With
``remat`` the encoder's down and mid blocks are rematerialised in the
backward as in the UNet (``enable_controlnet_checkpointing``).

``precompute_only=True`` returns the step-constant tensors (conditioning
feature map and context tokens); passing them back as ``precomputed`` runs
only the per-step work (time tower, encoder blocks, zero convs), which is how
the pipeline hoists conditioning out of the denoising loop.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from .embedders import (BBoxEmbedder, OccImageConditionEmbedder, SFATxtCon,
                        SFATxtConPlus, embed_camera_param)
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
                 conditioning_embedding_out_channels: Sequence[int] = (
                     16, 32, 96, 256),
                 n_cam: int = 6, use_txt_con_fusion: bool = False,
                 use_txt_con_fusionp: bool = False,
                 bbox_mode: str = "all-xyz",
                 bbox_num_points: Optional[int] = None,
                 bbox_n_classes: int = 10,
                 bbox_proj_dims: Sequence[int] = (768, 512, 512, 768),
                 bbox_class_token_dim: int = 768, remat: bool = False,
                 remat_min_tokens: int = 0):
        super().__init__()
        self.remat = remat
        self.remat_min_tokens = remat_min_tokens
        if cond_embedder not in ("occ_image", "occ_3d"):
            raise NotImplementedError(
                f"cond_embedder={cond_embedder!r} is not ported")
        chs = list(block_out_channels)
        self.block_out_channels = tuple(chs)
        self.cond_embedder = cond_embedder
        self.cam_num_freqs = cam_num_freqs
        self.uncond_cam_in_dim = tuple(uncond_cam_in_dim)
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
            num_points=bbox_num_points)
        self.controlnet_cond_embedding = OccImageConditionEmbedder(
            chs[0], conditioning_embedding_out_channels, n_cam) \
            if cond_embedder == "occ_image" else None
        # SFA and SFA+ keep their own 8 heads whatever the UNet's head count
        self.txt_con_fusion = SFATxtCon(chs[0], cross_attention_dim) \
            if use_txt_con_fusion else None
        self.txt_con_fusionp = SFATxtConPlus(chs[0], cross_attention_dim) \
            if use_txt_con_fusionp else None

        self.time_embedding = TimestepEmbedding(chs[0], temb)
        self.conv_in = Conv2d(in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        zero_chs = [chs[0]]
        prev = chs[0]
        for i, ch in enumerate(chs):
            if i < len(chs) - 1:
                self.down_blocks.append(CrossAttnDownBlock2D(
                    prev, ch, temb, layers_per_block, True, heads,
                    cross_attention_dim))
                zero_chs += [ch] * (layers_per_block + 1)
            else:
                self.down_blocks.append(DownBlock2D(prev, ch, temb,
                                                    layers_per_block))
                zero_chs += [ch] * layers_per_block
            prev = ch
        self.mid_block = UNetMidBlock2DCrossAttn(
            chs[-1], temb, heads, cross_attention_dim)
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
                precompute_only: bool = False):
        """sample (B, N, 4, h, w) noisy latents; timesteps (B,) or (B, N);
        camera_param (B, N, 3, 7); encoder_hidden_states (B, L, D) or
        (B, N, L, D); controlnet_cond: occ panorama (B, H, 6W, 3) or ORS rays
        (B, N, h, w, 320) channels-last.

        -> (down residuals, mid residual, UNet context tokens), or with
        ``precompute_only`` {"cond": (B*N, C0, h, w), "kv": (B*N, L', D)}."""
        B, N = camera_param.shape[:2]
        if precomputed is not None:
            return self._encode(sample, timesteps, precomputed["kv"],
                                precomputed["cond"], B, N,
                                conditioning_scale, guess_mode)

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
            emb = self.bbox_embedder(
                bb.reshape(B * n_box, *bb.shape[2:]),
                bboxes_3d["classes"].reshape(B * n_box, -1),
                bboxes_3d["masks"].reshape(B * n_box, -1))
            emb = emb.reshape(B, n_box, *emb.shape[1:])
            if n_box != N:  # view-shared boxes: repeat per camera
                emb = emb.expand(B, N, *emb.shape[2:])
            kv = torch.cat([states, emb.reshape(B * N, *emb.shape[2:])
                            .to(states.dtype)], dim=1)

        if self.cond_embedder == "occ_image":
            cond = self.controlnet_cond_embedding(controlnet_cond)
        else:  # raw ORS rays: the ray-depth axis is the channel axis
            cond = controlnet_cond.reshape(
                B * N, *controlnet_cond.shape[-3:]).permute(0, 3, 1, 2)
            cond = cond.to(self.conv_in.weight.dtype)
        if self.txt_con_fusion is not None:
            cond = self.txt_con_fusion(cond, states[:, 1:])
        if self.txt_con_fusionp is not None:
            cond = self.txt_con_fusionp(cond, states[:, 1:])
        if precompute_only:
            return {"cond": cond, "kv": kv}
        return self._encode(sample, timesteps, kv, cond, B, N,
                            conditioning_scale, guess_mode)

    def _encode(self, sample, timesteps, kv, cond, B, N, conditioning_scale,
                guess_mode):
        """Time tower + conv_in + encoder blocks + zero-conv heads: the
        per-step work."""
        chs = self.block_out_channels
        emb = self.time_embedding(
            get_timestep_embedding(timesteps.reshape(-1), chs[0]))
        if emb.shape[0] < B * N:
            emb = emb.repeat_interleave(N, dim=0)
        x = self.conv_in(sample.reshape(B * N, *sample.shape[2:])) + cond
        run = lambda block, *a: remat_call(self.remat, self.remat_min_tokens,
                                           block, *a)
        res_stack = [x]
        for block in self.down_blocks:
            if isinstance(block, CrossAttnDownBlock2D):
                x, res = run(block, x, emb, kv)
            else:
                x, res = run(block, x, emb)
            res_stack += res
        x = run(self.mid_block, x, emb, kv)

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
