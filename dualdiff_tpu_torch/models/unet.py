"""SD v1.5 conditional UNet with multiview attention, PyTorch.

Port of ``dualdiff_tpu/models/unet.py``.  Every transformer block carries
attn4 in one of the JAX package's forms (``add`` over the neighbour pairs,
the camera ring on its own kernel; ``concat``; ``self``) with its
connector (``zero_linear``, ``gated`` or ``none``); ControlNet residuals
are added to the skip connections and the mid block.  With ``remat`` each
down, mid and up block whose input has at least ``remat_min_tokens``
spatial tokens is rematerialised in the backward
(``enable_unet_checkpointing``).  NCHW; the
leading batch dim folds (batch, camera), or (clip, frame, camera) for the
video UNet (DualDiff+: ST-Attn and temporal attention in every transformer
block).  Under ``layers.capture`` it records each block's output, as the
JAX UNet's ``sow`` calls: ``down_block_<i>_out`` (before the ControlNet
residuals), ``mid_block_out`` (after its residual) and ``up_block_<i>_out``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (Conv2d, Downsample2D, ResnetBlock2D, TimestepEmbedding,
                     Transformer2DModel, Upsample2D, get_timestep_embedding,
                     record, remat_call)
from .norms import GroupNorm

__all__ = ["UNet2DConditionMultiview", "CrossAttnDownBlock2D", "DownBlock2D",
           "UNetMidBlock2DCrossAttn", "NEW_PARAM_MARKERS",
           "is_new_multiview_param"]

# parameter-name parts introduced by the multiview / video surgery: the UNet
# leaves trained under trainable_state='only_new'
NEW_PARAM_MARKERS = ("attn4", "norm4", "connector", "temporal",
                     "attn_temporal", "lora")


def is_new_multiview_param(name: str) -> bool:
    """True for a UNet parameter (``state_dict`` name) of the multiview /
    video surgery (the JAX package's ``is_new_multiview_param``)."""
    return any(m in part for part in name.split(".")
               for m in NEW_PARAM_MARKERS)


class CrossAttnDownBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 num_layers: int = 2, add_downsample: bool = True,
                 heads: int = 8, cross_attention_dim: int = 768,
                 multiview: bool = False, st_attn: bool = False,
                 temporal: bool = False, num_frames: int = 1,
                 lora_rank: int = 0, box_adapter: bool = False, **attn4):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, temb_dim) for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(out_channels, heads, cross_attention_dim,
                               multiview=multiview, st_attn=st_attn,
                               temporal=temporal, num_frames=num_frames,
                               lora_rank=lora_rank, box_adapter=box_adapter,
                               **attn4)
            for _ in range(num_layers)])
        self.downsamplers = (nn.ModuleList([Downsample2D(out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, encoder_hidden_states, n_cam=1,
                num_box_tokens: int = 0):
        res = []
        for resnet, attn in zip(self.resnets, self.attentions):
            x = attn(resnet(x, temb), encoder_hidden_states, n_cam,
                     num_box_tokens)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            res.append(x)
        return x, res


class DownBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 num_layers: int = 2):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, temb_dim) for i in range(num_layers)])

    def forward(self, x, temb):
        res = []
        for resnet in self.resnets:
            x = resnet(x, temb)
            res.append(x)
        return x, res


class UNetMidBlock2DCrossAttn(nn.Module):
    def __init__(self, channels: int, temb_dim: int, heads: int = 8,
                 cross_attention_dim: int = 768, multiview: bool = False,
                 st_attn: bool = False, temporal: bool = False,
                 num_frames: int = 1, lora_rank: int = 0,
                 box_adapter: bool = False, **attn4):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, temb_dim) for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(channels, heads, cross_attention_dim,
                               multiview=multiview, st_attn=st_attn,
                               temporal=temporal, num_frames=num_frames,
                               lora_rank=lora_rank, box_adapter=box_adapter,
                               **attn4)])

    def forward(self, x, temb, encoder_hidden_states, n_cam=1,
                num_box_tokens: int = 0):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, encoder_hidden_states, n_cam,
                               num_box_tokens)
        return self.resnets[1](x, temb)


class UpBlock(nn.Module):
    """``UpBlock2D`` (no attentions) and ``CrossAttnUpBlock2D``."""

    def __init__(self, in_channels: int, out_channels: int,
                 skip_channels: Sequence[int], temb_dim: int,
                 add_upsample: bool, cross_attn: bool, heads: int = 8,
                 cross_attention_dim: int = 768, multiview: bool = False,
                 st_attn: bool = False, temporal: bool = False,
                 num_frames: int = 1, lora_rank: int = 0, **attn4):
        super().__init__()
        chans = [in_channels] + [out_channels] * (len(skip_channels) - 1)
        self.resnets = nn.ModuleList([
            ResnetBlock2D(c + s, out_channels, temb_dim)
            for c, s in zip(chans, skip_channels)])
        self.attentions = nn.ModuleList([
            Transformer2DModel(out_channels, heads, cross_attention_dim,
                               multiview=multiview, st_attn=st_attn,
                               temporal=temporal, num_frames=num_frames,
                               lora_rank=lora_rank, **attn4)
            for _ in skip_channels]) if cross_attn else None
        self.upsamplers = (nn.ModuleList([Upsample2D(out_channels)])
                           if add_upsample else None)

    def forward(self, x, skips, temb, encoder_hidden_states=None,
                n_cam=1, upsample_target=None):
        for i, skip in enumerate(skips):
            x = self.resnets[i](torch.cat([x, skip], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x, encoder_hidden_states, n_cam)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, upsample_target)
        return x


class UNet2DConditionMultiview(nn.Module):
    def __init__(self, in_channels: int = 4, out_channels: int = 4,
                 block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, heads: int = 8,
                 cross_attention_dim: int = 768, multiview: bool = True,
                 neighboring_view_pair: Optional[Sequence[Sequence[int]]] = (
                     (5, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 0)),
                 neighboring_attn_type: str = "add",
                 zero_module_type: str = "zero_linear",
                 st_attn: bool = False, temporal: bool = False,
                 num_frames: int = 1, lora_rank: int = 0,
                 remat: bool = False, remat_min_tokens: int = 0):
        """attn4: ``neighboring_attn_type`` (``add`` over
        ``neighboring_view_pair``, ``concat`` or ``self``) with the
        ``zero_module_type`` connector (``BasicTransformerBlock``).
        ``st_attn``, ``temporal`` and ``num_frames``: the
        video hooks of every transformer block (``BasicTransformerBlock``);
        the batch then folds (clip, frame, camera), frame outer.
        ``lora_rank``: LoRA adapters on every block's attn1 and attn2 (RGD
        stage 2)."""
        super().__init__()
        self._capture = None
        self.num_frames = num_frames
        self.remat = remat
        self.remat_min_tokens = remat_min_tokens
        chs = list(block_out_channels)
        self.block_out_channels = tuple(chs)
        self.neighboring_view_pair = neighboring_view_pair
        self.multiview = multiview
        temb = chs[0] * 4
        self.neighboring_attn_type = neighboring_attn_type
        self.zero_module_type = zero_module_type
        tx = dict(heads=heads, cross_attention_dim=cross_attention_dim,
                  multiview=multiview, st_attn=st_attn, temporal=temporal,
                  num_frames=num_frames, lora_rank=lora_rank,
                  neighboring_view_pair=neighboring_view_pair,
                  neighboring_attn_type=neighboring_attn_type,
                  zero_module_type=zero_module_type)

        self.time_embedding = TimestepEmbedding(chs[0], temb)
        self.conv_in = Conv2d(in_channels, chs[0], 3, padding=1)

        self.down_blocks = nn.ModuleList()
        skip_chs = [chs[0]]
        prev = chs[0]
        for i, ch in enumerate(chs):
            if i < len(chs) - 1:
                self.down_blocks.append(CrossAttnDownBlock2D(
                    prev, ch, temb, layers_per_block, True, **tx))
                skip_chs += [ch] * (layers_per_block + 1)
            else:
                self.down_blocks.append(DownBlock2D(
                    prev, ch, temb, layers_per_block))
                skip_chs += [ch] * layers_per_block
            prev = ch
        self.mid_block = UNetMidBlock2DCrossAttn(chs[-1], temb, **tx)

        self.up_blocks = nn.ModuleList()
        n_lay = layers_per_block + 1
        for i, ch in enumerate(reversed(chs)):
            skips = skip_chs[-n_lay:][::-1]
            del skip_chs[-n_lay:]
            self.up_blocks.append(UpBlock(
                prev, ch, skips, temb, add_upsample=i < len(chs) - 1,
                cross_attn=i > 0, **tx))
            prev = ch
        self.conv_norm_out = GroupNorm(min(32, chs[0]), chs[0], eps=1e-5)
        self.conv_out = Conv2d(chs[0], out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                down_block_additional_residuals: Optional[
                    List[torch.Tensor]] = None,
                mid_block_additional_residual: Optional[torch.Tensor] = None,
                n_cam=6) -> torch.Tensor:
        """sample (B', 4, h, w), timesteps (B',), encoder_hidden_states
        (B', L, D) -> eps (B', 4, h, w) in the compute dtype.  ``n_cam``:
        the cameras of a sample, or this rank's ``Split`` under a mesh
        (``BasicTransformerBlock``)."""
        chs = self.block_out_channels
        temb = self.time_embedding(get_timestep_embedding(timesteps, chs[0]))
        x = self.conv_in(sample)
        run = lambda block, *a: remat_call(self.remat, self.remat_min_tokens,
                                           block, *a)
        res_stack = [x]
        sow = self._capture is not None
        for i, block in enumerate(self.down_blocks):
            if isinstance(block, CrossAttnDownBlock2D):
                x, res = run(block, x, temb, encoder_hidden_states, n_cam)
            else:
                x, res = run(block, x, temb)
            res_stack += res
            if sow:
                record(self, f"down_block_{i}_out", x)
        if down_block_additional_residuals is not None:
            res_stack = [r + a.to(r.dtype) for r, a in
                         zip(res_stack, down_block_additional_residuals)]
        x = run(self.mid_block, x, temb, encoder_hidden_states, n_cam)
        if mid_block_additional_residual is not None:
            x = x + mid_block_additional_residual.to(x.dtype)
        if sow:
            record(self, "mid_block_out", x)

        n_lay = len(self.up_blocks[0].resnets)
        for i, block in enumerate(self.up_blocks):
            skips = res_stack[-n_lay:][::-1]
            del res_stack[-n_lay:]
            target: Optional[Tuple[int, int]] = (
                tuple(res_stack[-1].shape[2:]) if res_stack else None)
            x = run(block, x, skips, temb, encoder_hidden_states, n_cam,
                    target)
            if sow:
                record(self, f"up_block_{i}_out", x)
        x = F.silu(self.conv_norm_out(x)).to(self.conv_out.weight.dtype)
        return self.conv_out(x)
