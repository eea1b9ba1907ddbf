"""Conditioning embedders: camera, box / map-vector tokens, BEV map,
occupancy image, SFA text-condition fusion.

Port of ``dualdiff_tpu/models/embedders.py``.  Feature maps are NCHW; token
tensors are ``(B, L, C)``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from ..ops.fourier import fourier_embed, fourier_out_dim
from .layers import Conv2d, Linear, zero_module

__all__ = ["embed_camera_param", "BBoxEmbedder", "BEVMapConditionEmbedder",
           "OccImageConditionEmbedder", "SFATxtCon", "SFATxtConPlus",
           "XYZ_MIN", "XYZ_RANGE"]

# box-corner normalisation of ``minmax_normalize`` (reference
# bbox_embedder.py:10-11)
XYZ_MIN = (-200.0, -300.0, -20.0)
XYZ_RANGE = (350.0, 650.0, 80.0)


def embed_camera_param(camera_param: torch.Tensor,
                       num_freqs: int = 4) -> torch.Tensor:
    """(B, N, 3, 7) -> (B, N, 189): each of the 7 columns (3 intrinsics +
    4 cam2lidar) is a 3-vector, Fourier-embedded to 27, column-major."""
    emb = fourier_embed(camera_param.transpose(-1, -2), num_freqs=num_freqs)
    return emb.reshape(*emb.shape[:-2], -1)


class BBoxEmbedder(nn.Module):
    """3D box corners (or map-vector points) + class -> one token each."""

    def __init__(self, n_classes: int = 10, class_token_dim: int = 768,
                 embedder_num_freq: int = 4,
                 proj_dims: Sequence[int] = (768, 512, 512, 768),
                 mode: str = "all-xyz", num_points: Optional[int] = None,
                 minmax_normalize: bool = False):
        super().__init__()
        self.n_classes = n_classes
        self.minmax_normalize = minmax_normalize
        self.num_freq = embedder_num_freq
        n_points = num_points if num_points is not None else \
            {"cxyz": 4, "all-xyz": 8}[mode]
        pos_dim = fourier_out_dim(3, embedder_num_freq) * n_points
        self.null_pos_feature = nn.Parameter(torch.zeros(pos_dim))
        self.null_class_feature = nn.Parameter(torch.zeros(class_token_dim))
        # normally CLIP-pooled class-name embeddings, set by weight import
        self._class_tokens = nn.Parameter(
            torch.randn(n_classes, class_token_dim))
        self.bbox_proj = Linear(pos_dim, proj_dims[0])
        self.second_linear = nn.Sequential(
            Linear(proj_dims[0] + class_token_dim, proj_dims[1]), nn.SiLU(),
            Linear(proj_dims[1], proj_dims[2]), nn.SiLU(),
            Linear(proj_dims[2], proj_dims[3]))

    def forward(self, bboxes: torch.Tensor, classes: torch.Tensor,
                masks: Optional[torch.Tensor] = None,
                return_cls: bool = False):
        """bboxes (B', M, P, 3), classes (B', M) (-1 = padding), masks
        (B', M) -> (B', M, proj_dims[-1]).  Masked-out boxes embed the null
        features, which is how CFG's unconditional box tokens are made.
        ``return_cls``: -> (tokens, the masked class tokens (B', M,
        class_token_dim)) for the box adapter.  With ``minmax_normalize``
        the points are mapped by ``(p - XYZ_MIN) / XYZ_RANGE`` before the
        Fourier embedding."""
        b, n = classes.shape
        if masks is None:
            masks = torch.ones(b, n, device=classes.device)
        m = masks.float()[..., None]
        pts = bboxes.float()
        if self.minmax_normalize:
            pts = (pts - pts.new_tensor(XYZ_MIN)) / pts.new_tensor(XYZ_RANGE)
        pos = fourier_embed(pts, num_freqs=self.num_freq)
        pos = pos.reshape(b, n, -1)
        pos = pos * m + self.null_pos_feature.float() * (1.0 - m)
        cls = self._class_tokens[classes.long().clamp(0, self.n_classes - 1)]
        cls = cls.float() * m + self.null_class_feature.float() * (1.0 - m)
        dtype = self.bbox_proj.weight.dtype
        emb = F.silu(self.bbox_proj(pos))
        emb = self.second_linear(torch.cat([emb, cls.to(dtype)], dim=-1))
        return (emb, cls.to(emb.dtype)) if return_cls else emb


class BEVMapConditionEmbedder(nn.Module):
    """(B, 200, 200, C_map) channels-last BEV mask -> (B*n_cam, 320, h, w),
    the map feature shared by all views (reference map_embedder.py:67).

    The conv stack is fixed for 200x200 -> 28x50 (224x400 latents): the
    stride-2 convs pad (2, 2) rows and (1, 1) columns, as flax's
    ``padding=((2, 2), (1, 1))``, and the last one strides (2, 1)
    (200 -> 101x100 -> 52x50 -> 54x50 -> 28x50).  Any other ``target_hw``
    is resized to after ``conv_out`` as ``jax.image.resize(...,
    "bilinear")`` does: antialiased where an axis shrinks, plain bilinear
    (half-pixel centres) where it grows, which is ``F.interpolate``'s
    ``antialias=True`` bilinear (float32 here)."""

    def __init__(self, conditioning_embedding_channels: int = 320,
                 block_out_channels: Sequence[int] = (16, 32, 96, 256),
                 n_cam: int = 6, map_channels: int = 8):
        super().__init__()
        chs = list(block_out_channels)
        self.n_cam = n_cam
        self.conv_in = Conv2d(map_channels, chs[0], 3, padding=1)
        blocks = []
        for i in range(len(chs) - 2):
            blocks.append(Conv2d(chs[i], chs[i], 3, padding=1))
            blocks.append(Conv2d(chs[i], chs[i + 1], 3, stride=2))
        blocks.append(Conv2d(chs[-2], chs[-2], 3))
        blocks.append(Conv2d(chs[-2], chs[-1], 3, stride=(2, 1)))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = zero_module(
            Conv2d(chs[-1], conditioning_embedding_channels, 3, padding=1))

    def forward(self, cond: torch.Tensor,
                target_hw: Optional[Tuple[int, int]] = None,
                n: Optional[int] = None) -> torch.Tensor:
        """``n``: the cameras to repeat the feature for (a rank's under a
        view split; ``n_cam`` by default)."""
        x = F.silu(self.conv_in(cond.permute(0, 3, 1, 2)))
        for conv in self.blocks:
            if conv.padding == (0, 0):  # flax's ((2, 2), (1, 1))
                x = F.pad(x, (1, 1, 2, 2))
            x = F.silu(conv(x))
        x = self.conv_out(x)
        if target_hw is not None and tuple(x.shape[2:]) != tuple(target_hw):
            x = F.interpolate(x.float(), size=tuple(target_hw),
                              mode="bilinear", align_corners=False,
                              antialias=True).to(x.dtype)
        return x.repeat_interleave(self.n_cam if n is None else n, dim=0)


class OccImageConditionEmbedder(nn.Module):
    """6-view occupancy-projection panorama (B, H, 6W, 3) ->
    (B*6, 320, H/8, W/8); under a view split, a rank's ``n`` views from
    ``view0`` -> (B*n, 320, H/8, W/8)."""

    def __init__(self, conditioning_embedding_channels: int = 320,
                 block_out_channels: Sequence[int] = (16, 32, 96, 256),
                 n_cam: int = 6):
        super().__init__()
        chs = list(block_out_channels)
        self.n_cam = n_cam
        self.conv_in = Conv2d(3, chs[0], 3, padding=1)
        blocks = []
        for i in range(len(chs) - 1):
            blocks.append(Conv2d(chs[i], chs[i], 3, padding=1))
            blocks.append(Conv2d(chs[i], chs[i + 1], 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = zero_module(
            Conv2d(chs[-1], conditioning_embedding_channels, 3, padding=1))

    def forward(self, cond: torch.Tensor, view0: int = 0,
                n: Optional[int] = None) -> torch.Tensor:
        b, h, w6, c = cond.shape
        w = w6 // self.n_cam
        n = self.n_cam if n is None else n
        x = cond.reshape(b, h, self.n_cam, w, c)[:, :, view0:view0 + n]
        x = F.silu(self.conv_in(x.permute(0, 2, 4, 1, 3).reshape(
            b * n, c, h, w)))
        for conv in self.blocks:
            x = F.silu(conv(x))
        return self.conv_out(x)


class SFATxtCon(nn.Module):
    """Semantic Fusion Attention: Q = condition feature map, K/V = text
    tokens, added back residually."""

    def __init__(self, con_dim: int = 320, txt_dim: int = 768,
                 heads: int = 8):
        super().__init__()
        self.heads = heads
        self.to_q = Linear(con_dim, con_dim, bias=False)
        self.to_k = Linear(txt_dim, con_dim, bias=False)
        self.to_v = Linear(txt_dim, con_dim, bias=False)
        self.to_out = nn.ModuleList([Linear(con_dim, con_dim)])

    def forward(self, cond: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
        b, c, h, w = cond.shape
        x = cond.flatten(2).transpose(1, 2)  # (B, h*w, C)
        hd = c // self.heads
        split = lambda t: t.reshape(b, t.shape[1], self.heads, hd)
        out = multi_head_attention(split(self.to_q(x)), split(self.to_k(txt)),
                                   split(self.to_v(txt)))
        out = self.to_out[0](out.reshape(b, h * w, c))
        return cond + out.transpose(1, 2).reshape(b, c, h, w)


class SFATxtConPlus(nn.Module):
    """Two-stage SFA+: the condition map's queries first attend to the text
    tokens, and the result then queries the condition map's own keys and
    values; added back residually.  Stage 2 is a self-attention of the
    h*w condition tokens (28x50 = 1400 at 224x400), which
    ``multi_head_attention`` sends to the split-layout kernels."""

    def __init__(self, con_dim: int = 320, txt_dim: int = 768,
                 heads: int = 8):
        super().__init__()
        self.heads = heads
        self.to_q_occ = Linear(con_dim, con_dim, bias=False)
        self.to_k_occ = Linear(con_dim, con_dim, bias=False)
        self.to_v_occ = Linear(con_dim, con_dim, bias=False)
        self.to_k_txt = Linear(txt_dim, con_dim, bias=False)
        self.to_v_txt = Linear(txt_dim, con_dim, bias=False)
        self.to_out = nn.ModuleList([Linear(con_dim, con_dim)])

    def forward(self, cond: torch.Tensor, txt: torch.Tensor) -> torch.Tensor:
        b, c, h, w = cond.shape
        x = cond.flatten(2).transpose(1, 2)  # (B, h*w, C)
        hd = c // self.heads
        split = lambda t: t.reshape(b, t.shape[1], self.heads, hd)
        stage1 = multi_head_attention(split(self.to_q_occ(x)),
                                      split(self.to_k_txt(txt)),
                                      split(self.to_v_txt(txt)))
        out = multi_head_attention(stage1, split(self.to_k_occ(x)),
                                   split(self.to_v_occ(x)))
        out = self.to_out[0](out.reshape(b, h * w, c))
        return cond + out.transpose(1, 2).reshape(b, c, h, w)
