"""AutoencoderKL (SD v1.5 VAE), PyTorch.

Port of ``dualdiff_tpu/models/vae.py``.  Encoder: down blocks of resnets with
stride-2 downsamplers (padded by one row and column at the bottom and right,
as diffusers does), mid block (resnet, single-head attention, resnet),
``quant_conv`` to the posterior moments.  Decoder: post-quant conv, mid
block, up blocks of resnets with nearest 2x upsampling.  GroupNorm eps 1e-6.
NCHW.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import mha_einsum
from .layers import Conv2d, Linear
from .norms import GroupNorm

__all__ = ["AutoencoderKL", "SD_VAE_SCALING"]

SD_VAE_SCALING = 0.18215


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(min(32, in_channels), in_channels, 1e-6)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(min(32, out_channels), out_channels, 1e-6)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.conv1.weight.dtype
        h = self.conv1(F.silu(self.norm1(x)).to(dtype))
        h = self.conv2(F.silu(self.norm2(h)).to(dtype))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttentionBlock(nn.Module):
    """Single-head spatial self-attention (diffusers ``Attention``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(min(32, channels), channels, 1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out = nn.ModuleList([Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)  # (B, h*w, C)
        split = lambda t: t[:, :, None]  # one head
        y = mha_einsum(split(self.to_q(y)), split(self.to_k(y)),
                       split(self.to_v(y)))[:, :, 0]
        y = self.to_out[0](y)
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class MidBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(channels, channels),
                                      VAEResnetBlock(channels, channels)])
        self.attentions = nn.ModuleList([VAEAttentionBlock(channels)])

    def forward(self, x):
        x = self.resnets[0](x)
        return self.resnets[1](self.attentions[0](x))


class DownsampleConv(nn.Module):
    """Stride-2 3x3 conv after a (0, 1) pad of the bottom and right edges
    (diffusers ``Downsample2D`` with ``padding=0``; the JAX package's
    ``padding=((0, 1), (0, 1))``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class EncoderDownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            VAEResnetBlock(in_channels if j == 0 else out_channels,
                           out_channels) for j in range(num_layers)])
        self.downsamplers = (nn.ModuleList([DownsampleConv(out_channels)])
                             if add_downsample else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512,
                                                            512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 in_channels: int = 3):
        super().__init__()
        chs = list(block_out_channels)
        self.conv_in = Conv2d(in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = chs[0]
        for i, ch in enumerate(chs):
            self.down_blocks.append(EncoderDownBlock(
                prev, ch, layers_per_block, add_downsample=i < len(chs) - 1))
            prev = ch
        self.mid_block = MidBlock(chs[-1])
        self.conv_norm_out = GroupNorm(min(32, chs[-1]), chs[-1], 1e-6)
        self.conv_out = Conv2d(chs[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        x = F.silu(self.conv_norm_out(x)).to(self.conv_out.weight.dtype)
        return self.conv_out(x)


class UpsampleConv(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class DecoderUpBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            VAEResnetBlock(in_channels if j == 0 else out_channels,
                           out_channels) for j in range(num_layers)])
        self.upsamplers = (nn.ModuleList([UpsampleConv(out_channels)])
                           if add_upsample else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class Decoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512,
                                                            512),
                 layers_per_block: int = 3, latent_channels: int = 4,
                 out_channels: int = 3):
        super().__init__()
        chs = list(reversed(block_out_channels))  # [512, 512, 256, 128]
        self.conv_in = Conv2d(latent_channels, chs[0], 3, padding=1)
        self.mid_block = MidBlock(chs[0])
        self.up_blocks = nn.ModuleList()
        prev = chs[0]
        for i, ch in enumerate(chs):
            self.up_blocks.append(DecoderUpBlock(
                prev, ch, layers_per_block, add_upsample=i < len(chs) - 1))
            prev = ch
        self.conv_norm_out = GroupNorm(min(32, chs[-1]), chs[-1], 1e-6)
        self.conv_out = Conv2d(chs[-1], out_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        x = F.silu(self.conv_norm_out(x)).to(self.conv_out.weight.dtype)
        return self.conv_out(x)


class AutoencoderKL(nn.Module):
    """SD v1.5's AutoencoderKL: ``encode`` (training) and ``decode``."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512,
                                                            512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 scaling_factor: float = SD_VAE_SCALING):
        super().__init__()
        self.scaling_factor = scaling_factor
        self.encoder = Encoder(block_out_channels, layers_per_block,
                               latent_channels)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.decoder = Decoder(block_out_channels, layers_per_block + 1,
                               latent_channels)
        self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        """Image (B, 3, H, W) in [-1, 1] -> (B, 8, H/8, W/8) posterior
        mean || logvar."""
        return self.quant_conv(self.encoder(x))

    def encode(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Sample the posterior and apply the SD scaling factor.  ``noise``
        (B, 4, H/8, W/8) is the standard-normal draw."""
        return self.sample(self.encode_moments(x), noise)

    def sample(self, moments: torch.Tensor,
               noise: torch.Tensor) -> torch.Tensor:
        """Posterior moments (B, 8, h, w) and the standard-normal draw
        ``noise`` (B, 4, h, w) -> scaled latents, as ``encode`` gives them
        (the conditioning cache stores the moments)."""
        mean, logvar = moments.chunk(2, dim=1)
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        return (mean + std * noise.to(mean.dtype)) * self.scaling_factor

    def encode_mode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode_moments(x).chunk(2, dim=1)[0] * self.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, 4, h, w) -> image (B, 3, 8h, 8w) in [-1, 1]."""
        return self.decoder(self.post_quant_conv(z / self.scaling_factor))
