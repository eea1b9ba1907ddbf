"""NeRF-style Fourier features and the SD sinusoidal timestep embedding.

Port of ``dualdiff_tpu/ops/fourier.py``: output layout
``[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]`` on the last axis,
so ``out_dim = d * (1 + 2 * num_freqs)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fourier_embed", "fourier_out_dim", "timestep_embedding"]


def fourier_out_dim(input_dims: int, num_freqs: int) -> int:
    return input_dims * (1 + 2 * num_freqs)


def fourier_embed(x: torch.Tensor, num_freqs: int = 4) -> torch.Tensor:
    """Embed the last axis. ``(..., d) -> (..., d * (1 + 2*num_freqs))``,
    log-spaced frequencies 2^0 .. 2^(num_freqs-1)."""
    outs = [x]
    for f in 2.0 ** np.linspace(0.0, num_freqs - 1, num_freqs):
        outs.append(torch.sin(x * float(f)))
        outs.append(torch.cos(x * float(f)))
    return torch.cat(outs, dim=-1)


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers ``Timesteps``; SD v1.5 uses
    flip_sin_to_cos=True, freq_shift=0, max_period 10000).  Always
    float32."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    emb = torch.exp(exponent / half)
    emb = timesteps.float()[..., None] * emb[None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)
