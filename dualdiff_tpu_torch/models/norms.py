"""GroupNorm and LayerNorm with the JAX package's numerics.

Port of ``dualdiff_tpu/models/norms.py``.  This GroupNorm is not
``F.group_norm``: statistics are float32 with the fast variance
``E[x^2] - E[x]^2`` clamped at 0, and the normalize is one per-channel
affine ``x * a + b`` applied in the compute dtype.  Inputs are NCHW (or any
``(B, C, *spatial)``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["GroupNorm", "LayerNorm"]


class GroupNorm(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"channels {num_channels} not divisible by "
                             f"groups {num_groups}")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.num_groups
        spatial = tuple(range(2, x.dim()))
        xf = x.float()
        mu = xf.mean(spatial).reshape(b, g, c // g).mean(-1)       # (B, G)
        m2 = xf.square().mean(spatial).reshape(b, g, c // g).mean(-1)
        inv = torch.rsqrt(torch.clamp(m2 - mu.square(), min=0.0) + self.eps)
        inv_c = inv.repeat_interleave(c // g, dim=1)               # (B, C)
        mu_c = mu.repeat_interleave(c // g, dim=1)
        a = inv_c * self.weight.float()
        shift = self.bias.float() - mu_c * a
        shape = (b, c) + (1,) * len(spatial)
        dtype = self.weight.dtype
        return (x.to(dtype) * a.to(dtype).reshape(shape)
                + shift.to(dtype).reshape(shape))


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with float32 statistics; the result is
    returned in ``out_dtype`` (the parameters' dtype unless given)."""

    def __init__(self, dim: int, eps: float = 1e-5, out_dtype=None):
        super().__init__(dim, eps=eps)
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.out_dtype or self.weight.dtype)
