"""Tone-guidance luminance (MSCN), PyTorch.

Port of ``dualdiff_tpu/ops/mscn.py``: RGB in [-1, 1] -> YUV luma -> a
separable 17-tap Gaussian blur (sigma 17/6) with reflect padding (the
torchvision ``GaussianBlur`` default).  The ``use_tone_guidance`` loss is
``mean((mscn(predicted image) - mscn(ground truth)) ** 2)``.  Everything
runs in float32, whatever the input's dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["mscn_luminance"]

_YUV_Y = (0.299, 0.587, 0.114)


def _gaussian_kernel(ksize: int = 17, sigma: float = 17.0 / 6.0) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def mscn_luminance(rgb: torch.Tensor, ksize: int = 17,
                   sigma: float = 17.0 / 6.0) -> torch.Tensor:
    """(..., 3, H, W) NCHW images in [-1, 1] -> (..., H, W) blurred luma
    in [0, 1], float32."""
    x = rgb.float() * 0.5 + 0.5
    y = torch.einsum("...chw,c->...hw", x, x.new_tensor(_YUV_Y))
    lead, (h, w) = y.shape[:-2], y.shape[-2:]
    k = torch.from_numpy(_gaussian_kernel(ksize, sigma)).to(y.device)
    p = ksize // 2
    y = F.pad(y.reshape(-1, 1, h, w), (p, p, p, p), mode="reflect")
    y = F.conv2d(y, k.reshape(1, 1, ksize, 1))
    y = F.conv2d(y, k.reshape(1, 1, 1, ksize))
    return y.reshape(*lead, h, w)
