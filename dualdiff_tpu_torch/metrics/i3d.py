"""I3D (Inflated 3D Inception) for FVD.

The port of ``dualdiff_tpu/metrics/i3d.py``: the module's parameters carry
the names of the standard ``i3d_pretrained_400.pt`` (piergiaj's
pytorch-i3d ``InceptionI3d``), and it computes what the JAX module does:
convolutions and max pools with TF's SAME padding (the pad split low /
high as TF splits it, max pools padded with -inf), BatchNorm with eps 1e-3
on its running averages, ReLU; the global spatial mean of the last block,
the 1x1x1 logits convolution on each remaining frame, then the mean over
frames.  ``InceptionI3d`` returns ``(logits (B, 400), pooled (B, 1024))``;
canonical FVD uses the logits.

``import_i3d`` checks the state dict against ``i3d_key_list()`` (the JAX
importer's list, copied): every key present and every key consumed, then
the module loads it with ``strict=True``.  Convolutions and pools are
PyTorch's (cuDNN on the card), as the JAX package has no kernel of its own
here.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["InceptionI3d", "I3D_CONV_UNITS", "i3d_key_list", "import_i3d",
           "load_i3d"]

# [b0, b1a, b1b, b2a, b2b, b3b] output channels per inception module
_MIXED: List[Tuple[str, Tuple[int, int, int, int, int, int]]] = [
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
]


def _same_pad(x, kernel: Sequence[int], stride: Sequence[int],
              value: float = 0.0):
    """TF's SAME padding over the last three dims of ``x``: a total of
    ``max((ceil(n / s) - 1) * s + k - n, 0)``, its floor half before."""
    pads = []
    for n, k, s in zip(reversed(x.shape[2:]), reversed(kernel),
                       reversed(stride)):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return F.pad(x, pads, value=value)


class Unit3D(nn.Module):
    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1),
                 stride=(1, 1, 1), use_bn: bool = True, relu: bool = True):
        super().__init__()
        self.kernel, self.stride, self.relu = tuple(kernel), tuple(stride), \
            relu
        self.conv3d = nn.Conv3d(cin, cout, kernel, stride, bias=not use_bn)
        self.bn = nn.BatchNorm3d(cout, eps=1e-3) if use_bn else None

    def forward(self, x):
        x = self.conv3d(_same_pad(x, self.kernel, self.stride))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


def _maxpool_same(x, kernel, stride):
    return F.max_pool3d(_same_pad(x, kernel, stride, float("-inf")),
                        kernel, stride)


class InceptionModule(nn.Module):
    def __init__(self, cin: int, ch: Tuple[int, ...]):
        super().__init__()
        c0, c1a, c1b, c2a, c2b, c3b = ch
        self.b0 = Unit3D(cin, c0)
        self.b1a = Unit3D(cin, c1a)
        self.b1b = Unit3D(c1a, c1b, (3, 3, 3))
        self.b2a = Unit3D(cin, c2a)
        self.b2b = Unit3D(c2a, c2b, (3, 3, 3))
        self.b3b = Unit3D(cin, c3b)

    def forward(self, x):
        b3 = self.b3b(_maxpool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), b3], 1)


class InceptionI3d(nn.Module):
    """Input (B, 3, T, H, W), or (B, T, H, W, 3), in [-1, 1]; T >= 9, H x W
    nominally 224 x 224.  -> (logits (B, 400), pooled (B, 1024)), float32.
    Built in ``eval()`` mode."""

    def __init__(self, num_classes: int = 400):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        cin = 192
        for name, ch in _MIXED:
            self.add_module(name, InceptionModule(cin, ch))
            cin = ch[0] + ch[2] + ch[4] + ch[5]
        self.logits = Unit3D(cin, num_classes, use_bn=False, relu=False)
        self.eval()

    def forward(self, x):
        if x.shape[1] != 3 and x.shape[-1] == 3:
            x = x.permute(0, 4, 1, 2, 3)
        x = x.float()
        x = self.Conv3d_1a_7x7(x)
        x = _maxpool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = _maxpool_same(x, (1, 3, 3), (1, 2, 2))
        for name, _ in _MIXED[:2]:
            x = getattr(self, name)(x)
        x = _maxpool_same(x, (3, 3, 3), (2, 2, 2))
        for name, _ in _MIXED[2:7]:
            x = getattr(self, name)(x)
        x = _maxpool_same(x, (2, 2, 2), (2, 2, 2))
        for name, _ in _MIXED[7:]:
            x = getattr(self, name)(x)
        pooled_t = x.mean(dim=(3, 4))  # (B, 1024, T')
        logits_t = self.logits(pooled_t[..., None, None])[..., 0, 0]
        return logits_t.mean(2), pooled_t.mean(2)


I3D_CONV_UNITS: List[str] = [
    "Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3"] + [
    f"{mixed}.{b}" for mixed, _ in _MIXED
    for b in ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")
]  # 3 + 9*6 = 57 BN conv units (+ the bias-only logits conv)

_BN_KEYS = ("weight", "bias", "running_mean", "running_var",
            "num_batches_tracked")


def i3d_key_list() -> List[str]:
    keys = []
    for mod in I3D_CONV_UNITS:
        keys.append(f"{mod}.conv3d.weight")
        keys += [f"{mod}.bn.{k}" for k in _BN_KEYS]
    keys += ["logits.conv3d.weight", "logits.conv3d.bias"]
    return keys


def import_i3d(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """An ``i3d_pretrained_400.pt`` state dict -> the module's: every key of
    ``i3d_key_list()`` present (the ``num_batches_tracked`` counters may be
    missing: 0), and no other."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    keys = i3d_key_list()
    missing = {k for k in keys
               if not k.endswith("num_batches_tracked")} - set(sd)
    assert not missing, f"i3d state dict missing keys: {sorted(missing)[:8]}"
    leftover = set(sd) - set(keys)
    assert not leftover, f"unconsumed i3d keys: {sorted(leftover)[:8]}"
    return {k: sd[k] if k in sd else torch.zeros((), dtype=torch.int64)
            for k in keys}


def load_i3d(model: nn.Module, state_dict: Dict) -> None:
    """``import_i3d`` of ``state_dict`` into ``model``, ``strict=True``."""
    model.load_state_dict(import_i3d(state_dict), strict=True)
