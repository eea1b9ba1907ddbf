"""PyTorch + CUDA port of ``dualdiff_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package imports none of it.  Plain
tensor code is PyTorch; the attention kernels that the JAX package wrote in
Pallas are hand-written CUDA C++ (``csrc/``), built on first use.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU.

    ``None`` means CUDA; asking for CUDA on a machine without a card raises
    instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dualdiff_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
