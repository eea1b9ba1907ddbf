"""Model-FLOP accounting and MFU on the card.

Port of ``dualdiff_tpu/utils/flops.py``.  The JAX package reads XLA's cost
model of the compiled program; the port runs one real call under
``torch.utils.flop_counter.FlopCounterMode`` (the aten matmuls, batched
matmuls and convolutions it executes) and under the attention kernels'
recorder (``ops.attention.recorded_kernel_flops``), which counts what the
torch counter cannot see: the ctypes kernels.  Eager mode runs every
denoising step, so one generation counts all of its steps and needs no
while-body correction.  On the CPU the kernel wrappers run their plain
versions, whose aten ops the torch counter sees as well; on the card it
does not, so there the two counts never overlap.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..ops.attention import recorded_kernel_flops

__all__ = ["count_flops", "device_peak_flops", "mfu"]

# dense bf16 tensor-core peak, FLOP/s, by torch.cuda.get_device_name(): the
# H100 SXM part at its 700 W limit (NVIDIA's data sheet)
_PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}


def count_flops(fn, *args, **kwargs) -> Tuple[float, float]:
    """(model FLOPs the torch counter saw, kernel FLOPs the attention
    kernels recorded) of one real call ``fn(*args, **kwargs)``."""
    with FlopCounterMode(display=False) as counter, \
            recorded_kernel_flops() as kernels:
        fn(*args, **kwargs)
    return float(counter.get_total_flops()), kernels.total


def device_peak_flops(name: Optional[str] = None) -> Optional[float]:
    """Peak bf16 FLOP/s of the card ``name`` (default: CUDA device 0's),
    None for a card not in the table or without one."""
    if name is None:
        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(0)
    return _PEAK_BF16.get(name)


def mfu(flops: Optional[float], seconds: float,
        name: Optional[str] = None) -> Optional[float]:
    """Model-FLOPs utilisation in [0, 1]; None if either side is unknown."""
    if not flops or seconds <= 0:
        return None
    peak = device_peak_flops(name)
    if not peak:
        return None
    return flops / seconds / peak
