"""Attention: einsum path, plain reference versions and the CUDA kernels.

Port of the inference part of ``dualdiff_tpu/ops/attention.py``.  Tensors
are channel-packed ``(B, L, C)`` with head ``h`` in columns
``[h*d, (h+1)*d)``, as in the JAX package, so no head split or merge copies
are made around the kernels.

Routing follows the JAX package: queries of at least ``PACKED_MIN_LQ`` tokens
with ``d % 8 == 0`` go to the kernels, everything shorter to einsum.  On the
flagship 224x400 path only the 28x50 = 1400-token level (C = 320, 8 heads,
d = 40) reaches a kernel; the 350-, 91- and 28-token levels use einsum.

Kernel wrappers (``packed_attention_fwd``, ``packed_attention_nbr_fwd``)
take the plain PyTorch version for tensors on the CPU, which is what the CPU
tests run.  A CUDA tensor either launches the kernel or raises; nothing
falls back.  Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .cuda_lib import library

__all__ = ["PACKED_MIN_LQ", "mha_einsum", "multi_head_attention",
           "attention_packed", "attention_packed_neighbors",
           "attention_packed_plain", "attention_packed_neighbors_plain",
           "packed_attention_fwd", "packed_attention_nbr_fwd",
           "KERNEL_WRAPPERS", "reset_launch_counts"]

# Queries at least this long take the kernels.  Carried over from the JAX
# package's _PACKED_MIN_LQ (a TPU measurement); to be decided again on the
# H100.
PACKED_MIN_LQ = 512
# Largest head_dim the CUDA kernels take (80 and 160 reach them at HD).
MAX_KERNEL_HEAD_DIM = 160


def _default_scale(scale: Optional[float], d: int) -> float:
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def mha_einsum(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: Optional[float] = None) -> torch.Tensor:
    """(B, Lq, H, D) x (B, Lk, H, D) -> (B, Lq, H, D).  Logits and softmax
    in float32; probabilities rounded to v's dtype before the second
    product, as the JAX package does."""
    scale = _default_scale(scale, q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def multi_head_attention(q, k, v, scale: Optional[float] = None):
    """(B, L, H, D) in and out.  The JAX package sends this to its
    split-layout flash kernel only on a TPU with both lengths >= 1024 (SFA+
    stage 2, not on this path); the port uses einsum."""
    return mha_einsum(q, k, v, scale)


def _einsum_packed(q, k, v, scale, heads):
    b, lq, c = q.shape
    d = c // heads
    split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, d)
    return mha_einsum(split(q), split(k), split(v), scale).reshape(b, lq, c)


# ------------------------------------------------------- plain versions --

def _attention_f32(q, k, v, heads, scale):
    """Exact attention in float32, (B, L, C) packed.  q is
    scaled in float32 before the product, as in the TPU kernel."""
    b, lq, c = q.shape
    d = c // heads
    qh = q.reshape(b, lq, heads, d).float() * scale
    kh = k.reshape(b, k.shape[1], heads, d).float()
    vh = v.reshape(b, v.shape[1], heads, d).float()
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vh).reshape(b, lq, c)


def attention_packed_plain(q, k, v, heads: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of ``packed_attention_fwd``: float32 logits, softmax
    and products, rounded once to q's dtype."""
    scale = _default_scale(scale, q.shape[-1] // heads)
    return _attention_f32(q, k, v, heads, scale).to(q.dtype)


def _ring(n_cam: int, offset: int):
    return [(i + offset) % n_cam for i in range(n_cam)]


def attention_packed_neighbors_plain(q, k, v, heads: int, n_cam: int,
                                     scale: Optional[float] = None):
    """Plain version of ``packed_attention_nbr_fwd``: for view n,
    attn(q_n, K/V of view n-1) + attn(q_n, K/V of view n+1) on the camera
    ring, each with its own softmax, summed in float32, rounded once."""
    bn, l, c = q.shape
    b = bn // n_cam
    scale = _default_scale(scale, c // heads)

    def take(t, idx):
        return t.reshape(b, n_cam, l, c)[:, idx].reshape(bn, l, c)

    left, right = _ring(n_cam, -1), _ring(n_cam, 1)
    out = (_attention_f32(q, take(k, left), take(v, left), heads, scale)
           + _attention_f32(q, take(k, right), take(v, right), heads, scale))
    return out.to(q.dtype)


# ------------------------------------------------------ kernel wrappers --

def _check_kernel_args(q, k, v, heads):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             "CUDA tensors")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes "
                             "bfloat16")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, L, C) tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v lie on different devices")
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    c = q.shape[2]
    if c % heads:
        raise ValueError(f"{c} channels do not split into {heads} heads")
    d = c // heads
    if d % 8 or d > MAX_KERNEL_HEAD_DIM:
        raise ValueError(f"head_dim {d}: the kernel takes multiples of 8 "
                         f"up to {MAX_KERNEL_HEAD_DIM}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    return d


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, fn: str) -> None:
    if err:
        raise RuntimeError(f"{fn} failed to launch: cudaError {err}")


def packed_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Inference attention, q (B, Lq, C), k/v (B, Lk, C) -> (B, Lq, C).

    CUDA kernel ``packed_attention_fwd`` (``csrc/attention.cu``), the port
    of the TPU kernel ``_fwd_kernel_t``.  CPU tensors take
    ``attention_packed_plain``."""
    if q.device.type == "cpu":
        return attention_packed_plain(q, k, v, heads, scale)
    d = _check_kernel_args(q, k, v, heads)
    scale = _default_scale(scale, d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library("attention").dd_packed_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.shape[0], q.shape[1], k.shape[1], heads, d, scale, _stream(q))
    _raise_on(err, "packed_attention_fwd")
    packed_attention_fwd.launches += 1
    return out


def packed_attention_nbr_fwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, heads: int, n_cam: int,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Camera-ring neighbor attention (attn4 'add'), q/k/v (B*N, L, C) ->
    (B*N, L, C): view n attends to views n-1 and n+1 (mod N).

    CUDA kernel ``packed_attention_nbr_fwd`` (``csrc/attention.cu``), the
    port of the TPU kernel ``_fwd_kernel_t_nbr``; K/V are read in place,
    never gathered.  CPU tensors take
    ``attention_packed_neighbors_plain``."""
    if q.device.type == "cpu":
        return attention_packed_neighbors_plain(q, k, v, heads, n_cam, scale)
    d = _check_kernel_args(q, k, v, heads)
    if q.shape != k.shape:
        raise ValueError("neighbor attention needs q, k, v of one shape")
    if n_cam < 1 or q.shape[0] % n_cam:
        raise ValueError(f"batch {q.shape[0]} is not a multiple of "
                         f"n_cam={n_cam}")
    scale = _default_scale(scale, d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library("attention").dd_packed_attention_nbr_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.shape[0], q.shape[1], heads, d, n_cam, scale, _stream(q))
    _raise_on(err, "packed_attention_nbr_fwd")
    packed_attention_nbr_fwd.launches += 1
    return out


packed_attention_fwd.launches = 0
packed_attention_nbr_fwd.launches = 0
KERNEL_WRAPPERS = (packed_attention_fwd, packed_attention_nbr_fwd)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


# -------------------------------------------------------------- routing --

def _takes_kernel(lq: int, d: int) -> bool:
    return lq >= PACKED_MIN_LQ and d % 8 == 0 and d <= MAX_KERNEL_HEAD_DIM


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int, scale: Optional[float] = None):
    """Channel-packed attention: q (B, Lq, C), k/v (B, Lk, C) -> (B, Lq, C).

    The JAX package's frame-axis head-packed path (lq == lk <= 32) is the
    same per-head math with a block-diagonal mask, so the port sends it to
    einsum like every other short query."""
    d = q.shape[-1] // heads
    scale = _default_scale(scale, d)
    if _takes_kernel(q.shape[1], d):
        return packed_attention_fwd(q, k, v, heads, scale)
    return _einsum_packed(q, k, v, scale, heads)


def attention_packed_neighbors(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, heads: int, n_cam: int,
                               scale: Optional[float] = None):
    """Ring-neighbor multiview attention (attn4 'add'): q/k/v are the
    per-view projections (B*n_cam, L, C); returns, for each view, the sum
    over its left and right camera neighbors of attention(q, kv[nbr])."""
    bn, lq, c = q.shape
    d = c // heads
    scale = _default_scale(scale, d)
    if _takes_kernel(lq, d):
        return packed_attention_nbr_fwd(q, k, v, heads, n_cam, scale)
    # short sequences: stack [left; right] on the batch dim, one einsum
    b = bn // n_cam

    def take(t, idx):
        return t.reshape(b, n_cam, lq, c)[:, idx].reshape(bn, lq, c)

    left, right = _ring(n_cam, -1), _ring(n_cam, 1)
    out2 = _einsum_packed(
        torch.cat([q, q]), torch.cat([take(k, left), take(k, right)]),
        torch.cat([take(v, left), take(v, right)]), scale, heads)
    return out2[:bn] + out2[bn:]
