"""Attention: einsum path, plain reference versions and the CUDA kernels.

Port of the channel-packed paths of ``dualdiff_tpu/ops/attention.py``.
Tensors are channel-packed ``(B, L, C)`` with head ``h`` in columns
``[h*d, (h+1)*d)``, as in the JAX package, so no head split or merge copies
are made around the kernels.

Routing follows the JAX package: queries of at least ``PACKED_MIN_LQ`` tokens
with ``d % 8 == 0`` go to the kernels, everything shorter to einsum.  On the
flagship 224x400 path only the 28x50 = 1400-token level (C = 320, 8 heads,
d = 40) reaches a kernel; the 350-, 91- and 28-token levels use einsum.

A call that is not differentiated takes the inference kernels
(``packed_attention_fwd``, ``packed_attention_nbr_fwd``), as the JAX
package's custom-VJP primal does; one whose padded score tile is over
``T_SCORE_CAP`` (the video ST-Attn's 1400 queries x 2800 keys) takes
``packed_attention_capped_fwd``, as ``_packed_infer`` sends it to
``_packed_infer_capped``.  A differentiated call (grad enabled and
an input that requires grad) goes through ``PackedAttention``: the forward
with ``lse`` (``packed_attention_lse_fwd``, or over the cap
``packed_attention_capped_lse_fwd``, as ``_packed_train_t_fwd`` picks
``_fwd_kernel_t_lse`` or ``_fwd_kernel_t_capped_lse``), and a backward that
launches ``packed_attention_bwd_dq`` and ``packed_attention_bwd_dkv`` at
every length (the JAX package's backward kernels are K/V-blocked already).
Under grad the camera-ring attn4 takes the JAX training formulation
(``_nbr_stacked``): the left and right neighbours' K/V gathered and stacked
on the batch axis, one ``PackedAttention`` call, the two halves summed.

Split layout.  ``flash_attention`` and ``multi_head_attention`` take
``(B, L, H, D)`` tensors, the JAX package's ``flash_attention`` API; a
contiguous ``(B, L, H, D)`` tensor is the same memory as the packed
``(B, L, C)``, so its kernels read it in place.  ``multi_head_attention``
sends a call with both lengths at least ``FLASH_MIN_LEN`` (SFA+ stage 2,
1400 x 1400 at d = 40) to ``flash_attention`` and everything else to
``mha_einsum``, as the JAX dispatcher does.  ``flash_attention`` runs
``flash_attention_fwd`` (the port of ``_fwd_kernel_nolse``) when it is not
differentiated, and ``FlashAttention`` otherwise: ``flash_attention_lse_fwd``
(``_fwd_kernel``), then ``flash_attention_bwd_dq`` (``_bwd_dq_kernel``) and
``flash_attention_bwd_dkv`` (``_bwd_dkv_kernel``), as ``_flash_padded``'s
VJP.  These four take any head_dim from 1 to ``MAX_KERNEL_HEAD_DIM``, so
``attention_packed`` also sends its ``d % 8 != 0`` queries of at least
``PACKED_MIN_LQ`` tokens there, as ``_packed_infer`` falls back to the split
kernels (under grad only with at least ``FLASH_MIN_LEN`` keys, einsum below,
as ``_flash_packed_fwd``).  The TPU's sequence padding (``_auto_blocks``,
the backward's re-pad to 512, the 128-lane lse) is not carried over: the
kernels mask keys >= Lk and queries >= Lq exactly.  Neither is
``_packed_infer``'s 5376-token envelope: the packed kernels hold no score
tile, so long sequences stay on them.

Frame-axis self-attention (lq == lk <= ``HEADPACK_MAX_LQ``, the video
temporal attention) is einsum; under grad it runs inside
``torch.utils.checkpoint``, so that only q, k and v are saved and the tiny
per-head probabilities are recomputed in the backward, as the JAX
package's ``_headpacked`` VJP does with ``jax.checkpoint``.

The Hopper forward.  The three inference wrappers without ring
(``packed_attention_fwd``, ``packed_attention_capped_fwd``,
``flash_attention_fwd``) send every call in ``sm90_in_scope`` (head_dim a
multiple of 8 up to ``SM90_MAX_HEAD_DIM``, 16-byte aligned rows) to
``sm90_attention_fwd`` (``csrc/attention_sm90.cu``: TMA, wgmma, warp
specialisation), the three training forwards with lse
(``packed_attention_lse_fwd``, ``packed_attention_capped_lse_fwd``,
``flash_attention_lse_fwd``, the split layout on the packed view of the
same memory) to ``sm90_attention_lse_fwd``, the same kernel with its lse
epilogue, and the camera ring (``packed_attention_nbr_fwd``) to
``sm90_attention_nbr_fwd``, the same kernel with both neighbours' K/V
streamed through one work item.  Every other shape (d = 160; d % 8 != 0 as
the tiny SFA+ at d = 4; unaligned rows) goes to ``csrc/attention.cu``'s
template, by that rule alone.
``route="template"`` sends an in-scope call to the template too: the
yardstick ``chip_smoke.py`` times beside the new kernel.  The ring stays
inference only: under grad attn4 takes ``_nbr_stacked`` through
``PackedAttention``, as in the JAX package.

The Hopper backward.  The four backward wrappers (``packed_attention_bwd_dq``,
``packed_attention_bwd_dkv``, ``flash_attention_bwd_dq``,
``flash_attention_bwd_dkv``) send every call in ``sm90_in_scope`` to
``sm90_attention_bwd_dq`` and ``sm90_attention_bwd_dkv``
(``csrc/attention_sm90_bwd.cu``), the split-layout pair on the packed view of
the same memory; ``csrc/attention_train.cu``'s template serves the backward
only outside that scope (d = 160, d % 8 != 0, unaligned rows, the tiny
SFA+ at d = 4) and under ``route="template"``.

Kernel wrappers take the plain PyTorch version for tensors on the CPU, which
is what the CPU tests run.  A CUDA tensor either launches the kernel or
raises; nothing falls back.  The inference wrappers raise under grad: their
output has no ``grad_fn``.  Each wrapper counts its launches in
``<wrapper>.launches`` and reports the hand-counted FLOPs of every call to
``recorded_kernel_flops`` (the JAX package's recorder of the same name).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Dict, Iterator, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .cuda_lib import library

__all__ = ["PACKED_MIN_LQ", "FLASH_MIN_LEN", "mha_einsum",
           "multi_head_attention", "flash_attention", "FlashAttention",
           "flash_attention_plain", "flash_attention_lse_plain",
           "flash_attention_bwd_dq_plain", "flash_attention_bwd_dkv_plain",
           "flash_attention_delta", "flash_attention_fwd",
           "flash_attention_lse_fwd", "flash_attention_bwd_dq",
           "flash_attention_bwd_dkv",
           "attention_packed", "attention_packed_neighbors",
           "attention_packed_plain", "attention_packed_neighbors_plain",
           "attention_packed_lse_plain", "attention_packed_bwd_dq_plain",
           "attention_packed_bwd_dkv_plain", "attention_delta",
           "attention_packed_capped_plain",
           "attention_packed_capped_lse_plain", "packed_attention_fwd",
           "packed_attention_nbr_fwd", "packed_attention_lse_fwd",
           "packed_attention_bwd_dq", "packed_attention_bwd_dkv",
           "packed_attention_capped_fwd", "packed_attention_capped_lse_fwd",
           "PackedAttention", "T_SCORE_CAP", "CAPPED_WARPS",
           "CAPPED_LSE_WARPS", "HEADPACK_MAX_LQ", "over_score_cap",
           "KERNEL_WRAPPERS", "SM90_KERNELS", "reset_launch_counts",
           "take_launch_counts",
           "SM90_MAX_HEAD_DIM", "sm90_in_scope", "sm90_attention_fwd",
           "sm90_attention_lse_fwd", "sm90_attention_nbr_fwd",
           "sm90_attention_bwd_dq", "sm90_attention_bwd_dkv",
           "KernelFlops", "recorded_kernel_flops"]

# Queries at least this long take the kernels.  Carried over from the JAX
# package's _PACKED_MIN_LQ (a TPU measurement); to be decided again on the
# H100.
PACKED_MIN_LQ = 512
# multi_head_attention sends a call with both lengths at least this long to
# flash_attention.  The JAX package's number (its dispatcher's ">= 1024",
# where a TPU score tile stops fitting in VMEM), to be decided again on the
# H100: chip_smoke.py phase 3 times mha_einsum beside the kernel at the
# SFA+ stage-2 shape.
FLASH_MIN_LEN = 1024
# Inference calls whose padded score tile up128(lq) * up128(lk) is over
# this take packed_attention_capped_fwd.  Carried over from the JAX
# package's _T_SCORE_CAP, the TPU's VMEM budget for a whole-sequence f32
# score tile; the port's kernels keep no score tile, so the split is to be
# decided again on the H100.
T_SCORE_CAP = 2 * 1024 * 1024
# Warps per block of packed_attention_capped_fwd's template instance (4 or
# 8), the faster of the two at the video ST-Attn shape (chip_smoke.py phase
# 3; PERF.md, kernel table row 6).  Calls in sm90_in_scope (the ST-Attn at
# d = 40 among them) take sm90_attention_fwd, where it does not apply.
CAPPED_WARPS = 8
# Warps per block of packed_attention_capped_lse_fwd's template instance (4
# or 8), the faster of the two at the ST-Attn training shape (chip_smoke.py
# phase 3; PERF.md, kernel table row 7).  Calls in sm90_in_scope (the
# ST-Attn at d = 40 among them) take sm90_attention_lse_fwd, where it does
# not apply.
CAPPED_LSE_WARPS = 8
# Self-attention this short (lq == lk, the video temporal attention over
# the frame axis) is the JAX package's head-packed path (_HEADPACK_MAX_LQ).
HEADPACK_MAX_LQ = 32
# Largest head_dim the CUDA kernels take (80 and 160 reach them at HD).
MAX_KERNEL_HEAD_DIM = 160
# Largest head_dim of the sm90 kernels: a 64-wide, 128-byte swizzled TMA
# box per row, and above 64 a second, 16-wide, 32-byte swizzled one (HD's
# second level, d = 80).
SM90_MAX_HEAD_DIM = 80

# ---------------------------------------------------------------- flops --
# The torch FLOP counter (utils/flops.py) sees aten ops only, never the
# ctypes kernels, so each kernel wrapper reports the hand-counted logical
# FLOPs of its call to the active recorders, with the JAX package's
# formulas (its _record_flops): 2 FLOPs a multiply-add, Q K^T and P V for a
# forward (4 B Lq Lk C, C = heads x head_dim; the split layout's B H Lq Lk D
# is the same product), both neighbours for the camera ring (8 B L L C),
# and the backward's five products, 10 B Lq Lk C, split between its two
# kernels: dq 4 (dP = dO V^T, dQ = dS K), dk/dv 6 (S = Q K^T, dV = P^T dO,
# dK = dS^T Q).  The einsum paths record nothing: the torch counter sees
# their GEMMs.  A wrapper records on either route, the plain version's for
# CPU tensors too, once per call; a forward that remat replays in the
# backward runs, and is counted, twice (launches likewise).


class KernelFlops:
    """What ``recorded_kernel_flops`` yields: ``total`` FLOPs and
    ``by_wrapper`` {wrapper name: FLOPs} of the kernel calls made while it
    was active."""

    def __init__(self):
        self.total = 0.0
        self.by_wrapper: Dict[str, float] = {}

    def add(self, name: str, flops: float) -> None:
        self.total += flops
        self.by_wrapper[name] = self.by_wrapper.get(name, 0.0) + flops


_RECORDERS: list = []


@contextlib.contextmanager
def recorded_kernel_flops() -> Iterator[KernelFlops]:
    """``with recorded_kernel_flops() as rec:`` every kernel wrapper call
    inside adds its hand-counted FLOPs to ``rec`` (recorders nest)."""
    rec = KernelFlops()
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def _record(wrapper: str, factor: int, q: torch.Tensor, lk: int) -> None:
    """``factor`` x (the batch, query and channel product of ``q``) x
    ``lk`` to every active recorder, under ``wrapper``."""
    if _RECORDERS:
        flops = float(factor * q.numel() * lk)
        for rec in _RECORDERS:
            rec.add(wrapper, flops)


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
    """(B, L, H, D) in and out: ``flash_attention`` when both lengths are at
    least ``FLASH_MIN_LEN`` (and head_dim at most ``MAX_KERNEL_HEAD_DIM``),
    ``mha_einsum`` otherwise."""
    if min(q.shape[1], k.shape[1]) >= FLASH_MIN_LEN \
            and q.shape[-1] <= MAX_KERNEL_HEAD_DIM:
        return flash_attention(q, k, v, scale)
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


def attention_packed_capped_plain(q, k, v, heads: int,
                                  scale: Optional[float] = None):
    """Plain version of ``packed_attention_capped_fwd``: exact softmax
    attention, float32 logits, softmax and products, rounded once to q's
    dtype.  The TPU kernel's K blocking with carried (m, l, acc) is an
    online evaluation of this same softmax."""
    return attention_packed_plain(q, k, v, heads, scale)


def attention_packed_capped_lse_plain(q, k, v, heads: int,
                                      scale: Optional[float] = None):
    """Plain version of ``packed_attention_capped_lse_fwd``: exact softmax
    attention and its logsumexp in float32, o rounded once to q's dtype;
    the same function as ``attention_packed_lse_plain``.  The TPU kernel's
    K blocking with carried (m, l, acc) is an online evaluation of it."""
    return attention_packed_lse_plain(q, k, v, heads, scale)


def _ring(n_cam: int, offset: int, n_local: Optional[int] = None,
          view0: int = 0):
    """The global views at ``offset`` on the camera ring of the ``n_local``
    views ``view0 ..`` (all ``n_cam`` by default)."""
    n_local = n_cam if n_local is None else n_local
    return [(view0 + i + offset) % n_cam for i in range(n_local)]


def _ring_take(t, n_cam: int, idx, rows: int):
    """Rows ``idx`` (global views) of each sample of ``t`` (B*n_cam, L, C)
    -> (rows, L, C)."""
    return t.reshape(-1, n_cam, *t.shape[1:])[:, idx].reshape(
        rows, *t.shape[1:])


def attention_packed_neighbors_plain(q, k, v, heads: int, n_cam: int,
                                     scale: Optional[float] = None,
                                     n_local: Optional[int] = None,
                                     view0: int = 0):
    """Plain version of ``packed_attention_nbr_fwd``: for view n,
    attn(q_n, K/V of view n-1) + attn(q_n, K/V of view n+1) on the camera
    ring, each with its own softmax, summed in float32, rounded once.
    ``n_local`` / ``view0``: q holds views ``view0 .. view0 + n_local - 1``
    of each sample (all ``n_cam`` by default), k and v all ``n_cam``."""
    bn = q.shape[0]
    scale = _default_scale(scale, q.shape[2] // heads)
    left, right = (_ring(n_cam, off, n_local, view0) for off in (-1, 1))
    take = lambda t, idx: _ring_take(t, n_cam, idx, bn)
    out = (_attention_f32(q, take(k, left), take(v, left), heads, scale)
           + _attention_f32(q, take(k, right), take(v, right), heads, scale))
    return out.to(q.dtype)


def _heads_f32(t, heads):
    b, n, c = t.shape
    return t.reshape(b, n, heads, c // heads).float()


def attention_packed_lse_plain(q, k, v, heads: int,
                               scale: Optional[float] = None):
    """Plain version of ``packed_attention_lse_fwd``: -> (o (B, Lq, C) in
    q's dtype, lse (B*H, Lq) float32), lse = log sum_k exp(s q.k), all in
    float32, o rounded once."""
    b, lq, c = q.shape
    scale = _default_scale(scale, c // heads)
    logits = torch.einsum("bqhd,bkhd->bhqk", _heads_f32(q, heads) * scale,
                          _heads_f32(k, heads))
    lse = torch.logsumexp(logits, dim=-1)  # (B, H, Lq)
    probs = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", probs, _heads_f32(v, heads))
    return out.reshape(b, lq, c).to(q.dtype), lse.reshape(b * heads, lq)


def attention_delta(o: torch.Tensor, do: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """delta = sum_d dO * O per (row, head, query), float32 (B*H, Lq),
    contiguous as the backward kernels take it, from the output as it was
    returned (bf16 on the card), as the JAX package takes it from
    ``out_t``."""
    b, lq, _ = o.shape
    prod = _heads_f32(do, heads) * _heads_f32(o, heads)
    # with B = 1 the reshape is a strided view, not a copy
    return prod.sum(-1).transpose(1, 2).reshape(b * heads, lq).contiguous()


def _probs_and_ds(q, k, v, do, lse, delta, heads, scale):
    """float32 P = exp(s Q K^T - lse) and dS = P * (dO V^T - delta), each
    (B, H, Lq, Lk)."""
    b, lq, _ = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", _heads_f32(q, heads),
                     _heads_f32(k, heads)) * scale
    p = torch.exp(s - lse.reshape(b, heads, lq, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", _heads_f32(do, heads),
                      _heads_f32(v, heads))
    return p, p * (dp - delta.reshape(b, heads, lq, 1))


def attention_packed_bwd_dq_plain(q, k, v, do, lse, delta, heads: int,
                                  scale: Optional[float] = None):
    """Plain version of ``packed_attention_bwd_dq``: dq = s dS K, float32,
    rounded once to q's dtype."""
    scale = _default_scale(scale, q.shape[-1] // heads)
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, heads, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, _heads_f32(k, heads)) * scale
    return dq.reshape(q.shape).to(q.dtype)


def attention_packed_bwd_dkv_plain(q, k, v, do, lse, delta, heads: int,
                                   scale: Optional[float] = None):
    """Plain version of ``packed_attention_bwd_dkv``: dk = s dS^T Q and
    dv = P^T dO, float32, rounded once to k's and v's dtype."""
    scale = _default_scale(scale, q.shape[-1] // heads)
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, heads, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, _heads_f32(q, heads)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, _heads_f32(do, heads))
    return dk.reshape(k.shape).to(k.dtype), dv.reshape(v.shape).to(v.dtype)


def _packed(t: torch.Tensor) -> torch.Tensor:
    """(B, L, H, D) -> (B, L, H*D), a view when contiguous."""
    return t.reshape(t.shape[0], t.shape[1], -1)


def flash_attention_plain(q, k, v, scale: Optional[float] = None):
    """Plain version of ``flash_attention_fwd``, (B, L, H, D) in and out:
    q scaled in float32 before the product, as in ``_fwd_kernel``; float32
    softmax and products, rounded once to q's dtype."""
    b, lq, h, d = q.shape
    out = attention_packed_plain(_packed(q), _packed(k), _packed(v), h,
                                 _default_scale(scale, d))
    return out.reshape(b, lq, h, d)


def flash_attention_lse_plain(q, k, v, scale: Optional[float] = None):
    """Plain version of ``flash_attention_lse_fwd``: -> (o (B, Lq, H, D) in
    q's dtype, lse (B*H, Lq) float32), lse = m + log l of ``_fwd_kernel``."""
    b, lq, h, d = q.shape
    out, lse = attention_packed_lse_plain(_packed(q), _packed(k), _packed(v),
                                          h, _default_scale(scale, d))
    return out.reshape(b, lq, h, d), lse


def flash_attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = sum_d dO * O, float32 (B*H, Lq), from the output as it was
    returned, as ``_flash_padded_bwd`` takes it."""
    return attention_delta(_packed(o), _packed(do), o.shape[2])


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                 scale: Optional[float] = None):
    """Plain version of ``flash_attention_bwd_dq``: the scale applied after
    the q.k product and to dq, as in ``_bwd_dq_kernel``; float32, rounded
    once to q's dtype."""
    h, d = q.shape[2:]
    dq = attention_packed_bwd_dq_plain(
        _packed(q), _packed(k), _packed(v), _packed(do), lse, delta, h,
        _default_scale(scale, d))
    return dq.reshape(q.shape)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                  scale: Optional[float] = None):
    """Plain version of ``flash_attention_bwd_dkv``: dk = s dS^T Q and dv =
    P^T dO over the real queries, as ``_bwd_dkv_kernel`` (its padded ones
    contribute nothing); float32, rounded once to k's and v's dtype."""
    h, d = q.shape[2:]
    dk, dv = attention_packed_bwd_dkv_plain(
        _packed(q), _packed(k), _packed(v), _packed(do), lse, delta, h,
        _default_scale(scale, d))
    return dk.reshape(k.shape), dv.reshape(v.shape)


# ------------------------------------------------------ kernel wrappers --

def _check_cuda_bf16(q, k, v, dims: int, layout: str) -> None:
    """q, k, v: contiguous bf16 CUDA tensors of ``dims`` dimensions on one
    device."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             "CUDA tensors")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes "
                             "bfloat16")
        if t.dim() != dims or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {layout} tensor")
    if q.device != k.device or q.device != v.device:
        raise ValueError("q, k and v lie on different devices")


def _check_kernel_args(q, k, v, heads, same_batch: bool = True):
    """``same_batch=False``: k and v may hold other rows than q (the
    camera ring's, checked by ``_check_ring_args``)."""
    _check_cuda_bf16(q, k, v, 3, "(B, L, C)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if k.shape != v.shape or (same_batch and k.shape[0] != q.shape[0]) \
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


def _check_grad_args(q, do, lse, delta, heads, align: int = 16):
    """The backward kernels' extra inputs: dO like q (``align``-byte
    aligned), lse and delta float32 (B*H, Lq)."""
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or not do.is_contiguous() or do.data_ptr() % align:
        raise ValueError(f"do must be a contiguous {align}-byte aligned "
                         "tensor of q's shape, dtype and device")
    want = (q.shape[0] * heads, q.shape[1])
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != want \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{name} must be a contiguous float32 {want} "
                             f"tensor on {q.device}")


def _refuse_grad(*tensors) -> None:
    """An inference kernel writes through raw pointers: its output has no
    grad_fn, so a differentiated call would cut the gradient silently."""
    if _differentiated(*tensors):
        raise RuntimeError(
            "the inference attention kernels are not differentiable; "
            "differentiated calls go through PackedAttention or "
            "FlashAttention")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(err: int, fn: str) -> None:
    if err:
        raise RuntimeError(f"{fn} failed to launch: cudaError {err}")


def sm90_in_scope(d: int, aligned: bool) -> bool:
    """The routing rule of every kernel wrapper: True when the sm90 kernels
    (``sm90_attention_fwd``, ``sm90_attention_lse_fwd``,
    ``sm90_attention_nbr_fwd``, ``sm90_attention_bwd_dq``,
    ``sm90_attention_bwd_dkv``) take a call of head_dim ``d`` whose rows
    start 16-byte ``aligned`` (TMA's stride and address rule); the other
    calls take the templates of ``csrc/attention.cu`` and
    ``csrc/attention_train.cu``."""
    return aligned and d % 8 == 0 and 0 < d <= SM90_MAX_HEAD_DIM


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _use_sm90(route: str, d: int, aligned: bool) -> bool:
    if route not in ("auto", "template"):
        raise ValueError(f"route={route!r}: 'auto' or 'template'")
    return route == "auto" and sm90_in_scope(d, aligned)


def _sm90_args(q, k, v, heads, scale, same_batch: bool = True):
    """(head_dim, scale) of a call the sm90 kernels take; raises on one
    outside ``sm90_in_scope``."""
    d = _check_kernel_args(q, k, v, heads, same_batch)
    if not sm90_in_scope(d, True):
        raise ValueError(f"head_dim {d}: the sm90 kernel takes multiples "
                         f"of 8 up to {SM90_MAX_HEAD_DIM}")
    return d, _default_scale(scale, d)


def _check_ring_args(q, k, v, n_cam, n_local, view0):
    """q (B*n_local, L, C), k and v (B*n_cam, L, C), views ``view0 ..
    view0 + n_local - 1`` of ``n_cam``; -> n_local."""
    n_local = n_cam if n_local is None else int(n_local)
    if n_cam < 1 or k.shape[0] % n_cam:
        raise ValueError(f"batch {k.shape[0]} is not a multiple of "
                         f"n_cam={n_cam}")
    if not 0 < n_local <= n_cam or not 0 <= view0 <= n_cam - n_local:
        raise ValueError(f"views {view0}..{view0 + n_local - 1} are not a "
                         f"run of n_cam={n_cam}")
    if k.shape != v.shape or q.shape[1:] != k.shape[1:] or \
            q.shape[0] != k.shape[0] // n_cam * n_local:
        raise ValueError(f"neighbor attention needs q (B*{n_local}, L, C) "
                         f"and k, v (B*{n_cam}, L, C): q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    return n_local


def sm90_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       heads: int,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Inference attention on Hopper, q (B, Lq, C), k/v (B, Lk, C) ->
    (B, Lq, C), head_dim a multiple of 8 up to ``SM90_MAX_HEAD_DIM``.

    CUDA kernel ``sm90_attention_fwd`` (``csrc/attention_sm90.cu``), the
    port of the TPU kernels ``_fwd_kernel_t``, ``_fwd_kernel_t_capped`` and
    ``_fwd_kernel_nolse`` for the calls in ``sm90_in_scope``; the three
    inference wrappers route those here.  CPU tensors take
    ``attention_packed_plain``."""
    if q.device.type == "cpu":
        return attention_packed_plain(q, k, v, heads, scale)
    _refuse_grad(q, k, v)
    d, scale = _sm90_args(q, k, v, heads, scale)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library("attention_sm90").dd_sm90_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.shape[0], q.shape[1], k.shape[1], heads, d, scale,
            _stream(q))
    _raise_on(err, "sm90_attention_fwd")
    sm90_attention_fwd.launches += 1
    return out


def sm90_attention_lse_fwd(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, heads: int,
                           scale: Optional[float] = None):
    """Training forward on Hopper, q (B, Lq, C), k/v (B, Lk, C) -> (o
    (B, Lq, C), lse (B*H, Lq) float32), head_dim a multiple of 8 up to
    ``SM90_MAX_HEAD_DIM``.

    CUDA kernel ``sm90_attention_lse_fwd`` (``csrc/attention_sm90.cu``, the
    kernel of ``sm90_attention_fwd`` with its lse epilogue), the port of
    the TPU kernels ``_fwd_kernel_t_lse``, ``_fwd_kernel_t_capped_lse`` and
    ``_fwd_kernel`` for the calls in ``sm90_in_scope``; the three lse
    wrappers route those here.  CPU tensors take
    ``attention_packed_lse_plain``."""
    if q.device.type == "cpu":
        return attention_packed_lse_plain(q, k, v, heads, scale)
    d, scale = _sm90_args(q, k, v, heads, scale)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0] * heads, q.shape[1], dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        err = library("attention_sm90").dd_sm90_attention_lse_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), q.shape[0], q.shape[1], k.shape[1], heads, d,
            scale, _stream(q))
    _raise_on(err, "sm90_attention_lse_fwd")
    sm90_attention_lse_fwd.launches += 1
    return out, lse


def sm90_attention_nbr_fwd(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, heads: int, n_cam: int,
                           scale: Optional[float] = None,
                           n_local: Optional[int] = None,
                           view0: int = 0) -> torch.Tensor:
    """Camera-ring attention on Hopper, q/k/v (B*n_cam, L, C) ->
    (B*n_cam, L, C), head_dim a multiple of 8 up to ``SM90_MAX_HEAD_DIM``:
    view n attends to views n-1 and n+1 (mod n_cam), two softmaxes, the
    halves summed in float32 and rounded once.  ``n_local`` / ``view0``
    (a rank's cameras under a view split): q and the output hold views
    ``view0 .. view0 + n_local - 1`` of each sample, (B*n_local, L, C),
    and k, v all ``n_cam``; each q row reads its sample's neighbour rows of
    k and v, so the output is those rows of the whole ring's.

    CUDA kernel ``sm90_attention_nbr_fwd`` (``csrc/attention_sm90.cu``, the
    kernel of ``sm90_attention_fwd`` with its ring flag: both neighbours in
    one work item, K/V read in place), the port of the TPU kernel
    ``_fwd_kernel_t_nbr`` for the calls in ``sm90_in_scope``;
    ``packed_attention_nbr_fwd`` routes those here.  CPU tensors take
    ``attention_packed_neighbors_plain``."""
    if q.device.type == "cpu":
        return attention_packed_neighbors_plain(q, k, v, heads, n_cam, scale,
                                                n_local, view0)
    _refuse_grad(q, k, v)
    d, scale = _sm90_args(q, k, v, heads, scale, same_batch=False)
    n_local = _check_ring_args(q, k, v, n_cam, n_local, view0)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library("attention_sm90").dd_sm90_attention_nbr_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.shape[0], q.shape[1], heads, d, n_cam, n_local, view0, scale,
            _stream(q))
    _raise_on(err, "sm90_attention_nbr_fwd")
    sm90_attention_nbr_fwd.launches += 1
    return out


def _sm90_grad_args(q, k, v, do, lse, delta, heads, scale):
    d, scale = _sm90_args(q, k, v, heads, scale)
    _check_grad_args(q, do, lse, delta, heads)
    return d, scale


def sm90_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          do: torch.Tensor, lse: torch.Tensor,
                          delta: torch.Tensor, heads: int,
                          scale: Optional[float] = None) -> torch.Tensor:
    """dq (B, Lq, C) on Hopper, the arguments of ``packed_attention_bwd_dq``,
    head_dim a multiple of 8 up to ``SM90_MAX_HEAD_DIM``.

    CUDA kernel ``sm90_attention_bwd_dq`` (``csrc/attention_sm90_bwd.cu``),
    the port of the TPU kernels ``_bwd_dq_kernel_t`` and ``_bwd_dq_kernel``
    for the calls in ``sm90_in_scope``; the two dq wrappers route those
    here.  CPU tensors take ``attention_packed_bwd_dq_plain``."""
    if q.device.type == "cpu":
        return attention_packed_bwd_dq_plain(q, k, v, do, lse, delta, heads,
                                             scale)
    d, scale = _sm90_grad_args(q, k, v, do, lse, delta, heads, scale)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library("attention_sm90_bwd").dd_sm90_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), q.shape[0],
            q.shape[1], k.shape[1], heads, d, scale, _stream(q))
    _raise_on(err, "sm90_attention_bwd_dq")
    sm90_attention_bwd_dq.launches += 1
    return dq


def sm90_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor,
                           heads: int, scale: Optional[float] = None):
    """(dk, dv), each (B, Lk, C), on Hopper, the arguments of
    ``packed_attention_bwd_dkv``, head_dim a multiple of 8 up to
    ``SM90_MAX_HEAD_DIM``.

    CUDA kernel ``sm90_attention_bwd_dkv`` (``csrc/attention_sm90_bwd.cu``),
    the port of the TPU kernels ``_bwd_dkv_kernel_t`` and ``_bwd_dkv_kernel``
    for the calls in ``sm90_in_scope``; the two dk/dv wrappers route those
    here.  CPU tensors take ``attention_packed_bwd_dkv_plain``."""
    if q.device.type == "cpu":
        return attention_packed_bwd_dkv_plain(q, k, v, do, lse, delta, heads,
                                              scale)
    d, scale = _sm90_grad_args(q, k, v, do, lse, delta, heads, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = library("attention_sm90_bwd").dd_sm90_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            q.shape[0], q.shape[1], k.shape[1], heads, d, scale, _stream(q))
    _raise_on(err, "sm90_attention_bwd_dkv")
    sm90_attention_bwd_dkv.launches += 1
    return dk, dv


def packed_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int, scale: Optional[float] = None, *,
                         route: str = "auto") -> torch.Tensor:
    """Inference attention, q (B, Lq, C), k/v (B, Lk, C) -> (B, Lq, C).

    CUDA kernel ``sm90_attention_fwd`` for calls in ``sm90_in_scope``
    (``route="template"``: not), else ``packed_attention_fwd``
    (``csrc/attention.cu``), the port of the TPU kernel ``_fwd_kernel_t``.
    CPU tensors take ``attention_packed_plain``."""
    _record("packed_attention_fwd", 4, q, k.shape[1])
    if q.device.type == "cpu":
        return attention_packed_plain(q, k, v, heads, scale)
    _refuse_grad(q, k, v)
    d = _check_kernel_args(q, k, v, heads)
    if _use_sm90(route, d, True):
        out = sm90_attention_fwd(q, k, v, heads, scale)
        packed_attention_fwd.launches += 1
        return out
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
                             scale: Optional[float] = None, *,
                             n_local: Optional[int] = None, view0: int = 0,
                             route: str = "auto") -> torch.Tensor:
    """Camera-ring neighbor attention (attn4 'add'), q/k/v (B*N, L, C) ->
    (B*N, L, C): view n attends to views n-1 and n+1 (mod N).  Under a
    view split q and the output hold a rank's ``n_local`` views ``view0
    ..`` of each sample, k and v all N (``sm90_attention_nbr_fwd``).

    CUDA kernel ``sm90_attention_nbr_fwd`` for calls in ``sm90_in_scope``
    (``route="template"``: not), else ``packed_attention_nbr_fwd``
    (``csrc/attention.cu``), the port of the TPU kernel
    ``_fwd_kernel_t_nbr``; K/V are read in place, never gathered.  Rows are
    16-byte aligned whenever ``_check_kernel_args`` lets a call through (an
    aligned base, d % 8 == 0), so alignment splits nothing here.  CPU
    tensors take ``attention_packed_neighbors_plain``."""
    _record("packed_attention_nbr_fwd", 8, q, q.shape[1])
    if q.device.type == "cpu":
        return attention_packed_neighbors_plain(q, k, v, heads, n_cam, scale,
                                                n_local, view0)
    _refuse_grad(q, k, v)
    d = _check_kernel_args(q, k, v, heads, same_batch=False)
    n_local = _check_ring_args(q, k, v, n_cam, n_local, view0)
    if _use_sm90(route, d, True):
        out = sm90_attention_nbr_fwd(q, k, v, heads, n_cam, scale, n_local,
                                     view0)
        packed_attention_nbr_fwd.launches += 1
        return out
    scale = _default_scale(scale, d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library("attention").dd_packed_attention_nbr_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.shape[0], q.shape[1], heads, d, n_cam, n_local, view0, scale,
            _stream(q))
    _raise_on(err, "packed_attention_nbr_fwd")
    packed_attention_nbr_fwd.launches += 1
    return out


def packed_attention_lse_fwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, heads: int,
                             scale: Optional[float] = None, *,
                             route: str = "auto"):
    """Training forward, q (B, Lq, C), k/v (B, Lk, C) -> (o (B, Lq, C),
    lse (B*H, Lq) float32).

    CUDA kernel ``sm90_attention_lse_fwd`` for calls in ``sm90_in_scope``
    (``route="template"``: not), else ``packed_attention_lse_fwd``
    (``csrc/attention.cu``), the port of the TPU kernel
    ``_fwd_kernel_t_lse``.  CPU tensors take
    ``attention_packed_lse_plain``."""
    _record("packed_attention_lse_fwd", 4, q, k.shape[1])
    if q.device.type == "cpu":
        return attention_packed_lse_plain(q, k, v, heads, scale)
    d = _check_kernel_args(q, k, v, heads)
    if _use_sm90(route, d, True):
        out, lse = sm90_attention_lse_fwd(q, k, v, heads, scale)
        packed_attention_lse_fwd.launches += 1
        return out, lse
    scale = _default_scale(scale, d)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0] * heads, q.shape[1], dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        err = library("attention").dd_packed_attention_lse_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), q.shape[0], q.shape[1], k.shape[1], heads, d,
            scale, _stream(q))
    _raise_on(err, "packed_attention_lse_fwd")
    packed_attention_lse_fwd.launches += 1
    return out, lse


def packed_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            heads: int, scale: Optional[float] = None, *,
                            route: str = "auto") -> torch.Tensor:
    """dq (B, Lq, C) of the attention whose forward gave ``lse``; ``do``
    the output cotangent, ``delta`` from ``attention_delta``.

    CUDA kernel ``sm90_attention_bwd_dq`` for calls in ``sm90_in_scope``
    (``route="template"``: not), else ``packed_attention_bwd_dq``
    (``csrc/attention_train.cu``), the port of the TPU kernel
    ``_bwd_dq_kernel_t``.  CPU tensors take
    ``attention_packed_bwd_dq_plain``."""
    _record("packed_attention_bwd_dq", 4, q, k.shape[1])
    if q.device.type == "cpu":
        return attention_packed_bwd_dq_plain(q, k, v, do, lse, delta, heads,
                                             scale)
    d = _check_kernel_args(q, k, v, heads)
    _check_grad_args(q, do, lse, delta, heads)
    if _use_sm90(route, d, True):
        dq = sm90_attention_bwd_dq(q, k, v, do, lse, delta, heads, scale)
        packed_attention_bwd_dq.launches += 1
        return dq
    scale = _default_scale(scale, d)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library("attention_train").dd_packed_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), q.shape[0],
            q.shape[1], k.shape[1], heads, d, scale, _stream(q))
    _raise_on(err, "packed_attention_bwd_dq")
    packed_attention_bwd_dq.launches += 1
    return dq


def packed_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor,
                             lse: torch.Tensor, delta: torch.Tensor,
                             heads: int, scale: Optional[float] = None, *,
                             route: str = "auto"):
    """(dk, dv), each (B, Lk, C), of the attention whose forward gave
    ``lse``.

    CUDA kernel ``sm90_attention_bwd_dkv`` for calls in ``sm90_in_scope``
    (``route="template"``: not), else ``packed_attention_bwd_dkv``
    (``csrc/attention_train.cu``), the port of the TPU kernel
    ``_bwd_dkv_kernel_t``.  CPU tensors take
    ``attention_packed_bwd_dkv_plain``."""
    _record("packed_attention_bwd_dkv", 6, q, k.shape[1])
    if q.device.type == "cpu":
        return attention_packed_bwd_dkv_plain(q, k, v, do, lse, delta, heads,
                                              scale)
    d = _check_kernel_args(q, k, v, heads)
    _check_grad_args(q, do, lse, delta, heads)
    if _use_sm90(route, d, True):
        dk, dv = sm90_attention_bwd_dkv(q, k, v, do, lse, delta, heads, scale)
        packed_attention_bwd_dkv.launches += 1
        return dk, dv
    scale = _default_scale(scale, d)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = library("attention_train").dd_packed_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            q.shape[0], q.shape[1], k.shape[1], heads, d, scale, _stream(q))
    _raise_on(err, "packed_attention_bwd_dkv")
    packed_attention_bwd_dkv.launches += 1
    return dk, dv


def packed_attention_capped_fwd(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, heads: int,
                                scale: Optional[float] = None,
                                warps: int = CAPPED_WARPS, *,
                                route: str = "auto") -> torch.Tensor:
    """Inference attention for long K, q (B, Lq, C), k/v (B, Lk, C) ->
    (B, Lq, C).

    CUDA kernel ``sm90_attention_fwd`` for calls in ``sm90_in_scope``
    (``route="template"``: not), else ``packed_attention_capped_fwd``
    (``csrc/attention.cu``) with ``warps`` per block, 4 or 8, the port of
    the TPU kernel ``_fwd_kernel_t_capped``.  CPU tensors take
    ``attention_packed_capped_plain``."""
    _record("packed_attention_capped_fwd", 4, q, k.shape[1])
    if q.device.type == "cpu":
        return attention_packed_capped_plain(q, k, v, heads, scale)
    _refuse_grad(q, k, v)
    d = _check_kernel_args(q, k, v, heads)
    if warps not in (4, 8):
        raise ValueError(f"warps={warps}: the kernel takes 4 or 8")
    if _use_sm90(route, d, True):
        out = sm90_attention_fwd(q, k, v, heads, scale)
        packed_attention_capped_fwd.launches += 1
        return out
    scale = _default_scale(scale, d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library("attention").dd_packed_attention_capped_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.shape[0], q.shape[1], k.shape[1], heads, d, warps, scale,
            _stream(q))
    _raise_on(err, "packed_attention_capped_fwd")
    packed_attention_capped_fwd.launches += 1
    return out


def packed_attention_capped_lse_fwd(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, heads: int,
                                    scale: Optional[float] = None,
                                    warps: int = CAPPED_LSE_WARPS, *,
                                    route: str = "auto"):
    """Training forward for long K, q (B, Lq, C), k/v (B, Lk, C) -> (o
    (B, Lq, C), lse (B*H, Lq) float32).

    CUDA kernel ``sm90_attention_lse_fwd`` for calls in ``sm90_in_scope``
    (``route="template"``: not), else ``packed_attention_capped_lse_fwd``
    (``csrc/attention.cu``) with ``warps`` per block, 4 or 8, the port of
    the TPU kernel ``_fwd_kernel_t_capped_lse``.  CPU tensors take
    ``attention_packed_capped_lse_plain``."""
    _record("packed_attention_capped_lse_fwd", 4, q, k.shape[1])
    if q.device.type == "cpu":
        return attention_packed_capped_lse_plain(q, k, v, heads, scale)
    d = _check_kernel_args(q, k, v, heads)
    if warps not in (4, 8):
        raise ValueError(f"warps={warps}: the kernel takes 4 or 8")
    if _use_sm90(route, d, True):
        out, lse = sm90_attention_lse_fwd(q, k, v, heads, scale)
        packed_attention_capped_lse_fwd.launches += 1
        return out, lse
    scale = _default_scale(scale, d)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0] * heads, q.shape[1], dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        err = library("attention").dd_packed_attention_capped_lse_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), q.shape[0], q.shape[1], k.shape[1], heads, d,
            warps, scale, _stream(q))
    _raise_on(err, "packed_attention_capped_lse_fwd")
    packed_attention_capped_lse_fwd.launches += 1
    return out, lse


def _check_split_args(q, k, v):
    """The split-layout kernels' inputs: contiguous bf16 (B, L, H, D) CUDA
    tensors, any alignment, head_dim 1 to ``MAX_KERNEL_HEAD_DIM``."""
    _check_cuda_bf16(q, k, v, 4, "(B, L, H, D)")
    b, _, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h,
                                                                       d):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if not 1 <= d <= MAX_KERNEL_HEAD_DIM:
        raise ValueError(f"head_dim {d}: the kernel takes 1 to "
                         f"{MAX_KERNEL_HEAD_DIM}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    return d


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None, *,
                        route: str = "auto") -> torch.Tensor:
    """Inference attention in the split layout, q (B, Lq, H, D), k/v
    (B, Lk, H, D) -> (B, Lq, H, D), any head_dim up to
    ``MAX_KERNEL_HEAD_DIM``.

    CUDA kernel ``sm90_attention_fwd`` on the packed view of the same
    memory for calls in ``sm90_in_scope`` (``route="template"``: not), else
    ``flash_attention_fwd`` (``csrc/attention.cu``), the port of the TPU
    kernel ``_fwd_kernel_nolse``.  CPU tensors take
    ``flash_attention_plain``."""
    _record("flash_attention_fwd", 4, q, k.shape[1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _refuse_grad(q, k, v)
    d = _check_split_args(q, k, v)
    if _use_sm90(route, d, _aligned(q, k, v)):
        out = sm90_attention_fwd(_packed(q), _packed(k), _packed(v),
                                 q.shape[2], scale)
        flash_attention_fwd.launches += 1
        return out.view(q.shape)
    scale = _default_scale(scale, d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library("attention").dd_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q.shape[0], q.shape[1], k.shape[1], q.shape[2], d, scale,
            _stream(q))
    _raise_on(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out


def flash_attention_lse_fwd(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: Optional[float] = None, *,
                            route: str = "auto"):
    """Training forward in the split layout, q (B, Lq, H, D), k/v
    (B, Lk, H, D) -> (o (B, Lq, H, D), lse (B*H, Lq) float32).

    CUDA kernel ``sm90_attention_lse_fwd`` on the packed view of the same
    memory for calls in ``sm90_in_scope`` (``route="template"``: not), else
    ``flash_attention_lse_fwd`` (``csrc/attention.cu``), the port of the TPU
    kernel ``_fwd_kernel``.  CPU tensors take
    ``flash_attention_lse_plain``."""
    _record("flash_attention_lse_fwd", 4, q, k.shape[1])
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, scale)
    d = _check_split_args(q, k, v)
    if _use_sm90(route, d, _aligned(q, k, v)):
        out, lse = sm90_attention_lse_fwd(_packed(q), _packed(k), _packed(v),
                                          q.shape[2], scale)
        flash_attention_lse_fwd.launches += 1
        return out.view(q.shape), lse
    scale = _default_scale(scale, d)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0] * q.shape[2], q.shape[1],
                      dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = library("attention").dd_flash_attention_lse_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), q.shape[0], q.shape[1], k.shape[1], q.shape[2],
            d, scale, _stream(q))
    _raise_on(err, "flash_attention_lse_fwd")
    flash_attention_lse_fwd.launches += 1
    return out, lse


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor,
                           scale: Optional[float] = None, *,
                           route: str = "auto") -> torch.Tensor:
    """dq (B, Lq, H, D) of the split-layout attention whose forward gave
    ``lse``; ``delta`` from ``flash_attention_delta``.

    CUDA kernel ``sm90_attention_bwd_dq`` on the packed view of the same
    memory for calls in ``sm90_in_scope`` (``route="template"``: not), else
    ``flash_attention_bwd_dq`` (``csrc/attention_train.cu``), the port of
    the TPU kernel ``_bwd_dq_kernel``.  CPU tensors take
    ``flash_attention_bwd_dq_plain``."""
    _record("flash_attention_bwd_dq", 4, q, k.shape[1])
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale)
    d = _check_split_args(q, k, v)
    _check_grad_args(q, do, lse, delta, q.shape[2], align=1)
    if _use_sm90(route, d, _aligned(q, k, v, do)):
        dq = sm90_attention_bwd_dq(_packed(q), _packed(k), _packed(v),
                                   _packed(do), lse, delta, q.shape[2], scale)
        flash_attention_bwd_dq.launches += 1
        return dq.view(q.shape)
    scale = _default_scale(scale, d)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = library("attention_train").dd_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), q.shape[0],
            q.shape[1], k.shape[1], q.shape[2], d, scale, _stream(q))
    _raise_on(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            scale: Optional[float] = None, *,
                            route: str = "auto"):
    """(dk, dv), each (B, Lk, H, D), of the split-layout attention whose
    forward gave ``lse``.

    CUDA kernel ``sm90_attention_bwd_dkv`` on the packed view of the same
    memory for calls in ``sm90_in_scope`` (``route="template"``: not), else
    ``flash_attention_bwd_dkv`` (``csrc/attention_train.cu``), the port of
    the TPU kernel ``_bwd_dkv_kernel``.  CPU tensors take
    ``flash_attention_bwd_dkv_plain``."""
    _record("flash_attention_bwd_dkv", 6, q, k.shape[1])
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    d = _check_split_args(q, k, v)
    _check_grad_args(q, do, lse, delta, q.shape[2], align=1)
    if _use_sm90(route, d, _aligned(q, k, v, do)):
        dk, dv = sm90_attention_bwd_dkv(_packed(q), _packed(k), _packed(v),
                                        _packed(do), lse, delta, q.shape[2],
                                        scale)
        flash_attention_bwd_dkv.launches += 1
        return dk.view(k.shape), dv.view(v.shape)
    scale = _default_scale(scale, d)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = library("attention_train").dd_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            q.shape[0], q.shape[1], k.shape[1], q.shape[2], d, scale,
            _stream(q))
    _raise_on(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


KERNEL_WRAPPERS = (packed_attention_fwd, packed_attention_nbr_fwd,
                   packed_attention_lse_fwd, packed_attention_bwd_dq,
                   packed_attention_bwd_dkv, packed_attention_capped_fwd,
                   packed_attention_capped_lse_fwd, flash_attention_fwd,
                   flash_attention_lse_fwd, flash_attention_bwd_dq,
                   flash_attention_bwd_dkv)
# the sm90 kernels behind the wrappers' in-scope calls (not wrappers: their
# launches are counted by the wrapper too)
SM90_KERNELS = (sm90_attention_fwd, sm90_attention_lse_fwd,
                sm90_attention_nbr_fwd, sm90_attention_bwd_dq,
                sm90_attention_bwd_dkv)
for _fn in KERNEL_WRAPPERS + SM90_KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    """Every wrapper's count and the sm90 kernels' to 0."""
    for fn in KERNEL_WRAPPERS + SM90_KERNELS:
        fn.launches = 0


def take_launch_counts() -> dict:
    """{name: launches} of every wrapper and sm90 kernel that launched
    since the last reset, then all counts to 0."""
    out = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS + SM90_KERNELS
           if fn.launches}
    reset_launch_counts()
    return out


class PackedAttention(torch.autograd.Function):
    """Differentiable channel-packed attention over the training kernels
    (the port of ``_flash_packed``'s VJP on its transposed-layout path).

    forward: ``packed_attention_lse_fwd``, or ``packed_attention_capped_lse_fwd``
    when the padded score tile is over ``T_SCORE_CAP``; saves q, k, v, o,
    lse.  backward: delta from the returned o, then
    ``packed_attention_bwd_dq`` and ``packed_attention_bwd_dkv``."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float):
        fwd = packed_attention_capped_lse_fwd \
            if over_score_cap(q.shape[1], k.shape[1]) \
            else packed_attention_lse_fwd
        out, lse = fwd(q, k, v, heads, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(out, do, ctx.heads)
        dq = packed_attention_bwd_dq(q, k, v, do, lse, delta, ctx.heads,
                                     ctx.scale)
        dk, dv = packed_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.heads,
                                          ctx.scale)
        return dq, dk, dv, None, None


class FlashAttention(torch.autograd.Function):
    """Differentiable split-layout attention, (B, L, H, D), over the
    training kernels (the port of ``_flash_padded``'s VJP).

    forward: ``flash_attention_lse_fwd``; saves q, k, v, o, lse.  backward:
    delta from the returned o, then ``flash_attention_bwd_dq`` and
    ``flash_attention_bwd_dkv``."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, lse = flash_attention_lse_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_attention_delta(out, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Split-layout attention, q (B, Lq, H, D), k/v (B, Lk, H, D) ->
    (B, Lq, H, D) (the JAX package's ``flash_attention``):
    ``flash_attention_fwd``, or ``FlashAttention`` when differentiated."""
    scale = _default_scale(scale, q.shape[-1])
    q, k, v = (t.contiguous() for t in (q, k, v))
    if _differentiated(q, k, v):
        return FlashAttention.apply(q, k, v, scale)
    return flash_attention_fwd(q, k, v, scale)


# -------------------------------------------------------------- routing --

def _takes_kernel(lq: int, d: int) -> bool:
    return lq >= PACKED_MIN_LQ and d % 8 == 0 and d <= MAX_KERNEL_HEAD_DIM


def _differentiated(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def over_score_cap(lq: int, lk: int) -> bool:
    """True when the padded score tile up128(lq) * up128(lk) is over
    ``T_SCORE_CAP`` (the JAX package's ``_packed_infer`` test)."""
    up128 = lambda x: -(-x // 128) * 128
    return up128(lq) * up128(lk) > T_SCORE_CAP


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int, scale: Optional[float] = None):
    """Channel-packed attention: q (B, Lq, C), k/v (B, Lk, C) -> (B, Lq, C).

    The JAX package's frame-axis head-packed path (lq == lk <=
    ``HEADPACK_MAX_LQ``, the video temporal attention) is the same per-head
    math with a block-diagonal mask, so the port sends it to einsum like
    every other short query, recomputed in the backward under grad.  A
    head_dim the packed kernels do not take (``d % 8 != 0``) goes to the
    split-layout kernels (``flash_attention``); under grad with fewer than
    ``FLASH_MIN_LEN`` keys, to einsum."""
    d = q.shape[-1] // heads
    scale = _default_scale(scale, d)
    if q.shape[1] == k.shape[1] <= HEADPACK_MAX_LQ \
            and _differentiated(q, k, v):
        return checkpoint(_einsum_packed, q, k, v, scale, heads,
                          use_reentrant=False)
    if _takes_kernel(q.shape[1], d):
        if _differentiated(q, k, v):
            return PackedAttention.apply(q, k, v, heads, scale)
        if over_score_cap(q.shape[1], k.shape[1]):
            return packed_attention_capped_fwd(q, k, v, heads, scale)
        return packed_attention_fwd(q, k, v, heads, scale)
    if q.shape[1] >= PACKED_MIN_LQ and d % 8 and d <= MAX_KERNEL_HEAD_DIM \
            and (not _differentiated(q, k, v)
                 or k.shape[1] >= FLASH_MIN_LEN):
        # d % 8 != 0: the split-layout kernels, as _packed_infer falls back
        # to them; under grad only with long K, as _flash_packed_fwd
        split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, d)
        out = flash_attention(split(q), split(k), split(v), scale)
        return out.reshape(q.shape[0], q.shape[1], q.shape[2])
    return _einsum_packed(q, k, v, scale, heads)


def attention_packed_neighbors(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, heads: int, n_cam: int,
                               scale: Optional[float] = None,
                               view0: int = 0):
    """Ring-neighbor multiview attention (attn4 'add'): q/k/v are the
    per-view projections (B*n_cam, L, C); returns, for each view, the sum
    over its left and right camera neighbors of attention(q, kv[nbr]).
    Under a view split q holds a rank's views ``view0 ..`` of each sample,
    (B*n_local, L, C), and k, v all ``n_cam`` of them (gathered)."""
    d = q.shape[-1] // heads
    scale = _default_scale(scale, d)
    if not _takes_kernel(q.shape[1], d):
        return _nbr_stacked(q, k, v, n_cam, lambda *t: _einsum_packed(
            *t, scale, heads), view0)
    if _differentiated(q, k, v):
        return _nbr_stacked(q, k, v, n_cam, lambda *t: PackedAttention.apply(
            *t, heads, scale), view0)
    return packed_attention_nbr_fwd(q, k, v, heads, n_cam, scale,
                                    n_local=q.shape[0] * n_cam // k.shape[0],
                                    view0=view0)


def _nbr_stacked(q, k, v, n_cam: int, call, view0: int = 0):
    """The JAX package's ``_nbr_stacked``: stack [left; right] neighbours'
    K/V on the batch dim, one ``call(q2, k2, v2)``, sum the halves.  Under
    autograd the gather's backward sums dK/dV back onto each view.  q may
    hold a rank's views ``view0 ..`` of each sample (k, v all ``n_cam``)."""
    bn = q.shape[0]
    n_local = bn * n_cam // k.shape[0]
    left, right = (_ring(n_cam, off, n_local, view0) for off in (-1, 1))
    take = lambda t, idx: _ring_take(t, n_cam, idx, bn)
    out2 = call(torch.cat([q, q]), torch.cat([take(k, left), take(k, right)]),
                torch.cat([take(v, left), take(v, right)]))
    return out2[:bn] + out2[bn:]
