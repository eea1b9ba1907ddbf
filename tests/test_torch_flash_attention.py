"""The port's split-layout attention against the JAX package's flash kernels.

``flash_attention_plain`` / ``flash_attention_lse_plain`` (the plain
versions of ``flash_attention_fwd`` / ``flash_attention_lse_fwd``) are held
against the JAX ``flash_attention`` and its ``_fwd_core``, whose Pallas
kernels ``_fwd_kernel_nolse`` and ``_fwd_kernel`` run in interpret mode (as
``tests/test_ops.py`` runs them), with 128-row blocks so that the lengths
are not block multiples and the K loop masks a ragged last block.
``FlashAttention`` (forward with lse, backward through the dq and dk/dv
wrappers, their plain versions on the CPU) is held against ``jax.vjp`` of
``flash_attention``, whose backward runs ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``.  Inputs and the cotangent are float32 from a seeded
numpy generator; layouts are ``(B, L, H, D)`` on both sides.

Tolerances: 2e-5 absolute on the output (magnitude ~1, both sides float32,
only the order of sums differs); 1e-4 absolute on lse, whose magnitude is
log(Lk) + the largest logit, ~6, the log of a float32 sum of 130-517 terms
(1.7e-5 relative; one run of the whole suite read 4.3e-5, where this file
alone reads under 2e-5); 1e-4 absolute on dq/dk/dv, which sum a few
hundred products of such terms (as ``ATOL_GRAD`` in
``test_torch_attention_train.py``).

Routing: ``multi_head_attention`` sends both lengths >= ``FLASH_MIN_LEN``
to ``flash_attention``; ``attention_packed`` sends ``d % 8 != 0`` queries of
at least ``PACKED_MIN_LQ`` tokens there (under grad only with at least
``FLASH_MIN_LEN`` keys).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.ops.attention import _fwd_core, _pad_to, flash_attention
from dualdiff_tpu_torch.ops import attention as A

ATOL_OUT = 2e-5
ATOL_LSE = 1e-4
ATOL_GRAD = 1e-4
BLOCK = 128

SHAPES = [  # b, lq, lk, heads, d
    (2, 300, 200, 2, 4),    # the tiny models' SFA+ head_dim, lq != lk
    (1, 333, 517, 2, 20),   # d % 8 != 0, lk over four blocks
    (2, 260, 130, 2, 40),   # the full-width head_dim
]


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _inputs(seed, b, lq, lk, heads, d):
    return _arrays(seed, (b, lq, heads, d), (b, lk, heads, d),
                   (b, lk, heads, d), (b, lq, heads, d))


def _jax_lse(q, k, v, scale):
    """lse (B*H, Lq) of ``_fwd_kernel`` through ``_fwd_core``, with the
    layout and padding ``flash_attention`` gives it."""
    b, lq, h, d = q.shape

    def to_bh(x):
        x = jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))
        return _pad_to(x.reshape(b * h, x.shape[2], d), 1, BLOCK)

    _, lse = _fwd_core(to_bh(q), to_bh(k), to_bh(v), scale, BLOCK, BLOCK,
                       k.shape[1])
    return np.asarray(lse)[:, :lq, 0]


def _count_calls(monkeypatch, *names):
    """Wrap the named wrappers of the port's attention module to count the
    calls the routing makes (on the CPU they launch nothing)."""
    calls = {n: 0 for n in names}
    for n in names:
        real = getattr(A, n)

        def wrapped(*a, _real=real, _n=n, **kw):
            calls[_n] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(A, n, wrapped)
    return calls


@pytest.mark.parametrize("b, lq, lk, heads, d", SHAPES)
def test_plain_forward_matches_fwd_kernels(b, lq, lk, heads, d):
    q, k, v, _ = _inputs(lq + d, b, lq, lk, heads, d)
    scale = 1.0 / math.sqrt(d)
    want = flash_attention(*map(jnp.asarray, (q, k, v)), block_q=BLOCK,
                           block_k=BLOCK)
    got = A.flash_attention_fwd(tp.t(q), tp.t(k), tp.t(v))
    assert got.shape == (b, lq, heads, d)
    tp.assert_close(got, want, rtol=0, atol=ATOL_OUT, what="out (nolse)")
    out, lse = A.flash_attention_lse_fwd(tp.t(q), tp.t(k), tp.t(v), scale)
    assert lse.shape == (b * heads, lq) and lse.dtype == torch.float32
    tp.assert_close(out, want, rtol=0, atol=ATOL_OUT, what="out (lse)")
    tp.assert_close(lse, _jax_lse(q, k, v, scale), rtol=0, atol=ATOL_LSE,
                    what="lse")


@pytest.mark.parametrize("b, lq, lk, heads, d", SHAPES)
def test_flash_attention_function_matches_flash_attention_vjp(
        b, lq, lk, heads, d, monkeypatch):
    q, k, v, g = _inputs(lk + d, b, lq, lk, heads, d)
    want_out, vjp = jax.vjp(
        lambda *a: flash_attention(*a, block_q=BLOCK, block_k=BLOCK),
        *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(g))

    calls = _count_calls(monkeypatch, "flash_attention_fwd",
                         "flash_attention_lse_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv")
    qt, kt, vt = (tp.t(x).requires_grad_() for x in (q, k, v))
    out = A.flash_attention(qt, kt, vt)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(tp.t(g))
    assert calls == {"flash_attention_fwd": 0, "flash_attention_lse_fwd": 1,
                     "flash_attention_bwd_dq": 1,
                     "flash_attention_bwd_dkv": 1}
    tp.assert_close(out, want_out, rtol=0, atol=ATOL_OUT, what="out")
    for name, got, want in zip("qkv", (qt.grad, kt.grad, vt.grad),
                               want_grads):
        tp.assert_close(got, want, rtol=0, atol=ATOL_GRAD, what=f"d{name}")


ROUTES = ("flash_attention_fwd", "flash_attention_lse_fwd",
          "packed_attention_fwd", "packed_attention_lse_fwd")


@pytest.mark.parametrize("lq, lk, grad, route", [
    (1024, 1024, False, "flash_attention_fwd"),
    (1024, 1024, True, "flash_attention_lse_fwd"),
    (1024, 1023, False, None),     # one length under FLASH_MIN_LEN: einsum
    (1023, 1024, True, None),
])
def test_multi_head_attention_routing(lq, lk, grad, route, monkeypatch):
    calls = _count_calls(monkeypatch, *ROUTES)
    q, k, v = (tp.t(x).requires_grad_(grad) for x in _arrays(
        lq + lk, (1, lq, 2, 4), (1, lk, 2, 4), (1, lk, 2, 4)))
    out = A.multi_head_attention(q, k, v)
    assert calls == {n: int(n == route) for n in ROUTES}
    want = A.mha_einsum(q.detach(), k.detach(), v.detach())
    tp.assert_close(out, want.numpy(), rtol=0, atol=ATOL_OUT)


@pytest.mark.parametrize("lq, lk, heads, grad, route", [
    (512, 300, 8, False, "flash_attention_fwd"),       # d = 4
    (512, 1024, 8, True, "flash_attention_lse_fwd"),   # d = 4, long K
    (512, 1023, 8, True, None),                        # d = 4, short K
    (511, 300, 8, False, None),                        # under PACKED_MIN_LQ
    (512, 300, 4, False, "packed_attention_fwd"),      # d = 8
])
def test_attention_packed_sends_odd_head_dims_to_the_split_kernels(
        lq, lk, heads, grad, route, monkeypatch):
    """``attention_packed`` with ``d % 8 != 0`` (32 channels over 8 heads,
    the tiny SFA+ width): the split-layout kernels, as ``_packed_infer``
    falls back to them, and under grad only with long K, as
    ``_flash_packed_fwd``; the result equals einsum's."""
    calls = _count_calls(monkeypatch, *ROUTES)
    q, k, v = (tp.t(x).requires_grad_(grad) for x in _arrays(
        lq + lk + heads, (2, lq, 32), (2, lk, 32), (2, lk, 32)))
    out = A.attention_packed(q, k, v, heads)
    assert calls == {n: int(n == route) for n in ROUTES}
    assert out.shape == q.shape
    want = A._einsum_packed(q.detach(), k.detach(), v.detach(),
                            (32 // heads) ** -0.5, heads)
    tp.assert_close(out, want.numpy(), rtol=0, atol=ATOL_OUT)


def test_split_inference_wrapper_raises_under_grad():
    """``flash_attention_fwd`` returns a tensor without grad_fn from the
    card: under grad it raises; a non-CPU (meta) tensor reaches the checks
    on a machine without a card, and nothing launches."""
    A.reset_launch_counts()
    q = torch.empty(2, 1024, 8, 5, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(RuntimeError, match="FlashAttention"):
        A.flash_attention_fwd(q, q, q)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        A.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        A.flash_attention_lse_fwd(q, q, q)
    assert all(fn.launches == 0 for fn in A.KERNEL_WRAPPERS)


@pytest.mark.parametrize("b", [1, 2])
def test_delta_is_contiguous(b):
    """The backward kernels take delta as a contiguous (B*H, Lq) tensor;
    with one batch row the (B, H, Lq) -> (B*H, Lq) reshape of the transposed
    sum is a strided view, which the card's wrappers refused."""
    o, do = (tp.t(x) for x in _arrays(b, (b, 64, 2, 3), (b, 64, 2, 3)))
    delta = A.flash_attention_delta(o, do)
    assert delta.shape == (b * 2, 64) and delta.is_contiguous()
    want = (o * do).sum(-1).transpose(1, 2).reshape(b * 2, 64)
    torch.testing.assert_close(delta, want, rtol=0, atol=0)
    assert A.attention_delta(o.reshape(b, 64, 6), do.reshape(b, 64, 6),
                             2).is_contiguous()
