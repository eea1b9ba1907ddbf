"""The port's training attention against the JAX package's training kernels.

``PackedAttention`` (forward with lse, backward through the dq and dk/dv
wrappers) runs its plain PyTorch versions on CPU tensors; it is held here
against ``jax.vjp`` of ``_flash_packed``, whose training VJP runs the three
Pallas kernels ``_fwd_kernel_t_lse``, ``_bwd_dq_kernel_t`` and
``_bwd_dkv_kernel_t`` in interpret mode (as ``tests/test_ops.py`` runs
them), and, over the score cap (512 queries x 4097 keys, as the capped
routing test of ``test_torch_attention.py`` uses), ``_fwd_kernel_t_capped_lse``
in place of the first.  Inputs and the cotangent are float32 from a seeded
numpy generator.

Tolerances: 2e-5 absolute on the output and lse (magnitude ~1, both sides
float32, only the order of sums differs); 1e-4 absolute on dq/dk/dv, whose
magnitude reaches ~10 and which sum 158-600 products of such terms.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.ops.attention import (_flash_packed, _flash_packed_nbr,
                                        _packed_train_t_fwd)
from dualdiff_tpu_torch.ops import attention as A

ATOL_OUT = 2e-5
ATOL_GRAD = 1e-4


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


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


def _port_vjp(fn, q, k, v, g):
    qt, kt, vt = (tp.t(x).requires_grad_() for x in (q, k, v))
    out = fn(qt, kt, vt)
    out.backward(tp.t(g))
    return out, qt.grad, kt.grad, vt.grad


@pytest.mark.parametrize("lk", [158, 300])
@pytest.mark.parametrize("d", [8, 16])
def test_packed_attention_matches_train_kernels_vjp(lk, d, monkeypatch):
    heads, b, lq = 4, 2, 300
    c = heads * d
    scale = 1.0 / math.sqrt(d)
    q, k, v, g = _arrays(lk + d, (b, lq, c), (b, lk, c), (b, lk, c),
                         (b, lq, c))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_out, vjp = jax.vjp(
        lambda *a: _flash_packed(*a, scale, heads, (lq, lk)), jq, jk, jv)
    want_grads = vjp(jnp.asarray(g))
    _, res = _packed_train_t_fwd(jq, jk, jv, scale, heads, (lq, lk))
    want_lse = np.asarray(res[-1])[:, 0, :lq]

    calls = _count_calls(monkeypatch, "packed_attention_lse_fwd",
                         "packed_attention_bwd_dq",
                         "packed_attention_bwd_dkv")
    out, *grads = _port_vjp(
        lambda *a: A.PackedAttention.apply(*a, heads, scale), q, k, v, g)
    assert calls == {"packed_attention_lse_fwd": 1,
                     "packed_attention_bwd_dq": 1,
                     "packed_attention_bwd_dkv": 1}
    tp.assert_close(out, want_out, rtol=0, atol=ATOL_OUT, what="out")
    _, lse = A.packed_attention_lse_fwd(tp.t(q), tp.t(k), tp.t(v), heads,
                                        scale)
    tp.assert_close(lse, want_lse, rtol=0, atol=ATOL_OUT, what="lse")
    for name, got, want in zip("qkv", grads, want_grads):
        tp.assert_close(got, want, rtol=0, atol=ATOL_GRAD, what=f"d{name}")


@pytest.mark.parametrize("d", [8, 16])
def test_neighbor_attention_under_grad_matches_flash_packed_nbr_vjp(
        d, monkeypatch):
    """attn4 under grad: the stacked formulation through PackedAttention
    (routing threshold lowered to this test's 300 tokens) against the VJP
    of ``_flash_packed_nbr``, which also stacks and runs the training
    kernels."""
    heads, n_cam, b, l = 2, 6, 1, 300
    c = heads * d
    scale = 1.0 / math.sqrt(d)
    q, k, v, g = _arrays(d, *[(b * n_cam, l, c)] * 4)
    want_out, vjp = jax.vjp(
        lambda *a: _flash_packed_nbr(*a, scale, heads, n_cam, (l, l)),
        *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(g))

    monkeypatch.setattr(A, "PACKED_MIN_LQ", 256)
    calls = _count_calls(monkeypatch, "packed_attention_lse_fwd",
                         "packed_attention_nbr_fwd",
                         "packed_attention_bwd_dkv")
    out, *grads = _port_vjp(
        lambda *a: A.attention_packed_neighbors(*a, heads, n_cam), q, k, v, g)
    assert calls == {"packed_attention_lse_fwd": 1,
                     "packed_attention_nbr_fwd": 0,
                     "packed_attention_bwd_dkv": 1}
    tp.assert_close(out, want_out, rtol=0, atol=ATOL_OUT, what="out")
    for name, got, want in zip("qkv", grads, want_grads):
        tp.assert_close(got, want, rtol=0, atol=ATOL_GRAD, what=f"d{name}")


def test_routing_of_differentiated_and_plain_calls(monkeypatch):
    """Only a call with grad enabled and an input that requires grad goes
    to ``PackedAttention``; a frozen call (no input requires grad, or
    ``no_grad``) takes the inference wrapper, as the JAX primal does."""
    calls = _count_calls(monkeypatch, "packed_attention_fwd",
                         "packed_attention_lse_fwd")
    q, k, v = (tp.t(x) for x in _arrays(0, *[(1, 512, 32)] * 3))
    A.attention_packed(q, k, v, heads=4)
    assert calls == {"packed_attention_fwd": 1, "packed_attention_lse_fwd": 0}
    with torch.no_grad():
        A.attention_packed(q, k.requires_grad_(), v, heads=4)
    assert calls == {"packed_attention_fwd": 2, "packed_attention_lse_fwd": 0}
    out = A.attention_packed(q, k, v, heads=4)
    assert calls == {"packed_attention_fwd": 2, "packed_attention_lse_fwd": 1}
    assert type(out.grad_fn).__name__ == "PackedAttentionBackward"


def test_inference_wrappers_raise_under_grad():
    """The inference kernels write through raw pointers and return a tensor
    without grad_fn: under grad they raise instead of cutting the gradient.
    A non-CPU (meta) tensor reaches the check on a machine without a card;
    nothing launches."""
    A.reset_launch_counts()
    q = torch.empty(2, 512, 64, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    with pytest.raises(RuntimeError, match="PackedAttention"):
        A.packed_attention_fwd(q, q, q, heads=8)
    with pytest.raises(RuntimeError, match="PackedAttention"):
        A.packed_attention_nbr_fwd(q, q, q, heads=8, n_cam=2)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        A.packed_attention_fwd(q, q, q, heads=8)
    assert all(fn.launches == 0 for fn in A.KERNEL_WRAPPERS)


CAP_SHAPE = dict(heads=2, d=8, b=1, lq=512, lk=4097)  # 512 * 4224 > 2^21


def _over_cap_inputs():
    heads, d, b, lq, lk = CAP_SHAPE.values()
    c = heads * d
    return _arrays(7, (b, lq, c), (b, lk, c), (b, lk, c), (b, lq, c))


def test_capped_lse_plain_matches_fwd_kernel_t_capped_lse():
    """``attention_packed_capped_lse_plain`` (o and lse) against the
    over-cap branch of ``_packed_train_t_fwd`` (K/V in blocks of
    ``_capped_block_k(512)``, the last one ragged)."""
    heads, d, _, lq, lk = CAP_SHAPE.values()
    q, k, v, _ = _over_cap_inputs()
    scale = 1.0 / math.sqrt(d)
    assert A.over_score_cap(lq, lk)
    want_out, res = _packed_train_t_fwd(*map(jnp.asarray, (q, k, v)), scale,
                                        heads, (lq, lk))
    want_lse = np.asarray(res[-1])[:, 0, :lq]
    out, lse = A.packed_attention_capped_lse_fwd(tp.t(q), tp.t(k), tp.t(v),
                                                 heads, scale)
    tp.assert_close(out, want_out, rtol=0, atol=ATOL_OUT, what="out")
    tp.assert_close(lse, want_lse, rtol=0, atol=ATOL_OUT, what="lse")


def test_packed_attention_over_the_cap_matches_flash_packed_vjp(monkeypatch):
    """Over the cap ``PackedAttention`` takes the capped forward and the
    same dq and dk/dv wrappers, as the JAX VJP pairs
    ``_fwd_kernel_t_capped_lse`` with its blocked backward kernels."""
    heads, d, _, lq, lk = CAP_SHAPE.values()
    q, k, v, g = _over_cap_inputs()
    scale = 1.0 / math.sqrt(d)
    want_out, vjp = jax.vjp(
        lambda *a: _flash_packed(*a, scale, heads, (lq, lk)),
        *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    calls = _count_calls(monkeypatch, "packed_attention_lse_fwd",
                         "packed_attention_capped_lse_fwd",
                         "packed_attention_bwd_dq",
                         "packed_attention_bwd_dkv")
    out, *grads = _port_vjp(
        lambda *a: A.attention_packed(*a, heads, scale), q, k, v, g)
    assert calls == {"packed_attention_lse_fwd": 0,
                     "packed_attention_capped_lse_fwd": 1,
                     "packed_attention_bwd_dq": 1,
                     "packed_attention_bwd_dkv": 1}
    assert type(out.grad_fn).__name__ == "PackedAttentionBackward"
    tp.assert_close(out, want_out, rtol=0, atol=ATOL_OUT, what="out")
    for name, got, want in zip("qkv", grads, want_grads):
        tp.assert_close(got, want, rtol=0, atol=ATOL_GRAD, what=f"d{name}")


@pytest.mark.parametrize("lk, grad, route", [
    (4096, True, "packed_attention_lse_fwd"),         # 512 * 4096 == 2^21
    (4097, True, "packed_attention_capped_lse_fwd"),  # over the cap
    (4097, False, "packed_attention_capped_fwd"),     # inference
])
def test_routing_of_long_k_under_grad(lk, grad, route, monkeypatch):
    """The forward a call takes at and over ``T_SCORE_CAP``, with grad and
    without: the inference wrappers only without, the capped ones only
    over the cap."""
    names = ("packed_attention_fwd", "packed_attention_capped_fwd",
             "packed_attention_lse_fwd", "packed_attention_capped_lse_fwd")
    calls = _count_calls(monkeypatch, *names)
    q, k, v = (tp.t(x).requires_grad_(grad)
               for x in _arrays(lk, (1, 512, 16), (1, lk, 16), (1, lk, 16)))
    A.attention_packed(q, k, v, heads=2)
    assert calls == {n: int(n == route) for n in names}
