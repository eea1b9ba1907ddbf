"""The port's attention module against the JAX package's Pallas kernels.

The port's kernel wrappers take their plain PyTorch versions on CPU tensors;
those are held here against ``_packed_infer`` (``_fwd_kernel_t``),
``_flash_packed_nbr`` (``_fwd_kernel_t_nbr``) and ``_packed_infer_capped``
(``_fwd_kernel_t_capped``) run in Pallas interpret mode, as
``tests/test_ops.py`` runs them.  Inputs are float32 from a seeded numpy
generator; tolerance 2e-5 absolute on outputs of magnitude ~1 (1e-5 for the
capped kernel): both sides compute in float32, and only the order of the
sums differs.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parity as tp  # noqa: F401  (sets torch threads)
from dualdiff_tpu.ops.attention import (_einsum_packed, _flash_packed_nbr,
                                        _packed_infer, _packed_infer_capped)
from dualdiff_tpu_torch.ops import attention as A

ATOL = 2e-5


def _qkv(b, lq, lk, c, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, c)).astype(np.float32)
            for n in (lq, lk, lk)]


@pytest.mark.parametrize("lk", [158, 300])
@pytest.mark.parametrize("d", [8, 16])
def test_packed_plain_matches_fwd_kernel_t(lk, d):
    heads = 4
    b, lq, c = 2, 300, heads * d
    q, k, v = _qkv(b, lq, lk, c, seed=lk + d)
    want = _packed_infer(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         1.0 / math.sqrt(d), heads, (lq, lk))
    got = A.packed_attention_fwd(tp.t(q), tp.t(k), tp.t(v), heads)
    tp.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("d", [8, 16])
def test_neighbor_plain_matches_fwd_kernel_t_nbr(d):
    heads, n_cam, b, l = 2, 6, 1, 300
    c = heads * d
    q, k, v = _qkv(b * n_cam, l, l, c, seed=d)
    want = _flash_packed_nbr(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             1.0 / math.sqrt(d), heads, n_cam, (l, l))
    got = A.packed_attention_nbr_fwd(tp.t(q), tp.t(k), tp.t(v), heads, n_cam)
    tp.assert_close(got, want, rtol=0, atol=ATOL)


def test_padded_k_with_very_negative_logits_is_exact():
    """Every real logit <= -12.  The port computes the exact masked softmax
    and matches ``_einsum_packed``.

    The TPU kernel ``_fwd_kernel_t`` does not: its body ``_attn_body_t``
    (dualdiff_tpu/ops/attention.py:656-665) leaves the zero-padded K columns
    in the softmax and subtracts ``n_pad * exp(-m)`` from the denominator
    with ``m = max(max real logit, 0)``.  When every real logit is far below
    0 that subtraction cancels catastrophically in float32 (max abs error
    0.197 at logits near -11 and inf/NaN near -70 for b=1, lq=128, lk=30,
    h=2, d=8), so this case is checked against einsum, not the kernel."""
    heads, d, b, lq, lk = 2, 8, 1, 128, 30
    c = heads * d
    rng = np.random.default_rng(0)
    q = (4.0 + 0.1 * rng.normal(size=(b, lq, c))).astype(np.float32)
    k = (-3.0 + 0.1 * rng.normal(size=(b, lk, c))).astype(np.float32)
    v = rng.normal(size=(b, lk, c)).astype(np.float32)
    logits = np.einsum("bqhd,bkhd->bhqk", q.reshape(b, lq, heads, d),
                       k.reshape(b, lk, heads, d)) / math.sqrt(d)
    assert logits.max() <= -12.0
    want = _einsum_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          1.0 / math.sqrt(d), heads)
    got = A.attention_packed_plain(tp.t(q), tp.t(k), tp.t(v), heads)
    tp.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("logits", ["ordinary", "very negative"])
def test_capped_plain_matches_fwd_kernel_t_capped(logits):
    """``block_k=128`` carries (m, l, acc) over three K blocks, the last
    one ragged (300 keys in 384).  The TPU capped kernel masks keys >= Lk to
    -inf, so it stays exact also when every real logit is far below 0."""
    heads, d, b, lq, lk = 2, 8, 2, 200, 300
    c = heads * d
    q, k, v = _qkv(b, lq, lk, c, seed=3)
    if logits == "very negative":
        q, k = 4.0 + 0.1 * q, -3.0 + 0.1 * k
        assert np.einsum("bqhd,bkhd->bhqk", q.reshape(b, lq, heads, d),
                         k.reshape(b, lk, heads, d)).max() / math.sqrt(d) \
            <= -30.0
    want = _packed_infer_capped(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), 1.0 / math.sqrt(d), heads,
                                (lq, lk), block_k=128)
    got = A.packed_attention_capped_fwd(tp.t(q), tp.t(k), tp.t(v), heads)
    tp.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("lk, grad, route", [
    (4096, False, "packed_attention_fwd"),          # 512 * 4096 == 2^21
    (4097, False, "packed_attention_capped_fwd"),   # 512 * 4224 > 2^21
    (4097, True, "packed_attention_capped_lse_fwd"),  # the same under grad
])
def test_capped_routing_matches_reference(lk, grad, route, monkeypatch):
    """A non-differentiated call whose padded score tile is over
    ``T_SCORE_CAP`` takes the capped wrapper, as ``_packed_infer`` sends it
    to ``_packed_infer_capped``; a differentiated one ``PackedAttention``
    with the capped forward, as ``_packed_train_t_fwd`` picks
    ``_fwd_kernel_t_capped_lse``.  Either way the result equals the JAX
    einsum reference."""
    heads, d = 2, 8
    calls = []
    for name in ("packed_attention_fwd", "packed_attention_capped_fwd",
                 "packed_attention_lse_fwd",
                 "packed_attention_capped_lse_fwd"):
        real = getattr(A, name)
        monkeypatch.setattr(A, name, lambda *a, _r=real, _n=name, **kw:
                            calls.append(_n) or _r(*a, **kw))
    q, k, v = _qkv(1, 512, lk, heads * d, seed=lk)
    qt, kt, vt = (tp.t(x).requires_grad_(grad) for x in (q, k, v))
    got = A.attention_packed(qt, kt, vt, heads)
    want = _einsum_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          1.0 / math.sqrt(d), heads)
    assert calls == [route]
    tp.assert_close(got, want, rtol=0, atol=ATOL)


def test_cpu_tensors_take_plain_path_and_launch_nothing():
    A.reset_launch_counts()
    q, k, v = (tp.t(x) for x in _qkv(1, 512, 512, 32, seed=1))
    out = A.attention_packed(q, k, v, heads=4)
    torch.testing.assert_close(out, A.attention_packed_plain(q, k, v, 4))
    out = A.attention_packed_neighbors(torch.cat([q] * 6),
                                       torch.cat([k] * 6),
                                       torch.cat([v] * 6), 4, n_cam=6)
    assert out.shape == (6, 512, 32)
    assert A.packed_attention_fwd.launches == 0
    assert A.packed_attention_nbr_fwd.launches == 0


@pytest.mark.parametrize("lq, d, routed", [(511, 8, False), (512, 8, True),
                                           (512, 12, False)])
def test_routing_matches_reference(lq, d, routed, monkeypatch):
    """Queries >= 512 with d % 8 == 0 take the kernel wrapper (as
    ``_PACKED_MIN_LQ`` routes the JAX package on the TPU); the rest einsum.
    Either way the result equals the JAX einsum reference."""
    heads = 2
    calls = []
    real = A.packed_attention_fwd
    monkeypatch.setattr(A, "packed_attention_fwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v = _qkv(1, lq, 40, heads * d, seed=lq)
    got = A.attention_packed(tp.t(q), tp.t(k), tp.t(v), heads)
    want = _einsum_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          1.0 / math.sqrt(d), heads)
    assert bool(calls) == routed
    tp.assert_close(got, want, rtol=0, atol=ATOL)
