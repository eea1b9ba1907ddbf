"""The port's CUDA kernels against their plain versions, on the card.

Mirrors the kernel phase of ``chip_smoke.py``: bf16 inputs at the flagship
and clip paths' shapes plus ragged ones, the training kernels also at the
video training step's ST-Attn (12 x 1400 x 2800, capped forward); the plain
version computes in float32 and rounds once.  Tolerance 2^-7 of the output's magnitude + 1e-3: the kernels
round one MMA operand to bf16 (P for P.V and dV, dS for dQ and dK) and the
output to bf16.  lse is float32 on both sides: 1e-3 absolute.  Every test is
marked ``cuda`` and skips without a card; run them on the GPU machine with
``python -m pytest tests/test_torch_kernels_cuda.py``.
"""

import pytest
import torch

from dualdiff_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _qkv(b, lq, lk, c, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(b, n, c, generator=g, device=device).bfloat16()
            for n in (lq, lk, lk)]


def _check(got, want):
    tol = 2.0 ** -7 * want.float().abs().max().item() + 1e-3
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("b, lq, lk, c, heads", [
    (24, 1400, 1400, 320, 8),   # attn1 at the 28x50 level
    (24, 1400, 158, 320, 8),    # attn2: 1 + 77 + 80 context tokens
    (3, 777, 333, 320, 4),      # ragged, d = 80
    (2, 513, 65, 1280, 8),      # d = 160
    (1, 64, 1, 64, 8),          # one key, d = 8
])
def test_packed_attention_kernel(cuda, b, lq, lk, c, heads):
    q, k, v = _qkv(b, lq, lk, c, cuda)
    A.reset_launch_counts()
    got = A.packed_attention_fwd(q, k, v, heads)
    torch.cuda.synchronize()
    assert A.packed_attention_fwd.launches == 1
    _check(got, A.attention_packed_plain(q, k, v, heads))


@pytest.mark.parametrize("b, n_cam, l, c, heads", [
    (4, 6, 1400, 320, 8),       # attn4 on the camera ring
    (2, 3, 701, 320, 4),        # ragged, d = 80
])
def test_neighbor_attention_kernel(cuda, b, n_cam, l, c, heads):
    q, k, v = _qkv(b * n_cam, l, l, c, cuda, seed=1)
    A.reset_launch_counts()
    got = A.packed_attention_nbr_fwd(q, k, v, heads, n_cam)
    torch.cuda.synchronize()
    assert A.packed_attention_nbr_fwd.launches == 1
    _check(got, A.attention_packed_neighbors_plain(q, k, v, heads, n_cam))


@pytest.mark.parametrize("warps", [4, 8])
@pytest.mark.parametrize("b, lq, lk, c, heads", [
    (96, 1400, 2800, 320, 8),   # video ST-Attn: first + previous frame
    (96, 1400, 2801, 320, 8),   # ragged lk
])
def test_capped_attention_kernel(cuda, b, lq, lk, c, heads, warps):
    q, k, v = _qkv(b, lq, lk, c, cuda, seed=6)
    A.reset_launch_counts()
    got = A.packed_attention_capped_fwd(q, k, v, heads, warps=warps)
    torch.cuda.synchronize()
    assert A.packed_attention_capped_fwd.launches == 1
    _check(got, A.attention_packed_capped_plain(q, k, v, heads))


@pytest.mark.parametrize("lk, kernel", [
    (2800, "packed_attention_capped_fwd"),  # 1408 * 2816 > 2^21
    (1400, "packed_attention_fwd"),         # 1408 * 1408 <= 2^21
])
def test_router_sends_long_k_to_the_capped_kernel(cuda, lk, kernel):
    q, k, v = _qkv(12, 1400, lk, 320, cuda, seed=7)
    A.reset_launch_counts()
    with torch.no_grad():
        got = A.attention_packed(q, k, v, 8)
    torch.cuda.synchronize()
    launched = {fn.__name__: fn.launches for fn in A.KERNEL_WRAPPERS}
    assert launched == {name: int(name == kernel) for name in launched}
    _check(got, A.attention_packed_plain(q, k, v, 8))


def test_kernel_refuses_float32(cuda):
    q, k, v = (t.float() for t in _qkv(1, 64, 64, 64, cuda))
    with pytest.raises(ValueError, match="bfloat16"):
        A.packed_attention_fwd(q, k, v, 8)


TRAIN_SHAPES = [
    (6, 1400, 1400, 320, 8),    # attn1, train_batch_size 1 x 6 views
    (12, 1400, 1400, 320, 8),   # attn4: both neighbours stacked
    (6, 1400, 158, 320, 8),     # attn2: 1 + 77 + 80 context tokens
    (3, 777, 333, 320, 4),      # ragged, d = 80
    (2, 513, 65, 1280, 8),      # d = 160
]


@pytest.mark.parametrize("b, lq, lk, c, heads", TRAIN_SHAPES)
def test_training_kernels(cuda, b, lq, lk, c, heads):
    q, k, v = _qkv(b, lq, lk, c, cuda, seed=2)
    do = _qkv(b, lq, 1, c, cuda, seed=3)[0]
    A.reset_launch_counts()
    o, lse = A.packed_attention_lse_fwd(q, k, v, heads)
    delta = A.attention_delta(o, do, heads)
    dq = A.packed_attention_bwd_dq(q, k, v, do, lse, delta, heads)
    dk, dv = A.packed_attention_bwd_dkv(q, k, v, do, lse, delta, heads)
    torch.cuda.synchronize()
    assert [fn.launches for fn in A.KERNEL_WRAPPERS] == [0, 0, 1, 1, 1, 0, 0]
    o_want, lse_want = A.attention_packed_lse_plain(q, k, v, heads)
    _check(o, o_want)
    assert (lse - lse_want).abs().max().item() <= 1e-3
    _check(dq, A.attention_packed_bwd_dq_plain(q, k, v, do, lse, delta,
                                               heads))
    dk_want, dv_want = A.attention_packed_bwd_dkv_plain(q, k, v, do, lse,
                                                        delta, heads)
    _check(dk, dk_want)
    _check(dv, dv_want)


@pytest.mark.parametrize("warps", [4, 8])
@pytest.mark.parametrize("lk", [2800, 2801])
def test_capped_training_kernels(cuda, lk, warps):
    """The video training step's ST-Attn under grad (2 frames x 6 views,
    1400 queries against the first and the previous frame's 2800 keys, and
    a ragged 2801): the capped forward with lse, then dq and dk/dv fed its
    lse."""
    b, lq, c, heads = 12, 1400, 320, 8
    q, k, v = _qkv(b, lq, lk, c, cuda, seed=8)
    do = _qkv(b, lq, 1, c, cuda, seed=9)[0]
    A.reset_launch_counts()
    o, lse = A.packed_attention_capped_lse_fwd(q, k, v, heads, warps=warps)
    delta = A.attention_delta(o, do, heads)
    dq = A.packed_attention_bwd_dq(q, k, v, do, lse, delta, heads)
    dk, dv = A.packed_attention_bwd_dkv(q, k, v, do, lse, delta, heads)
    torch.cuda.synchronize()
    assert [fn.launches for fn in A.KERNEL_WRAPPERS] == [0, 0, 0, 1, 1, 0, 1]
    o_want, lse_want = A.attention_packed_capped_lse_plain(q, k, v, heads)
    _check(o, o_want)
    assert (lse - lse_want).abs().max().item() <= 1e-3
    _check(dq, A.attention_packed_bwd_dq_plain(q, k, v, do, lse, delta,
                                               heads))
    dk_want, dv_want = A.attention_packed_bwd_dkv_plain(q, k, v, do, lse,
                                                        delta, heads)
    _check(dk, dk_want)
    _check(dv, dv_want)


def test_differentiated_long_k_takes_the_capped_training_forward(cuda):
    """Under grad, ST-Attn over ``T_SCORE_CAP`` goes through
    ``PackedAttention`` with the capped forward; its gradients agree with
    autograd through the float32 einsum path."""
    heads = 8
    q = _qkv(12, 1400, 1, 320, cuda, seed=10)[0].requires_grad_()
    k, v = (t.requires_grad_() for t in _qkv(12, 2800, 2800, 320, cuda,
                                              seed=11)[1:])
    w = _qkv(12, 1400, 1, 320, cuda, seed=12)[0]
    A.reset_launch_counts()
    out = A.attention_packed(q, k, v, heads)
    (out.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    assert [fn.launches for fn in A.KERNEL_WRAPPERS] == [0, 0, 0, 1, 1, 0, 1]
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = A._einsum_packed(*ref, 40 ** -0.5, heads)
    (want * w.float()).sum().backward()
    for got, r in zip((q, k, v), ref):
        _check(got.grad, r.grad)


def test_differentiated_attention_launches_the_training_kernels(cuda):
    """Under grad ``attention_packed`` goes through ``PackedAttention``:
    one forward with lse, then dq and dk/dv in the backward.  Its gradients
    agree with autograd through the float32 einsum path."""
    heads = 8
    q, k, v = (t.requires_grad_() for t in _qkv(2, 600, 600, 320, cuda, 4))
    w = _qkv(2, 600, 1, 320, cuda, seed=5)[0]
    A.reset_launch_counts()
    out = A.attention_packed(q, k, v, heads)
    (out.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    assert [fn.launches for fn in A.KERNEL_WRAPPERS] == [0, 0, 1, 1, 1, 0, 0]
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = A._einsum_packed(*ref, 40 ** -0.5, heads)
    (want * w.float()).sum().backward()
    for got, r in zip((q, k, v), ref):
        _check(got.grad, r.grad)


def test_inference_kernels_raise_under_grad(cuda):
    q, k, v = (t.requires_grad_() for t in _qkv(1, 64, 64, 64, cuda))
    with pytest.raises(RuntimeError, match="PackedAttention"):
        A.packed_attention_fwd(q, k, v, 8)
    with pytest.raises(RuntimeError, match="PackedAttention"):
        A.packed_attention_nbr_fwd(q, k, v, 8, n_cam=1)
