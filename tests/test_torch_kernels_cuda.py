"""The port's CUDA kernels against their plain versions, on the card.

Mirrors the kernel phase of ``chip_smoke.py``: bf16 inputs at the flagship
and clip paths' shapes plus ragged ones, the training kernels also at the
video training step's ST-Attn (12 x 1400 x 2800, capped forward), and the
split-layout kernels at the SFA+ stage-2 shapes (24 and 6 x 1400 x 1400,
d = 40), the tiny models' d = 4 and head dims that are not multiples of 8,
and at HD the ring over 5184 tokens and the second level's d = 80 (the
sm90 kernels' second TMA box, columns 64..79, also at d = 72 and alone,
with columns 0..63 zero); the plain version computes in float32 and rounds
once.  Tolerance 2^-7 of the output's magnitude + 1e-3: the kernels
round one MMA operand to bf16 (P for P.V and dV, dS for dQ and dK) and the
output to bf16.  lse is float32 on both sides: 1e-3 absolute.  The camera
ring's sm90 kernel is also held against a planted fault (one neighbour
replaced by the view itself): phase 3's comparison and phase 5's gate each
read it.  Every test is marked ``cuda`` and skips without a card; run them
on the GPU machine with ``python -m pytest tests/test_torch_kernels_cuda.py``.
"""

import json

import pytest
import torch

import chip_smoke
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


def _launched():
    """The wrappers that launched since the last reset, with their counts."""
    return {fn.__name__: fn.launches for fn in A.KERNEL_WRAPPERS
            if fn.launches}


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
    (6, 1296, 1296, 640, 8),    # HD 432x768's second level, d = 80
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
    (1, 6, 5184, 320, 8),       # HD 432x768's top level, one sample
])
def test_neighbor_attention_kernel(cuda, b, n_cam, l, c, heads):
    """The ring wrapper: d = 40 and HD's d = 80 take the sm90 ring."""
    q, k, v = _qkv(b * n_cam, l, l, c, cuda, seed=1)
    A.reset_launch_counts()
    got = A.packed_attention_nbr_fwd(q, k, v, heads, n_cam)
    torch.cuda.synchronize()
    assert A.packed_attention_nbr_fwd.launches == 1
    assert A.sm90_attention_nbr_fwd.launches == int(A.sm90_in_scope(
        c // heads, True))
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
    assert _launched() == {kernel: 1}
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
    assert _launched() == {"packed_attention_lse_fwd": 1,
                           "packed_attention_bwd_dq": 1,
                           "packed_attention_bwd_dkv": 1}
    o_want, lse_want = A.attention_packed_lse_plain(q, k, v, heads)
    _check(o, o_want)
    assert (lse - lse_want).abs().max().item() <= 1e-3
    _check(dq, A.attention_packed_bwd_dq_plain(q, k, v, do, lse, delta,
                                               heads))
    dk_want, dv_want = A.attention_packed_bwd_dkv_plain(q, k, v, do, lse,
                                                        delta, heads)
    _check(dk, dk_want)
    _check(dv, dv_want)


@pytest.mark.parametrize("route, warps", [("auto", 8), ("template", 4),
                                          ("template", 8)])
@pytest.mark.parametrize("lk", [2800, 2801])
def test_capped_training_kernels(cuda, lk, route, warps):
    """The video training step's ST-Attn under grad (2 frames x 6 views,
    1400 queries against the first and the previous frame's 2800 keys, and
    a ragged 2801): the capped forward with lse (the path's sm90 kernel, or
    the template at 4 or 8 warps), then dq and dk/dv fed its lse."""
    b, lq, c, heads = 12, 1400, 320, 8
    q, k, v = _qkv(b, lq, lk, c, cuda, seed=8)
    do = _qkv(b, lq, 1, c, cuda, seed=9)[0]
    A.reset_launch_counts()
    o, lse = A.packed_attention_capped_lse_fwd(q, k, v, heads, warps=warps,
                                               route=route)
    assert A.sm90_attention_lse_fwd.launches == (route == "auto")
    delta = A.attention_delta(o, do, heads)
    dq = A.packed_attention_bwd_dq(q, k, v, do, lse, delta, heads)
    dk, dv = A.packed_attention_bwd_dkv(q, k, v, do, lse, delta, heads)
    torch.cuda.synchronize()
    assert _launched() == {"packed_attention_capped_lse_fwd": 1,
                           "packed_attention_bwd_dq": 1,
                           "packed_attention_bwd_dkv": 1}
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
    assert _launched() == {"packed_attention_capped_lse_fwd": 1,
                           "packed_attention_bwd_dq": 1,
                           "packed_attention_bwd_dkv": 1}
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
    assert _launched() == {"packed_attention_lse_fwd": 1,
                           "packed_attention_bwd_dq": 1,
                           "packed_attention_bwd_dkv": 1}
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
    with pytest.raises(RuntimeError, match="FlashAttention"):
        A.flash_attention_fwd(*(t.view(1, 64, 8, 8) for t in (q, k, v)))


def _qkv4(b, lq, lk, heads, d, device, seed=0):
    """Split-layout (B, L, H, D) bf16 q, k, v."""
    return [t.view(t.shape[0], t.shape[1], heads, d)
            for t in _qkv(b, lq, lk, heads * d, device, seed)]


SPLIT_SHAPES = [
    (24, 1400, 1400, 8, 40),    # SFA+ stage 2 in generation (CFG batch)
    (6, 1400, 1400, 8, 40),     # SFA+ stage 2 in training
    (6, 1400, 1400, 8, 4),      # the tiny models' SFA+ (C = 32)
    (3, 777, 1111, 8, 20),      # d % 8 != 0, ragged
    (2, 300, 65, 3, 13),        # odd d
    (2, 513, 65, 8, 160),       # d = 160
    (1, 64, 1, 2, 1),           # one key, d = 1
]


@pytest.mark.parametrize("b, lq, lk, heads, d", SPLIT_SHAPES)
def test_split_attention_kernel(cuda, b, lq, lk, heads, d):
    q, k, v = _qkv4(b, lq, lk, heads, d, cuda, seed=13)
    A.reset_launch_counts()
    got = A.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert _launched() == {"flash_attention_fwd": 1}
    _check(got, A.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("b, lq, lk, heads, d", SPLIT_SHAPES)
def test_split_training_kernels(cuda, b, lq, lk, heads, d):
    q, k, v = _qkv4(b, lq, lk, heads, d, cuda, seed=14)
    do = _qkv4(b, lq, 1, heads, d, cuda, seed=15)[0]
    A.reset_launch_counts()
    o, lse = A.flash_attention_lse_fwd(q, k, v)
    delta = A.flash_attention_delta(o, do)
    dq = A.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert _launched() == {"flash_attention_lse_fwd": 1,
                           "flash_attention_bwd_dq": 1,
                           "flash_attention_bwd_dkv": 1}
    o_want, lse_want = A.flash_attention_lse_plain(q, k, v)
    _check(o, o_want)
    assert (lse - lse_want).abs().max().item() <= 1e-3
    _check(dq, A.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta))
    dk_want, dv_want = A.flash_attention_bwd_dkv_plain(q, k, v, do, lse,
                                                       delta)
    _check(dk, dk_want)
    _check(dv, dv_want)


def test_split_kernels_take_unaligned_rows(cuda):
    """d = 40 with every tensor starting 2 bytes past a 16-byte boundary:
    the entries stage element by element instead of with cp.async."""
    b, l, heads, d = 2, 600, 8, 40

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        assert out.data_ptr() % 16 and out.is_contiguous()
        return out

    q, k, v = (unaligned(t) for t in _qkv4(b, l, l, heads, d, cuda, 16))
    do = unaligned(_qkv4(b, l, 1, heads, d, cuda, seed=17)[0])
    _check(A.flash_attention_fwd(q, k, v), A.flash_attention_plain(q, k, v))
    o, lse = A.flash_attention_lse_fwd(q, k, v)
    delta = A.flash_attention_delta(o, do)
    _check(A.flash_attention_bwd_dq(q, k, v, do, lse, delta),
           A.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta))
    for got, want in zip(
            A.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
            A.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta)):
        _check(got, want)


@pytest.mark.parametrize("lq, lk, d, kernels", [
    (1400, 1400, 40, ("flash_attention_fwd",)),   # SFA+ stage 2
    (1400, 1023, 40, ()),                         # one length < 1024
    (1400, 77, 40, ()),                           # SFA+ stage 1
])
def test_multi_head_attention_routes_long_sequences_to_flash(
        cuda, lq, lk, d, kernels):
    q, k, v = _qkv4(2, lq, lk, 8, d, cuda, seed=18)
    A.reset_launch_counts()
    with torch.no_grad():
        got = A.multi_head_attention(q, k, v)
    torch.cuda.synchronize()
    assert _launched() == {n: 1 for n in kernels}
    _check(got, A.flash_attention_plain(q, k, v))


@pytest.mark.parametrize("heads, lk, kernels", [
    (8, 1400, ("flash_attention_lse_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")),   # d = 4: the split kernels
    (8, 600, ()),                             # d = 4, short K: einsum
    (4, 1400, ("packed_attention_lse_fwd", "packed_attention_bwd_dq",
               "packed_attention_bwd_dkv")),  # d = 8: the packed kernels
])
def test_differentiated_attention_routes_by_head_dim(cuda, heads, lk,
                                                     kernels):
    """Under grad, ``attention_packed`` at 1400 queries: d % 8 != 0 (d =
    4, the tiny SFA+ width) goes through ``FlashAttention`` with 1400 keys
    and to einsum with 600, d = 8 through ``PackedAttention``; gradients
    agree with autograd through the float32 einsum path."""
    c = 32
    q = _qkv(2, 1400, 1, c, cuda, seed=19)[0].requires_grad_()
    k, v = (t.requires_grad_() for t in _qkv(2, lk, lk, c, cuda, 20)[1:])
    w = _qkv(2, 1400, 1, c, cuda, seed=21)[0]
    A.reset_launch_counts()
    out = A.attention_packed(q, k, v, heads)
    (out.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    assert _launched() == {n: 1 for n in kernels}
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = A._einsum_packed(*ref, (c // heads) ** -0.5, heads)
    (want * w.float()).sum().backward()
    for got, r in zip((q, k, v), ref):
        _check(got.grad, r.grad)


# ------------------------------------------- the Hopper forward (sm90) --

SM90_LQ = (1, 127, 128, 129, 1400)
SM90_LK = (1, 158, 238, 1400, 2800, 2801)


@pytest.mark.parametrize("lk", SM90_LK)
@pytest.mark.parametrize("d", (8, 16, 24, 32, 40, 48, 56, 64, 72, 80))
def test_sm90_kernel_against_plain(cuda, d, lk):
    """``sm90_attention_fwd`` at every in-scope head_dim, against the
    float32 plain version: query counts around its 128-row blocks and the
    whole 1400, key counts from one key to a ragged long-K tile."""
    heads = 2
    for i, lq in enumerate(SM90_LQ):
        q, k, v = _qkv(2, lq, lk, heads * d, cuda, seed=30 + i)
        A.reset_launch_counts()
        got = A.sm90_attention_fwd(q, k, v, heads)
        torch.cuda.synchronize()
        assert A.sm90_attention_fwd.launches == 1
        _check(got, A.attention_packed_plain(q, k, v, heads))


@pytest.mark.parametrize("d", (8, 40, 64, 72, 80))
def test_sm90_kernel_with_very_negative_logits_is_exact(cuda, d):
    """Every logit near -80 (and a ragged last key tile): exact key masks
    and a finite running max keep the output finite and right."""
    heads, lq, lk = 4, 300, 333
    q, k, v = _qkv(2, lq, lk, heads * d, cuda, seed=40)
    q = (q.float() * 0.05 - 4.0).bfloat16()
    k = (k.float() * 0.05 + 4.0).bfloat16()
    scale = 5.0 / d
    got = A.sm90_attention_fwd(q, k, v, heads, scale)
    torch.cuda.synchronize()
    want = A.attention_packed_plain(q, k, v, heads, scale)
    assert want.float().max().item() < 1e30  # the reference is finite
    assert torch.isfinite(got).all()
    _check(got, want)


@pytest.mark.parametrize("d", (40, 72, 80))
def test_sm90_kernel_reads_the_split_view_of_the_same_memory(cuda, d):
    """``flash_attention_fwd`` on a (B, L, H, D) view and
    ``packed_attention_fwd`` on its packed memory launch the one kernel and
    agree bit for bit."""
    q, k, v = _qkv4(3, 777, 1111, 8, d, cuda, seed=41)
    A.reset_launch_counts()
    split = A.flash_attention_fwd(q, k, v)
    packed = A.packed_attention_fwd(*(t.reshape(3, t.shape[1], 8 * d)
                                      for t in (q, k, v)), 8)
    torch.cuda.synchronize()
    assert A.sm90_attention_fwd.launches == 2
    assert torch.equal(split.reshape(packed.shape), packed)
    _check(split, A.flash_attention_plain(q, k, v))


def _unaligned(t):
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("call, sm90", [
    ("packed d=40", 1), ("capped d=40", 1), ("split d=40", 1),
    ("packed d=8", 1), ("split d=64", 1),
    ("packed d=80", 1), ("packed d=160", 0), ("capped d=80", 1),
    ("split d=20", 0), ("split d=40 unaligned", 0), ("split d=80", 1),
    ("packed d=72", 1), ("split d=72", 1), ("split d=80 unaligned", 0),
])
def test_sm90_routing_on_the_card(cuda, call, sm90):
    """In-scope calls launch the sm90 kernel, the others the template; the
    wrapper counts its launch either way, and both agree with the plain
    version."""
    kind, dd = call.split()[0], int(call.split()[1][2:])
    heads = 4
    A.reset_launch_counts()
    if kind == "split":
        q, k, v = _qkv4(2, 300, 200, heads, dd, cuda, seed=42)
        if "unaligned" in call:
            q, k, v = (_unaligned(t) for t in (q, k, v))
        got = A.flash_attention_fwd(q, k, v)
        want = A.flash_attention_plain(q, k, v)
        wrapper = A.flash_attention_fwd
    else:
        q, k, v = _qkv(2, 300, 200, heads * dd, cuda, seed=43)
        fn = A.packed_attention_fwd if kind == "packed" \
            else A.packed_attention_capped_fwd
        got, want, wrapper = fn(q, k, v, heads), \
            A.attention_packed_plain(q, k, v, heads), fn
    torch.cuda.synchronize()
    assert wrapper.launches == 1
    assert A.sm90_attention_fwd.launches == sm90
    _check(got, want)


@pytest.mark.parametrize("fn", ["packed_attention_fwd",
                                "packed_attention_capped_fwd",
                                "flash_attention_fwd"])
def test_template_route_keeps_the_template_in_scope(cuda, fn):
    """``route="template"`` runs the mma.sync template on an in-scope
    shape (the yardstick chip_smoke.py times beside the sm90 kernel)."""
    q, k, v = _qkv(2, 300, 200, 320, cuda, seed=44)
    wrapper = getattr(A, fn)
    if fn == "flash_attention_fwd":
        q, k, v = (t.view(2, t.shape[1], 8, 40) for t in (q, k, v))
    A.reset_launch_counts()
    got = wrapper(q, k, v, route="template") if fn == "flash_attention_fwd" \
        else wrapper(q, k, v, 8, route="template")
    torch.cuda.synchronize()
    assert wrapper.launches == 1 and A.sm90_attention_fwd.launches == 0
    want = A.flash_attention_plain(q, k, v) if fn == "flash_attention_fwd" \
        else A.attention_packed_plain(q, k, v, 8)
    _check(got, want)


# ------------------------------- the Hopper forward with lse (sm90) --

def _check_lse(got, want):
    """lse is float32 on both sides: 1e-3 absolute."""
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 1e-3, err


@pytest.mark.parametrize("lk", SM90_LK)
@pytest.mark.parametrize("d", (8, 16, 24, 32, 40, 48, 56, 64, 72, 80))
def test_sm90_lse_kernel_against_plain(cuda, d, lk):
    """``sm90_attention_lse_fwd`` at every in-scope head_dim against the
    float32 plain version, o and lse (B*H, Lq): query counts around its
    128-row blocks and the whole 1400, key counts from one key to a ragged
    long-K tile."""
    heads = 2
    for i, lq in enumerate(SM90_LQ):
        q, k, v = _qkv(2, lq, lk, heads * d, cuda, seed=80 + i)
        A.reset_launch_counts()
        o, lse = A.sm90_attention_lse_fwd(q, k, v, heads)
        torch.cuda.synchronize()
        assert A.sm90_attention_lse_fwd.launches == 1
        assert lse.shape == (2 * heads, lq) and lse.dtype == torch.float32
        o_want, lse_want = A.attention_packed_lse_plain(q, k, v, heads)
        _check(o, o_want)
        _check_lse(lse, lse_want)


@pytest.mark.parametrize("d", (8, 40, 64, 72, 80))
def test_sm90_lse_kernel_with_very_negative_logits(cuda, d):
    """Every logit near -80 (and a ragged last key tile): lse = m s + ln l
    keeps the scale's units, so lse is near -80 and right to 1e-3."""
    heads, lq, lk = 4, 300, 333
    q, k, v = _qkv(2, lq, lk, heads * d, cuda, seed=81)
    q = (q.float() * 0.05 - 4.0).bfloat16()
    k = (k.float() * 0.05 + 4.0).bfloat16()
    scale = 5.0 / d
    o, lse = A.sm90_attention_lse_fwd(q, k, v, heads, scale)
    torch.cuda.synchronize()
    o_want, lse_want = A.attention_packed_lse_plain(q, k, v, heads, scale)
    assert lse_want.max().item() < -50  # the logits are very negative
    assert torch.isfinite(o).all()
    _check(o, o_want)
    _check_lse(lse, lse_want)


@pytest.mark.parametrize("b, lq, lk, c, heads", [
    (6, 1400, 1400, 320, 8),    # attn1 and SFA+ stage 2 under grad
    (12, 1400, 2800, 320, 8),   # video ST-Attn under grad
    (6, 1400, 158, 320, 8),     # attn2
    (12, 512, 512, 32, 4),      # the tiny models' d = 8
    (6, 1296, 1296, 640, 8),    # HD 432x768's second level, d = 80
])
def test_sm90_lse_kernel_output_is_the_inference_kernels(cuda, b, lq, lk, c,
                                                         heads):
    """The lse epilogue changes nothing else: o is bit for bit
    ``sm90_attention_fwd``'s on the same inputs, and a second launch
    repeats o and lse bit for bit."""
    q, k, v = _qkv(b, lq, lk, c, cuda, seed=82)
    o, lse = A.sm90_attention_lse_fwd(q, k, v, heads)
    o2, lse2 = A.sm90_attention_lse_fwd(q, k, v, heads)
    plain_o = A.sm90_attention_fwd(q, k, v, heads)
    torch.cuda.synchronize()
    assert torch.equal(o, plain_o)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o_want, lse_want = A.attention_packed_lse_plain(q, k, v, heads)
    _check(o, o_want)
    _check_lse(lse, lse_want)


@pytest.mark.parametrize("d", (40, 72, 80))
def test_sm90_lse_kernel_reads_the_split_view_of_the_same_memory(cuda, d):
    """``flash_attention_lse_fwd`` on a (B, L, H, D) view and
    ``packed_attention_lse_fwd`` on its packed memory launch the one kernel
    and agree bit for bit, o and lse."""
    q, k, v = _qkv4(3, 777, 1111, 8, d, cuda, seed=83)
    A.reset_launch_counts()
    o_split, lse_split = A.flash_attention_lse_fwd(q, k, v)
    o_packed, lse_packed = A.packed_attention_lse_fwd(
        *(t.reshape(3, t.shape[1], 8 * d) for t in (q, k, v)), 8)
    torch.cuda.synchronize()
    assert A.sm90_attention_lse_fwd.launches == 2
    assert o_split.shape == q.shape
    assert torch.equal(o_split.reshape(o_packed.shape), o_packed)
    assert torch.equal(lse_split, lse_packed)
    o_want, lse_want = A.flash_attention_lse_plain(q, k, v)
    _check(o_split, o_want)
    _check_lse(lse_split, lse_want)


@pytest.mark.parametrize("call, sm90", [
    ("packed d=40", 1), ("capped d=40", 1), ("split d=40", 1),
    ("packed d=8", 1), ("split d=64", 1),
    ("packed d=80", 1), ("packed d=160", 0), ("capped d=80", 1),
    ("split d=20", 0), ("split d=4", 0), ("split d=40 unaligned", 0),
    ("split d=80", 1), ("packed d=72", 1), ("split d=72", 1),
])
def test_sm90_lse_routing_on_the_card(cuda, call, sm90):
    """In-scope training forwards launch ``sm90_attention_lse_fwd``, the
    others the template; the wrapper counts its launch either way, and both
    agree with the plain version, o and lse."""
    kind, dd = call.split()[0], int(call.split()[1][2:])
    heads = 4
    A.reset_launch_counts()
    if kind == "split":
        q, k, v = _qkv4(2, 300, 200, heads, dd, cuda, seed=84)
        if "unaligned" in call:
            q, k, v = (_unaligned(t) for t in (q, k, v))
        got = A.flash_attention_lse_fwd(q, k, v)
        want = A.flash_attention_lse_plain(q, k, v)
        wrapper = A.flash_attention_lse_fwd
    else:
        q, k, v = _qkv(2, 300, 200, heads * dd, cuda, seed=85)
        wrapper = A.packed_attention_lse_fwd if kind == "packed" \
            else A.packed_attention_capped_lse_fwd
        got = wrapper(q, k, v, heads)
        want = A.attention_packed_lse_plain(q, k, v, heads)
    torch.cuda.synchronize()
    assert wrapper.launches == 1
    assert A.sm90_attention_lse_fwd.launches == sm90
    _check(got[0], want[0])
    _check_lse(got[1], want[1])


@pytest.mark.parametrize("fn", ["packed_attention_lse_fwd",
                                "packed_attention_capped_lse_fwd",
                                "flash_attention_lse_fwd"])
def test_template_route_keeps_the_lse_template_in_scope(cuda, fn):
    """``route="template"`` runs the mma.sync template's lse forward on an
    in-scope shape (the yardstick chip_smoke.py times beside the sm90
    kernel)."""
    q, k, v = _qkv(2, 300, 200, 320, cuda, seed=86)
    wrapper = getattr(A, fn)
    A.reset_launch_counts()
    if fn == "flash_attention_lse_fwd":
        q, k, v = (t.view(2, t.shape[1], 8, 40) for t in (q, k, v))
        got = wrapper(q, k, v, route="template")
        want = A.flash_attention_lse_plain(q, k, v)
    else:
        got = wrapper(q, k, v, 8, route="template")
        want = A.attention_packed_lse_plain(q, k, v, 8)
    torch.cuda.synchronize()
    assert wrapper.launches == 1 and A.sm90_attention_lse_fwd.launches == 0
    _check(got[0], want[0])
    _check_lse(got[1], want[1])


@pytest.mark.parametrize("b, lq, lk, split", [
    (6, 1400, 1400, False),    # attn1 under grad: PackedAttention
    (12, 1400, 2800, False),   # ST-Attn over the cap: the capped route
    (6, 1400, 1400, True),     # SFA+ stage 2 under grad: FlashAttention
])
def test_sm90_training_forward_and_backward_gradients(cuda, b, lq, lk,
                                                      split):
    """``PackedAttention`` (whole and capped) and ``FlashAttention`` at the
    main training shapes (C = 320, d = 40): the sm90 lse forward, then the
    sm90 backward fed its lse.  Their gradients agree with autograd through
    the float32 plain version (``attention_packed_plain`` /
    ``flash_attention_plain`` on float32 copies) within 2^-7 of the
    gradient's magnitude + 1e-3, the kernels' tolerance."""
    heads, c = 8, 320
    q = _qkv(b, lq, 1, c, cuda, seed=87)[0].requires_grad_()
    k, v = (t.requires_grad_() for t in _qkv(b, lk, lk, c, cuda, 88)[1:])
    w = _qkv(b, lq, 1, c, cuda, seed=89)[0]
    scale = 40 ** -0.5
    sp = lambda t: t.view(b, t.shape[1], heads, 40)
    A.reset_launch_counts()
    if split:
        out = A.FlashAttention.apply(sp(q), sp(k), sp(v), scale)
    else:
        out = A.PackedAttention.apply(q, k, v, heads, scale)
    (out.reshape(w.shape).float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    assert A.sm90_attention_lse_fwd.launches == 1
    assert A.sm90_attention_bwd_dq.launches == 1
    assert A.sm90_attention_bwd_dkv.launches == 1
    fwd = "flash_attention_lse_fwd" if split else \
        "packed_attention_capped_lse_fwd" if A.over_score_cap(lq, lk) \
        else "packed_attention_lse_fwd"
    assert getattr(A, fwd).launches == 1
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    if split:
        want = A.flash_attention_plain(*(sp(t) for t in ref), scale)
    else:
        want = A.attention_packed_plain(*ref, heads, scale)
    (want.reshape(w.shape) * w.float()).sum().backward()
    for got, r in zip((q, k, v), ref):
        _check(got.grad, r.grad)


# ------------------------------------------ the Hopper backward (sm90) --

def _grad_inputs(b, lq, lk, c, heads, device, seed):
    """q, k, v, do and the lse and delta of the training forward."""
    q, k, v = _qkv(b, lq, lk, c, device, seed)
    do = _qkv(b, lq, 1, c, device, seed + 1)[0]
    o, lse = A.packed_attention_lse_fwd(q, k, v, heads)
    return q, k, v, do, lse, A.attention_delta(o, do, heads)


def _check_sm90_backward(args, heads):
    A.reset_launch_counts()
    dq = A.sm90_attention_bwd_dq(*args, heads)
    dk, dv = A.sm90_attention_bwd_dkv(*args, heads)
    torch.cuda.synchronize()
    assert A.sm90_attention_bwd_dq.launches == 1
    assert A.sm90_attention_bwd_dkv.launches == 1
    _check(dq, A.attention_packed_bwd_dq_plain(*args, heads))
    for got, want in zip((dk, dv),
                         A.attention_packed_bwd_dkv_plain(*args, heads)):
        _check(got, want)
    return dq, dk, dv


@pytest.mark.parametrize("lk", SM90_LK)
@pytest.mark.parametrize("d", (8, 16, 24, 32, 40, 48, 56, 64, 72, 80))
def test_sm90_backward_against_plain(cuda, d, lk):
    """``sm90_attention_bwd_dq`` and ``_dkv`` at every in-scope head_dim,
    against the float32 plain versions: query counts around the 128-query
    items and 64-query tiles and the whole 1400, key counts from one key to
    a ragged long-K tile."""
    heads = 2
    for i, lq in enumerate(SM90_LQ):
        _check_sm90_backward(
            _grad_inputs(2, lq, lk, heads * d, heads, cuda, 50 + i), heads)


@pytest.mark.parametrize("b, lq, lk, c, heads", [
    (6, 1400, 1400, 320, 8),    # attn1 and SFA+ stage 2 under grad
    (12, 1400, 1400, 320, 8),   # attn4, both neighbours stacked
    (6, 1400, 158, 320, 8),     # attn2
    (12, 1400, 2800, 320, 8),   # video ST-Attn under grad
    (12, 512, 512, 32, 4),      # the tiny models' d = 8
    (6, 1296, 1296, 640, 8),    # HD 432x768's second level, d = 80
    (6, 704, 704, 640, 8),      # HD 256x704's, d = 80
])
def test_sm90_backward_at_the_main_shapes_is_deterministic(cuda, b, lq, lk,
                                                           c, heads):
    """The main paths' shapes against the plain versions, and a second
    launch bit for bit equal to the first: each block owns its rows, no
    atomics."""
    args = _grad_inputs(b, lq, lk, c, heads, cuda, 60)
    first = _check_sm90_backward(args, heads)
    again = (A.sm90_attention_bwd_dq(*args, heads),
             *A.sm90_attention_bwd_dkv(*args, heads))
    torch.cuda.synchronize()
    for x, y in zip(first, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("d", (8, 40, 64, 72, 80))
def test_sm90_backward_with_very_negative_logits(cuda, d):
    """Every logit near -80 (and ragged last tiles): the key mask and the
    queries' lse past Lq keep dq, dk and dv finite and right.

    dq sums dS over keys that share one large offset (k near +4), where
    the rounding of dS to bf16 (an MMA operand, in the template and in
    SDPA's FLASH backward too) does not cancel: at d = 8 both routes read
    0.0031 against the float32 plain version's 0.0012 tolerance (ROADMAP
    Queue 3 #3).  So dq is held to the plain version with dS rounded to
    bf16 as the kernels round it, at the usual tolerance, and to the
    float32 one within that rounding's bound: one bf16 rounding moves dS by
    at most 2^-8 |dS|, so dq by at most s 2^-8 sum_k |dS| |K| per element,
    on top of the usual tolerance.  dk and dv are held to the float32
    version."""
    heads, lq, lk = 4, 300, 333
    q, k, v = _qkv(2, lq, lk, heads * d, cuda, seed=70)
    q = (q.float() * 0.05 - 4.0).bfloat16()
    k = (k.float() * 0.05 + 4.0).bfloat16()
    do = _qkv(2, lq, 1, heads * d, cuda, seed=71)[0]
    scale = 5.0 / d
    o, lse = A.packed_attention_lse_fwd(q, k, v, heads, scale)
    args = (q, k, v, do, lse, A.attention_delta(o, do, heads))
    dq = A.sm90_attention_bwd_dq(*args, heads, scale)
    dk, dv = A.sm90_attention_bwd_dkv(*args, heads, scale)
    torch.cuda.synchronize()
    _, ds = A._probs_and_ds(*args, heads, scale)
    kh = k.view(2, lk, heads, d).float()
    dq_bf16_ds = torch.einsum("bhqk,bkhd->bqhd", ds.bfloat16().float(),
                              kh).reshape(q.shape) * scale
    assert torch.isfinite(dq).all()
    _check(dq, dq_bf16_ds.bfloat16())
    dq_f32 = A.attention_packed_bwd_dq_plain(*args, heads, scale).float()
    ds_bound = torch.einsum("bhqk,bkhd->bqhd", ds.abs(), kh.abs()).reshape(
        q.shape) * scale * 2.0 ** -8
    tol = 2.0 ** -7 * dq_f32.abs().max().item() + 1e-3
    excess = (dq.float() - dq_f32).abs() - ds_bound - tol
    assert excess.max().item() <= 0, excess.max().item()
    for got, want in zip((dk, dv), A.attention_packed_bwd_dkv_plain(
            *args, heads, scale)):
        assert torch.isfinite(got).all()
        _check(got, want)


@pytest.mark.parametrize("d", (40, 72, 80))
def test_sm90_backward_reads_the_split_view_of_the_same_memory(cuda, d):
    """``flash_attention_bwd_dq`` / ``_dkv`` on (B, L, H, D) views and the
    packed wrappers on their packed memory launch the same two kernels and
    agree bit for bit."""
    b, lq, lk, heads = 3, 777, 1111, 8
    q, k, v, do, lse, delta = _grad_inputs(b, lq, lk, heads * d, heads, cuda, 72)
    sp = lambda t: t.view(b, t.shape[1], heads, d)
    A.reset_launch_counts()
    split = (A.flash_attention_bwd_dq(sp(q), sp(k), sp(v), sp(do), lse,
                                      delta),
             *A.flash_attention_bwd_dkv(sp(q), sp(k), sp(v), sp(do), lse,
                                        delta))
    packed = (A.packed_attention_bwd_dq(q, k, v, do, lse, delta, heads),
              *A.packed_attention_bwd_dkv(q, k, v, do, lse, delta, heads))
    torch.cuda.synchronize()
    assert A.sm90_attention_bwd_dq.launches == 2
    assert A.sm90_attention_bwd_dkv.launches == 2
    for s, p in zip(split, packed):
        assert s.shape == (b, s.shape[1], heads, d)
        assert torch.equal(s.reshape(p.shape), p)
    _check(packed[0], A.attention_packed_bwd_dq_plain(q, k, v, do, lse,
                                                      delta, heads))


@pytest.mark.parametrize("call, sm90", [
    ("packed d=40", 1), ("split d=40", 1), ("packed d=8", 1),
    ("split d=64", 1), ("packed d=80", 1), ("packed d=160", 0),
    ("split d=20", 0), ("split d=4", 0), ("split d=40 unaligned", 0),
    ("split d=80", 1), ("packed d=72", 1), ("split d=72", 1),
])
def test_sm90_backward_routing_on_the_card(cuda, call, sm90):
    """In-scope backward calls launch the sm90 kernels, the others the
    template; the wrappers count their launch either way, and both agree
    with the plain versions."""
    kind, dd = call.split()[0], int(call.split()[1][2:])
    heads = 4
    if kind == "split":
        q, k, v = _qkv4(2, 300, 200, heads, dd, cuda, seed=74)
        do = _qkv4(2, 300, 1, heads, dd, cuda, seed=75)[0]
        o, lse = A.flash_attention_lse_fwd(q, k, v)
        delta = A.flash_attention_delta(o, do)
        if "unaligned" in call:
            q, k, v, do = (_unaligned(t) for t in (q, k, v, do))
        A.reset_launch_counts()
        dq = A.flash_attention_bwd_dq(q, k, v, do, lse, delta)
        dk, dv = A.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
        want = (A.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta),
                *A.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta))
        wrappers = (A.flash_attention_bwd_dq, A.flash_attention_bwd_dkv)
    else:
        q, k, v, do, lse, delta = _grad_inputs(2, 300, 200, heads * dd, heads,
                                               cuda, 74)
        A.reset_launch_counts()
        dq = A.packed_attention_bwd_dq(q, k, v, do, lse, delta, heads)
        dk, dv = A.packed_attention_bwd_dkv(q, k, v, do, lse, delta, heads)
        want = (A.attention_packed_bwd_dq_plain(q, k, v, do, lse, delta,
                                                heads),
                *A.attention_packed_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  heads))
        wrappers = (A.packed_attention_bwd_dq, A.packed_attention_bwd_dkv)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [1, 1]
    assert A.sm90_attention_bwd_dq.launches == sm90
    assert A.sm90_attention_bwd_dkv.launches == sm90
    for got, w in zip((dq, dk, dv), want):
        _check(got, w)


@pytest.mark.parametrize("split", [False, True])
def test_template_route_keeps_the_backward_template_in_scope(cuda, split):
    """``route="template"`` runs the mma.sync template's dq and dk/dv on an
    in-scope shape (the yardstick chip_smoke.py times beside the sm90
    backward)."""
    heads, d = 8, 40
    q, k, v, do, lse, delta = _grad_inputs(2, 300, 200, heads * d, heads, cuda,
                                           76)
    A.reset_launch_counts()
    if split:
        q, k, v, do = (t.view(2, t.shape[1], heads, d) for t in (q, k, v, do))
        dq = A.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                      route="template")
        dk, dv = A.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                           route="template")
        want = (A.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta),
                *A.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta))
    else:
        dq = A.packed_attention_bwd_dq(q, k, v, do, lse, delta, heads,
                                       route="template")
        dk, dv = A.packed_attention_bwd_dkv(q, k, v, do, lse, delta, heads,
                                            route="template")
        want = (A.attention_packed_bwd_dq_plain(q, k, v, do, lse, delta,
                                                heads),
                *A.attention_packed_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  heads))
    torch.cuda.synchronize()
    assert A.sm90_attention_bwd_dq.launches == 0
    assert A.sm90_attention_bwd_dkv.launches == 0
    assert sum(fn.launches for fn in A.KERNEL_WRAPPERS) == 2
    for got, w in zip((dq, dk, dv), want):
        _check(got, w)


# ------------------------------------- the Hopper camera ring (sm90) --

def _ring_inputs(b, n_cam, l, c, device, seed):
    """q, k, v (B*n_cam, L, C); v carries 0.1 x its row index, so that each
    view's output names the two views it read (a wrong b*N offset or
    neighbour moves it by 0.1 or more)."""
    q, k, v = _qkv(b * n_cam, l, l, c, device, seed)
    rows = torch.arange(b * n_cam, device=device).view(-1, 1, 1)
    return q, k, (v.float() + 0.1 * rows).bfloat16()


@pytest.mark.parametrize("b, n_cam, l, c, heads", [
    (4, 6, 1400, 320, 8),    # attn4 of a generation: 24 rows
    (16, 6, 1400, 320, 8),   # attn4 of a clip: 16 frames x 6 views
    (2, 3, 701, 320, 8),     # ragged, d = 40
    (2, 3, 777, 320, 8),
    (2, 6, 127, 320, 8),     # one partial key tile a pass
    (2, 6, 129, 320, 8),     # a full tile and one key
    (2, 3, 1, 320, 8),       # one key a pass
    (2, 6, 300, 32, 4),      # d = 8, the tiny models'
    (2, 6, 300, 64, 4),      # d = 16
    (2, 6, 300, 256, 4),     # d = 64
    (2, 6, 300, 288, 4),     # d = 72: columns 72..79 of the second box zero
    (2, 3, 701, 320, 4),     # ragged, d = 80
    (4, 6, 1296, 640, 8),    # HD 432x768's second level, d = 80
    (4, 6, 704, 640, 8),     # HD 256x704's, d = 80
    (3, 1, 300, 320, 8),     # one view: its own left and right neighbour
    (3, 2, 300, 320, 8),     # two views: left == right
])
def test_sm90_ring_against_plain(cuda, b, n_cam, l, c, heads):
    """``packed_attention_nbr_fwd`` in scope launches
    ``sm90_attention_nbr_fwd`` once and agrees with the float32 plain
    version (two softmaxes, the halves summed in float32, rounded once)
    within phase 3's tolerance."""
    q, k, v = _ring_inputs(b, n_cam, l, c, cuda, seed=100 + l)
    A.reset_launch_counts()
    got = A.packed_attention_nbr_fwd(q, k, v, heads, n_cam)
    torch.cuda.synchronize()
    assert A.packed_attention_nbr_fwd.launches == 1
    assert A.sm90_attention_nbr_fwd.launches == 1
    _check(got, A.attention_packed_neighbors_plain(q, k, v, heads, n_cam))


@pytest.mark.parametrize("d", (8, 40, 64, 72, 80))
def test_sm90_ring_with_very_negative_logits(cuda, d):
    """Every logit near -80 in both passes (and a ragged last key tile):
    each half's softmax starts afresh at the pass boundary, so the output
    stays finite and right."""
    heads, n_cam, l = 4, 3, 333
    q, k, v = _ring_inputs(2, n_cam, l, heads * d, cuda, seed=110)
    q = (q.float() * 0.05 - 4.0).bfloat16()
    k = (k.float() * 0.05 + 4.0).bfloat16()
    scale = 5.0 / d
    got = A.sm90_attention_nbr_fwd(q, k, v, heads, n_cam, scale)
    torch.cuda.synchronize()
    want = A.attention_packed_neighbors_plain(q, k, v, heads, n_cam, scale)
    assert want.float().abs().max().item() < 1e30  # the reference is finite
    assert torch.isfinite(got).all()
    _check(got, want)


@pytest.mark.parametrize("route", ["auto", "template"])
@pytest.mark.parametrize("n_local, view0, l, c, heads", [
    (3, 0, 1400, 320, 8), (3, 3, 1400, 320, 8),  # the (1, 2) mesh's ranks
    (2, 4, 333, 320, 4),                          # d = 80, ragged
    (1, 5, 257, 64, 8),                           # d = 8, one view
])
def test_split_ring_is_the_whole_rings_rows(cuda, route, n_local, view0, l,
                                            c, heads):
    """Row 2 under a view split: q holds ``n_local`` views from ``view0``
    of each sample, k and v all 6.  Both routes launch once, agree with
    the plain version within phase 3's tolerance and equal the matching
    rows of the same route's whole-ring call bit for bit."""
    b, n_cam = 2, 6
    q, k, v = _ring_inputs(b, n_cam, l, c, cuda, seed=120 + view0)
    mine = lambda t: t.view(b, n_cam, l, c)[:, view0:view0 + n_local] \
        .reshape(b * n_local, l, c).contiguous()
    whole = A.packed_attention_nbr_fwd(q, k, v, heads, n_cam, route=route)
    A.reset_launch_counts()
    got = A.packed_attention_nbr_fwd(mine(q), k, v, heads, n_cam, route=route,
                                     n_local=n_local, view0=view0)
    torch.cuda.synchronize()
    assert A.packed_attention_nbr_fwd.launches == 1
    assert A.sm90_attention_nbr_fwd.launches == (route == "auto")
    assert torch.equal(got, mine(whole))
    _check(got, A.attention_packed_neighbors_plain(
        mine(q), k, v, heads, n_cam, n_local=n_local, view0=view0))


def test_split_ring_refuses_a_run_outside_the_ring(cuda):
    """Views past the last camera, or k/v rows that are not whole samples
    of the q rows' views, are refused before any launch."""
    q, k, v = _ring_inputs(2, 6, 300, 320, cuda, seed=130)
    A.reset_launch_counts()
    with pytest.raises(ValueError, match="not a run"):
        A.packed_attention_nbr_fwd(q[:6], k, v, 8, 6, n_local=3, view0=4)
    with pytest.raises(ValueError, match="neighbor attention needs"):
        A.packed_attention_nbr_fwd(q[:5], k, v, 8, 6, n_local=3, view0=0)
    assert A.packed_attention_nbr_fwd.launches == 0


def test_sm90_ring_repeats_bit_for_bit(cuda):
    q, k, v = _ring_inputs(4, 6, 1400, 320, cuda, seed=111)
    first = A.sm90_attention_nbr_fwd(q, k, v, 8, 6)
    second = A.sm90_attention_nbr_fwd(q, k, v, 8, 6)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_template_route_keeps_the_ring_template_in_scope(cuda):
    """``route="template"`` runs ``attention.cu``'s ring instance on an
    in-scope shape (the yardstick chip_smoke.py times beside the sm90
    ring)."""
    q, k, v = _ring_inputs(2, 6, 300, 320, cuda, seed=112)
    A.reset_launch_counts()
    got = A.packed_attention_nbr_fwd(q, k, v, 8, 6, route="template")
    torch.cuda.synchronize()
    assert A.packed_attention_nbr_fwd.launches == 1
    assert A.sm90_attention_nbr_fwd.launches == 0
    _check(got, A.attention_packed_neighbors_plain(q, k, v, 8, 6))


def test_ring_refuses_an_unaligned_view(cuda):
    """The packed wrappers take no unaligned base (``_check_kernel_args``):
    an unaligned ring view is refused before any launch, by either
    route."""
    q, k, v = (_unaligned(t) for t in _ring_inputs(2, 3, 300, 320, cuda,
                                                   seed=114))
    A.reset_launch_counts()
    for route in ("auto", "template"):
        with pytest.raises(ValueError, match="aligned"):
            A.packed_attention_nbr_fwd(q, k, v, 8, 3, route=route)
    assert A.packed_attention_nbr_fwd.launches == 0
    assert A.sm90_attention_nbr_fwd.launches == 0


def _ring_without_left(q, k, v, heads, n_cam, scale=None, **kw):
    """A planted fault: the camera ring with the left neighbour replaced by
    the view itself (the sm90 kernel on the view's own K/V plus on the
    right neighbour's), summed in float32 and rounded once."""
    bn, l, c = q.shape
    right = torch.tensor([(n + 1) % n_cam for n in range(n_cam)],
                         device=q.device)
    take = lambda t: t.view(bn // n_cam, n_cam, l, c).index_select(
        1, right).reshape(bn, l, c)
    out = A.sm90_attention_fwd(q, k, v, heads, scale).float() \
        + A.sm90_attention_fwd(q, take(k), take(v), heads, scale).float()
    return out.to(q.dtype)


def test_phase_3_catches_a_ring_without_its_left_neighbour(cuda):
    """Phase 3's comparison (2^-7 max|out| + 1e-3 against the plain
    version) refuses the planted fault at the generation's ring shape."""
    q, k, v = _qkv(24, 1400, 1400, 320, cuda, seed=115)
    want = A.attention_packed_neighbors_plain(q, k, v, 8, 6)
    sound = A.packed_attention_nbr_fwd(q, k, v, 8, 6)
    bad = _ring_without_left(q, k, v, 8, 6)
    torch.cuda.synchronize()
    tol = 2.0 ** -7 * want.float().abs().max().item() + 1e-3
    err = lambda got: (got.float() - want.float()).abs().max().item()
    print(f"ring fault: sound {err(sound):.3e}, fault {err(bad):.3e}, "
          f"tol {tol:.3e}")
    assert err(sound) <= tol < err(bad)


def _gate_reading(monkeypatch, fault: bool) -> dict:
    """Phase 5's row (``chip_smoke.phase_reference``), with or without the
    planted ring fault in every ring call on the card; the phase raises
    with it (the fault leaves ``packed_attention_nbr_fwd`` uncounted)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    real = A.packed_attention_nbr_fwd

    def faulty(q, k, v, heads, n_cam, scale=None, **kw):
        if q.device.type == "cpu":  # the float32 reference stays sound
            return real(q, k, v, heads, n_cam, scale, **kw)
        return _ring_without_left(q, k, v, heads, n_cam, scale)

    lines = []
    with monkeypatch.context() as m:
        if fault:
            m.setattr(A, "packed_attention_nbr_fwd", faulty)
        m.setattr(chip_smoke, "log", lines.append)
        if fault:
            with pytest.raises(AssertionError):
                chip_smoke.phase_reference()
        else:
            chip_smoke.phase_reference()
    return json.loads(next(x for x in lines if '"phase": "reference"' in x))


def test_generation_gate_reading_of_a_ring_without_its_left_neighbour(
        cuda, monkeypatch):
    """Phase 5's gate (the tiny bf16 generation on the card against float32
    on the CPU, mean absolute error at most 1e-2) under the planted ring
    fault.  The fault moves the reading, but not past the limit: on an H100
    80GB HBM3 at 700 W the sound run read 3.2e-3 and the fault 3.8e-3.  The
    tiny models' random attn4 weights leave the ring's softmaxes near
    uniform, so each half is close to its view's mean of V, and the views'
    means are alike: the gate cannot tell a view from its neighbour.  Phase
    3's comparison catches the fault (the test above); the gate's blind
    spot is recorded, the gate unchanged."""
    sound = _gate_reading(monkeypatch, fault=False)
    bad = _gate_reading(monkeypatch, fault=True)
    print(f"generation gate: sound {sound['mean_abs_err']:.3e}, ring fault "
          f"{bad['mean_abs_err']:.3e} (limit {bad['tol_mean']})")
    assert sound["mean_abs_err"] <= sound["tol_mean"]
    assert bad["mean_abs_err"] > sound["mean_abs_err"]


# ------------------------------- the sm90 kernels' second box (d > 64) --

def _second_box_only(t, heads):
    """``t`` (B, L, H*d) with each head's columns 0..63 zeroed."""
    b, l, c = t.shape
    t = t.view(b, l, heads, c // heads).clone()
    t[..., :64] = 0
    return t.view(b, l, c)


@pytest.mark.parametrize("d", (72, 80))
@pytest.mark.parametrize("kind", ["fwd", "lse", "ring", "backward"])
def test_sm90_second_box_carries_columns_64_and_up(cuda, kind, d):
    """q, k, v (and dO) zero in each head's columns 0..63: every signal is
    in the second TMA box (columns 64..d-1).  A kernel that never loads,
    multiplies or stores that box gives uniform softmaxes or leaves
    columns 64.. unwritten, and disagrees with the plain version; ragged
    lengths, each wrapper's sm90 launch counted."""
    heads, lq, lk = 4, 333, 301
    q, k, v = (_second_box_only(t, heads)
               for t in _qkv(6, lq, lk, heads * d, cuda, seed=120 + d))
    q = (q.float() * 2).bfloat16()  # sharper softmaxes from 16 columns
    A.reset_launch_counts()
    if kind == "fwd":
        got = A.packed_attention_fwd(q, k, v, heads)
        torch.cuda.synchronize()
        assert A.sm90_attention_fwd.launches == 1
        want = A.attention_packed_plain(q, k, v, heads)
    elif kind == "lse":
        got, lse = A.packed_attention_lse_fwd(q, k, v, heads)
        torch.cuda.synchronize()
        assert A.sm90_attention_lse_fwd.launches == 1
        want, lse_want = A.attention_packed_lse_plain(q, k, v, heads)
        _check_lse(lse, lse_want)
    elif kind == "ring":
        q, k, v = (_second_box_only(t, heads) for t in _ring_inputs(
            2, 3, lq, heads * d, cuda, seed=121 + d))
        got = A.packed_attention_nbr_fwd(q, k, v, heads, 3)
        torch.cuda.synchronize()
        assert A.sm90_attention_nbr_fwd.launches == 1
        want = A.attention_packed_neighbors_plain(q, k, v, heads, 3)
    else:
        do = _second_box_only(_qkv(6, lq, 1, heads * d, cuda, 122)[0], heads)
        o, lse = A.packed_attention_lse_fwd(q, k, v, heads)
        args = (q, k, v, do, lse, A.attention_delta(o, do, heads))
        A.reset_launch_counts()
        got = A.packed_attention_bwd_dq(*args, heads)
        dk, dv = A.packed_attention_bwd_dkv(*args, heads)
        torch.cuda.synchronize()
        assert A.sm90_attention_bwd_dq.launches == 1
        assert A.sm90_attention_bwd_dkv.launches == 1
        want = A.attention_packed_bwd_dq_plain(*args, heads)
        dk_want, dv_want = A.attention_packed_bwd_dkv_plain(*args, heads)
        for g, w in ((dk, dk_want), (dv, dv_want)):
            assert w.float().abs().max().item() > 0.05
            _check(g, w)
    # the signal is there, and only past column 64
    want4 = want.view(*want.shape[:2], heads, d).float()
    assert want4[..., 64:].abs().max().item() > 0.05
    assert want4[..., :64].abs().max().item() == 0
    _check(got, want)


# attn4's other forms at 224x400 (B = 2 x 6 with batched CFG: 4 samples):
# ``self`` attends over a sample's six views at each level, ``concat`` over
# both neighbours' tokens, ``add`` over other pairs stacks [q; q]
ATTN4_FORWARD_SHAPES = [
    (4, 8400, 8400, 320, 8),    # self, top level: the longest yet, d = 40
    (4, 2100, 2100, 640, 8),    # self, second level, d = 80
    (24, 1400, 2800, 320, 8),   # concat
    (48, 1400, 1400, 320, 8),   # add over other pairs
]


def _by_rows(fn, b, heads, lq, lk):
    """``fn`` (a plain version) on slices of rows whose float32 scores stay
    under phase 3's limit (``chip_smoke.by_rows``)."""
    return chip_smoke.by_rows(fn, b, heads, lq, lk)


@pytest.mark.parametrize("b, lq, lk, c, heads", ATTN4_FORWARD_SHAPES)
def test_attn4_form_forward_takes_the_sm90_kernel(cuda, b, lq, lk, c,
                                                  heads):
    """The inference route of each new attn4 shape: over ``T_SCORE_CAP``
    the capped wrapper, else the whole-K one, both on the sm90 forward
    (d = 40 and 80); 4 x 8400 x 8400's float32 scores (9 GB) are compared
    on slices of rows."""
    q, k, v = _qkv(b, lq, lk, c, cuda, seed=130)
    A.reset_launch_counts()
    with torch.no_grad():
        got = A.attention_packed(q, k, v, heads)
    torch.cuda.synchronize()
    kern = chip_smoke._fwd_kernel(lq, lk)
    assert _launched() == {kern: 1}
    assert A.sm90_attention_fwd.launches == 1
    _check(got, _by_rows(A.attention_packed_capped_plain, b, heads, lq,
                         lk)(q, k, v, heads))


def test_self_form_third_level_forward_on_the_template(cuda):
    """``self`` at the third level: 4 samples x 6 x 91 = 546 tokens at
    d = 160, outside ``sm90_in_scope``: ``packed_attention_fwd``'s
    template (``csrc/attention.cu``), the first full-width call there."""
    q, k, v = _qkv(4, 546, 546, 1280, cuda, seed=131)
    A.reset_launch_counts()
    with torch.no_grad():
        got = A.attention_packed(q, k, v, 8)
    torch.cuda.synchronize()
    assert _launched() == {"packed_attention_fwd": 1}
    assert A.sm90_attention_fwd.launches == 0
    _check(got, A.attention_packed_plain(q, k, v, 8))


@pytest.mark.parametrize("b, lq, lk, c, heads", [
    (1, 546, 546, 1280, 8),     # self, third level, d = 160: templates
    (1, 8400, 8400, 320, 8),    # self, top level, under grad
    (1, 2100, 2100, 640, 8),    # self, second level, d = 80
    (6, 1400, 2800, 320, 8),    # concat under grad
])
def test_attn4_form_training_kernels(cuda, b, lq, lk, c, heads):
    """``PackedAttention`` at each new attn4 training shape: the forward
    with lse (capped over ``T_SCORE_CAP``), dq and dk/dv, on the sm90
    kernels in scope and on the templates (``csrc/attention.cu``,
    ``csrc/attention_train.cu``) at d = 160, each against its plain
    version."""
    q, k, v = _qkv(b, lq, lk, c, cuda, seed=132)
    do = _qkv(b, lq, 1, c, cuda, seed=133)[0]
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    A.reset_launch_counts()
    out = A.attention_packed(qr, kr, vr, heads)
    out.backward(do)
    torch.cuda.synchronize()
    fwd = chip_smoke._fwd_kernel(lq, lk, lse=True)
    assert _launched() == {fwd: 1, "packed_attention_bwd_dq": 1,
                           "packed_attention_bwd_dkv": 1}
    sm90 = int(A.sm90_in_scope(c // heads, True))
    assert (A.sm90_attention_lse_fwd.launches, A.sm90_attention_bwd_dq
            .launches, A.sm90_attention_bwd_dkv.launches) == (sm90,) * 3
    o, lse = getattr(A, fwd)(q, k, v, heads)
    o_want, lse_want = _by_rows(A.attention_packed_lse_plain, b, heads, lq,
                                lk)(q, k, v, heads)
    _check(out, o_want)
    _check_lse(lse, lse_want)
    args = (q, k, v, do, lse, A.attention_delta(o, do, heads), heads)
    _check(qr.grad, _by_rows(A.attention_packed_bwd_dq_plain, b, heads, lq,
                             lk)(*args))
    dk_want, dv_want = _by_rows(A.attention_packed_bwd_dkv_plain, b, heads,
                                lq, lk)(*args)
    _check(kr.grad, dk_want)
    _check(vr.grad, dv_want)
