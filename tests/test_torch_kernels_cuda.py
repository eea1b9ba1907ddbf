"""The port's CUDA kernels against their plain versions, on the card.

Mirrors the kernel phase of ``chip_smoke.py``: bf16 inputs at the flagship
path's shapes plus ragged ones; the plain version computes in float32 and
rounds once.  Tolerance 2^-7 of the output's magnitude + 1e-3: the kernel
rounds the probabilities to bf16 for the P.V product and the output to
bf16.  Every test is marked ``cuda`` and skips without a card; run them on
the GPU machine with ``python -m pytest tests/test_torch_kernels_cuda.py``.
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


def test_kernel_refuses_float32(cuda):
    q, k, v = (t.float() for t in _qkv(1, 64, 64, 64, cuda))
    with pytest.raises(ValueError, match="bfloat16"):
        A.packed_attention_fwd(q, k, v, 8)
