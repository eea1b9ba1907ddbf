"""The routing rule of the Hopper forward (``sm90_attention_fwd``), on the
CPU.

``sm90_in_scope`` is a pure rule on (head_dim, alignment): the three
inference wrappers without lse or ring send a call to the sm90 kernel
exactly when it holds, and to ``csrc/attention.cu``'s template otherwise.
On the CPU every wrapper takes its plain version and launches nothing.
The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``).  Tiny shapes, float32: the
plain versions are one function, so outputs agree to 1e-6.
"""

import pytest
import torch

import chip_smoke
from dualdiff_tpu_torch.ops import attention as A
from dualdiff_tpu_torch.ops import cuda_lib


@pytest.mark.parametrize("d, aligned, want", [
    (8, True, True), (16, True, True), (40, True, True), (64, True, True),
    (72, True, False), (80, True, False), (160, True, False),
    (20, True, False), (4, True, False), (0, True, False),
    (40, False, False), (8, False, False),
])
def test_scope_rule(d, aligned, want):
    assert A.sm90_in_scope(d, aligned) is want


def _qkv(b=2, lq=9, lk=7, c=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, n, c, generator=g) for n in (lq, lk, lk)]


@pytest.mark.parametrize("fn", ["packed_attention_fwd",
                                "packed_attention_capped_fwd",
                                "sm90_attention_fwd"])
def test_packed_wrappers_take_the_plain_version_on_the_cpu(fn):
    q, k, v = _qkv()
    A.reset_launch_counts()
    got = getattr(A, fn)(q, k, v, 4)
    want = A.attention_packed_plain(q, k, v, 4)
    assert torch.allclose(got, want, atol=1e-6)
    assert getattr(A, fn).launches == 0
    assert A.sm90_attention_fwd.launches == 0


def test_split_wrapper_takes_the_plain_version_on_the_cpu():
    q, k, v = (t.view(2, t.shape[1], 4, 8) for t in _qkv(seed=1))
    A.reset_launch_counts()
    got = A.flash_attention_fwd(q, k, v)
    assert torch.allclose(got, A.flash_attention_plain(q, k, v), atol=1e-6)
    assert A.flash_attention_fwd.launches == 0
    assert A.sm90_attention_fwd.launches == 0


def test_reset_clears_the_sm90_count_and_the_wrappers_stay_eleven():
    A.sm90_attention_fwd.launches = 3
    A.reset_launch_counts()
    assert A.sm90_attention_fwd.launches == 0
    assert len(A.KERNEL_WRAPPERS) == 11
    assert A.sm90_attention_fwd not in A.KERNEL_WRAPPERS


def test_the_sm90_library_is_built_like_the_others():
    assert cuda_lib.SOURCES["attention_sm90"] == "attention_sm90.cu"
    assert "dd_sm90_attention_fwd" in cuda_lib._SIGNATURES["attention_sm90"]
    path = cuda_lib.library_path("attention_sm90")
    assert path.startswith(cuda_lib.BUILD_DIR) and path.endswith(".so")


@pytest.mark.parametrize("counts, sm90, out_of_scope, ok", [
    ({"packed_attention_fwd": 360, "flash_attention_fwd": 1}, 361, (), True),
    ({"packed_attention_fwd": 360, "flash_attention_fwd": 1}, 360, (), False),
    ({"packed_attention_fwd": 8, "flash_attention_fwd": 1}, 8,
     ("flash_attention_fwd",), True),
    ({"packed_attention_fwd": 520, "packed_attention_capped_fwd": 200}, 720,
     (), True),
])
def test_chip_smoke_holds_the_sm90_count_to_the_wrappers(counts, sm90,
                                                         out_of_scope, ok):
    """``chip_smoke.check_sm90_launches``: the sm90 kernel's count equals
    the in-scope launches of the three wrappers."""
    counts = dict(chip_smoke._launches(**counts),
                  sm90_attention_fwd=sm90)
    if ok:
        chip_smoke.check_sm90_launches(counts, out_of_scope)
    else:
        with pytest.raises(AssertionError, match="sm90"):
            chip_smoke.check_sm90_launches(counts, out_of_scope)


def test_sm90_wrapper_refuses_a_tensor_off_the_cpu_and_the_card():
    """A meta tensor reaches the CUDA checks (no plain fallback) and is
    refused before any launch."""
    q = torch.empty(2, 512, 64, device="meta", dtype=torch.bfloat16)
    A.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        A.sm90_attention_fwd(q, q, q, heads=8)
    assert A.sm90_attention_fwd.launches == 0


def _kernels_line(generate_sm90=360):
    """``chip_smoke.kernels_line`` on made-up phase-3 rows and path counts:
    every wrapper's row at 1.0 ms on its own kernel, the template at 0.5,
    the sm90 kernel at 0.25."""
    row = lambda ms, **kw: dict(max_abs_err=1e-3, kernel_ms=ms, plain_ms=9.0,
                                bound_ms=0.06, bound_by="operations",
                                library_ms=0.24, shape={}, **kw)
    results = {k: [row(0.5 if k in chip_smoke.SM90_WRAPPERS else 1.0)]
               for k in chip_smoke.REPLACES}
    results[chip_smoke.SM90] = [row(0.25, wrapper=w)
                                for w in chip_smoke.SM90_WRAPPERS]

    def counts(sm90=None, **kw):
        c = chip_smoke._launches(**kw)
        c[chip_smoke.SM90] = sum(c[k] for k in chip_smoke.SM90_WRAPPERS) \
            if sm90 is None else sm90
        return c

    per_step = chip_smoke._launches(packed_attention_fwd=1)
    path = {"generate": counts(generate_sm90, packed_attention_fwd=360),
            "train": counts(packed_attention_fwd=2),
            "video": counts(packed_attention_fwd=520,
                            packed_attention_capped_fwd=200),
            "video_train": {"stage 1": counts(), "stage 2": counts()},
            "fusionp": counts(packed_attention_fwd=280,
                              flash_attention_fwd=1),
            "fusionp_train": counts()}
    return chip_smoke.kernels_line(results, path, per_step,
                                   {"stage 1": per_step,
                                    "stage 2": per_step}, per_step)


def test_kernels_line_credits_in_scope_calls_to_the_sm90_kernel():
    """The three wrappers' entries are ``attention.cu``'s template: its
    time, no launches on a path whose calls all took the sm90 kernel.  One
    sm90 entry per replaced TPU kernel, with that wrapper's launches."""
    got = {e["name"]: e for e in _kernels_line()["kernels"]}
    assert len(got) == 11 + 3
    for w in chip_smoke.SM90_WRAPPERS:
        tmpl, sm90 = got[w], got[f"{chip_smoke.SM90}:{w}"]
        assert tmpl["source"].endswith("attention.cu")
        assert (tmpl["ms"], tmpl["launches"]) == (0.5, 0)
        assert tmpl["routed_to"] == sm90["name"]
        assert sm90["source"].endswith("attention_sm90.cu")
        assert sm90["replaces"] == tmpl["replaces"] == chip_smoke.REPLACES[w]
        assert sm90["ms"] == 0.25
    assert [got[f"{chip_smoke.SM90}:{w}"]["launches"]
            for w in chip_smoke.SM90_WRAPPERS] == [360, 200, 1]


def test_kernels_line_refuses_a_path_where_the_template_ran():
    with pytest.raises(AssertionError, match="sm90"):
        _kernels_line(generate_sm90=359)
