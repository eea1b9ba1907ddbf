"""The routing rule of the Hopper kernels (``sm90_attention_fwd``,
``sm90_attention_lse_fwd``, ``sm90_attention_nbr_fwd``,
``sm90_attention_bwd_dq``, ``sm90_attention_bwd_dkv``), on the CPU.

``sm90_in_scope`` is a pure rule on (head_dim, alignment): the three
inference wrappers without ring, the three training forwards with lse, the
camera ring and the four backward wrappers send a call to their sm90 kernel
exactly when it holds, and to the template of ``csrc/attention.cu`` or
``csrc/attention_train.cu`` otherwise.  On the
CPU every wrapper takes its plain version and launches nothing.  The
kernels themselves run only on the card
(``tests/test_torch_kernels_cuda.py``).  Tiny shapes, float32: the plain
versions are one function, so outputs agree to 1e-6.
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


@pytest.mark.parametrize("route", ["auto", "template"])
@pytest.mark.parametrize("fn", ["packed_attention_lse_fwd",
                                "packed_attention_capped_lse_fwd",
                                "flash_attention_lse_fwd"])
def test_lse_wrappers_take_the_plain_version_on_the_cpu(fn, route):
    """The three training forwards return their plain versions bit for bit
    on the CPU under either route, and launch nothing."""
    q, k, v = _qkv(seed=5)
    A.reset_launch_counts()
    if fn == "flash_attention_lse_fwd":
        q, k, v = (t.view(2, t.shape[1], 4, 8) for t in (q, k, v))
        got = A.flash_attention_lse_fwd(q, k, v, route=route)
        want = A.flash_attention_lse_plain(q, k, v)
    else:
        got = getattr(A, fn)(q, k, v, 4, route=route)
        want = A.attention_packed_lse_plain(q, k, v, 4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert getattr(A, fn).launches == 0
    assert A.sm90_attention_lse_fwd.launches == 0


def test_sm90_lse_kernel_takes_the_plain_version_on_the_cpu():
    q, k, v = _qkv(seed=6)
    A.reset_launch_counts()
    for g, w in zip(A.sm90_attention_lse_fwd(q, k, v, 4),
                    A.attention_packed_lse_plain(q, k, v, 4)):
        assert torch.equal(g, w)
    assert A.sm90_attention_lse_fwd.launches == 0


def _grad_args(b=2, lq=9, lk=7, c=32, heads=4, seed=2):
    """q, k, v, do (B, L, C) and the lse and delta of their attention."""
    q, k, v = _qkv(b, lq, lk, c, seed)
    do = _qkv(b, lq, 1, c, seed + 1)[0]
    o, lse = A.attention_packed_lse_plain(q, k, v, heads)
    return q, k, v, do, lse, A.attention_delta(o, do, heads)


@pytest.mark.parametrize("fn", ["packed_attention_bwd_dq",
                                "sm90_attention_bwd_dq"])
def test_dq_wrappers_take_the_plain_version_on_the_cpu(fn):
    args = _grad_args()
    A.reset_launch_counts()
    got = getattr(A, fn)(*args, 4)
    assert torch.allclose(got, A.attention_packed_bwd_dq_plain(*args, 4),
                          atol=1e-6)
    assert getattr(A, fn).launches == 0
    assert A.sm90_attention_bwd_dq.launches == 0


@pytest.mark.parametrize("fn", ["packed_attention_bwd_dkv",
                                "sm90_attention_bwd_dkv"])
def test_dkv_wrappers_take_the_plain_version_on_the_cpu(fn):
    args = _grad_args()
    A.reset_launch_counts()
    got = getattr(A, fn)(*args, 4)
    for g, w in zip(got, A.attention_packed_bwd_dkv_plain(*args, 4)):
        assert torch.allclose(g, w, atol=1e-6)
    assert getattr(A, fn).launches == 0
    assert A.sm90_attention_bwd_dkv.launches == 0


@pytest.mark.parametrize("route", ["auto", "template"])
def test_split_backward_wrappers_take_the_plain_versions_on_the_cpu(route):
    q, k, v, do, lse, delta = (t.view(2, t.shape[1], 4, 8) if t.dim() == 3
                               else t for t in _grad_args(seed=4))
    A.reset_launch_counts()
    dq = A.flash_attention_bwd_dq(q, k, v, do, lse, delta, route=route)
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, do, lse, delta, route=route)
    assert torch.allclose(
        dq, A.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta),
        atol=1e-6)
    for g, w in zip((dk, dv), A.flash_attention_bwd_dkv_plain(
            q, k, v, do, lse, delta)):
        assert torch.allclose(g, w, atol=1e-6)
    assert A.flash_attention_bwd_dq.launches == 0
    assert A.flash_attention_bwd_dkv.launches == 0
    assert A.sm90_attention_bwd_dq.launches == 0
    assert A.sm90_attention_bwd_dkv.launches == 0


def test_reset_clears_the_sm90_count_and_the_wrappers_stay_eleven():
    A.sm90_attention_fwd.launches = 3
    A.reset_launch_counts()
    assert A.sm90_attention_fwd.launches == 0
    assert len(A.KERNEL_WRAPPERS) == 11
    assert A.sm90_attention_fwd not in A.KERNEL_WRAPPERS


def test_reset_clears_the_sm90_lse_count_and_the_sm90_kernels_are_five():
    A.sm90_attention_lse_fwd.launches = 4
    A.sm90_attention_nbr_fwd.launches = 3
    A.reset_launch_counts()
    assert A.sm90_attention_lse_fwd.launches == 0
    assert A.sm90_attention_nbr_fwd.launches == 0
    assert len(A.KERNEL_WRAPPERS) == 11
    assert A.SM90_KERNELS == (A.sm90_attention_fwd, A.sm90_attention_lse_fwd,
                              A.sm90_attention_nbr_fwd,
                              A.sm90_attention_bwd_dq,
                              A.sm90_attention_bwd_dkv)


def test_reset_clears_the_sm90_backward_counts():
    A.sm90_attention_bwd_dq.launches = 2
    A.sm90_attention_bwd_dkv.launches = 5
    A.reset_launch_counts()
    assert A.sm90_attention_bwd_dq.launches == 0
    assert A.sm90_attention_bwd_dkv.launches == 0
    assert len(A.KERNEL_WRAPPERS) == 11
    assert not set(A.SM90_KERNELS) & set(A.KERNEL_WRAPPERS)
    assert set(chip_smoke.launch_counts(A)) == set(chip_smoke.REPLACES) \
        | set(chip_smoke.SM90_ROUTES)


def test_the_sm90_library_is_built_like_the_others():
    assert cuda_lib.SOURCES["attention_sm90"] == "attention_sm90.cu"
    assert "dd_sm90_attention_fwd" in cuda_lib._SIGNATURES["attention_sm90"]
    path = cuda_lib.library_path("attention_sm90")
    assert path.startswith(cuda_lib.BUILD_DIR) and path.endswith(".so")


def test_the_sm90_lse_entry_takes_the_template_arguments():
    """``dd_sm90_attention_lse_fwd`` lives in the sm90 forward's library
    and takes ``dd_packed_attention_lse_fwd``'s arguments, one for one."""
    sigs = cuda_lib._SIGNATURES["attention_sm90"]
    assert sigs["dd_sm90_attention_lse_fwd"] == \
        cuda_lib._SIGNATURES["attention"]["dd_packed_attention_lse_fwd"]


def test_the_sm90_backward_library_is_built_like_the_others():
    assert cuda_lib.SOURCES["attention_sm90_bwd"] == "attention_sm90_bwd.cu"
    sigs = cuda_lib._SIGNATURES["attention_sm90_bwd"]
    train = cuda_lib._SIGNATURES["attention_train"]
    # the template's arguments, one for one
    assert sigs["dd_sm90_attention_bwd_dq"] == \
        train["dd_packed_attention_bwd_dq"]
    assert sigs["dd_sm90_attention_bwd_dkv"] == \
        train["dd_packed_attention_bwd_dkv"]
    path = cuda_lib.library_path("attention_sm90_bwd")
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


# a flagship training step: 22 dq and 22 dk/dv calls; occ_bg_fusionp's
# tiny reference: the SFA+ stage-2 pair at d = 4 out of scope
TRAIN = {"packed_attention_bwd_dq": 22, "packed_attention_bwd_dkv": 22}
FUSIONP = {"packed_attention_bwd_dq": 18, "packed_attention_bwd_dkv": 18,
           "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1}
SPLIT = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")


@pytest.mark.parametrize("counts, dq, dkv, out_of_scope, ok", [
    (TRAIN, 22, 22, (), True),
    (TRAIN, 0, 0, (), False),       # the template ran every call
    (TRAIN, 21, 22, (), False),     # one dq call took the template
    (TRAIN, 22, 21, (), False),
    (FUSIONP, 19, 19, (), True),
    (FUSIONP, 18, 18, (), False),
    (FUSIONP, 18, 18, SPLIT, True),
    (FUSIONP, 19, 19, SPLIT, False),
])
def test_chip_smoke_holds_the_sm90_backward_counts_to_the_wrappers(
        counts, dq, dkv, out_of_scope, ok):
    """``chip_smoke.check_sm90_launches`` on a training path: each sm90
    backward kernel's count equals its two wrappers' in-scope calls, so a
    path whose in-scope backward calls ran the template is refused."""
    counts = dict(chip_smoke._launches(**counts), sm90_attention_fwd=0,
                  sm90_attention_bwd_dq=dq, sm90_attention_bwd_dkv=dkv)
    if ok:
        chip_smoke.check_sm90_launches(counts, out_of_scope)
    else:
        with pytest.raises(AssertionError, match="sm90_attention_bwd"):
            chip_smoke.check_sm90_launches(counts, out_of_scope)


# a flagship training step's 44 lse forwards; a video stage-1 step's 36 +
# 8 capped; occ_bg_fusionp's tiny reference: SFA+ stage 2 at d = 4 out of
# scope
LSE_TRAIN = {"packed_attention_lse_fwd": 44}
LSE_VIDEO = {"packed_attention_lse_fwd": 36,
             "packed_attention_capped_lse_fwd": 8}
LSE_FUSIONP = {"packed_attention_lse_fwd": 36, "flash_attention_lse_fwd": 1}


@pytest.mark.parametrize("counts, lse, out_of_scope, ok", [
    (LSE_TRAIN, 44, (), True),
    (LSE_TRAIN, 43, (), False),     # one call took the template
    (LSE_VIDEO, 44, (), True),
    (LSE_VIDEO, 36, (), False),     # the capped calls took the template
    (LSE_FUSIONP, 37, (), True),
    (LSE_FUSIONP, 36, (), False),
    (LSE_FUSIONP, 36, ("flash_attention_lse_fwd",), True),
    (LSE_FUSIONP, 37, ("flash_attention_lse_fwd",), False),
])
def test_chip_smoke_holds_the_sm90_lse_count_to_the_wrappers(
        counts, lse, out_of_scope, ok):
    """``chip_smoke.check_sm90_launches``: ``sm90_attention_lse_fwd``'s
    count equals the three training forwards' in-scope calls."""
    counts = dict(chip_smoke._launches(**counts), sm90_attention_lse_fwd=lse)
    if ok:
        chip_smoke.check_sm90_launches(counts, out_of_scope)
    else:
        with pytest.raises(AssertionError, match="sm90_attention_lse_fwd"):
            chip_smoke.check_sm90_launches(counts, out_of_scope)


def test_sm90_wrapper_refuses_a_tensor_off_the_cpu_and_the_card():
    """A meta tensor reaches the CUDA checks (no plain fallback) and is
    refused before any launch."""
    q = torch.empty(2, 512, 64, device="meta", dtype=torch.bfloat16)
    A.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        A.sm90_attention_fwd(q, q, q, heads=8)
    assert A.sm90_attention_fwd.launches == 0


@pytest.mark.parametrize("fn", ["sm90_attention_lse_fwd",
                                "packed_attention_lse_fwd",
                                "packed_attention_capped_lse_fwd"])
def test_sm90_lse_kernel_refuses_a_tensor_off_the_cpu_and_the_card(fn):
    q = torch.empty(2, 512, 64, device="meta", dtype=torch.bfloat16)
    A.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        getattr(A, fn)(q, q, q, 8)
    assert getattr(A, fn).launches == 0
    assert A.sm90_attention_lse_fwd.launches == 0


@pytest.mark.parametrize("c, heads, match", [
    (320, 4, "sm90 kernel"),      # d = 80
    (288, 4, "sm90 kernel"),      # d = 72
    (160, 8, "multiples of 8"),   # d = 20
])
def test_sm90_lse_kernel_refuses_a_head_dim_outside_its_scope(
        monkeypatch, c, heads, match):
    """Past the device checks (taken out here: no card), a head_dim outside
    ``sm90_in_scope`` is refused before any launch, not sent elsewhere."""
    monkeypatch.setattr(A, "_check_cuda_bf16", lambda *a: None)
    q = torch.empty(2, 512, c, device="meta", dtype=torch.bfloat16)
    A.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        A.sm90_attention_lse_fwd(q, q, q, heads)
    assert A.sm90_attention_lse_fwd.launches == 0


@pytest.mark.parametrize("fn", ["sm90_attention_bwd_dq",
                                "sm90_attention_bwd_dkv",
                                "packed_attention_bwd_dq",
                                "packed_attention_bwd_dkv"])
def test_sm90_backward_refuses_a_tensor_off_the_cpu_and_the_card(fn):
    q = torch.empty(2, 512, 64, device="meta", dtype=torch.bfloat16)
    lse = torch.empty(16, 512, device="meta")
    A.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        getattr(A, fn)(q, q, q, q, lse, lse, 8)
    assert getattr(A, fn).launches == 0
    assert A.sm90_attention_bwd_dq.launches == 0
    assert A.sm90_attention_bwd_dkv.launches == 0


def _kernels_line(generate_sm90=360, train_dq=None, train_lse=None,
                  clip_ring=None):
    """``chip_smoke.kernels_line`` on made-up phase-3 rows and path counts:
    every wrapper's row at 1.0 ms on its own kernel, the template at 0.5,
    the sm90 forward at 0.25, with lse at 0.0625, the ring at 0.5 (no
    library call, the stacked yardstick at 0.75) and the sm90 backward at
    0.125.  ``clip_ring``: the sm90 ring's launches in the clip (the
    wrapper's 200 by default)."""
    row = lambda ms, **kw: dict(
        dict(max_abs_err=1e-3, kernel_ms=ms, plain_ms=9.0, bound_ms=0.06,
             bound_by="operations", library_ms=0.24, shape={}), **kw)
    ring = dict(library_ms=None, stacked_sdpa_ms=0.75,
                stacked_sdpa="_nbr_stacked gather + SDPA (default) + sum of "
                             "the halves")
    routed = chip_smoke.SM90_REPLACES
    results = {k: [row(0.5 if k in routed else 1.0)]
               for k in chip_smoke.REPLACES}
    results["packed_attention_nbr_fwd"] = [row(1.0, **ring)]
    ms = {chip_smoke.SM90: 0.25, chip_smoke.SM90_LSE: 0.0625,
          chip_smoke.SM90_NBR: 0.5}
    for kern, (wrappers, _) in chip_smoke.SM90_ROUTES.items():
        results[kern] = [row(ms.get(kern, 0.125), wrapper=w,
                             **(ring if kern == chip_smoke.SM90_NBR else {}))
                         for w in wrappers]

    def counts(sm90=None, dq=None, lse=None, nbr=None, **kw):
        c = chip_smoke._launches(**kw)
        for kern, (wrappers, _) in chip_smoke.SM90_ROUTES.items():
            c[kern] = sum(c[k] for k in wrappers)
        for kern, n in ((chip_smoke.SM90, sm90), (chip_smoke.SM90_DQ, dq),
                        (chip_smoke.SM90_LSE, lse),
                        (chip_smoke.SM90_NBR, nbr)):
            if n is not None:
                c[kern] = n
        return c

    per_step = chip_smoke._launches(packed_attention_fwd=1)
    path = {"generate": counts(generate_sm90, packed_attention_fwd=360,
                               packed_attention_nbr_fwd=100),
            "train": counts(packed_attention_fwd=2, dq=train_dq,
                            lse=train_lse, packed_attention_lse_fwd=264,
                            packed_attention_bwd_dq=132,
                            packed_attention_bwd_dkv=132),
            "video": counts(packed_attention_fwd=520, nbr=clip_ring,
                            packed_attention_nbr_fwd=200,
                            packed_attention_capped_fwd=200),
            "video_train": {
                "stage 1": counts(packed_attention_capped_lse_fwd=32),
                "stage 2": counts(packed_attention_capped_lse_fwd=40)},
            "fusionp": counts(packed_attention_fwd=280,
                              packed_attention_nbr_fwd=100,
                              flash_attention_fwd=1),
            "fusionp_train": counts(flash_attention_lse_fwd=6,
                                    flash_attention_bwd_dq=6,
                                    flash_attention_bwd_dkv=6)}
    return chip_smoke.kernels_line(results, path, per_step,
                                   {"stage 1": per_step,
                                    "stage 2": per_step}, per_step)


def test_kernels_line_credits_in_scope_calls_to_the_sm90_kernel():
    """The three wrappers' entries are ``attention.cu``'s template: its
    time, no launches on a path whose calls all took the sm90 kernel.  One
    sm90 entry per replaced TPU kernel, with that wrapper's launches."""
    got = {e["name"]: e for e in _kernels_line()["kernels"]}
    assert len(got) == 11 + 3 + 3 + 1 + 4
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


def test_kernels_line_credits_in_scope_backward_calls_to_the_sm90_kernels():
    """The four backward wrappers' entries are ``attention_train.cu``'s
    template, routed to one ``sm90_attention_bwd_dq:<wrapper>`` or
    ``sm90_attention_bwd_dkv:<wrapper>`` entry each, which replaces the
    wrapper's TPU kernel (:719, :751, :160, :184) and carries its
    launches."""
    got = {e["name"]: e for e in _kernels_line()["kernels"]}
    want = {"packed_attention_bwd_dq": ("sm90_attention_bwd_dq", ":719", 132),
            "packed_attention_bwd_dkv": ("sm90_attention_bwd_dkv", ":751",
                                         132),
            "flash_attention_bwd_dq": ("sm90_attention_bwd_dq", ":160", 6),
            "flash_attention_bwd_dkv": ("sm90_attention_bwd_dkv", ":184", 6)}
    for w, (kern, line, launches) in want.items():
        tmpl, sm90 = got[w], got[f"{kern}:{w}"]
        assert tmpl["source"].endswith("attention_train.cu")
        assert (tmpl["ms"], tmpl["launches"]) == (0.5, 0)
        assert tmpl["routed_to"] == sm90["name"]
        assert sm90["source"].endswith("attention_sm90_bwd.cu")
        assert sm90["replaces"] == tmpl["replaces"]
        assert sm90["replaces"].endswith(line)
        assert (sm90["ms"], sm90["launches"]) == (0.125, launches)


def test_kernels_line_refuses_a_path_where_the_backward_template_ran():
    with pytest.raises(AssertionError, match="sm90_attention_bwd_dq"):
        _kernels_line(train_dq=131)


def test_kernels_line_credits_in_scope_lse_calls_to_the_sm90_kernel():
    """The three training forwards' entries are ``attention.cu``'s
    template, routed to one ``sm90_attention_lse_fwd:<wrapper>`` entry
    each, which replaces the wrapper's TPU kernel (:701, :789, :126) from
    ``attention_sm90.cu`` and carries its launches on its path."""
    got = {e["name"]: e for e in _kernels_line()["kernels"]}
    want = {"packed_attention_lse_fwd": (":701", 264),
            "packed_attention_capped_lse_fwd": (":789", 72),
            "flash_attention_lse_fwd": (":126", 6)}
    for w, (line, launches) in want.items():
        tmpl, sm90 = got[w], got[f"{chip_smoke.SM90_LSE}:{w}"]
        assert tmpl["source"].endswith("attention.cu")
        assert (tmpl["ms"], tmpl["launches"]) == (0.5, 0)
        assert tmpl["routed_to"] == sm90["name"]
        assert sm90["source"].endswith("attention_sm90.cu")
        assert sm90["replaces"] == tmpl["replaces"]
        assert sm90["replaces"].endswith(line)
        assert (sm90["ms"], sm90["launches"]) == (0.0625, launches)


def test_kernels_line_refuses_a_path_where_the_lse_template_ran():
    with pytest.raises(AssertionError, match="sm90_attention_lse_fwd"):
        _kernels_line(train_lse=263)


@pytest.mark.parametrize("times, want", [
    ({"default": 0.1753, "FLASH_ATTENTION": 0.2801,
      "CUDNN_ATTENTION": 0.1749, "MATH": 1.9122}, ("CUDNN_ATTENTION", 0.1749)),
    ({"default": 0.0617, "CUDNN_ATTENTION": 0.0621}, ("default", 0.0617)),
])
def test_the_library_yardstick_is_the_fastest_sdpa_backend(times, want):
    """Phase 3's ``library_ms`` is the fastest of SDPA's default dispatch
    and its backends, not one pinned backend; no library call gives
    None."""
    assert chip_smoke.fastest(times) == want
    assert chip_smoke.library_row(None) == {"library_ms": None}


# ----------------------------------------------------- the camera ring --

def _ring_qkv(b=2, n_cam=3, l=9, c=32, seed=7):
    return _qkv(b * n_cam, l, l, c, seed)


@pytest.mark.parametrize("fn, route", [
    ("sm90_attention_nbr_fwd", None),
    ("packed_attention_nbr_fwd", "auto"),
    ("packed_attention_nbr_fwd", "template"),
])
def test_ring_wrappers_take_the_plain_version_on_the_cpu(fn, route):
    """The ring's sm90 kernel and its wrapper (either route) return the
    plain version bit for bit on the CPU and launch nothing."""
    q, k, v = _ring_qkv()
    A.reset_launch_counts()
    kw = {} if route is None else {"route": route}
    got = getattr(A, fn)(q, k, v, 4, 3, **kw)
    assert torch.equal(got, A.attention_packed_neighbors_plain(q, k, v, 4,
                                                               3))
    assert A.packed_attention_nbr_fwd.launches == 0
    assert A.sm90_attention_nbr_fwd.launches == 0


def test_ring_wrapper_refuses_a_bad_route(monkeypatch):
    """Past the device checks (taken out here: no card), a route other
    than "auto" or "template" is refused before any launch."""
    monkeypatch.setattr(A, "_check_cuda_bf16", lambda *a: None)
    q = torch.empty(6, 512, 64, device="meta", dtype=torch.bfloat16)
    A.reset_launch_counts()
    with pytest.raises(ValueError, match="route"):
        A.packed_attention_nbr_fwd(q, q, q, 8, 3, route="sm90")
    assert A.packed_attention_nbr_fwd.launches == 0
    assert A.sm90_attention_nbr_fwd.launches == 0


@pytest.mark.parametrize("fn", ["sm90_attention_nbr_fwd",
                                "packed_attention_nbr_fwd"])
def test_ring_kernel_refuses_a_tensor_off_the_cpu_and_the_card(fn):
    q = torch.empty(6, 512, 64, device="meta", dtype=torch.bfloat16)
    A.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        getattr(A, fn)(q, q, q, 8, 3)
    assert A.sm90_attention_nbr_fwd.launches == 0


def test_sm90_ring_refuses_grad():
    q = torch.empty(6, 512, 64, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    A.reset_launch_counts()
    with pytest.raises(RuntimeError, match="PackedAttention"):
        A.sm90_attention_nbr_fwd(q, q, q, 8, 3)
    assert A.sm90_attention_nbr_fwd.launches == 0


@pytest.mark.parametrize("c, heads, n_cam, match", [
    (320, 4, 3, "sm90 kernel"),      # d = 80: the template's
    (160, 8, 3, "multiples of 8"),   # d = 20
    (320, 8, 4, "n_cam=4"),          # 6 rows are not views of 4
])
def test_sm90_ring_refuses_what_it_cannot_take(monkeypatch, c, heads, n_cam,
                                               match):
    """Past the device checks, a head_dim outside ``sm90_in_scope`` or a
    batch that is not whole rings is refused before any launch, not sent
    elsewhere."""
    monkeypatch.setattr(A, "_check_cuda_bf16", lambda *a: None)
    q = torch.empty(6, 512, c, device="meta", dtype=torch.bfloat16)
    A.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        A.sm90_attention_nbr_fwd(q, q, q, heads, n_cam)
    assert A.sm90_attention_nbr_fwd.launches == 0


def test_the_sm90_ring_entry_takes_the_template_arguments():
    """``dd_sm90_attention_nbr_fwd`` lives in the sm90 forward's library
    and takes ``dd_packed_attention_nbr_fwd``'s arguments, one for one."""
    sigs = cuda_lib._SIGNATURES["attention_sm90"]
    assert sigs["dd_sm90_attention_nbr_fwd"] == \
        cuda_lib._SIGNATURES["attention"]["dd_packed_attention_nbr_fwd"]


@pytest.mark.parametrize("ring, sm90, ok", [
    (100, 100, True),    # a generation
    (200, 200, True),    # a clip
    (100, 99, False),    # one call took the template
    (200, 0, False),     # the template ran every call
    (0, 0, True),        # a training path: the ring never runs
    (0, 1, False),
])
def test_chip_smoke_holds_the_sm90_ring_count_to_the_wrapper(ring, sm90, ok):
    """``chip_smoke.check_sm90_launches``: ``sm90_attention_nbr_fwd``'s
    count equals the ring wrapper's in-scope calls."""
    counts = dict(chip_smoke._launches(packed_attention_nbr_fwd=ring),
                  sm90_attention_nbr_fwd=sm90)
    if ok:
        chip_smoke.check_sm90_launches(counts)
    else:
        with pytest.raises(AssertionError, match="sm90_attention_nbr_fwd"):
            chip_smoke.check_sm90_launches(counts)


def test_kernels_line_credits_in_scope_ring_calls_to_the_sm90_kernel():
    """The ring wrapper's entry is ``attention.cu``'s template (its time,
    no launches at 224x400), routed to ``sm90_attention_nbr_fwd:
    packed_attention_nbr_fwd``, which replaces ``_fwd_kernel_t_nbr``
    (:671) from ``attention_sm90.cu``, carries the wrapper's launches (100
    a generation, 200 a clip), no library call and the stacked
    yardstick."""
    got = {e["name"]: e for e in _kernels_line()["kernels"]}
    w = "packed_attention_nbr_fwd"
    tmpl, sm90 = got[w], got[f"{chip_smoke.SM90_NBR}:{w}"]
    assert tmpl["source"].endswith("attention.cu")
    assert (tmpl["ms"], tmpl["launches"]) == (1.0, 0)
    assert tmpl["routed_to"] == sm90["name"]
    assert sm90["source"].endswith("attention_sm90.cu")
    assert sm90["replaces"] == tmpl["replaces"]
    assert sm90["replaces"].endswith(":671")
    assert (sm90["ms"], sm90["launches"]) == (0.5, 100)
    assert sm90["launches_by_path"]["clip"] == 200
    assert sm90["library_ms"] is None and sm90["stacked_sdpa_ms"] == 0.75


def test_kernels_line_refuses_a_path_where_the_ring_template_ran():
    with pytest.raises(AssertionError, match="sm90_attention_nbr_fwd"):
        _kernels_line(clip_ring=199)
