"""The training reference gate of ``chip_smoke.py`` against planted faults,
on the card.

``chip_smoke.train_reference_readings`` runs one tiny loss + gradient in
bf16 on the card and in float32 on the CPU and reads every trainable leaf's
relative gradient error.  Here the backward kernels' wrappers are wrapped so
that one call's output is spoiled (zeroed, one head zeroed, scaled, or one
attn4 neighbour half dropped), and the worst leaf must then exceed
``chip_smoke.LEAF_TOL`` while the sound run stays under it.  Each case
prints its reading.  Marked ``cuda``: skips without a card.

The tiny step makes 12 differentiated attention calls.  Call 7 of the
backward is the UNet's first attn2 (``down_blocks_0``): its queries come
through frozen layers only, so its dq reaches no trainable and no gradient
check can see it (its dk/dv can: case ``dkv_zero_7``).

The video stage-2 gate (``train_reference_readings(video=True)``, phase 11)
is held against one planted fault in the capped training forward: the tiny
stage-2 step makes 6 capped calls (3 ST-Attn x 2 with remat); the last is
the replay of the UNet's first ST-Attn, whose lse its backward reads, and
it returns that lse shifted by 0.5 (P off by a factor e^-0.5 in dq and
dk/dv).

The ``occ_bg_fusionp`` gate (``train_reference_readings(fusionp=True)``,
phase ``fusionp_reference``) is held against faults planted in the SFA+
stage-2 backward, the one ``FlashAttention`` call of the tiny step (512 x
512 at d = 4): its dq zeroed, its dk/dv zeroed, one head's dq zeroed.  The
head is the one whose sound dq is largest: a head whose stage-1 attention
is near uniform over the text passes almost no gradient to SFA+'s leaves,
and its fault stays under the limit (head 0's reading is printed beside).
"""

import math

import pytest
import torch

import chip_smoke
from dualdiff_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda

CALLS = 12
VIDEO_CAPPED_CALLS = 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _zero(i, j, a, out):
    if i != j:
        return out
    return (tuple(torch.zeros_like(t) for t in out) if isinstance(out, tuple)
            else torch.zeros_like(out))


def _zero_head0(i, a, dq):
    if i:
        return dq
    dq = dq.clone()
    dq[..., :a[0].shape[-1] // a[6]] = 0
    return dq


def _drop_attn4_half(i, a, out):
    """dk/dv of the right-neighbour half of the first stacked attn4 call
    (12 rows: 6 views x both neighbours)."""
    dk, dv = out
    if a[0].shape[0] != 12 or _drop_attn4_half.done:
        return out
    _drop_attn4_half.done = True
    dk, dv = dk.clone(), dv.clone()
    dk[6:] = 0
    dv[6:] = 0
    return dk, dv


FAULTS = (
    [(f"dq_zero_{j}", "packed_attention_bwd_dq",
      lambda i, a, o, j=j: _zero(i, j, a, o)) for j in range(CALLS) if j != 7]
    + [(f"dkv_zero_{j}", "packed_attention_bwd_dkv",
        lambda i, a, o, j=j: _zero(i, j, a, o)) for j in range(CALLS)]
    + [("dq_zero_one_head_0", "packed_attention_bwd_dq", _zero_head0),
       ("dq_scale_0.9_0", "packed_attention_bwd_dq",
        lambda i, a, o: o * 0.9 if i == 0 else o),
       ("dkv_drop_attn4_half", "packed_attention_bwd_dkv", _drop_attn4_half)]
)


def _worst(readings):
    name, err = max(readings["leaf_rel_err"].items(), key=lambda kv: kv[1])
    return err, name


def test_sound_gradients_pass_the_gate(cuda):
    err, leaf = _worst(chip_smoke.train_reference_readings())
    print(f"sound: worst leaf {err:.4f} ({leaf})")
    assert err <= chip_smoke.LEAF_TOL


@pytest.mark.parametrize("label, wrapper, fault", FAULTS,
                         ids=[f[0] for f in FAULTS])
def test_planted_fault_fails_the_gate(cuda, monkeypatch, label, wrapper,
                                      fault):
    orig = getattr(A, wrapper)
    calls = [0]
    _drop_attn4_half.done = False

    def spoiled(*a, **kw):
        out = orig(*a, **kw)
        if a[0].is_cuda:  # the float32 CPU side stays sound
            out = fault(calls[0], a, out)
            calls[0] += 1
        return out

    spoiled.launches = 0  # the wrapper counts through its module name
    monkeypatch.setattr(A, wrapper, spoiled)
    err, leaf = _worst(chip_smoke.train_reference_readings())
    print(f"{label}: worst leaf {err:.4f} ({leaf})")
    assert calls[0] == CALLS
    assert err > chip_smoke.LEAF_TOL


def _zero_head(head):
    def fault(dq):
        dq = dq.clone()
        dq[:, :, head] = 0  # (B, L, H, D)
        return dq
    return fault


def _strongest_head(dq):
    """The head with the largest dq norm, (B, L, H, D)."""
    return int(dq.float().pow(2).sum((0, 1, 3)).argmax())


SFA_FAULTS = [
    ("sfa_plus_dq_zero", "flash_attention_bwd_dq", torch.zeros_like),
    ("sfa_plus_dkv_zero", "flash_attention_bwd_dkv",
     lambda out: tuple(torch.zeros_like(t) for t in out)),
    ("sfa_plus_dq_zero_strongest_head", "flash_attention_bwd_dq",
     lambda dq: _zero_head(_strongest_head(dq))(dq)),
]


def test_sound_fusionp_gradients_pass_the_gate(cuda):
    err, leaf = _worst(chip_smoke.train_reference_readings(fusionp=True))
    print(f"fusionp sound: worst leaf {err:.4f} ({leaf})")
    assert err <= chip_smoke.LEAF_TOL


@pytest.mark.parametrize("label, wrapper, fault", SFA_FAULTS,
                         ids=[f[0] for f in SFA_FAULTS])
def test_planted_sfa_plus_fault_fails_the_fusionp_gate(cuda, monkeypatch,
                                                       label, wrapper,
                                                       fault):
    calls = _plant(monkeypatch, wrapper, fault)
    err, leaf = _worst(chip_smoke.train_reference_readings(fusionp=True))
    print(f"{label}: worst leaf {err:.4f} ({leaf})")
    assert calls[0] == 1
    assert err > chip_smoke.LEAF_TOL


def _plant(monkeypatch, wrapper, fault):
    """Spoil the card's calls of ``wrapper`` with ``fault``; -> the count of
    spoiled calls, read after the run."""
    orig = getattr(A, wrapper)
    calls = [0]

    def spoiled(*a, **kw):
        out = orig(*a, **kw)
        if a[0].is_cuda:  # the float32 CPU side stays sound
            calls[0] += 1
            out = fault(out)
        return out

    spoiled.launches = 0  # the wrapper counts through its module name
    monkeypatch.setattr(A, wrapper, spoiled)
    return calls


def test_sfa_plus_head0_fault_reading(cuda, monkeypatch):
    """Head 0's dq zeroed: its reading is printed, not held to the limit
    (see above)."""
    calls = _plant(monkeypatch, "flash_attention_bwd_dq", _zero_head(0))
    err, leaf = _worst(chip_smoke.train_reference_readings(fusionp=True))
    print(f"sfa_plus_dq_zero_head_0: worst leaf {err:.4f} ({leaf})")
    assert calls[0] == 1


def test_sfa_plus_dq_fault_needs_the_cond_scale(cuda, monkeypatch):
    """Without ``SFA_COND_SCALE`` the random conditioning features are so
    small that SFA+'s softmaxes are uniform and its query path carries no
    gradient a leaf shows: the stage-2 dq zeroed stays under the limit.
    This is why the reference scales them."""
    monkeypatch.setattr(chip_smoke, "SFA_COND_SCALE", 1.0)
    calls = _plant(monkeypatch, "flash_attention_bwd_dq", torch.zeros_like)
    err, leaf = _worst(chip_smoke.train_reference_readings(fusionp=True))
    print(f"sfa_plus_dq_zero, unscaled: worst leaf {err:.4f} ({leaf})")
    assert calls[0] == 1
    assert err <= chip_smoke.LEAF_TOL


def test_gate_readings_at_224x400(cuda, monkeypatch):
    """The gate at 224x400 (8400 latent positions) instead of 256x128, for
    the flagship and ``occ_bg_fusionp``: printed, not held to the limit.
    Sums over every position in bf16 (the ControlNets' first
    ``time_emb_proj``, SFA+'s projections) read over it there, whatever the
    kernels; every leaf has a gradient on both sides."""
    from dualdiff_tpu_torch.utils import config as C

    load = C.load_config
    monkeypatch.setattr(C, "load_config", lambda name=C.FLAGSHIP,
                        overrides=(): load(name, [o for o in overrides
                                                  if "image_size" not in o]))
    for kw in ({}, {"fusionp": True}):
        errs = chip_smoke.train_reference_readings(**kw)["leaf_rel_err"]
        worst = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        print(f"224x400 {kw}: worst leaf "
              + ", ".join(f"{e:.4f} ({k})" for k, e in worst))
        assert all(math.isfinite(e) for e in errs.values())


def test_sound_video_gradients_pass_the_gate(cuda):
    err, leaf = _worst(chip_smoke.train_reference_readings(video=True))
    print(f"video sound: worst leaf {err:.4f} ({leaf})")
    assert err <= chip_smoke.LEAF_TOL


def test_planted_capped_lse_fault_fails_the_video_gate(cuda, monkeypatch):
    orig = A.packed_attention_capped_lse_fwd
    calls = [0]

    def spoiled(*a, **kw):
        out, lse = orig(*a, **kw)
        if a[0].is_cuda:  # the float32 CPU side stays sound
            calls[0] += 1
            if calls[0] == VIDEO_CAPPED_CALLS:
                lse = lse + 0.5
        return out, lse

    spoiled.launches = 0  # the wrapper counts through its module name
    monkeypatch.setattr(A, "packed_attention_capped_lse_fwd", spoiled)
    err, leaf = _worst(chip_smoke.train_reference_readings(video=True))
    print(f"capped_lse_shift_0.5_last: worst leaf {err:.4f} ({leaf})")
    assert calls[0] == VIDEO_CAPPED_CALLS
    assert err > chip_smoke.LEAF_TOL
