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
"""

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
