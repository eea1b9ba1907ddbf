#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``dualdiff_tpu_torch``) on one card.

    python3 chip_smoke.py                # the default run; one CUDA card
    python3 chip_smoke.py --profile DIR  # also writes kernel-time
                                         # breakdowns of one generation, one
                                         # training step, one clip, one
                                         # video training step of each stage
                                         # and one occ_bg_fusionp generation
                                         # and training step to
                                         # DIR/profile_generation.txt,
                                         # DIR/profile_train_step.txt,
                                         # DIR/profile_video_clip.txt,
                                         # DIR/profile_video_train_step.txt,
                                         # ..._video_train_step_rgd.txt,
                                         # DIR/profile_fusionp_generation.txt
                                         # and ..._fusionp_train_step.txt

Phases, in order; any failure exits non-zero:

1. device   requires CUDA; prints the card's name and power limit.
2. build    compiles every CUDA kernel from ``dualdiff_tpu_torch/csrc``.
3. kernels  each kernel against its plain PyTorch version at the shapes the
            flagship, clip and video training paths give it (bf16 inputs;
            plain version in float32, rounded once), with times of the
            kernel, the plain version, the fastest PyTorch library call
            where one computes the same function (SDPA's default dispatch
            and each backend that takes the shape, ``sdpa_ms``, named in
            the row), and the least time the card could
            take (bound); the sm90 forward (with and without lse, and the
            camera ring) and backward beside the template instances they
            replace at every in-scope shape (variants ``sm90``,
            ``template``; the capped templates at 4 and at 8 warps per
            block); the ring also beside the JAX package's training
            formulation in library calls (``stacked_sdpa_ms``: the
            ``_nbr_stacked`` gather, one SDPA on the stacked rows, the sum
            of the halves; no single call computes the ring); the split-layout
            kernels at the SFA+ stage-2 shapes and at d = 20, with
            ``mha_einsum``'s time beside them.  Kernel and
            library times come from a CUDA graph of 20 calls (``graph_ms``),
            the plain versions' and ``mha_einsum``'s from a host loop
            (``cuda_ms``).
4. generate the flagship dual-branch 224x400 generation at full SD v1.5
            width (two ControlNets, seeded random weights, bf16), B=2 x 6
            views, UniPC-20, CFG 2: one warm-up call and timed calls; checks
            shape, finiteness, range and the kernels' launch counts per call.
5. reference the tiny model set at 256x128, 3 steps, on the card in bf16
            against the same weights on the CPU in float32 (plain path).
6. train    the flagship training step at full width (B=1 x 6 views, bf16,
            remat, AdamW): one warm-up and timed steps; checks finite loss
            and grad_norm, launches per step, trainables moved and frozen
            parameters unchanged.
7. train_reference  one tiny loss + gradient at 256x128 on the card in bf16
            against the CPU in float32.
8. video    DualDiff+ clip generation (``video_16f``: ST-Attn + temporal
            attention, sequential CFG, VAE slicing 12) at full SD v1.5 width,
            seeded random weights, bf16: clip 0 of the seed-0 synthetic clips,
            16 frames x 6 views at 224x400, UniPC-20, CFG 2; one warm-up clip
            and timed clips; checks shape, finiteness, range and the kernels'
            launches per clip.
9. video_reference  the tiny video model set at 256x128, 2 frames, 3 steps,
            on the card in bf16 against the CPU in float32 (phase 5's gate).
10. video_train  DualDiff+ video training at full SD v1.5 width, seeded random
            weights, bf16, remat, AdamW, on clip 0 of the seed-0 synthetic
            2-frame clips (2 frames x 6 views at 224x400): stage 1
            (``video_16f``: ST-Attn, temporal attention, ``only_new`` + both
            ControlNets) and stage 2 (``rgd_stage2``: LoRA only, minus the
            FGM foreground + temporal reward of the decoded prediction), one
            warm-up and timed steps each; checks finite loss, grad_norm and
            reward, launches per step, trainables moved and frozen
            parameters unchanged, and that stage 2 trains only LoRA leaves.
11. video_train_reference  phase 7's gate on the tiny stage-2 model set
            (2-frame clip, reward included) with ST-Attn on the capped
            training route.
12. fusionp SFA+ (``occ_bg_fusionp``: one ControlNet, two-stage SFA+ whose
            1400 x 1400 stage 2 runs on the split-layout kernels) at full
            SD v1.5 width: phase 4's generation and phase 6's training step
            on its config, with its own launch counts.
13. fusionp_reference  the tiny ``occ_bg_fusionp`` set with SFA+ stage 2
            at d = 4 on the split-layout kernels: phase 5's gate at 224x400,
            phase 7's at 256x128 with ``FLASH_MIN_LEN`` lowered to 512.

On the CPU, ``VideoTrainer(cfg, clips, device="cpu", models=...)`` runs the
same training with the plain versions; README.md says how to rehearse
phases 10 and 11 there at a tiny size.

The last three lines are the ``kernels`` JSON summary (one entry per
kernel, and one ``<sm90 kernel>:<wrapper>`` entry per TPU kernel each sm90
kernel replaces: ``sm90_attention_fwd``, ``sm90_attention_lse_fwd``,
``sm90_attention_nbr_fwd``, ``sm90_attention_bwd_dq``,
``sm90_attention_bwd_dkv``), the card's name
and power limit, and ``{"ok": true, "device": {...}}``.  Imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time

import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, NVIDIA data sheet (SXM)
H100_BYTES_PER_S = 3.35e12
# exponentials per clock of one SM (MUFU: 4 per SM sub-partition) on 132 SMs
H100_SMS, EXP_PER_CLOCK = 132, 16
SEED = 0
TIMED_GENERATIONS = 3
TIMED_TRAIN_STEPS = 5
TIMED_CLIPS = 2
TIMED_VIDEO_TRAIN_STEPS = 3
# Training reference (phase 7), bf16 card against float32 CPU; readings on
# an H100 80GB HBM3 at 700 W.  Loss: 3.75e-4 relative apart; the limit is
# about 5x that.  Gradients, per trainable leaf (``leaf_grad_errors``): the
# worst sound leaf reads 0.048 with the floor at 3e-3 of the network's
# largest leaf; planted faults (tests/test_torch_grad_gate_cuda.py) read
# 0.098 (one call's dq scaled by 0.9) to 1.0 (one call's dq or dk/dv
# zeroed: 0.149 and up).  The limit sits between 0.048 and 0.098.
LOSS_REL_TOL = 2e-3
LEAF_FLOOR = 3e-3
LEAF_TOL = 0.07
# The stage-2 reference (phase 11) scales the random LoRA B down: at full
# random scale B A is a second projection as large as W, which sharpens
# every LoRA-carrying softmax until bf16 rounding decides it (the tiny model
# in bf16 on the CPU read 0.12 against float32 at full scale, 0.06 at 0.1;
# on an H100 80GB HBM3 at 700 W 0.055 at 0.1, planted lse fault 0.40; a
# trained adapter starts at B = 0 and stays a small perturbation).
LORA_B_SCALE = 0.1
# The SFA+ reference (phase 13's training gate) scales the tiny conditioning
# embedder's conv_out up: with random weights the [0, 1] occupancy panorama
# leaves its convs at about 0.02 per element, where both SFA+ softmaxes are
# uniform to 2e-3 and the query path carries no gradient a leaf could show
# (tests/test_torch_grad_gate_cuda.py: the stage-2 dq zeroed reads as sound
# without the scale).  At 100x the features are O(1), as a trained
# embedder's grow from their zero init, and the planted SFA+ faults show.
SFA_COND_SCALE = 100.0

# main-path kernel shapes: CFG batch 2*B*N = 24 rows, the 28x50 = 1400-token
# latent level at C = 320 with 8 heads (d = 40); cross-attention KV
# 1 camera + 77 text + 80 box tokens = 158 in the UNet and both ControlNets
B, N_CAM, L, C, HEADS = 2, 6, 1400, 320, 8
KV_CROSS = 1 + 77 + 80
# training: train_batch_size 1 x 6 views; attn4 stacks both neighbours
B_TRAIN = 1
# video: one clip of 16 frames x 6 views per CFG half (sequential CFG); the
# UNet's ST-Attn K/V are the first and the previous frame's 1400 tokens
FRAMES = 16
# video training: one clip of 2 frames x 6 views per step
TRAIN_FRAMES = 2
# the TPU kernel each CUDA kernel replaces, and its source here
REPLACES = {
    "packed_attention_fwd": "dualdiff_tpu/ops/attention.py:468",      # _fwd_kernel_t
    "packed_attention_nbr_fwd": "dualdiff_tpu/ops/attention.py:671",  # _fwd_kernel_t_nbr
    "packed_attention_lse_fwd": "dualdiff_tpu/ops/attention.py:701",  # _fwd_kernel_t_lse
    "packed_attention_bwd_dq": "dualdiff_tpu/ops/attention.py:719",   # _bwd_dq_kernel_t
    "packed_attention_bwd_dkv": "dualdiff_tpu/ops/attention.py:751",  # _bwd_dkv_kernel_t
    "packed_attention_capped_fwd": "dualdiff_tpu/ops/attention.py:484",  # _fwd_kernel_t_capped
    "packed_attention_capped_lse_fwd": "dualdiff_tpu/ops/attention.py:789",  # _fwd_kernel_t_capped_lse
    "flash_attention_fwd": "dualdiff_tpu/ops/attention.py:267",       # _fwd_kernel_nolse
    "flash_attention_lse_fwd": "dualdiff_tpu/ops/attention.py:126",   # _fwd_kernel
    "flash_attention_bwd_dq": "dualdiff_tpu/ops/attention.py:160",    # _bwd_dq_kernel
    "flash_attention_bwd_dkv": "dualdiff_tpu/ops/attention.py:184",   # _bwd_dkv_kernel
}
SOURCE = {
    "packed_attention_fwd": "dualdiff_tpu_torch/csrc/attention.cu",
    "packed_attention_nbr_fwd": "dualdiff_tpu_torch/csrc/attention.cu",
    "packed_attention_lse_fwd": "dualdiff_tpu_torch/csrc/attention.cu",
    "packed_attention_bwd_dq": "dualdiff_tpu_torch/csrc/attention_train.cu",
    "packed_attention_bwd_dkv": "dualdiff_tpu_torch/csrc/attention_train.cu",
    "packed_attention_capped_fwd": "dualdiff_tpu_torch/csrc/attention.cu",
    "packed_attention_capped_lse_fwd": "dualdiff_tpu_torch/csrc/attention.cu",
    "flash_attention_fwd": "dualdiff_tpu_torch/csrc/attention.cu",
    "flash_attention_lse_fwd": "dualdiff_tpu_torch/csrc/attention.cu",
    "flash_attention_bwd_dq": "dualdiff_tpu_torch/csrc/attention_train.cu",
    "flash_attention_bwd_dkv": "dualdiff_tpu_torch/csrc/attention_train.cu",
}


# The Hopper forward behind packed_attention_fwd, packed_attention_capped_fwd
# and flash_attention_fwd for the calls in ops.attention.sm90_in_scope: the
# TPU kernel each wrapper's calls replace there (rows 1, 6 and 8 without
# lse: _fwd_kernel_t, _fwd_kernel_t_capped, _fwd_kernel_nolse).
SM90 = "sm90_attention_fwd"
SM90_WRAPPERS = ("packed_attention_fwd", "packed_attention_capped_fwd",
                 "flash_attention_fwd")
SM90_SOURCE = "dualdiff_tpu_torch/csrc/attention_sm90.cu"
# The same kernel with its lse epilogue behind the three training forwards
# (rows 3, 7 and 8 with lse: _fwd_kernel_t_lse, _fwd_kernel_t_capped_lse,
# _fwd_kernel).
SM90_LSE = "sm90_attention_lse_fwd"
SM90_LSE_WRAPPERS = ("packed_attention_lse_fwd",
                     "packed_attention_capped_lse_fwd",
                     "flash_attention_lse_fwd")
# The same kernel with its ring flag behind the camera ring (row 2:
# _fwd_kernel_t_nbr).
SM90_NBR = "sm90_attention_nbr_fwd"
# The Hopper backward behind the four backward wrappers for the calls in
# ops.attention.sm90_in_scope (rows 4-5 and 9-10: _bwd_dq_kernel_t,
# _bwd_dkv_kernel_t, _bwd_dq_kernel, _bwd_dkv_kernel).
SM90_DQ, SM90_DKV = "sm90_attention_bwd_dq", "sm90_attention_bwd_dkv"
SM90_BWD_SOURCE = "dualdiff_tpu_torch/csrc/attention_sm90_bwd.cu"
# each sm90 kernel: the wrappers whose in-scope calls it takes, its source
SM90_ROUTES = {
    SM90: (SM90_WRAPPERS, SM90_SOURCE),
    SM90_LSE: (SM90_LSE_WRAPPERS, SM90_SOURCE),
    SM90_NBR: (("packed_attention_nbr_fwd",), SM90_SOURCE),
    SM90_DQ: (("packed_attention_bwd_dq", "flash_attention_bwd_dq"),
              SM90_BWD_SOURCE),
    SM90_DKV: (("packed_attention_bwd_dkv", "flash_attention_bwd_dkv"),
               SM90_BWD_SOURCE),
}
SM90_REPLACES = {kern: REPLACES[kern]
                 for wrappers, _ in SM90_ROUTES.values() for kern in wrappers}


def _launches(**counts) -> dict:
    """Launches of every kernel wrapper, 0 where not given."""
    return {name: counts.get(name, 0) for name in REPLACES}


def launch_counts(A) -> dict:
    """Launches since the last reset: each of the eleven wrappers and the
    five sm90 kernels (``SM90_ROUTES``)."""
    return {**{fn.__name__: fn.launches for fn in A.KERNEL_WRAPPERS},
            **{fn.__name__: fn.launches for fn in A.SM90_KERNELS}}


def _wrappers(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if k not in SM90_ROUTES}


def _sm90_kernel_of(wrapper: str):
    """The sm90 kernel that takes ``wrapper``'s in-scope calls, or None."""
    return next((k for k, (ws, _) in SM90_ROUTES.items() if wrapper in ws),
                None)


def check_sm90_launches(counts: dict, out_of_scope=()) -> None:
    """Every in-scope launch of the three inference wrappers, of the three
    training forwards, of the ring wrapper and of the four backward
    wrappers went through its sm90 kernel: each sm90 kernel's count equals
    its wrappers', less the
    wrappers named in ``out_of_scope`` (whose calls on this path have a
    head_dim outside ``sm90_in_scope``, as SFA+ stage 2 at d = 4 in the
    tiny models).  A kernel or wrapper missing from ``counts`` counts 0."""
    for kernel, (wrappers, _) in SM90_ROUTES.items():
        want = sum(counts.get(k, 0) for k in wrappers
                   if k not in out_of_scope)
        if counts.get(kernel, 0) != want:
            raise AssertionError(f"{kernel} launched {counts.get(kernel, 0)}"
                                 f" times, the wrappers' in-scope calls "
                                 f"{want}: {counts}")


def _sfa_plus_on_kernels(fusionp: bool, tokens: int) -> bool:
    """SFA+ stage 2 (``tokens`` x ``tokens``) reaches ``flash_attention``
    when both lengths are at least ``FLASH_MIN_LEN``."""
    from dualdiff_tpu_torch.ops.attention import FLASH_MIN_LEN

    return fusionp and tokens >= FLASH_MIN_LEN


def generate_launches_per_generation(layers: int, n_controlnets: int,
                                     steps: int, fusionp: bool = False,
                                     tokens: int = 1400) -> dict:
    """Kernel launches of one image generation, derived from the code.  Per
    model evaluation the UNet's ``2 * layers + 1`` transformer blocks at the
    top latent level (``down_blocks_0``, ``up_blocks_3``) run attn1, attn2
    (``packed_attention_fwd``) and attn4 (the ring kernel), and each
    ControlNet's ``layers`` blocks attn1 and attn2; nothing is
    differentiated.  With SFA+ (``fusionp``) its stage 2 runs once per
    generation, in the ControlNet's step-constant precompute over the whole
    CFG batch: one ``flash_attention_fwd`` when it reaches the kernels."""
    blocks = 2 * layers + 1
    return _launches(
        packed_attention_fwd=(2 * blocks + 2 * n_controlnets * layers)
        * steps,
        packed_attention_nbr_fwd=blocks * steps,
        flash_attention_fwd=int(_sfa_plus_on_kernels(fusionp, tokens)))


def train_launches_per_step(layers: int, n_controlnets: int,
                            remat: bool, fusionp: bool = False,
                            tokens: int = 1400) -> dict:
    """Kernel launches of one training step, derived from the code.  Only
    the top latent level reaches the kernels (28x50 = 1400 tokens at
    224x400; 32x16 = 512 for the tiny 256x128 models).  There:

    * UNet ``down_blocks_0``: ``layers`` transformer blocks of attn1, attn2
      and attn4.  Its first block's attn1 sees only frozen inputs (the noisy
      latents through frozen layers): no input needs a gradient, so it
      takes the inference kernel.  That block's attn2 (K/V from the
      ControlNet's context tokens) and attn4 (trainable norm4 and
      projections) are differentiated, as is everything after them.
    * UNet ``up_blocks_3``: ``layers + 1`` blocks, 3 differentiated each.
    * each ControlNet's ``down_blocks_0``: ``layers`` blocks of attn1 and
      attn2 (no attn4), all trainable.
    * attn4 under grad is one stacked ``PackedAttention`` call per block;
      the ring kernel never runs.

    * with SFA+ (``fusionp``), its stage 2 over the ``tokens`` of the
      condition map runs once, outside the remat blocks, differentiated
      (every ControlNet leaf trains): one ``FlashAttention`` when both
      lengths reach ``FLASH_MIN_LEN``.

    A differentiated call is one forward with lse, one dq and one dk/dv;
    remat replays every block's forward in the backward, so the forward
    kernels run twice."""
    train = 2 + 3 * (layers - 1) + 3 * (layers + 1) \
        + 2 * n_controlnets * layers
    replay = 2 if remat else 1
    sfa = int(_sfa_plus_on_kernels(fusionp, tokens))
    return _launches(packed_attention_fwd=replay,
                     packed_attention_lse_fwd=train * replay,
                     packed_attention_bwd_dq=train,
                     packed_attention_bwd_dkv=train,
                     flash_attention_lse_fwd=sfa, flash_attention_bwd_dq=sfa,
                     flash_attention_bwd_dkv=sfa)


def video_launches_per_clip(layers: int, n_controlnets: int, steps: int,
                            sequential_cfg: bool, tokens: int) -> dict:
    """Kernel launches of one clip's generation, derived from the code.
    Only the top latent level (``tokens`` = 28x50 = 1400 at 224x400; 32x16
    = 512 for the tiny 256x128 models) reaches the kernels.  Per model
    evaluation:

    * UNet ``down_blocks_0`` (``layers`` transformer blocks) and
      ``up_blocks_3`` (``layers + 1``): attn1 is ST-Attn, ``tokens``
      queries against the first and the previous frame's ``2 * tokens``
      keys, which takes the capped kernel when its padded score tile is over
      ``T_SCORE_CAP`` (1408 x 2816 is) and ``packed_attention_fwd``
      otherwise; attn2 (context tokens) takes ``packed_attention_fwd``;
      attn4 the ring kernel.  The temporal attention (16 frames) is einsum.
    * each ControlNet's ``down_blocks_0``: ``layers`` blocks of attn1 (self,
      ``tokens`` keys) and attn2, both ``packed_attention_fwd``.

    The sampler evaluates the model once per step; sequential CFG evaluates
    the uncond and the cond half one after the other."""
    from dualdiff_tpu_torch.ops.attention import over_score_cap

    blocks = 2 * layers + 1
    evals = steps * (2 if sequential_cfg else 1)
    capped = over_score_cap(tokens, 2 * tokens)
    per_eval_fwd = blocks * (1 if capped else 2) + 2 * n_controlnets * layers
    return _launches(
        packed_attention_fwd=per_eval_fwd * evals,
        packed_attention_nbr_fwd=blocks * evals,
        packed_attention_capped_fwd=(blocks if capped else 0) * evals)


def video_train_launches_per_step(layers: int, n_controlnets: int,
                                  remat: bool, lora: bool,
                                  tokens: int) -> dict:
    """Kernel launches of one video training step, derived from the code.
    Only the top latent level (``tokens`` = 1400 at 224x400; 512 for the
    tiny 256x128 models) reaches the kernels: the UNet's ``down_blocks_0``
    (``layers`` transformer blocks) and ``up_blocks_3`` (``layers + 1``),
    each with attn1 as ST-Attn (``tokens`` queries against ``2 * tokens``
    keys), attn2 and attn4, and each ControlNet's ``down_blocks_0``
    (``layers`` blocks of attn1 self and attn2).  The temporal attention
    (2 frames) is einsum.

    * Stage 1 (``lora=False``: ``only_new`` + ControlNets): the UNet's
      first block's attn1 sees only frozen inputs and takes an inference
      kernel (the capped one when 1408 x 2816 is over ``T_SCORE_CAP``);
      its attn2 (the ControlNet's context tokens) and attn4 (trainable) and
      everything after are differentiated, as are the ControlNets.
    * Stage 2 (``lora=True``: LoRA on every UNet attn1 / attn2, ControlNets
      frozen): every UNet attention is differentiated (attn4 through its
      LoRA-carrying input); the ControlNets take the inference kernel once
      each, since nothing of theirs is replayed or differentiated.

    A differentiated call is one forward with lse (the capped one for
    ST-Attn over the cap), one dq and one dk/dv; remat replays every
    differentiated network's forward in the backward."""
    from dualdiff_tpu_torch.ops.attention import over_score_cap

    blocks = 2 * layers + 1
    capped = over_score_cap(tokens, 2 * tokens)
    replay = 2 if remat else 1
    st_frozen = 0 if lora else 1  # ST-Attn calls taking inference kernels
    st_train = blocks - st_frozen
    cn = 2 * n_controlnets * layers  # ControlNet attention calls
    whole = 2 * blocks + (0 if lora else cn) + (0 if capped else st_train)
    return _launches(
        packed_attention_fwd=(cn if lora else 0)
        + (0 if capped else st_frozen * replay),
        packed_attention_lse_fwd=whole * replay,
        packed_attention_bwd_dq=whole + (st_train if capped else 0),
        packed_attention_bwd_dkv=whole + (st_train if capped else 0),
        packed_attention_capped_fwd=st_frozen * replay if capped else 0,
        packed_attention_capped_lse_fwd=st_train * replay if capped else 0)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed(name, fn, *a, **kw):
    """``fn(*a, **kw)``, logging its wall time as phase ``name``."""
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    log(f"# phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"# device: {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    return smi


def phase_build() -> None:
    from dualdiff_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    secs = cuda_lib.build()
    log(f"# build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f} s)")
    for name in secs:
        with open(cuda_lib.library_path(name)[:-3] + ".log") as f:
            for line in f:
                if any(w in line for w in ("registers", "spill", "arning")):
                    log(f"#   {line.strip()}")


def cuda_ms(fn, iters: int) -> float:
    """Mean time of ``fn()`` over ``iters`` calls from a host loop after
    one warm-up, with CUDA events: the device time where a call takes
    longer than its enqueue (the plain versions), else the host's enqueue
    rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn()`` from a CUDA graph of ``iters`` calls,
    replayed once after a warm-up replay and timed with CUDA events: no
    host enqueue in the window, so short kernels read their own time.  A
    call that cannot be captured raises."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def bound(nbytes: float, flops: float):
    t_mem = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return (max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations")


def kernel_cases():
    """(kernel, label, b, lq, lk, c, heads, n_cam) of every compared shape."""
    return [
        ("packed_attention_fwd", "attn1 self", 2 * B * N_CAM, L, L, C, HEADS,
         0),
        ("packed_attention_fwd", "attn2 cross (UNet, ControlNet 0 and 1)",
         2 * B * N_CAM, L, KV_CROSS, C, HEADS, 0),
        # the clip's ControlNet attn1: 16 frames x 6 views
        ("packed_attention_fwd", "ControlNet attn1 in the clip",
         FRAMES * N_CAM, L, L, C, HEADS, 0),
        ("packed_attention_fwd", "ragged, d=40", 3, 777, 333, C, HEADS, 0),
        # the tiny reference models' 512-token level (C = 32, 4 heads)
        ("packed_attention_fwd", "tiny models, d=8", 12, 512, 512, 32, 4, 0),
        ("packed_attention_fwd", "ragged, d=80", 3, 777, 333, 320, 4, 0),
        ("packed_attention_nbr_fwd", "attn4 camera ring", 2 * B * N_CAM, L, L,
         C, HEADS, N_CAM),
        # the clip's ring: 16 frames x 6 views per CFG half
        ("packed_attention_nbr_fwd", "attn4 camera ring in the clip",
         FRAMES * N_CAM, L, L, C, HEADS, N_CAM),
        ("packed_attention_nbr_fwd", "ragged ring, d=40", 2 * 3, 777, 777, C,
         HEADS, 3),
        # the tiny reference models' ring at their 512-token level
        ("packed_attention_nbr_fwd", "tiny models' ring, d=8", 2 * N_CAM, 512,
         512, 32, 4, N_CAM),
        ("packed_attention_nbr_fwd", "ragged ring, d=80", 2 * 3, 701, 701,
         320, 4, 3),
        ("packed_attention_capped_fwd", "video ST-Attn, first + previous "
         "frame", FRAMES * N_CAM, L, 2 * L, C, HEADS, 0),
        ("packed_attention_capped_fwd", "ragged ST-Attn, lk = 2801",
         FRAMES * N_CAM, L, 2 * L + 1, C, HEADS, 0),
        # not on any path: is the 8-warp block also faster under the cap?
        ("packed_attention_capped_fwd", "yardstick: attn1 self shape",
         2 * B * N_CAM, L, L, C, HEADS, 0),
        # SFA+ stage 2 in the ControlNet's precompute over the CFG batch
        ("flash_attention_fwd", "SFA+ stage 2 (occ_bg_fusionp generation)",
         2 * B * N_CAM, L, L, C, HEADS, 0),
        ("flash_attention_fwd", "d=20 (d % 8 != 0), ragged", 3, 777, 1111,
         160, 8, 0),
    ]


def train_kernel_cases():
    """(label, b, lq, lk, c, heads[, split_layout]) of every compared
    training shape: the flagship step's 1400-token attentions (6 view rows;
    attn4 stacks the left and right neighbours on the batch axis, 12 rows),
    the video training step's ST-Attn under grad (2 frames x 6 views
    against the first and the previous frame's 2800 keys, over
    ``T_SCORE_CAP``: the capped forward), the ``occ_bg_fusionp`` step's SFA+
    stage 2 on the split-layout kernels (``split_layout``) plus ragged
    ones and the sm90 backward's edge cases."""
    rows = B_TRAIN * N_CAM
    video_rows = TRAIN_FRAMES * N_CAM
    return [
        ("attn1 self", rows, L, L, C, HEADS),
        ("SFA+ stage 2 under grad (occ_bg_fusionp training)", rows, L, L, C,
         HEADS, True),
        ("d=20 (d % 8 != 0), ragged", 3, 777, 1111, 160, 8, True),
        ("attn4 stacked neighbours", 2 * rows, L, L, C, HEADS),
        ("attn2 cross", rows, L, KV_CROSS, C, HEADS),
        ("ragged, d=80", 3, 777, 333, 320, 4),
        ("d=160", 2, 513, 65, 1280, 8),
        ("video ST-Attn under grad, first + previous frame", video_rows, L,
         2 * L, C, HEADS),
        ("ragged ST-Attn under grad, lk = 2801", video_rows, L, 2 * L + 1, C,
         HEADS),
        # the sm90 backward's edges: ragged tiles at both ends, one key, one
        # query, the tiny models' d = 8 and the largest head_dim, 64
        ("ragged, d=40", 3, 777, 333, C, HEADS),
        ("one key, d=40", 2, 129, 1, C, HEADS),
        ("one query, d=40", 2, 1, 300, C, HEADS),
        ("tiny models, d=8", 12, 512, 512, 32, 4),
        ("ragged, d=64", 3, 777, 333, 256, 4),
    ]


def _tol(want) -> float:
    """bf16 output: one rounding is 2^-8 relative; the kernels also round
    one MMA operand to bf16 (P in the forward and dv, dS in dq and dk:
    2^-9 relative per term, averaging out over the summed keys or
    queries)."""
    return 2.0 ** -7 * want.float().abs().max().item() + 1e-3


def _max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def sdpa_ms(call, iters: int = 20) -> dict:
    """``graph_ms`` of ``call()`` (which calls SDPA) under SDPA's default
    dispatch and under each backend alone, by backend name; a backend whose
    eager call raises (it does not take the shape) is left out."""
    import contextlib

    from torch.nn.attention import SDPBackend, sdpa_kernel

    ctxs = {"default": contextlib.nullcontext}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        ctxs[be.name] = functools.partial(sdpa_kernel, [be])
    times = {}
    for name, ctx in ctxs.items():
        with ctx():
            try:
                call()
            except RuntimeError:
                continue
            times[name] = graph_ms(call, iters)
    if not times:
        raise RuntimeError("no SDPA backend takes these inputs")
    return times


def fastest(times: dict):
    """(name, ms) of the fastest entry of ``times``."""
    name = min(times, key=times.get)
    return name, times[name]


def library_row(call) -> dict:
    """``library_ms`` of the fastest SDPA backend for ``call`` (None
    without one), the backend's name and every backend's time."""
    if call is None:
        return {"library_ms": None}
    times = sdpa_ms(call)
    name, ms = fastest(times)
    return {"library_ms": ms, "library": f"SDPA ({name})",
            "library_ms_by_backend": times}


def stacked_sdpa_call(q, k, v, heads: int, n_cam: int):
    """The camera ring as the JAX package's training formulation computes
    it with library calls (``_nbr_stacked``): the left and right views' K/V
    gathered and stacked on the batch axis with ``torch.cat``, one
    ``scaled_dot_product_attention`` over the 2B stacked rows, the two
    halves summed; q/k/v (B*N, L, C) packed in, (B*N, L, C) out.  A
    yardstick of two calls beside the ring kernel: the port never calls
    it."""
    bn, l, c = q.shape
    b, d = bn // n_cam, c // heads
    idx = lambda off: torch.tensor([(n + off) % n_cam for n in range(n_cam)],
                                   device=q.device)
    left, right = idx(-1), idx(1)
    take = lambda t, i: t.view(b, n_cam, l, c).index_select(1, i).reshape(
        bn, l, c)
    split = lambda t: t.view(t.shape[0], l, heads, d).transpose(1, 2)

    def call():
        k2 = torch.cat([take(k, left), take(k, right)])
        v2 = torch.cat([take(v, left), take(v, right)])
        o2 = torch.nn.functional.scaled_dot_product_attention(
            split(torch.cat([q, q])), split(k2), split(v2))
        return (o2[:bn] + o2[bn:]).transpose(1, 2).reshape(bn, l, c)
    return call


def split_on_packed(A):
    """The split-layout wrappers and plain versions called like the packed
    ones, on packed (B, L, C) tensors and ``heads``: each reads the
    (B, L, H, D) view of the same memory, and its result is viewed back."""
    sp = lambda t, h: t.view(t.shape[0], t.shape[1], h, -1)
    pk = lambda t: t.reshape(t.shape[0], t.shape[1], -1)

    def call(fn, n_split):
        def run(*a, **kw):
            heads = a[-1]
            out = fn(*(sp(t, heads) for t in a[:n_split]),
                     *a[n_split:-1], **kw)
            if isinstance(out, tuple):
                return tuple(pk(t) if t.dim() == 4 else t for t in out)
            return pk(out)
        return run

    return {"fwd": call(A.flash_attention_fwd, 3),
            "plain": call(A.flash_attention_plain, 3),
            "lse_fwd": call(A.flash_attention_lse_fwd, 3),
            "lse_plain": call(A.flash_attention_lse_plain, 3),
            "bwd_dq": call(A.flash_attention_bwd_dq, 4),
            "bwd_dq_plain": call(A.flash_attention_bwd_dq_plain, 4),
            "bwd_dkv": call(A.flash_attention_bwd_dkv, 4),
            "bwd_dkv_plain": call(A.flash_attention_bwd_dkv_plain, 4)}


def train_kernel_rows(A, g, label, b, lq, lk, c, heads,
                      split_layout=False, clock_hz=None):
    """The three training kernels on one shape against their plain
    versions: the forward with lse (over ``T_SCORE_CAP`` the capped one,
    whose template runs at 4 and at 8 warps, the path's count first), dq
    and dk/dv; with ``split_layout`` the split-layout ones
    (``flash_attention_*``, any head_dim).  On a shape in ``sm90_in_scope``
    each runs on the path's route, the sm90 kernels (variant ``sm90``: rows
    of ``SM90_LSE``, ``SM90_DQ`` and ``SM90_DKV``), and on the template
    (``template``: the wrappers' own rows), each checked.  Each backward
    kernel gets the path's forward kernel's lse and the delta of its bf16
    output, as ``PackedAttention.backward`` and ``FlashAttention.backward``
    do; ``exp_floor_ms`` (with ``clock_hz``) counts one exponential per
    score in each kernel.  Library yardsticks, each the fastest of SDPA's
    default dispatch and its backends (``sdpa_ms``): the forward of
    ``F.scaled_dot_product_attention`` under grad (it keeps the
    logsumexp) for the forward, its backward for dq and dk/dv together (a
    graph of its forward and backward less a graph of its forward).  With
    ``split_layout`` also the forward and backward of ``mha_einsum``, the
    route below ``FLASH_MIN_LEN``."""
    q, k, v = (torch.randn(b, n, c, generator=g, device="cuda").bfloat16()
               for n in (lq, lk, lk))
    do = torch.randn(b, lq, c, generator=g, device="cuda").bfloat16()
    d = c // heads
    shape = {"b": b, "lq": lq, "lk": lk, "c": c, "heads": heads,
             "head_dim": d}
    names = {"dq": "packed_attention_bwd_dq",
             "dkv": "packed_attention_bwd_dkv"}
    fns = {"lse_plain": A.attention_packed_lse_plain,
           "bwd_dq": A.packed_attention_bwd_dq,
           "bwd_dq_plain": A.attention_packed_bwd_dq_plain,
           "bwd_dkv": A.packed_attention_bwd_dkv,
           "bwd_dkv_plain": A.attention_packed_bwd_dkv_plain}
    warps = ()
    if split_layout:
        fns = split_on_packed(A)
        fwd_kern, fwd_fn = "flash_attention_lse_fwd", fns["lse_fwd"]
        names = {"dq": "flash_attention_bwd_dq",
                 "dkv": "flash_attention_bwd_dkv"}
    elif A.over_score_cap(lq, lk):
        fwd_kern = "packed_attention_capped_lse_fwd"
        fwd_fn = A.packed_attention_capped_lse_fwd
        warps = sorted((4, 8), key=lambda w: w != A.CAPPED_LSE_WARPS)
    else:
        fwd_kern = "packed_attention_lse_fwd"
        fwd_fn = A.packed_attention_lse_fwd
    # every kernel's routes, the path's first: in scope the sm90 kernels,
    # timed beside the template instances they replace
    in_scope = A.sm90_in_scope(d, True)
    routes = {"sm90": {}, "template": {"route": "template"}} if in_scope \
        else {"": {}}
    fwd_routes = {"sm90": {}} if in_scope else {}
    for n, kw in ({f"{w} warps": {"warps": w} for w in warps}
                  or {"": {}}).items():
        if in_scope:
            n, kw = f"template {n}".strip(), dict(kw, route="template")
        fwd_routes[n] = kw
    fwds = {n: functools.partial(fwd_fn, **kw) for n, kw in fwd_routes.items()}
    o_want, lse_want = fns["lse_plain"](q, k, v, heads)
    checks = {fwd_kern: {}, names["dq"]: {}, names["dkv"]: {}}
    # lse is float32 on both sides; online softmax with exp2 and another
    # order of sums: 1e-3 absolute on values of about log(Lk) + max logit
    for name, fwd in fwds.items():
        o, lse = fwd(q, k, v, heads)
        torch.cuda.synchronize()
        checks[fwd_kern][name] = [
            (f"o {name}".strip(), _max_err(o, o_want), _tol(o_want)),
            (f"lse {name}".strip(), _max_err(lse, lse_want), 1e-3)]
    fwd = next(iter(fwds.values()))
    o, lse = fwd(q, k, v, heads)
    delta = A.attention_delta(o, do, heads)
    bwd_args = (q, k, v, do, lse, delta, heads)
    bwd_runs = {kind: {n: functools.partial(fns[f"bwd_{kind}"], *bwd_args,
                                            **kw)
                       for n, kw in routes.items()}
                for kind in ("dq", "dkv")}
    dq_want = fns["bwd_dq_plain"](*bwd_args)
    dk_want, dv_want = fns["bwd_dkv_plain"](*bwd_args)
    for n in routes:
        dq = bwd_runs["dq"][n]()
        dk, dv = bwd_runs["dkv"][n]()
        torch.cuda.synchronize()
        checks[names["dq"]][n] = [
            ("dq", _max_err(dq, dq_want), _tol(dq_want))]
        checks[names["dkv"]][n] = [
            ("dk", _max_err(dk, dk_want), _tol(dk_want)),
            ("dv", _max_err(dv, dv_want), _tol(dv_want))]
        del dq, dk, dv
    del o_want, lse_want, dq_want, dk_want, dv_want

    split = lambda t: t.view(b, t.shape[1], heads, d).transpose(1, 2)
    qr, kr, vr = (split(t).detach().requires_grad_() for t in (q, k, v))

    def lib_step(backward: bool):
        # the forward in the same graph: autograd runs the backward on the
        # forward's stream, which has to be the capturing one
        out = torch.nn.functional.scaled_dot_product_attention(qr, kr, vr)
        return torch.autograd.grad(out, (qr, kr, vr), split(do)) \
            if backward else out

    # under grad SDPA's forward keeps its logsumexp (or, in MATH, P)
    lib_fwd_by = sdpa_ms(lambda: lib_step(False), 10)
    lib_step_by = sdpa_ms(lambda: lib_step(True), 10)
    lib_bwd_by = {n: lib_step_by[n] - lib_fwd_by[n] for n in lib_step_by
                  if n in lib_fwd_by}
    del qr, kr, vr
    lib_fwd_name, lib_fwd_ms = fastest(lib_fwd_by)
    lib_bwd_name, lib_bwd_ms = fastest(lib_bwd_by)
    einsum = {}
    if split_layout:
        sp = lambda t: t.view(b, t.shape[1], heads, d)
        qr, kr, vr = (sp(t).detach().requires_grad_() for t in (q, k, v))
        einsum["einsum_ms"] = cuda_ms(
            lambda: A.mha_einsum(sp(q), sp(k), sp(v)), 5)
        out_e = A.mha_einsum(qr, kr, vr)
        einsum["einsum_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
            out_e, (qr, kr, vr), sp(do), retain_graph=True), 5)
        del out_e, qr, kr, vr

    nq, nk = b * lq * c, b * lk * c
    rows_lse = b * heads * lq * 4  # one float32 per query and head
    work = {  # bytes: each input read once, each output written once
        fwd_kern: (2 * (2 * nq + 2 * nk) + rows_lse, 4 * b * lq * lk * c),
        names["dq"]: (2 * (3 * nq + 2 * nk) + 2 * rows_lse,
                      6 * b * lq * lk * c),
        names["dkv"]: (2 * (2 * nq + 4 * nk) + 2 * rows_lse,
                       8 * b * lq * lk * c),
    }
    runs = {
        fwd_kern: ({n: functools.partial(f, q, k, v, heads)
                    for n, f in fwds.items()},
                   lambda: fns["lse_plain"](q, k, v, heads), lib_fwd_ms),
        names["dq"]: (bwd_runs["dq"],
                      lambda: fns["bwd_dq_plain"](*bwd_args), lib_bwd_ms),
        names["dkv"]: (bwd_runs["dkv"],
                       lambda: fns["bwd_dkv_plain"](*bwd_args), lib_bwd_ms),
    }
    exp_floor_ms = b * heads * lq * lk / (
        H100_SMS * EXP_PER_CLOCK * clock_hz) * 1e3 if clock_hz else None
    out = {}
    for kern, (variants, plain, lib_ms) in runs.items():
        nbytes, flops = work[kern]
        bound_ms, bound_by = bound(nbytes, flops)
        times = {n: graph_ms(run) for n, run in variants.items()}
        # the row of kern is its own kernel's (the template where the sm90
        # kernel takes the shape), the sm90 row the sm90 kernel's
        own = [n for n in variants if n != "sm90"]
        errs = [c for n in own for c in checks[kern][n]]
        row = {
            "kernel": kern, "replaces": REPLACES[kern], "case": label,
            "shape": shape,
            "max_abs_err": max(e for _, e, _ in errs),
            "checks": {n: {"max_abs_err": e, "tol": t} for n, e, t in errs},
            "kernel_ms": times[own[0]],
            "plain_ms": cuda_ms(plain, 3),
            "library_ms": lib_ms, "library": (
                f"SDPA backward ({lib_bwd_name}), dq and dk/dv together"
                if "bwd" in kern else
                f"SDPA forward under grad ({lib_fwd_name})"),
            "library_ms_by_backend": lib_bwd_by if "bwd" in kern
            else lib_fwd_by,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "exp_floor_ms": exp_floor_ms, **einsum,
        }
        if len(times) > 1:
            row["kernel_ms_by_variant"] = times
        log(json.dumps(row))
        out[kern] = row
        gated = [(kern, errs)]
        if "sm90" in variants:
            sm90 = _sm90_kernel_of(kern)
            sm90_errs = checks[kern]["sm90"]
            out[sm90] = dict(
                row, kernel=sm90, wrapper=kern,
                max_abs_err=max(e for _, e, _ in sm90_errs),
                checks={n: {"max_abs_err": e, "tol": t}
                        for n, e, t in sm90_errs},
                kernel_ms=times["sm90"])
            log(json.dumps(out[sm90]))
            gated.append((sm90, sm90_errs))
        for name, errs in gated:
            for n, e, t in errs:
                if not (e <= t and math.isfinite(e)):
                    raise AssertionError(
                        f"{name} [{label}] {n} disagrees with its plain "
                        f"version: max abs err {e} > {t}")
    return out


def sm_clock_hz() -> float:
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``), for the
    exponential floor."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0]
    return float(mhz) * 1e6


def phase_kernels():
    from dualdiff_tpu_torch.ops import attention as A

    clock_hz = sm_clock_hz()
    log(f"# SM clock (max) {clock_hz / 1e6:.0f} MHz")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for case in train_kernel_cases():
        for kern, row in train_kernel_rows(A, g, *case,
                                           clock_hz=clock_hz).items():
            results.setdefault(kern, []).append(row)
        torch.cuda.empty_cache()
    for kern, label, b, lq, lk, c, heads, n_cam in kernel_cases():
        q = torch.randn(b, lq, c, generator=g, device="cuda").bfloat16()
        k = torch.randn(b, lk, c, generator=g, device="cuda").bfloat16()
        v = torch.randn(b, lk, c, generator=g, device="cuda").bfloat16()
        d = c // heads
        split = lambda t: t.view(b, t.shape[1], heads, d).transpose(1, 2)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(
            split(q), split(k), split(v))
        flops = 4 * b * lq * lk * c
        variants = {}  # label -> launch; the first is the one the path runs
        extra = {}  # further yardsticks
        stacked = None
        # in scope, the path's route is the sm90 kernel, timed beside the
        # template instance it replaces
        sm90_kern = _sm90_kernel_of(kern)
        sm90 = sm90_kern is not None and A.sm90_in_scope(d, True)
        if n_cam:
            ring = functools.partial(A.packed_attention_nbr_fwd, q, k, v,
                                     heads, n_cam)
            if sm90:
                variants["sm90"] = ring
                variants["template"] = functools.partial(ring,
                                                         route="template")
            else:
                variants[""] = ring
            plain = lambda: A.attention_packed_neighbors_plain(
                q, k, v, heads, n_cam)
            library = None  # no single PyTorch call computes the ring sum
            stacked = stacked_sdpa_call(q, k, v, heads, n_cam)
            flops *= 2
        elif kern == "flash_attention_fwd":
            fl = split_on_packed(A)
            if sm90:
                variants["sm90"] = lambda: fl["fwd"](q, k, v, heads)
                variants["template"] = lambda: fl["fwd"](q, k, v, heads,
                                                         route="template")
            else:
                variants[""] = lambda: fl["fwd"](q, k, v, heads)
            plain = lambda: fl["plain"](q, k, v, heads)
            extra["einsum_ms"] = cuda_ms(lambda: A.mha_einsum(
                *(t.view(b, t.shape[1], heads, d) for t in (q, k, v))), 5)
        elif kern == "packed_attention_capped_fwd":
            if sm90:
                variants["sm90"] = functools.partial(
                    A.packed_attention_capped_fwd, q, k, v, heads)
            for w in sorted((4, 8), key=lambda w: w != A.CAPPED_WARPS):
                variants[f"template {w} warps" if sm90 else f"{w} warps"] = \
                    functools.partial(A.packed_attention_capped_fwd, q, k, v,
                                      heads, warps=w, route="template")
            plain = lambda: A.attention_packed_capped_plain(q, k, v, heads)
        elif sm90:
            variants["sm90"] = lambda: A.packed_attention_fwd(q, k, v, heads)
            variants["template"] = lambda: A.packed_attention_fwd(
                q, k, v, heads, route="template")
            plain = lambda: A.attention_packed_plain(q, k, v, heads)
        else:
            variants[""] = lambda: A.packed_attention_fwd(q, k, v, heads)
            plain = lambda: A.attention_packed_plain(q, k, v, heads)
        want = plain()
        # bf16 output: one rounding of |o| <= max|v| is 2^-8 relative; the
        # kernel also rounds P to bf16 for the P.V product (2^-9 relative
        # per term, averaging out over the keys)
        tol = 2.0 ** -7 * want.float().abs().max().item() + 1e-3
        errs = {}
        for name, run in variants.items():
            got = run()
            torch.cuda.synchronize()
            errs[name] = (got.float() - want.float()).abs().max().item()
            del got
        if stacked is not None:
            # the yardstick's own error, recorded (it gates nothing)
            extra["stacked_sdpa_max_abs_err"] = _max_err(stacked(), want)
            by_backend = sdpa_ms(stacked)
            name, ms = fastest(by_backend)
            extra.update(stacked_sdpa_ms=ms,
                         stacked_sdpa=f"_nbr_stacked gather + SDPA ({name}) "
                                      f"+ sum of the halves",
                         stacked_sdpa_ms_by_backend=by_backend)
        del want
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        bound_ms, bound_by = bound(nbytes, flops)
        times = {name: graph_ms(run) for name, run in variants.items()}
        exp_floor_ms = b * heads * lq * lk * (2 if n_cam else 1) / (
            H100_SMS * EXP_PER_CLOCK * clock_hz) * 1e3
        # the row of kern is attention.cu's instance (the template one where
        # the sm90 kernel takes the shape), and the sm90 row is the sm90 one
        own = [n for n in variants if n != "sm90"]
        row = {
            "kernel": kern, "replaces": REPLACES[kern], "case": label,
            "shape": {
                "b": b, "lq": lq, "lk": lk, "c": c, "heads": heads,
                "head_dim": d, "n_cam": n_cam},
            "max_abs_err": max(errs[n] for n in own), "tol": tol,
            "kernel_ms": times[own[0]],
            "plain_ms": cuda_ms(plain, 3),
            **library_row(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "exp_floor_ms": exp_floor_ms, **extra,
        }
        if len(variants) > 1:
            row["kernel_ms_by_variant"] = times
            row["max_abs_err_by_variant"] = errs
        log(json.dumps(row))
        for name, err in errs.items():
            if not (err <= tol and math.isfinite(err)):
                raise AssertionError(
                    f"{kern} {name} [{label}] disagrees with its plain "
                    f"version: max abs err {err} > {tol}")
        results.setdefault(kern, []).append(row)
        if sm90:
            sm90_row = dict(row, kernel=sm90_kern, wrapper=kern,
                            replaces=SM90_REPLACES[kern],
                            kernel_ms=times["sm90"], max_abs_err=errs["sm90"])
            log(json.dumps(sm90_row))
            results.setdefault(sm90_kern, []).append(sm90_row)
        del q, k, v
        torch.cuda.empty_cache()
    return results


def _flagship(device, tiny=False, extra=(), weights_from=None,
              video=False, name=None):
    """(cfg, collated batch, pipeline) with seeded random weights, or the
    weights of the models in ``weights_from``; the flagship config, or
    ``name``.  The batch: B=2 synthetic samples; with ``video``, clip 0 of
    ``bench.py::main_video``'s seed-0 synthetic clips (``video.num_frames``
    frames), collated as it collates them."""
    import numpy as np

    from dualdiff_tpu_torch.data.collate import collate_fn
    from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes
    from dualdiff_tpu_torch.data.tokenizer import HashTokenizer
    from dualdiff_tpu_torch.data.video import (SyntheticNuScenesVideo,
                                               collate_video)
    from dualdiff_tpu_torch.pipeline.bev_controlnet import \
        BEVControlNetPipeline
    from dualdiff_tpu_torch.runner.factory import (build_models,
                                                   randomize_weights)
    from dualdiff_tpu_torch.utils.config import (FLAGSHIP, VIDEO_16F,
                                                 load_config)

    cfg = load_config(name or (VIDEO_16F if video else FLAGSHIP),
                      overrides=extra)
    h, w = cfg.dataset.image_size
    if video:
        clips = SyntheticNuScenesVideo(
            num_clips=2, num_frames=int(cfg.video.num_frames),
            image_size=(h, w))
        batch = collate_video([clips[0]], cfg, HashTokenizer(),
                              rng=np.random.default_rng(SEED))
    else:
        ds = SyntheticNuScenes(num_samples=B, image_size=(h, w),
                               seed=int(cfg.seed))
        batch = collate_fn([ds[i] for i in range(B)], cfg, HashTokenizer(),
                           is_train=False, rng=np.random.default_rng(SEED))
    models = build_models(cfg, tiny=tiny, device=device)
    names = ["unet", "vae", "text_encoder"]
    mods = [models[k] for k in names] + models["controlnets"]
    if weights_from is None:
        for m in mods:
            randomize_weights(m, SEED)
    else:
        src = [weights_from[k] for k in names] + weights_from["controlnets"]
        for m, m_src in zip(mods, src):
            m.load_state_dict(m_src.state_dict(), strict=True)
    return cfg, batch, BEVControlNetPipeline(cfg, models, device=device)


def phase_generate(profile_dir, name=None):
    """Image generation at full SD v1.5 width, B=2 x 6 views: the flagship
    (phase 4), or the config ``name`` (``occ_bg_fusionp`` in phase
    ``fusionp``).  One warm-up call, then timed calls, each checked for
    shape, finiteness, range and the kernels' launches per generation
    (``generate_launches_per_generation``)."""
    from dualdiff_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    cfg, batch, pipe = _flagship("cuda", name=name)
    torch.cuda.synchronize()
    log(f"# models built and cast in {time.perf_counter() - t0:.1f} s")
    steps = int(cfg.runner.pipeline_param.num_inference_steps)
    h, w = cfg.dataset.image_size
    lh, lw = h // 8, w // 8
    models = pipe.models
    fusionp = bool(cfg.model.controlnet.use_txt_con_fusionp)
    expect = generate_launches_per_generation(
        len(models["unet"].down_blocks[0].resnets), len(models["controlnets"]),
        steps, fusionp, lh * lw)
    gen = torch.Generator(device="cuda")
    times, counts = [], None
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + TIMED_GENERATIONS):
        gen.manual_seed(SEED + i)
        A.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(batch, generator=gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts(A)
        if _wrappers(counts) != expect:
            raise AssertionError(f"kernel launches {counts} != {expect}")
        check_sm90_launches(counts)
        if tuple(out.shape) != (B, N_CAM, h, w, 3):
            raise AssertionError(f"output shape {tuple(out.shape)}")
        if not torch.isfinite(out).all():
            raise AssertionError("non-finite output")
        if out.min().item() < 0.0 or out.max().item() > 1.0:
            raise AssertionError("output outside [0, 1]")
        log(f"# generation {i} ({'warm-up' if i == 0 else 'timed'}): "
            f"{dt:.3f} s, mean {out.mean().item():.4f}, "
            f"std {out.std().item():.4f}")
        if i:
            times.append(dt)
    s = sorted(times)[len(times) // 2]
    row = {"phase": "fusionp generate" if fusionp else "generate",
           "config": f"{cfg.task_id} {h}x{w}",
           "batch": B, "views": N_CAM, "steps": steps, "cfg_scale": float(
               cfg.runner.pipeline_param.guidance_scale),
           "latent_hw": [lh, lw], "s_per_generation": s,
           "s_per_generation_all": times, "samples_per_s": B / s,
           "images_per_s": B * N_CAM / s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches_per_generation": counts}
    log(json.dumps(row))
    if fusionp:
        log(f"fusionp s/generation: {s}")
        log(f"fusionp images/s: {B * N_CAM / s}")
    if profile_dir:
        gen.manual_seed(SEED)
        profile_run(lambda: pipe(batch, generator=gen), s, profile_dir,
                    "fusionp_generation" if fusionp else "generation")
    del pipe
    torch.cuda.empty_cache()
    return counts


_CATEGORIES = (  # kernel-name fragment -> category, first match wins
    ("attention_kernel", "attention kernels (csrc)"),
    ("bwd_dq_kernel", "attention kernels (csrc)"),
    ("bwd_dkv_kernel", "attention kernels (csrc)"),
    ("fprop", "convolution (cuDNN)"), ("dgrad", "convolution (cuDNN)"),
    ("wgrad", "convolution (cuDNN)"), ("conv", "convolution (cuDNN)"),
    ("gemm", "matmul (cuBLAS / CUTLASS)"), ("nvjet", "matmul (cuBLAS / CUTLASS)"),
    ("softmax", "softmax (einsum levels)"),
    ("layer_norm", "norm statistics"), ("reduce_kernel", "norm statistics"),
    ("copy", "copies and dtype casts"), ("elementwise", "elementwise"),
)


def profile_run(run, wall_unprofiled: float, out_dir: str,
                name: str) -> dict:
    """Device time of one ``run()`` by kernel and by category
    (torch.profiler), written to ``out_dir/profile_<name>.txt``; the idle
    share is taken against the unprofiled wall time, since the profiler
    itself slows the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    cats = {}
    for us, n, key in rows:
        cat = next((c for frag, c in _CATEGORIES if frag in key), "other")
        ms, cnt = cats.get(cat, (0.0, 0))
        cats[cat] = (ms + us / 1e3, cnt + n)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(f"profiled wall {wall:.3f} s, unprofiled wall "
                f"{wall_unprofiled:.3f} s, device busy {busy:.3f} s\n")
        for cat, (ms, n) in sorted(cats.items(), key=lambda x: -x[1][0]):
            f.write(f"{ms:10.2f} ms {n:7d}  [{cat}]\n")
        for us, n, key in rows[:40]:
            f.write(f"{us / 1e3:10.2f} ms {n:7d}  {key[:160]}\n")
    row = {"phase": f"profile {name}", "device_busy_s": busy,
           "wall_s": wall_unprofiled, "profiled_wall_s": wall,
           "idle_share": max(0.0, 1.0 - busy / wall_unprofiled),
           "by_category_ms": {c: v[0] for c, v in cats.items()},
           "kernels_by_category": {c: v[1] for c, v in cats.items()}}
    log(json.dumps(row))
    return row


def phase_reference(video=False, fusionp=False):
    """Tiny models, 256x128, 3 steps: bf16 on the card (kernels) against
    float32 on the CPU (plain versions), same weights and noise.  Mean
    absolute error on the [0, 1] images at most 1e-2: bf16 weights and
    activations through every layer and step (3.1e-3 measured on an
    H100 80GB HBM3 at 700 W).  ``video``: the tiny video model set on a
    2-frame clip (sequential CFG, VAE slicing 5 of its 12 images), the
    ``video_reference`` phase.  ``fusionp``: the tiny single-branch
    ``occ_bg_fusionp`` set at 224x400 (28x50 latents), so that SFA+ stage 2
    is 1400 x 1400 at d = 4 on ``flash_attention_fwd`` and the UNet's
    1400-token attention (d = 8) on the packed kernels; each of those must
    launch (phase ``fusionp_reference``)."""
    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.utils.config import FUSIONP

    extra = ["runner.pipeline_param.num_inference_steps=3"]
    if not fusionp:
        extra.append("dataset.image_size=[256, 128]")
    if video:
        extra += ["video.num_frames=2", "runner.pipeline_param.vae_slicing=5"]
    name = FUSIONP if fusionp else None
    _, batch, cpu_pipe = _flagship(
        "cpu", tiny=True, extra=extra + ["runner.mixed_precision=fp32"],
        video=video, name=name)
    cpu_models = cpu_pipe.models
    with torch.no_grad():
        # cam2token reads raw intrinsics (fx ~ 1266): a random kernel makes
        # the camera token ~400 and the cross-attention softmax one-hot,
        # where bf16 rounding alone flips the winner
        for cn in cpu_models["controlnets"]:
            cn.cam2token.weight.mul_(0.01)
    cfg, _, gpu_pipe = _flagship("cuda", tiny=True, extra=extra,
                                 weights_from=cpu_models, video=video,
                                 name=name)
    h, w = cfg.dataset.image_size
    rows = len(batch["camera_param"])  # samples, or frames of the clip
    lat = torch.randn((rows, 1, h // 8, w // 8, 4),
                      generator=torch.Generator().manual_seed(SEED))
    want = cpu_pipe(batch, latents=lat)
    A.reset_launch_counts()
    got = gpu_pipe(batch, latents=lat).cpu()
    err = (got - want).abs()
    phase = "fusionp_reference" if fusionp else "video_reference" if video \
        else "reference"
    row = {"phase": phase, "shape": list(got.shape),
           "max_abs_err": err.max().item(),
           "mean_abs_err": err.mean().item(), "tol_mean": 1e-2,
           "launches": launch_counts(A)}
    log(json.dumps(row))
    if not row["mean_abs_err"] <= row["tol_mean"]:
        raise AssertionError("bf16 generation on the card disagrees with the "
                             "float32 CPU reference")
    # the tiny SFA+ stage 2 (d = 4) is outside the sm90 kernel's scope
    check_sm90_launches(row["launches"], ("flash_attention_fwd",) if fusionp
                        else ())
    must = ("packed_attention_fwd", SM90, "packed_attention_nbr_fwd",
            SM90_NBR) + (("flash_attention_fwd",) if fusionp else ())
    if not all(row["launches"][k] > 0 for k in must):
        raise AssertionError(f"the kernels did not run: {row['launches']}")


def phase_video(profile_dir):
    """DualDiff+ clip generation at full width (phase 8): the ``video_16f``
    config with sequential CFG and VAE slicing 12, seeded random weights in
    bf16, clip 0 of ``SyntheticNuScenesVideo(num_clips=2, num_frames=16)``.
    One warm-up clip, then timed clips; each is checked for shape,
    finiteness, range and the kernels' launches per clip."""
    from dualdiff_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    cfg, batch, pipe = _flagship("cuda", video=True)
    torch.cuda.synchronize()
    log(f"# video models built and cast in {time.perf_counter() - t0:.1f} s")
    pp = cfg.runner.pipeline_param
    steps = int(pp.num_inference_steps)
    frames = int(cfg.video.num_frames)
    h, w = cfg.dataset.image_size
    expect = video_launches_per_clip(
        len(pipe.models["unet"].down_blocks[0].resnets),
        len(pipe.models["controlnets"]), steps, bool(pp.sequential_cfg),
        (h // 8) * (w // 8))
    gen = torch.Generator(device="cuda")
    times, counts = [], None
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + TIMED_CLIPS):
        gen.manual_seed(SEED + i)
        A.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe(batch, generator=gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts(A)
        if _wrappers(counts) != expect:
            raise AssertionError(f"kernel launches {counts} != {expect}")
        check_sm90_launches(counts)
        if tuple(out.shape) != (frames, N_CAM, h, w, 3):
            raise AssertionError(f"output shape {tuple(out.shape)}")
        if not torch.isfinite(out).all():
            raise AssertionError("non-finite output")
        if out.min().item() < 0.0 or out.max().item() > 1.0:
            raise AssertionError("output outside [0, 1]")
        log(f"# clip {i} ({'warm-up' if i == 0 else 'timed'}): {dt:.3f} s, "
            f"mean {out.mean().item():.4f}, std {out.std().item():.4f}")
        if i:
            times.append(dt)
    s = sorted(times)[len(times) // 2]
    row = {"phase": "video", "config": "video_16f 224x400",
           "frames": frames, "views": N_CAM, "steps": steps,
           "cfg_scale": float(pp.guidance_scale),
           "sequential_cfg": bool(pp.sequential_cfg),
           "vae_slicing": int(pp.vae_slicing), "s_per_clip": s,
           "s_per_clip_all": times, "frames_per_s": frames / s,
           "images_per_s": frames * N_CAM / s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches_per_clip": counts}
    log(json.dumps(row))
    log(f"s/clip: {s}")
    log(f"frames/s: {frames / s}")
    log(f"images/s: {frames * N_CAM / s}")
    if profile_dir:
        gen.manual_seed(SEED)
        profile_run(lambda: pipe(batch, generator=gen), s, profile_dir,
                    "video_clip")
    del pipe
    torch.cuda.empty_cache()
    return counts


def _train_batch(cfg, n: int):
    """Seeded synthetic training dataset of ``n`` samples at the config's
    image size."""
    from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes

    h, w = cfg.dataset.image_size
    return SyntheticNuScenes(num_samples=n, image_size=(h, w),
                             seed=int(cfg.seed))


def phase_train(profile_dir, name=None):
    """The flagship training step (or that of the config ``name``:
    ``occ_bg_fusionp`` in phase ``fusionp``) at full SD v1.5 width: seeded
    random weights, B = 1 x 6 views, bf16, remat on, AdamW with a bf16
    first moment and the warmup-cosine schedule; one warm-up step, then
    timed steps.  Checks finite loss and grad_norm > 0 every step, the kernels'
    launches per step, and that the trainables (float32 master copies)
    moved while every frozen parameter stayed as it was.  The learning rate
    of step 0 is exactly 0 (warmup from 0), so the comparison starts after
    step 1."""
    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.runner.factory import (build_models,
                                                   randomize_weights)
    from dualdiff_tpu_torch.runner.trainer import MultiviewTrainer
    from dualdiff_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    cfg = load_config(name) if name else load_config()
    models = build_models(cfg, device="cuda")
    for m in (models["unet"], models["vae"], models["text_encoder"],
              *models["controlnets"]):
        randomize_weights(m, SEED)
    n_steps = 1 + TIMED_TRAIN_STEPS
    trainer = MultiviewTrainer(cfg, _train_batch(cfg, n_steps + 2),
                               models=models)
    torch.cuda.synchronize()
    log(f"# training models built and cast in {time.perf_counter() - t0:.1f}"
        f" s; {sum(p.numel() for p in trainer.trainable.values()) / 1e6:.1f}"
        f"M trainable, "
        f"{sum(p.numel() for p in trainer.frozen.values()) / 1e6:.1f}M "
        f"frozen parameters")
    layers = len(models["unet"].down_blocks[0].resnets)
    h, w = cfg.dataset.image_size
    fusionp = bool(cfg.model.controlnet.use_txt_con_fusionp)
    expect = train_launches_per_step(
        layers, len(models["controlnets"]),
        bool(cfg.runner.enable_unet_checkpointing)
        and bool(cfg.runner.enable_controlnet_checkpointing), fusionp,
        (h // 8) * (w // 8))
    steps, snap = [], {}
    run_counts = dict.fromkeys(launch_counts(A), 0)

    def on_metrics(step, m):
        counts = launch_counts(A)
        A.reset_launch_counts()
        for k, v in counts.items():
            run_counts[k] += v
        log(f"# train step {step}: " + ", ".join(
            f"{k} {m[k]:.6f}" for k in ("loss", "mse", "aug_loss",
                                        "grad_norm") if k in m)
            + f", {m['step_time_s']:.3f} s (batch assembly "
            f"{m['data_time_s']:.3f} s)")
        if _wrappers(counts) != expect:
            raise AssertionError(f"kernel launches {counts} != {expect}")
        check_sm90_launches(counts)
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            raise AssertionError(f"step {step}: loss {m['loss']}, grad_norm "
                                 f"{m['grad_norm']}")
        steps.append(dict(m, step=step))
        if step == 1:  # snapshot after the lr = 0 step, on the host
            snap["frozen"] = {k: p.detach().to("cpu", copy=True)
                              for k, p in trainer.frozen.items()}
            snap["master"] = {k: v.to("cpu", copy=True)
                              for k, v in trainer.optimizer.master.items()}
            torch.cuda.reset_peak_memory_stats()

    A.reset_launch_counts()
    trainer.run(n_steps, on_metrics)
    if len(steps) != n_steps:
        raise AssertionError(f"{len(steps)} steps ran, not {n_steps}")
    frozen_changed = [k for k, p in trainer.frozen.items()
                      if not torch.equal(p.detach().cpu(), snap["frozen"][k])]
    opt = trainer.optimizer
    # warmup lr is peak * step / 3000, about 1e-8 per step: an element moves
    # only where that exceeds half a float32 ulp, which holds below 0.25 in
    # magnitude (ulp <= 3e-8) but not for norm scales near 1.  So every
    # trainable that got a gradient and holds a value below 0.25 must move.
    got_grad = {k for k, v in opt.nu.items() if bool(v.any())}
    must_move = {k for k in got_grad
                 if bool((snap["master"][k].abs() < 0.25).any())}
    moved = {k for k, v in opt.master.items()
             if not torch.equal(v.cpu(), snap["master"][k])}
    times = [m["step_time_s"] for m in steps[1:]]
    s = sorted(times)[len(times) // 2]
    data = sorted(m["data_time_s"] for m in steps[1:])[len(times) // 2]
    row = {"phase": "fusionp train" if fusionp else "train",
           "config": f"{cfg.task_id} {h}x{w}",
           "batch": B_TRAIN, "views": N_CAM, "steps": n_steps,
           "s_per_step": s, "s_per_step_all": times,
           "batch_assembly_s": data,
           "images_per_s": B_TRAIN * N_CAM / s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "loss": [m["loss"] for m in steps],
           "grad_norm": [m["grad_norm"] for m in steps],
           "trainable_tensors": len(opt.master),
           "trainable_tensors_with_grad": len(got_grad),
           "trainable_tensors_moved": len(moved),
           "trainable_tensors_required_to_move": len(must_move),
           "trainable_tensors_without_grad": sorted(set(opt.master)
                                                    - got_grad),
           "frozen_tensors_changed": len(frozen_changed),
           "launches_per_step": expect, "launches_run": run_counts}
    log(json.dumps(row))
    if fusionp:
        log(f"fusionp s/step: {s}")
        log(f"fusionp train images/s: {B_TRAIN * N_CAM / s}")
    if frozen_changed:
        raise AssertionError(f"frozen parameters changed: "
                             f"{frozen_changed[:5]}")
    if must_move - moved:
        raise AssertionError(f"trainables that did not move: "
                             f"{sorted(must_move - moved)[:5]}")
    # a few trainables see a gradient only in some steps (the learned
    # uncond camera only when the CFG switch drops a sample); 844 of 844
    # did in the flagship's seeded run on an H100 80GB HBM3 at 700 W
    if len(got_grad) < 0.9 * len(opt.master):
        raise AssertionError(f"only {len(got_grad)} of {len(opt.master)} "
                             "trainable tensors got a gradient")
    if profile_dir:
        batch = trainer._build_batch(next(trainer._batch_plan(0)))
        profile_run(lambda: trainer.train_step(batch), s, profile_dir,
                    "fusionp_train_step" if fusionp else "train_step")
    del trainer, models, snap
    torch.cuda.empty_cache()
    return run_counts, expect


def _trainable_grads(models) -> dict:
    """{"root/name": float32 gradient on the host, or None} of every
    trainable leaf."""
    from dualdiff_tpu_torch.runner.train_state import named_roots

    return {f"{root}/{n}": None if p.grad is None else p.grad.float().cpu()
            for root, m in named_roots(models)
            for n, p in m.named_parameters() if p.requires_grad}


def leaf_grad_errors(want: dict, got: dict) -> dict:
    """Per trainable leaf, ``||got - want|| / (||want|| + floor)``, with
    ``floor = LEAF_FLOOR * max ||want||`` over the leaves of the leaf's
    network.  The floor covers leaves whose exact gradient is zero (a conv
    bias before a GroupNorm of one channel per group cancels), where both
    sides hold rounding noise.  A leaf that is trainable, or has a
    gradient, on one side only reads inf."""
    top = {}
    for k, w in want.items():
        r = k.split("/")[0]
        top[r] = max(top.get(r, 0.0), 0.0 if w is None else w.norm().item())
    out = {}
    for k in sorted(set(want) | set(got)):
        w, g = want.get(k), got.get(k)
        if w is None and g is None and k in want and k in got:
            out[k] = 0.0  # no gradient on either side this run
        elif w is None or g is None:
            out[k] = math.inf
        else:
            den = w.norm().item() + LEAF_FLOOR * top[k.split("/")[0]]
            diff = (g - w).norm().item()
            out[k] = diff / den if den > 0 else (math.inf if diff else 0.0)
    return out


def train_reference_readings(device: str = "cuda", video: bool = False,
                             fusionp: bool = False) -> dict:
    """One tiny loss + gradient on ``device`` in bf16 and on the CPU in
    float32: the loss of each, and each trainable leaf's relative gradient
    error (``leaf_grad_errors``).  ``video``: the tiny RGD stage-2 model
    set (LoRA on the UNet's attn1 / attn2, the reward through the VAE
    decode) on clip 0 of 2-frame synthetic clips, with ``T_SCORE_CAP``
    lowered to 2^18 meanwhile, so that the tiny ST-Attn (512 queries x
    1024 keys) takes the capped route as the full-width one (1400 x 2800)
    does, while the 512 x 512 self-attention stays under the cap.
    ``fusionp``: the tiny single-branch ``occ_bg_fusionp`` set, with
    ``FLASH_MIN_LEN`` lowered to its 512-token condition map meanwhile, so
    that SFA+ stage 2 (512 x 512, d = 4) trains through ``FlashAttention``
    as the 1400 x 1400 one does at 224x400, and the conditioning embedder's
    output scaled by ``SFA_COND_SCALE``.  At 224x400 itself the gate does
    not hold, for the flagship either: leaves whose gradient sums over all
    8400 latent positions in bf16 (the ControlNets' first
    ``time_emb_proj``, SFA+'s projections) read over ``LEAF_TOL``
    (``tests/test_torch_grad_gate_cuda.py::test_gate_readings_at_224x400``
    prints the readings)."""
    import numpy as np

    from dualdiff_tpu_torch.data.collate import collate_fn
    from dualdiff_tpu_torch.data.tokenizer import HashTokenizer
    from dualdiff_tpu_torch.data.video import (SyntheticNuScenesVideo,
                                               collate_video)
    from dualdiff_tpu_torch.diffusion.schedule import DiffusionSchedule
    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.runner.conds import prepare_batch
    from dualdiff_tpu_torch.runner.factory import (build_models,
                                                   randomize_weights)
    from dualdiff_tpu_torch.runner.rewards import make_rgd_reward
    from dualdiff_tpu_torch.runner.train_state import (named_roots,
                                                       partition_params,
                                                       trainable_predicate)
    from dualdiff_tpu_torch.runner.trainer import make_draws, make_loss_fn
    from dualdiff_tpu_torch.utils.config import (FLAGSHIP, FUSIONP,
                                                 RGD_STAGE2, load_config)

    name = RGD_STAGE2 if video else FUSIONP if fusionp else FLAGSHIP
    extra = ["dataset.image_size=[256, 128]"]
    frames = TRAIN_FRAMES if video else 1
    if video:
        extra.append(f"video.num_frames={frames}")
    cap, flash_min = A.T_SCORE_CAP, A.FLASH_MIN_LEN
    if video:
        A.T_SCORE_CAP = 2 ** 18
    if fusionp:
        A.FLASH_MIN_LEN = 512
    results = []  # (loss, grads by leaf, launches): CPU, then the device
    cpu_models = None
    try:
        for dev, cfg in (("cpu", load_config(
                name, extra + ["runner.mixed_precision=fp32"])),
                (device, load_config(name, extra))):
            models = build_models(cfg, tiny=True, device=dev)
            for root, m in named_roots(models):
                if cpu_models is None:
                    randomize_weights(m, SEED)
                else:
                    m.load_state_dict(dict(named_roots(cpu_models))[root]
                                      .state_dict(), strict=True)
                m.to(dev, models["dtype"])
            if cpu_models is None:
                with torch.no_grad():  # see phase_reference
                    for cn in models["controlnets"]:
                        cn.cam2token.weight.mul_(0.01)
                        if fusionp:  # see SFA_COND_SCALE
                            conv = cn.controlnet_cond_embedding.conv_out
                            conv.weight.mul_(SFA_COND_SCALE)
                            conv.bias.mul_(SFA_COND_SCALE)
                    for n, p in models["unet"].named_parameters():
                        if "lora_b" in n:
                            p.mul_(LORA_B_SCALE)
                cpu_models = models
            partition_params(models, trainable_predicate(
                str(cfg.model.unet.trainable_state)))
            h, w = cfg.dataset.image_size
            rng = np.random.default_rng(SEED)
            if video:
                clips = SyntheticNuScenesVideo(num_clips=2, num_frames=frames,
                                               image_size=(h, w))
                collated = collate_video([clips[0]], cfg, HashTokenizer(),
                                         rng=rng)
            else:
                collated = collate_fn([_train_batch(cfg, 1)[0]], cfg,
                                      HashTokenizer(), rng=rng)
            batch = prepare_batch(collated, dev)
            draws = make_draws(torch.Generator().manual_seed(SEED), cfg,
                               frames, N_CAM, (h // 8, w // 8), 1000,
                               frames=frames)
            draws = {k: None if v is None else v.to(dev)
                     for k, v in draws.items()}
            reward = dict(reward_fn=make_rgd_reward(cfg), reward_weight=float(
                cfg.video.rgd.reward_weight)) if video else {}
            A.reset_launch_counts()
            loss, _ = make_loss_fn(models, cfg, DiffusionSchedule.create(),
                                   (h // 8, w // 8),
                                   tuple(cfg.model.get("ors_frame_hw")),
                                   frames=frames, **reward)(batch, draws)
            loss.backward()
            results.append((loss.detach().item(), _trainable_grads(models),
                            launch_counts(A)))
    finally:
        A.T_SCORE_CAP, A.FLASH_MIN_LEN = cap, flash_min
    (loss_cpu, g_cpu, _), (loss_gpu, g_gpu, launches) = results
    errs = leaf_grad_errors(g_cpu, g_gpu)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    phase = "video_train_reference" if video else \
        "fusionp_train_reference" if fusionp else "train_reference"
    return {"phase": phase,
            "loss_cpu_f32": loss_cpu, "loss_gpu_bf16": loss_gpu,
            "loss_rel_err": abs(loss_gpu - loss_cpu) / abs(loss_cpu),
            "trainable_leaves": len(errs),
            "leaves_without_grad": sum(g_cpu.get(k) is None for k in errs),
            "worst_leaf_rel_err": dict(worst[:5]), "launches": launches,
            "tol": {"loss_rel_err": LOSS_REL_TOL, "leaf_rel_err": LEAF_TOL,
                    "leaf_floor": LEAF_FLOOR}, "leaf_rel_err": errs}


def _reference_gate(row: dict, kernels, out_of_scope=()) -> None:
    """The loss within ``LOSS_REL_TOL`` relative, every trainable leaf's
    gradient within ``LEAF_TOL``, each of ``kernels`` launched and every
    in-scope call of an sm90-routed wrapper (all but ``out_of_scope``'s)
    on its sm90 kernel."""
    errs = row.pop("leaf_rel_err")
    log(json.dumps(row))
    if not row["loss_rel_err"] <= LOSS_REL_TOL:
        raise AssertionError("bf16 loss on the card disagrees with float32")
    bad = [(k, e) for k, e in errs.items() if not e <= LEAF_TOL]
    if bad:
        raise AssertionError(f"bf16 gradients on the card disagree at "
                             f"{len(bad)} leaves: {bad[:5]}")
    if not all(row["launches"][k] > 0 for k in kernels):
        raise AssertionError(f"the training kernels did not run: "
                             f"{row['launches']}")
    check_sm90_launches(row["launches"], out_of_scope)


def phase_train_reference():
    """Tiny models at 256x128 (a 512-token top level, so the training
    kernels run): one loss + gradient on the card in bf16 against the same
    weights on the CPU in float32 (plain versions), with the same batch and
    the same injected draws.  The loss within ``LOSS_REL_TOL`` relative,
    and every trainable leaf's gradient within ``LEAF_TOL``
    (``leaf_grad_errors``): a limit that one attention call's dq or dk/dv
    spoiled exceeds while the sound run stays under it (see the limits'
    readings at the top)."""
    _reference_gate(train_reference_readings(), (
        "packed_attention_lse_fwd", "packed_attention_bwd_dq",
        "packed_attention_bwd_dkv", SM90_LSE, SM90_DQ, SM90_DKV))


def phase_fusionp(profile_dir):
    """SFA+ (``occ_bg_fusionp``: one ControlNet on the occupancy image with
    per-view boxes and two-stage SFA+) at full SD v1.5 width and 224x400:
    phase 4's generation and phase 6's training step on its config, each
    with its own derived launch counts (SFA+ stage 2 on
    ``flash_attention_fwd`` once per generation, on ``FlashAttention`` once
    per step)."""
    from dualdiff_tpu_torch.utils.config import FUSIONP

    counts = {"fusionp": timed("fusionp generate", phase_generate,
                               profile_dir, FUSIONP)}
    counts["fusionp_train"], per_step = timed("fusionp train", phase_train,
                                              profile_dir, FUSIONP)
    return counts, per_step


def phase_fusionp_reference():
    """The tiny ``occ_bg_fusionp`` set with SFA+ stage 2 at d = 4 on the
    split-layout kernels: phase 5's generation gate at 224x400 (1400 x
    1400) and phase 7's training gate, the SFA+ leaves included, at 256x128
    with ``FLASH_MIN_LEN`` lowered to 512 (``train_reference_readings``)."""
    phase_reference(fusionp=True)
    # the tiny SFA+ stage 2 (d = 4) is outside the sm90 kernels' scope
    _reference_gate(train_reference_readings(fusionp=True), (
        "flash_attention_lse_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv", "packed_attention_lse_fwd", SM90_LSE,
        SM90_DQ, SM90_DKV), ("flash_attention_lse_fwd",
                             "flash_attention_bwd_dq",
                             "flash_attention_bwd_dkv"))


def phase_video_train(profile_dir):
    """DualDiff+ video training at full SD v1.5 width (phase 10): stage 1
    (``video_16f``) and stage 2 (``rgd_stage2``), each with
    ``video.num_frames=2``, seeded random weights (every leaf, LoRA B and
    the zero-init connectors included), bf16, remat, AdamW."""
    from dualdiff_tpu_torch.utils.config import RGD_STAGE2, VIDEO_16F

    counts, per_step = {}, {}
    for stage, name in (("stage1", VIDEO_16F), ("stage2", RGD_STAGE2)):
        counts[stage], per_step[stage] = _video_train_stage(stage, name,
                                                            profile_dir)
    return counts, per_step


def _video_train_stage(stage: str, name: str, profile_dir):
    """One stage of phase 10 on clip 0 of ``SyntheticNuScenesVideo(
    num_clips=2, num_frames=2)``, collated as the trainer collates it: one
    warm-up step (learning rate exactly 0), then timed steps.  Checks every
    step's launches against ``video_train_launches_per_step``, a finite
    loss, grad_norm (> 0) and reward (stage 2); that stage 2 trains exactly
    the UNet's LoRA leaves; that the trainables moved and the frozen
    parameters did not."""
    from dualdiff_tpu_torch.data.video import SyntheticNuScenesVideo
    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.runner.factory import (build_models,
                                                   randomize_weights)
    from dualdiff_tpu_torch.runner.train_state import named_roots
    from dualdiff_tpu_torch.runner.video_trainer import VideoTrainer
    from dualdiff_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    cfg = load_config(name, [f"video.num_frames={TRAIN_FRAMES}"])
    h, w = cfg.dataset.image_size
    models = build_models(cfg, device="cuda")
    for _, m in named_roots(models):
        randomize_weights(m, SEED)
    clips = SyntheticNuScenesVideo(num_clips=2, num_frames=TRAIN_FRAMES,
                                   image_size=(h, w))
    trainer = VideoTrainer(cfg, clips, models=models)
    batch = trainer._build_batch((0, 0, [0]))
    lora = bool(cfg.video.rgd.enable)
    trainable = trainer.trainable
    if lora:
        unet_lora = {f"unet/{n}" for n, _ in models["unet"].named_parameters()
                     if "lora" in n}
        if set(trainable) != unet_lora or not unet_lora:
            raise AssertionError(f"stage 2 trains {len(trainable)} tensors, "
                                 f"not the {len(unet_lora)} LoRA leaves")
    expect = video_train_launches_per_step(
        len(models["unet"].down_blocks[0].resnets), len(models["controlnets"]),
        bool(cfg.runner.enable_unet_checkpointing)
        and bool(cfg.runner.enable_controlnet_checkpointing), lora,
        (h // 8) * (w // 8))
    torch.cuda.synchronize()
    log(f"# video training {stage} built in {time.perf_counter() - t0:.1f} "
        f"s; {sum(p.numel() for p in trainable.values()) / 1e6:.2f}M "
        f"trainable, {sum(p.numel() for p in trainer.frozen.values()) / 1e6:.1f}"
        f"M frozen parameters")
    frozen0 = {k: p.detach().clone() for k, p in trainer.frozen.items()}
    steps, snap = [], {}
    run_counts = dict.fromkeys(launch_counts(A), 0)
    for i in range(1 + TIMED_VIDEO_TRAIN_STEPS):
        A.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)  # the metrics' float() synchronises
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = launch_counts(A)
        for k, v in counts.items():
            run_counts[k] += v
        log(f"# video train {stage} step {i} "
            f"({'warm-up' if i == 0 else 'timed'}): "
            + ", ".join(f"{k} {v:.6f}" for k, v in m.items())
            + f", {dt:.3f} s")
        if _wrappers(counts) != expect:
            raise AssertionError(f"kernel launches {counts} != {expect}")
        check_sm90_launches(counts)
        finite = [m["loss"], m["grad_norm"]] + ([m["reward"]] if lora else [])
        if not (all(map(math.isfinite, finite)) and m["grad_norm"] > 0):
            raise AssertionError(f"{stage} step {i}: {m}")
        steps.append(dict(m, s=dt))
        if i == 0:  # after the lr = 0 step
            snap = {k: v.clone() for k, v in trainer.optimizer.master.items()}
            torch.cuda.reset_peak_memory_stats()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    frozen_changed = [k for k, p in trainer.frozen.items()
                      if not torch.equal(p, frozen0[k])]
    opt = trainer.optimizer
    # see phase_train: a trainable with a gradient and a value under 0.25
    # must move at the warmup learning rate
    got_grad = {k for k, v in opt.nu.items() if bool(v.any())}
    must_move = {k for k in got_grad if bool((snap[k].abs() < 0.25).any())}
    moved = {k for k, v in opt.master.items() if not torch.equal(v, snap[k])}
    times = [st["s"] for st in steps[1:]]
    s = sorted(times)[len(times) // 2]
    rows = TRAIN_FRAMES * N_CAM
    row = {"phase": "video_train", "stage": stage, "config":
           f"{cfg.task_id} 224x400, video.num_frames={TRAIN_FRAMES}",
           "frames": TRAIN_FRAMES, "views": N_CAM,
           "steps": 1 + TIMED_VIDEO_TRAIN_STEPS, "s_per_step": s,
           "s_per_step_all": times, "warmup_s": steps[0]["s"],
           "images_per_s": rows / s, "peak_mem_gib": peak,
           **{k: [st[k] for st in steps] for k in steps[0]
              if k in ("loss", "mse", "aug_loss", "reward", "grad_norm")},
           "trainable_tensors": len(opt.master),
           "trainable_params": sum(p.numel() for p in trainable.values()),
           "trainable_tensors_with_grad": len(got_grad),
           "trainable_tensors_moved": len(moved),
           "trainable_tensors_required_to_move": len(must_move),
           "frozen_tensors_changed": len(frozen_changed),
           "launches_per_step": expect, "launches_run": run_counts}
    log(json.dumps(row))
    log(f"video train {stage} s/step: {s}")
    log(f"video train {stage} images/s: {rows / s}")
    if frozen_changed:
        raise AssertionError(f"frozen parameters changed: "
                             f"{frozen_changed[:5]}")
    if must_move - moved:
        raise AssertionError(f"trainables that did not move: "
                             f"{sorted(must_move - moved)[:5]}")
    if len(got_grad) < 0.9 * len(opt.master):
        raise AssertionError(f"only {len(got_grad)} of {len(opt.master)} "
                             "trainable tensors got a gradient")
    if profile_dir:
        profile_run(lambda: trainer.train_step(batch), s, profile_dir,
                    "video_train_step" + ("_rgd" if lora else ""))
    del trainer, models, frozen0, snap, opt
    torch.cuda.empty_cache()
    return run_counts, expect


def phase_video_train_reference():
    """Phase 7's gate on the tiny RGD stage-2 model set (2-frame clip,
    LoRA, reward through the VAE decode), with ST-Attn on the capped
    training route (``train_reference_readings(video=True)``)."""
    _reference_gate(train_reference_readings(video=True), (
        "packed_attention_capped_lse_fwd", "packed_attention_lse_fwd",
        "packed_attention_bwd_dq", "packed_attention_bwd_dkv", SM90_LSE,
        SM90_DQ, SM90_DKV))


# the path each kernel serves, whose launches the kernels line reports
KERNEL_PATH = {"packed_attention_fwd": "generate",
               "packed_attention_nbr_fwd": "generate",
               "packed_attention_lse_fwd": "train",
               "packed_attention_bwd_dq": "train",
               "packed_attention_bwd_dkv": "train",
               "packed_attention_capped_fwd": "video",
               "packed_attention_capped_lse_fwd": "video_train",
               "flash_attention_fwd": "fusionp",
               "flash_attention_lse_fwd": "fusionp_train",
               "flash_attention_bwd_dq": "fusionp_train",
               "flash_attention_bwd_dkv": "fusionp_train"}


def kernels_line(results, path_counts, train_per_step, video_per_step,
                 fusionp_per_step):
    """One entry per kernel: its main-path shape's times and the launches
    of the path it serves, with their unit: one generation for the flagship
    inference kernels, one clip for the capped kernel, the whole training
    run for the training kernels, both stages' video training runs for the
    capped training forward (whose counts per step, checked on every step,
    are beside them), one ``occ_bg_fusionp`` generation for the split-layout
    forward and its training run for the split-layout training kernels.

    Each sm90 kernel (the forward, the forward with lse and the
    backward's two) has one entry per TPU kernel it replaces, named
    ``<sm90 kernel>:<wrapper>``: the launches of that wrapper on its path,
    all of which took the sm90 kernel (``check_sm90_launches`` held
    there), and its times at that wrapper's main-path shape.  Those
    wrappers' own entries are the template instances of ``attention.cu``
    and ``attention_train.cu``:
    their times are the template's at the same shapes, and their launches
    the template's on the path, none at 224x400."""
    units = {"generate": "generation",
             "train": f"training run of {1 + TIMED_TRAIN_STEPS} steps",
             "video": "clip",
             "video_train": f"video training runs of "
                            f"{1 + TIMED_VIDEO_TRAIN_STEPS} steps, stage 1 "
                            f"and stage 2",
             "fusionp": "occ_bg_fusionp generation",
             "fusionp_train": f"occ_bg_fusionp training run of "
                              f"{1 + TIMED_TRAIN_STEPS} steps"}
    counts = dict(path_counts)
    stages = counts.pop("video_train")
    counts["video_train"] = {k: sum(c[k] for c in stages.values())
                             for k in next(iter(stages.values()))}
    for c in counts.values():
        check_sm90_launches(c)

    def entry(name, source, replaces, rows, path, launches_of):
        main = rows[0]  # the dominant main-path shape
        e = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches_of(counts[path]),
            "launches_per": units[path],
            "launches_by_path": {units[p]: launches_of(c)
                                 for p, c in counts.items()},
            "launches_per_train_step": launches_of(train_per_step),
            "launches_per_video_train_step": {
                st: launches_of(c) for st, c in video_per_step.items()},
            "launches_per_fusionp_train_step": launches_of(fusionp_per_step),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
        }
        if "kernel_ms_by_variant" in main:
            e["ms_by_variant"] = main["kernel_ms_by_variant"]
        for key in ("stacked_sdpa_ms", "stacked_sdpa"):  # the ring's
            if key in main:
                e[key] = main[key]
        return e

    out = []
    for kern, rows in results.items():
        if kern in SM90_ROUTES:
            continue
        path = KERNEL_PATH[kern]
        calls = lambda c, kern=kern: c[kern]  # noqa: E731
        sm90 = _sm90_kernel_of(kern)
        if sm90 is None:
            out.append(entry(kern, SOURCE[kern], REPLACES[kern], rows, path,
                             calls))
            continue
        # every call of the wrapper took the sm90 kernel
        out.append(entry(kern, SOURCE[kern], REPLACES[kern], rows, path,
                         lambda c: 0))
        out[-1]["routed_to"] = f"{sm90}:{kern}"
        out.append(entry(f"{sm90}:{kern}", SM90_ROUTES[sm90][1],
                         SM90_REPLACES[kern],
                         [r for r in results[sm90] if r["wrapper"] == kern],
                         path, calls))
        out[-1]["sm90_launches_by_path"] = {units[p]: c[sm90]
                                            for p, c in counts.items()}
    return {"kernels": out}


def main() -> int:
    args = sys.argv[1:]
    profile_dir = args[args.index("--profile") + 1] \
        if "--profile" in args else None
    t_start = time.perf_counter()
    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    timed("build", phase_build)
    results = timed("kernels", phase_kernels)
    # what phase 3 leaves allocated sits under every later phase's peak
    log(f"# allocated after phase 3: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    counts = {"generate": timed("generate", phase_generate, profile_dir)}
    timed("reference", phase_reference)
    counts["train"], train_per_step = timed("train", phase_train,
                                            profile_dir)
    timed("train_reference", phase_train_reference)
    counts["video"] = timed("video", phase_video, profile_dir)
    timed("video_reference", phase_reference, video=True)
    counts["video_train"], video_per_step = timed(
        "video_train", phase_video_train, profile_dir)
    timed("video_train_reference", phase_video_train_reference)
    fusionp_counts, fusionp_per_step = timed("fusionp", phase_fusionp,
                                             profile_dir)
    counts.update(fusionp_counts)
    timed("fusionp_reference", phase_fusionp_reference)
    log(f"# all phases: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line(results, counts, train_per_step,
                                  video_per_step, fusionp_per_step)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
