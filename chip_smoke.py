#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``dualdiff_tpu_torch``) on one card.

    python3 chip_smoke.py                # the default run; one CUDA card
    python3 chip_smoke.py --profile DIR  # also writes kernel-time
                                         # breakdowns of one generation, one
                                         # training step, one clip, one
                                         # video training step of each stage
                                         # and one occ_bg_fusionp and HD
                                         # generation and training step to
                                         # DIR/profile_generation.txt,
                                         # DIR/profile_train_step.txt,
                                         # DIR/profile_video_clip.txt,
                                         # DIR/profile_video_train_step.txt,
                                         # ..._video_train_step_rgd.txt,
                                         # DIR/profile_fusionp_generation.txt,
                                         # ..._fusionp_train_step.txt, the
                                         # variants' (profile_baseline_...,
                                         # profile_occ_bg_adapter_..., ...) and
                                         # DIR/profile_hd_<h>x<w>_generation
                                         # .txt, ..._train_step.txt

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
            ``mha_einsum``'s time beside them; HD's shapes (the top level
            at 2816 and 5184 tokens, the second at d = 80), the plain
            versions there on slices of rows (``by_rows``).  Kernel and
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
14. variants  the shipped exp variants at full SD v1.5 width (``VARIANTS``):
            the ``+exp=224x400`` baseline (one ControlNet on the BEV map),
            ``occ_bg_adapter`` (the box adapter), ``occ_bg_camtemb_fusion``
            (the camera token in the time embedding) and ``occ_bg_tone``
            (tone guidance): phase 4's generation (not for tone guidance)
            and phase 6's training step on each, with launches derived for
            one ControlNet, every call on the sm90 kernels, the
            generations' kernel FLOPs equal to ``generate_kernel_flops``,
            the adapter's projections copied from their base ones at init
            and moved by the steps, and tone guidance's ``tone`` above 0.
            Alone: ``python3 -c "import chip_smoke as s; s.phase_device();
            s.phase_build(); s.phase_variants(None)"``.
15. variants_reference  phase 5's gate on the tiny ``+exp=224x400`` set and
            phase 7's on the tiny ``occ_bg`` set with the box adapter, the
            camera token in the time embedding and tone guidance on.
16. options the pipeline's generation options and attn4's other forms at
            full SD v1.5 width: on the flagship's models DDIM-20, the
            ControlNet cache at k = 2 and 3, a per-call override (10 steps,
            guidance 3.5) and views 0 and 3 pinned to their VAE-encoded
            images; a generation with each of attn4 ``concat``, ``self``,
            ``add`` over non-ring pairs and the ring with the ``gated`` and
            with no connector, and a training step with ``self`` and with
            the non-ring pairs; each with its launches derived (the
            ``self`` form's d = 160 calls on the templates) and, for the
            generations, its kernel FLOPs; and every new attention shape
            (the sm90 forward at 4 x 8400 x 8400, the templates at d = 160
            and 546 tokens, forward, lse, dq and dk/dv) against its plain
            version, timed beside its bound and SDPA.  Alone: ``python3
            -c "import chip_smoke as s; s.phase_device(); s.phase_build();
            s.phase_options(None)"``.
17. hd      the flagship at HD (``+exp-hd=256x704`` and ``432x768``) at
            full SD v1.5 width: phase 4's generation, its UNet, VAE and CLIP
            weights loaded through the checkpoint loader by their SD v1.5
            names (``load_sd15_shaped``), and phase 6's training step, each
            with its launches derived per latent level (the top level over
            ``T_SCORE_CAP`` on the capped routes, the second at d = 80;
            every call on the sm90 kernels).  Alone: ``python3 -c "import chip_smoke as s;
            s.phase_device(); s.phase_build(); s.phase_hd(None)"``.
18. cache   the flagship training step at ``bench.py``'s training point:
            B = 2 x 6 views, the conditioning cache on, seeded random
            weights, bf16, remat, AdamW.  One batch through the cached and
            the uncached loss with the same draws (within
            ``CACHE_LOSS_RTOL``); then ``run()`` over three epochs of a
            4-sample set: the precompute runs in the first epoch only, the
            later epochs are served the first's entries bit for bit, and
            every step's launches equal ``train_launches_per_step``.
19. bench   ``python -m dualdiff_tpu_torch.bench`` in a subprocess with
            ``BENCH_ENV`` (no video sections, 3 training steps): its line
            parsed, the headline and the training section above 0 with
            ``0 < mfu_corrected <= 1``, the numerics pin ``ok``, and the
            generation's recorded kernel FLOPs and launches equal to their
            derivations (``generate_kernel_flops``,
            ``generate_launches_per_generation``).
20. tools   a training run through the port's own entry points at full SD
            v1.5 width (``phase_tools``): ``python -m
            dualdiff_tpu_torch.tools.train`` in a subprocess (the flagship,
            runner=debug, 4 micro-steps at gradient_accumulation_steps=2,
            checkpoints at 2 and 4, a validation at 4), the resume from
            checkpoint-2 in this process against checkpoint-4 bit for bit,
            the export back through ``load_pretrained_dir``, ``tools.test``
            and ``tools.val_set_gen`` (JPEGs at 900 x 1600, a rerun that
            skips), every micro-step's and generation's launches against
            their derivations; checkpoint and export bytes and seconds,
            s per micro-step and the peak with the accumulators.  Alone:
            ``python3 -c "import chip_smoke as s; s.phase_device();
            s.phase_build(); s.phase_tools()"``.
21. nuscenes  real nuScenes-format data in, scores out
            (``phase_nuscenes``): the native binding built (``# native``
            line) and its mask codec round trip; a small set written with
            the port's own code (two train scenes of 3 samples, one val
            scene of 2, 1600 x 900 frames, occupancy panoramas, Occ3D
            labels, map vectors) and read through ``build_dataset`` with
            ``dataset=Nuscenes``, every sample checked, the native decode
            against the reader's own path; the batch build timed at
            ``runner.num_workers`` 0 and 2; one full-width flagship step and
            one UniPC-20 generation on the reader's batches with their
            launches derived; ``tools.val_set_gen`` (2 steps) then
            ``tools.fid_score`` in config mode over it (finite, every token
            x sensor paired), the card's Inception against the CPU's,
            Inception images/s and I3D clips/s, ``tools.fvd_score``.
            Alone: ``python3 -c "import chip_smoke as s; s.phase_device();
            s.phase_build(); s.phase_nuscenes()"``.
22. explore the explore tools at full SD v1.5 width (``phase_explore``):
            the flagship with ``--config-name explore_config`` at 224x400,
            bf16, seeded random weights, the first synthetic sample;
            ``tools.explore_attn``'s and ``tools.explore_unet``'s ``run``
            in this process under ``models.layers.capture``: every map and
            the nine block features finite, every probability row summing
            to 1 within ``EXPLORE_ROW_TOL``, the PNGs and
            ``block_features.npz`` written; then the capture-off ControlNet
            + UNet forward again, its launches on the sm90 kernels
            (``check_sm90_launches``, the camera ring among them) and equal
            to those before the tools, its output within 2^-7 max|x| of the
            one before; seconds and peak GiB on a ``# explore`` line.
            Alone: ``python3 -c "import chip_smoke as s; s.phase_device();
            s.phase_build(); s.phase_explore()"``.
23. ddp     data parallelism over processes (``phase_ddp``): two ranks
            (``chip_smoke.py --ddp-rank DIR``, spawned with the launcher's
            variables) on the one card over gloo (``init_from_env``: NCCL
            refuses two ranks on one device), after what earlier phases
            left on the card is freed.  Each rank: phase 7's tiny flagship
            at 256x128 on its row of a global batch of 2, the gradients
            averaged; its row of the flagship's UniPC-20 generation at
            224x400 (global B = 2, full width, seeded weights, bf16) and of
            the tiny set's at 256x128, launches derived; then the flagship's training step at full
            width on the global batch of 2 (one row a rank), a warm-up
            and a timed step, launches per step equal to
            ``train_launches_per_step`` on the sm90 kernels, and the
            averaged gradients and the updated trainables (the optimizer's
            float32 masters) bit for bit equal to rank 0's
            (``differs_from_rank0``).  The parent holds the averaged
            256x128 gradient to one process's float32 B = 2 gradient on
            the CPU under phase 7's gate (loss ``LOSS_REL_TOL``, every leaf
            ``LEAF_TOL``; the full-width gradients are not held to it, see
            ``train_reference_readings``), and the generated rows within
            ``GEN_MEAN_TOL`` (mean) of one process's with the same weights
            and noise (``ddp_generation_readings``): at 224x400 of its
            generation of the row alone (its B = 2 rows differ from its
            B = 1 rows by more than the gate: cuDNN's convolutions and
            cuBLAS's GEMMs give a row other bits in another batch,
            ``tests/torch_batch_probe.py``), at phase 5's tiny 256x128 of
            its B = 2 generation, UniPC-20 both; at 224x400 every
            attention kernel call of one B = 2 step, run again on each
            half of its batch, bit-equal to the whole call
            (``halved_calls``); a one-rank ``nccl``
            group from the environment (``--nccl-probe``) does one
            ``all_reduce``.  Prints s/step beside phase 6's, all-reduce
            seconds and bytes per step and the peak per rank.  Then the
            splits (``ddp_split_rank``, in the same rank processes): on
            the ``(data=1, view=2)`` mesh, 3 of the 6 cameras a rank,
            row 2 on the rank's views at 224x400 (``split_ring_row``:
            within phase 3's tolerance of its plain version and bit-equal
            to the matching rows of the whole ring's call, sm90 and
            template, timed in CUDA graphs beside its bound and the
            stacked SDPA yardstick; an entry of the kernels line), the
            rank's cameras of the flagship's UniPC-20 generation of row 0
            alone (launches derived; no further (mean) from one process's
            row than one process's own B = 2 rows are from its B = 1 rows,
            as every call there has half the rows; every attention kernel
            call of one step of it, run again on each half of its cameras
            as a rank runs it, bit-equal to the whole call:
            ``halved_calls(views=True)``; and on the ranks, every ring
            call of one step, with its gathered K/V, bit-equal to the
            rank's rows of the whole ring run on q gathered from both:
            ``ring_calls_on_rank``), and phase 7's 256x128 gate on B = 2;
            on the ``(data=2)`` mesh
            one clip of ``SPLIT_FRAMES`` frames, 2 a rank (the frame
            split): the gate on the tiny RGD clip (stage 2, the temporal
            reward across the ranks), and the full-width stage-1 step
            (``clip_step_reading``: s/step, the peak per rank, the
            gathered bytes and seconds per step, launches derived).  The
            parent holds both gates to one process's float32 gradients
            and, with the ranks gone, runs one process's full-width step
            of the whole clip for its peak (``ddp_split_readings``).
            Alone: ``python3 -c "import chip_smoke as s;
            s.phase_device(); s.phase_build(); s.phase_ddp()"``.

An early line lists which of ``OPTIONAL_PACKAGES`` (PIL, cv2, PyYAML,
h5py, tensorboardX, orbax) import on the card, and whether ``g++``,
``make`` and libjpeg's ``jpeglib.h`` are there (``toolchain_probe``);
the port needs none of them (without g++ and libjpeg the reader decodes
through its own path).

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
import fractions
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, NVIDIA data sheet (SXM)
H100_BYTES_PER_S = 3.35e12
# exponentials per clock of one SM (MUFU: 4 per SM sub-partition) on 132 SMs
H100_SMS, EXP_PER_CLOCK = 132, 16
SEED = 0
# timed calls after each warm-up, kept few so that the whole run, phase
# ddp included, stays well inside its time limit (no check depends on
# their number)
TIMED_GENERATIONS = 1
TIMED_TRAIN_STEPS = 1
TIMED_CLIPS = 1
TIMED_VIDEO_TRAIN_STEPS = 1
TIMED_HD_GENERATIONS = 1
TIMED_HD_TRAIN_STEPS = 1
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
# phase cache: bench.py's training batch with the conditioning cache on,
# three epochs of a 4-sample set; the cached loss within JAX's own
# tolerance of the uncached one (test_conditioning_cache_matches_uncached_step)
B_CACHE, CACHE_SAMPLES, CACHE_EPOCHS = 2, 4, 3
CACHE_LOSS_RTOL = 2e-4
# phase variants: the shipped exp variants at full width, each with its
# generation (B x 6, UniPC-20, CFG 2) and training step (B_TRAIN x 6):
# config name -> (timed generations, timed steps); the configs live in
# dualdiff_tpu_torch.utils.config
VARIANTS = {"baseline_224x400": (1, 1), "occ_bg_adapter_224x400": (1, 1),
            "occ_bg_camtemb_fusion_224x400": (1, 1),
            "occ_bg_tone_224x400": (0, 1)}
# phase variants_reference's training set: occ_bg with the box adapter, the
# camera token in the time embedding and tone guidance all on
VARIANTS_TRAIN = ["use_box_adapter=true",
                  "model.controlnet.use_cam_in_temb=true",
                  "use_tone_guidance=true"]
# the ControlNets' attn2 keys with the box adapter: camera + 77 text tokens
# (the box and class tokens take einsum)
KV_ADAPTER = 1 + 77
# phase bench: the port bench without its video sections, 3 training steps
BENCH_ENV = {"BENCH_SKIP_VIDEO": "1", "BENCH_TRAIN_STEPS": "3"}
# phase tools: the train tool's words (the flagship, 4 micro-steps at k = 2,
# checkpoints at 2 and 4, a validation at 4), val_set_gen's samples, each
# tool's time limit, and the packages probed on the card
TOOLS_ARGS = ["+exp=dual_branch_augloss_fusion", "runner=debug",
              "runner.max_train_steps=4",
              "runner.gradient_accumulation_steps=2",
              "runner.checkpointing_steps=2", "runner.validation_steps=4",
              "dataset.num_samples=4"]
TOOLS_VAL_SAMPLES = 2
TOOLS_TIMEOUT = 600
OPTIONAL_PACKAGES = ("PIL", "cv2", "yaml", "h5py", "tensorboardX", "orbax")
# phase options: the pipeline's generation options on the flagship's model
# set, tag -> (config overrides, call arguments); given-view pinning
# (``PINNED_VIEWS``) comes beside them.  One warm-up and
# ``TIMED_OPTION_CALLS`` timed calls each.
OPTION_GENERATIONS = {
    "ddim": (["runner.pipeline_param.scheduler=ddim"], {}),
    "cn_cache_2": (["runner.pipeline_param.cn_cache_interval=2"], {}),
    "cn_cache_3": (["runner.pipeline_param.cn_cache_interval=3"], {}),
    "override": ([], {"num_inference_steps": 10, "guidance_scale": 3.5}),
}
PINNED_VIEWS = (0, 3)
TIMED_OPTION_CALLS = 1
# attn4's other forms and connectors on the flagship: tag -> (config
# overrides, whether a training step runs too); a generation each, and
# for self and add over other pairs (each view with (i - 2) % 6 and
# (i + 2) % 6) also a training step at B_TRAIN (one warm-up, two timed)
NON_RING_PAIRS = [f"dataset.neighboring_view_pair.{i}=[{(i - 2) % 6}, "
                  f"{(i + 2) % 6}]" for i in range(6)]
OPTION_ATTN4 = {
    "attn4_concat": (["model.unet.neighboring_attn_type=concat"], False),
    "attn4_self": (["model.unet.neighboring_attn_type=self"], True),
    "attn4_add_pairs": (NON_RING_PAIRS, True),
    "attn4_gated": (["model.unet.zero_module_type=gated"], False),
    "attn4_none": (["model.unet.zero_module_type=none"], False),
}
TIMED_OPTION_STEPS = 1
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
# what every training gate's step must launch
TRAIN_GATE_KERNELS = ("packed_attention_lse_fwd", "packed_attention_bwd_dq",
                      "packed_attention_bwd_dkv", SM90_LSE, SM90_DQ, SM90_DKV)
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


def check_sm90_launches(counts: dict, out_of_scope=None) -> None:
    """Every in-scope launch of the three inference wrappers, of the three
    training forwards, of the ring wrapper and of the four backward
    wrappers went through its sm90 kernel: each sm90 kernel's count equals
    its wrappers', less each wrapper's calls in ``out_of_scope`` ({wrapper:
    calls whose head_dim is outside ``sm90_in_scope``}, as d = 160 or
    SFA+ stage 2 at d = 4 in the tiny models; those take the templates).  A kernel or wrapper missing from ``counts`` counts 0."""
    out_of_scope = out_of_scope or {}
    for kernel, (wrappers, _) in SM90_ROUTES.items():
        want = sum(counts.get(k, 0) - out_of_scope.get(k, 0)
                   for k in wrappers)
        if counts.get(kernel, 0) != want:
            raise AssertionError(f"{kernel} launched {counts.get(kernel, 0)}"
                                 f" times, the wrappers' in-scope calls "
                                 f"{want}: {counts}")


def _sfa_plus_on_kernels(fusionp: bool, tokens: int) -> bool:
    """SFA+ stage 2 (``tokens`` x ``tokens``) reaches ``flash_attention``
    when both lengths are at least ``FLASH_MIN_LEN``."""
    from dualdiff_tpu_torch.ops.attention import FLASH_MIN_LEN

    return fusionp and tokens >= FLASH_MIN_LEN


def attention_levels(latent_hw, channels, heads: int,
                     self_views: int = 0) -> list:
    """(tokens, head_dim) of each latent level that holds transformer
    blocks, top first: the UNet's and each ControlNet's down blocks 0-2
    (and the UNet's up blocks 3-1) at ``channels[i] / heads``, each level
    the last's size halved by a stride-2 conv (rounded up).  The mid
    block's level holds one more block of each; it stays under
    ``PACKED_MIN_LQ`` at every size the configs give (4x7 tokens at
    224x400, 7x12 at 432x768), so it reaches no kernel, and a size where
    it would is refused.  ``self_views``: the views of attn4's ``self``
    form, whose mid-block call attends over that many times the mid
    block's tokens (168 at 224x400, 504 at 432x768): refused too where
    that reaches the kernels."""
    from dualdiff_tpu_torch.ops.attention import PACKED_MIN_LQ

    h, w = latent_hw
    levels = []
    for c in channels[:-1]:
        levels.append((h * w, c // heads))
        h, w = -(-h // 2), -(-w // 2)
    if h * w * max(self_views, 1) >= PACKED_MIN_LQ:
        raise NotImplementedError(f"the mid block's {h}x{w} tokens would "
                                  f"reach the kernels")
    return levels


def _kernel_levels(levels, template_only: bool):
    """(index, tokens) of each level whose attention reaches the packed
    kernels (at least ``PACKED_MIN_LQ`` queries).  With ``template_only``,
    only the levels whose head_dim is outside ``sm90_in_scope``."""
    from dualdiff_tpu_torch.ops.attention import PACKED_MIN_LQ, sm90_in_scope

    out = []
    for i, (t, d) in enumerate(levels):
        if t < PACKED_MIN_LQ:
            continue
        if d % 8:
            raise NotImplementedError(f"head_dim {d}: the split-layout route"
                                      f" is not derived here")
        if template_only and sm90_in_scope(d, True):
            continue
        out.append((i, t))
    return out


def attn4_form(unet) -> str:
    """attn4's form in a built UNet, as the derivations name it: ``ring``
    (``add`` over the camera ring's pairs), ``add`` (over other pairs),
    ``concat`` or ``self``."""
    from dualdiff_tpu_torch.models.layers import is_camera_ring

    kind = unet.neighboring_attn_type
    if kind == "add" and is_camera_ring(unet.neighboring_view_pair, N_CAM):
        return "ring"
    return kind


def _fwd_kernel(lq: int, lk: int, lse: bool = False) -> str:
    """The packed forward wrapper a call of ``lq`` x ``lk`` takes: the
    capped one where its padded score tile is over ``T_SCORE_CAP``."""
    from dualdiff_tpu_torch.ops.attention import over_score_cap

    capped = "_capped" if over_score_cap(lq, lk) else ""
    return f"packed_attention{capped}{'_lse' if lse else ''}_fwd"


def attn4_calls(levels, form: str, template_only: bool = False,
                n_cam: int = N_CAM) -> list:
    """(level, lq, lk, rows factor) of the one attention call attn4 makes
    per transformer block, at each level whose call reaches the packed
    kernels (at least ``PACKED_MIN_LQ`` queries), by ``form``: the ring
    and ``add`` over other pairs ``t`` x ``t`` (``add`` stacks ``[q; q]``
    over both neighbours: twice the rows), ``concat`` ``t`` x ``2t``,
    ``self`` ``n_cam t`` x ``n_cam t`` on one row per sample (so it also
    reaches the kernels at levels under ``PACKED_MIN_LQ``).  With
    ``template_only`` only the calls outside ``sm90_in_scope``."""
    from dualdiff_tpu_torch.ops.attention import PACKED_MIN_LQ, sm90_in_scope

    shape = {"ring": lambda t: (t, t, 1), "add": lambda t: (t, t, 2),
             "concat": lambda t: (t, 2 * t, 1),
             "self": lambda t: (n_cam * t, n_cam * t,
                                fractions.Fraction(1, n_cam))}[form]
    out = []
    for i, (t, d) in enumerate(levels):
        lq, lk, rows = shape(t)
        if lq < PACKED_MIN_LQ:
            continue
        if d % 8:
            raise NotImplementedError(f"head_dim {d}: the split-layout route"
                                      f" is not derived here")
        if template_only and sm90_in_scope(d, True):
            continue
        out.append((i, lq, lk, rows))
    return out


def cn_evaluations(steps: int, cn_cache: int = 0) -> int:
    """ControlNet evaluations of a generation: every step, or with
    ``cn_cache_interval = k > 1`` the steps ``i % k == 0``."""
    return -(-steps // cn_cache) if cn_cache > 1 else steps


def generate_launches_per_generation(layers: int, n_controlnets: int,
                                     steps: int, levels: list,
                                     fusionp: bool = False,
                                     template_only: bool = False,
                                     attn4: str = "ring",
                                     cn_cache: int = 0) -> dict:
    """Kernel launches of one image generation, derived from the code.
    ``levels``: (tokens, head_dim) of each latent level, top first
    (``attention_levels``; at 224x400 and in the tiny 256x128 models only
    the top level reaches the kernels, the second's 350 and 128 tokens
    being under ``PACKED_MIN_LQ``).  Per model evaluation, at each level
    with at least ``PACKED_MIN_LQ`` tokens:

    * the UNet's ``2 * layers + 1`` transformer blocks there (``layers`` in
      the down block, ``layers + 1`` in the up block) run attn1 (self) and
      attn2 (over the ``KV_CROSS`` context tokens);
    * each ControlNet's ``layers`` blocks there run attn1 and attn2;
    * attn1 and attn2 take ``packed_attention_capped_fwd`` where their
      padded score tile is over ``T_SCORE_CAP`` (HD's top level: 2816 and
      5184 tokens), else ``packed_attention_fwd``.

    Each of the UNet's blocks also runs attn4 (``attn4``, as
    ``attn4_form`` names it; ``attn4_calls``): the camera ring on the ring
    kernel, every other form on ``packed_attention_fwd`` or, over the cap,
    ``packed_attention_capped_fwd`` (``concat`` at 1400 x 2800, ``self``
    at 8400 and 2100 tokens at 224x400), ``self`` also at levels whose own
    tokens are under ``PACKED_MIN_LQ``.  The UNet runs every step; the
    ControlNets at ``cn_evaluations(steps, cn_cache)`` of them.

    Nothing is differentiated.  With SFA+ (``fusionp``) its stage 2 over
    the top level's tokens runs once per generation, in the ControlNet's
    step-constant precompute over the whole CFG batch: one
    ``flash_attention_fwd`` when it reaches the kernels (its head_dim is
    the top level's).  ``template_only``: only the calls outside
    ``sm90_in_scope`` (the templates' launches: ``self``'s d = 160 at
    224x400)."""
    blocks = 2 * layers + 1
    cn = n_controlnets * layers * cn_evaluations(steps, cn_cache)
    counts = _launches()
    for i, t in _kernel_levels(levels, template_only):
        for lk in (t, KV_CROSS):  # attn1, attn2
            counts[_fwd_kernel(t, lk)] += blocks * steps + cn
        if i == 0:
            counts["flash_attention_fwd"] += int(
                _sfa_plus_on_kernels(fusionp, t))
    for _, lq, lk, _ in attn4_calls(levels, attn4, template_only):
        kern = "packed_attention_nbr_fwd" if attn4 == "ring" \
            else _fwd_kernel(lq, lk)
        counts[kern] += blocks * steps
    return counts


def generate_kernel_flops(layers: int, n_controlnets: int, steps: int,
                          levels: list, channels, rows: int,
                          cn_kv: int = KV_CROSS, attn4: str = "ring",
                          cn_cache: int = 0) -> dict:
    """Hand-counted FLOPs of one image generation's kernel calls per
    wrapper, with ``ops.attention.recorded_kernel_flops``' formulas (4 x
    rows x Lq x Lk x C a forward, 8 x rows x L x L x C the ring), over the
    calls ``generate_launches_per_generation`` derives (no SFA+): at each
    level with at least ``PACKED_MIN_LQ`` tokens ``t`` (C =
    ``channels[level]``), attn1 (``t`` keys) and attn2 (``KV_CROSS``; the
    ControlNets' ``cn_kv``, 1 + 77 with the box adapter, whose box and
    class tokens take einsum) of the UNet's blocks every step and the
    ControlNets' at ``cn_evaluations(steps, cn_cache)``, and the UNet's
    attn4 calls (``attn4_calls``), on ``rows`` rows (2 x B x views with
    batched CFG)."""
    blocks = 2 * layers + 1
    cn = n_controlnets * layers * cn_evaluations(steps, cn_cache)
    flops = _launches()
    for i, t in _kernel_levels(levels, False):
        c = channels[i]
        for lk, n in ((t, blocks * steps + cn), (KV_CROSS, blocks * steps),
                      (cn_kv, cn)):
            flops[_fwd_kernel(t, lk)] += n * 4 * rows * t * lk * c
    for i, lq, lk, r in attn4_calls(levels, attn4):
        c = channels[i]
        if attn4 == "ring":
            flops["packed_attention_nbr_fwd"] += blocks * steps * 8 * rows \
                * lq * lk * c
        else:
            flops[_fwd_kernel(lq, lk)] += blocks * steps * 4 * int(
                rows * r) * lq * lk * c  # rows * r: whole rows
    return flops


def train_launches_per_step(layers: int, n_controlnets: int,
                            remat: bool, levels: list, fusionp: bool = False,
                            template_only: bool = False,
                            attn4: str = "ring") -> dict:
    """Kernel launches of one training step, derived from the code.
    ``levels`` and ``template_only`` as in
    ``generate_launches_per_generation``.  At each level with at least
    ``PACKED_MIN_LQ`` tokens:

    * the UNet's down block there: ``layers`` transformer blocks of attn1,
      attn2 and attn4.  At the top level its first block's attn1 sees only
      frozen inputs (the noisy latents through frozen layers): no input
      needs a gradient, so it takes an inference kernel.  That block's
      attn2 (K/V from the ControlNet's context tokens) and attn4
      (trainable norm4 and projections) are differentiated, as is
      everything after them, every lower level included.
    * the UNet's up block there: ``layers + 1`` blocks, 3 differentiated
      each.
    * each ControlNet's down block there: ``layers`` blocks of attn1 and
      attn2 (no attn4), all trainable.
    * attn4 (trainable norm4 and projections) under grad is one
      ``PackedAttention`` call per block, at each level of
      ``attn4_calls``: the ring and ``add`` over other pairs the stacked
      call (both neighbours on the batch axis, the view's own length; the
      ring kernel never runs), ``concat`` the view's tokens over both
      neighbours' (2L keys), ``self`` the sample's ``n_cam`` x L tokens
      (also at levels under ``PACKED_MIN_LQ``).
    * a call whose padded score tile is over ``T_SCORE_CAP`` (attn1 and
      attn4 at HD's top level) takes the capped kernels:
      ``packed_attention_capped_fwd`` frozen,
      ``packed_attention_capped_lse_fwd`` differentiated.

    * with SFA+ (``fusionp``), its stage 2 over the top level's tokens
      runs once, outside the remat blocks, differentiated (every
      ControlNet leaf trains): one ``FlashAttention`` when both lengths
      reach ``FLASH_MIN_LEN``.

    A differentiated call is one forward with lse, one dq and one dk/dv;
    remat replays every block's forward in the backward, so the forward
    kernels run twice."""
    blocks = 2 * layers + 1
    cn = n_controlnets * layers
    replay = 2 if remat else 1
    counts = _launches()

    def differentiated(n, lq, lk):
        counts[_fwd_kernel(lq, lk, lse=True)] += n * replay
        counts["packed_attention_bwd_dq"] += n
        counts["packed_attention_bwd_dkv"] += n

    for i, t in _kernel_levels(levels, template_only):
        frozen = 1 if i == 0 else 0  # the UNet's first attn1
        if frozen:
            counts[_fwd_kernel(t, t)] += replay
        differentiated(blocks - frozen + cn, t, t)  # attn1
        differentiated(blocks + cn, t, KV_CROSS)  # attn2
        if i == 0:
            sfa = int(_sfa_plus_on_kernels(fusionp, t))
            for kern in ("flash_attention_lse_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"):
                counts[kern] += sfa
    for _, lq, lk, _ in attn4_calls(levels, attn4, template_only):
        differentiated(blocks, lq, lk)
    return counts


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


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        sys.exit(2)
    smi = card()
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
        # occ_bg_adapter: the ControlNet's attn2 over camera + text only
        ("packed_attention_fwd", "attn2 cross, box adapter (ControlNet)",
         2 * B * N_CAM, L, KV_ADAPTER, C, HEADS, 0),
        # the clip's ControlNet attn1: 16 frames x 6 views
        ("packed_attention_fwd", "ControlNet attn1 in the clip",
         FRAMES * N_CAM, L, L, C, HEADS, 0),
        ("packed_attention_fwd", "ragged, d=40", 3, 777, 333, C, HEADS, 0),
        # the tiny reference models' 512-token level (C = 32, 4 heads)
        ("packed_attention_fwd", "tiny models, d=8", 12, 512, 512, 32, 4, 0),
        ("packed_attention_fwd", "ragged, d=80", 3, 777, 333, 320, 4, 0),
        # d = 72: the second TMA box's columns 72..79 read as zero
        ("packed_attention_fwd", "ragged, d=72", 3, 777, 333, 288, 4, 0),
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
        ("packed_attention_nbr_fwd", "ragged ring, d=72", 2 * 3, 701, 701,
         288, 4, 3),
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
    ] + [  # HD: the top level over the cap (d = 40), the second at d = 80
        ("packed_attention_capped_fwd", f"HD {g} attn1 self", 2 * B * N_CAM,
         t, t, C, HEADS, 0) for g, t in (("432x768", 5184), ("256x704", 2816))
    ] + [
        ("packed_attention_fwd", "HD 432x768 attn2 cross", 2 * B * N_CAM,
         5184, KV_CROSS, C, HEADS, 0),
        ("packed_attention_fwd", "HD 432x768 attn1 self, d=80", 2 * B * N_CAM,
         1296, 1296, 2 * C, HEADS, 0),
        ("packed_attention_fwd", "HD 432x768 attn2 cross, d=80",
         2 * B * N_CAM, 1296, KV_CROSS, 2 * C, HEADS, 0),
    ] + [
        ("packed_attention_nbr_fwd", f"HD {g} attn4 camera ring{dd}",
         2 * B * N_CAM, t, t, c, HEADS, N_CAM)
        for g, t, c, dd in (("432x768", 5184, C, ""), ("256x704", 2816, C, ""),
                            ("432x768", 1296, 2 * C, ", d=80"),
                            ("256x704", 704, 2 * C, ", d=80"))
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
        ("attn2 cross, box adapter (ControlNet)", rows, L, KV_ADAPTER, C,
         HEADS),
        ("ragged, d=80", 3, 777, 333, 320, 4),
        ("ragged, d=72", 3, 777, 333, 288, 4),
        ("d=160", 2, 513, 65, 1280, 8),
        ("video ST-Attn under grad, first + previous frame", video_rows, L,
         2 * L, C, HEADS),
        ("ragged ST-Attn under grad, lk = 2801", video_rows, L, 2 * L + 1, C,
         HEADS),
        # the sm90 backward's edges: ragged tiles at both ends, one key, one
        # query, the tiny models' d = 8 and the first box's widest, 64
        ("ragged, d=40", 3, 777, 333, C, HEADS),
        ("one key, d=40", 2, 129, 1, C, HEADS),
        ("one query, d=40", 2, 1, 300, C, HEADS),
        ("tiny models, d=8", 12, 512, 512, 32, 4),
        ("ragged, d=64", 3, 777, 333, 256, 4),
        # HD 432x768: attn1 over the cap (the capped forward), the stacked
        # ring, attn2, and the second level at d = 80
        ("HD 432x768 attn1 self", rows, 5184, 5184, C, HEADS),
        ("HD 432x768 attn4 stacked neighbours", 2 * rows, 5184, 5184, C,
         HEADS),
        ("HD 432x768 attn2 cross", rows, 5184, KV_CROSS, C, HEADS),
        ("HD 432x768 attn1 self, d=80", rows, 1296, 1296, 2 * C, HEADS),
    ]


# The plain versions materialise float32 scores, (rows, heads, lq, lk):
# 20.6 GB at HD's 24 x 5184 x 5184.  Phase 3 calls them on slices of rows
# whose scores stay under this (whole camera rings for the ring; every
# 224x400 case but the clip's ST-Attn fits in one), and SDPA's MATH
# backend, which does the same, is not timed above it.
PLAIN_SCORE_BYTES = 6 * 2 ** 30


def _score_bytes(b, heads, lq, lk) -> int:
    """The float32 scores (b, heads, lq, lk) a plain version holds; the
    ring's computes its two neighbours one after the other
    (``attention_packed_neighbors_plain``), so it too holds one set at a
    time."""
    return b * heads * lq * lk * 4


def by_rows(fn, b: int, heads: int, lq: int, lk: int, n_cam: int = 0):
    """``fn`` (a plain version) on slices of the ``b`` rows small enough
    for ``PLAIN_SCORE_BYTES``, outputs concatenated: row-sized arguments
    (q, k, v, do) are sliced by rows, (rows * heads)-sized ones (lse,
    delta) by their rows' heads, other arguments passed as they are.  The
    rows are independent (the ring's within a sample of ``n_cam`` views),
    so the result is ``fn``'s on all rows."""
    group = max(n_cam, 1)
    step = max(group, PLAIN_SCORE_BYTES // _score_bytes(group, heads, lq, lk)
               * group)
    if step >= b:
        return fn

    def run(*args):
        outs = []
        for r in range(0, b, step):
            sl = [a[r:r + step] if torch.is_tensor(a) and a.shape[0] == b
                  else a[r * heads:(r + step) * heads]
                  if torch.is_tensor(a) and a.shape[0] == b * heads else a
                  for a in args]
            outs.append(fn(*sl))
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return torch.cat(outs)
    return run


def _tol(want) -> float:
    """bf16 output: one rounding is 2^-8 relative; the kernels also round
    one MMA operand to bf16 (P in the forward and dv, dS in dq and dk:
    2^-9 relative per term, averaging out over the summed keys or
    queries)."""
    return 2.0 ** -7 * want.float().abs().max().item() + 1e-3


def _max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def sdpa_ms(call, scores, iters: int = 20) -> dict:
    """``graph_ms`` of ``call()`` (which calls SDPA on (b, heads, lq, lk)
    ``scores``) under SDPA's default dispatch and under each backend alone,
    by backend name; a backend whose eager call raises (it does not take
    the shape) is left out, and MATH (the scores in memory) where they are
    over ``PLAIN_SCORE_BYTES``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    math = _score_bytes(*scores) <= PLAIN_SCORE_BYTES
    ctxs = {"default": contextlib.nullcontext}
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION) + ((SDPBackend.MATH,) if math
                                              else ()):
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


def library_row(call, scores=None) -> dict:
    """``library_ms`` of the fastest SDPA backend for ``call`` on
    ``scores`` (None without one), the backend's name and every backend's
    time."""
    if call is None:
        return {"library_ms": None}
    times = sdpa_ms(call, scores)
    name, ms = fastest(times)
    return {"library_ms": ms, "library": f"SDPA ({name})",
            "library_ms_by_backend": times}


def stacked_sdpa_call(q, k, v, heads: int, n_cam: int,
                      n_local: int = None, view0: int = 0):
    """The camera ring as the JAX package's training formulation computes
    it with library calls (``_nbr_stacked``): the left and right views' K/V
    gathered and stacked on the batch axis with ``torch.cat``, one
    ``scaled_dot_product_attention`` over the 2B stacked rows, the two
    halves summed; q/k/v (B*N, L, C) packed in, (B*N, L, C) out (under a
    view split q and the output hold the ``n_local`` views ``view0 ..`` of
    each sample, k and v all N).  A yardstick of two calls beside the ring
    kernel: the port never calls it."""
    bn, l, c = q.shape
    b, d = k.shape[0] // n_cam, c // heads
    n_local = n_cam if n_local is None else n_local
    idx = lambda off: torch.tensor([(view0 + n + off) % n_cam
                                    for n in range(n_local)], device=q.device)
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
    chunked = functools.partial(by_rows, b=b, heads=heads, lq=lq, lk=lk)
    fns = {n: chunked(f) if "plain" in n else f for n, f in fns.items()}
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
    lib_fwd_by = sdpa_ms(lambda: lib_step(False), (b, heads, lq, lk), 10)
    lib_step_by = sdpa_ms(lambda: lib_step(True), (b, heads, lq, lk), 10)
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
        for name, row in forward_kernel_rows(
                A, g, kern, label, b, lq, lk, c, heads, n_cam,
                clock_hz).items():
            results.setdefault(name, []).append(row)
    return results


def forward_kernel_rows(A, g, kern, label, b, lq, lk, c, heads, n_cam,
                        clock_hz) -> dict:
    """One inference kernel (``kern``, a wrapper) on one shape against its
    plain version, with its times (``kernel_cases`` gives the shapes):
    ``{kern: row}``, and in ``sm90_in_scope`` also ``{sm90 kernel: row}``
    (the wrapper's own row is then the template instance's).  Raises when
    a variant disagrees with the plain version."""
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
        plain = lambda: by_rows(A.attention_packed_neighbors_plain, b,
                                heads, lq, lk, n_cam)(q, k, v, heads,
                                                      n_cam)
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
        plain = lambda: by_rows(fl["plain"], b, heads, lq, lk)(
            q, k, v, heads)
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
        plain = lambda: by_rows(A.attention_packed_capped_plain, b,
                                heads, lq, lk)(q, k, v, heads)
    elif sm90:
        variants["sm90"] = lambda: A.packed_attention_fwd(q, k, v, heads)
        variants["template"] = lambda: A.packed_attention_fwd(
            q, k, v, heads, route="template")
        plain = lambda: by_rows(A.attention_packed_plain, b, heads, lq,
                                lk)(q, k, v, heads)
    else:
        variants[""] = lambda: A.packed_attention_fwd(q, k, v, heads)
        plain = lambda: by_rows(A.attention_packed_plain, b, heads, lq,
                                lk)(q, k, v, heads)
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
        by_backend = sdpa_ms(stacked, (2 * b, heads, lq, lk))
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
        **library_row(library, (b, heads, lq, lk)),
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
    out = {kern: row}
    if sm90:
        sm90_row = dict(row, kernel=sm90_kern, wrapper=kern,
                        replaces=SM90_REPLACES[kern],
                        kernel_ms=times["sm90"], max_abs_err=errs["sm90"])
        log(json.dumps(sm90_row))
        out[sm90_kern] = sm90_row
    del q, k, v
    torch.cuda.empty_cache()
    return out


def _flagship(device, tiny=False, extra=(), weights_from=None,
              video=False, name=None, loader=False, mesh=None):
    """(cfg, collated batch, pipeline) with seeded random weights, or the
    weights of the models in ``weights_from``; the flagship config, or
    ``name``.  With ``loader`` the UNet's, VAE's and CLIP's weights come
    through the checkpoint loader (``load_sd15_shaped``).  The batch: B=2
    synthetic samples; with ``video``, clip 0 of ``bench.py::main_video``'s
    seed-0 synthetic clips (``video.num_frames`` frames), collated as it
    collates them."""
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
    if loader:
        log(json.dumps({"phase": f"{_tag(cfg)} checkpoint loader",
                        **load_sd15_shaped(cfg, models, SEED + 1)}))
    return cfg, batch, BEVControlNetPipeline(cfg, models, device=device,
                                             mesh=mesh)


def _tag(cfg) -> str:
    """The phase tag of a config: "" for the flagship at 224x400,
    ``fusionp`` for ``occ_bg_fusionp``, ``hd_<h>x<w>`` at HD, ``baseline``
    for ``+exp=224x400``, the task for the other variants, and
    ``attn4_<form>`` or ``attn4_<connector>`` for attn4's other forms and
    connectors (``OPTION_ATTN4``)."""
    h, w = cfg.dataset.image_size
    task = str(cfg.task_id)
    from dualdiff_tpu_torch.models.layers import is_camera_ring

    u = cfg.model.unet
    pairs = cfg.dataset.neighboring_view_pair
    if u.neighboring_attn_type != "add":
        return f"attn4_{u.neighboring_attn_type}"
    if not is_camera_ring([pairs[str(i)] for i in range(N_CAM)], N_CAM):
        return "attn4_add_pairs"
    if u.zero_module_type != "zero_linear":
        return f"attn4_{u.zero_module_type}"
    if cfg.model.controlnet.use_txt_con_fusionp:
        return "fusionp"
    if task == "224x400":
        return "baseline"
    if task not in ("dual_branch_augloss_fusion", f"{h}x{w}"):
        return task
    return "" if (h, w) == (224, 400) else f"hd_{h}x{w}"


def _named(tag: str, what: str) -> str:
    return f"{tag}_{what}" if tag else what


def load_sd15_shaped(cfg, models, seed: int) -> dict:
    """The UNet's, VAE's and CLIP's weights through the port's checkpoint
    loader, as from a released SD v1.5 checkpoint: a second model set,
    seeded with ``seed``, on the same device; its state dicts renamed to
    such a checkpoint's names (the UNet's SD v1.5 keys alone, without the
    multiview leaves SD v1.5 lacks; the VAE in the legacy attention names
    of the hub's SD v1.5 dump; CLIP with ``position_ids``) and loaded in
    memory with ``load_pretrained``.  Checks that every loaded tensor
    equals its source bit for bit and that the tensors not loaded are
    exactly the UNet's multiview leaves.  -> {component: {"src_keys",
    "missing"}}."""
    from dualdiff_tpu_torch.runner.factory import (build_models,
                                                   randomize_weights)
    from dualdiff_tpu_torch.runner.sd15_keys import sd15_unet_keys
    from dualdiff_tpu_torch.runner.weights import (LEGACY_VAE_NAMES,
                                                   MULTIVIEW_MODULES,
                                                   load_pretrained)

    dev = next(models["unet"].parameters()).device
    src = build_models(cfg, device=dev)
    report = {}
    for key, kind in (("unet", "unet"), ("vae", "vae"),
                      ("text_encoder", "clip")):
        randomize_weights(src[key], seed)
        want = src[key].state_dict()
        if kind == "unet":
            sd = {k: want[k] for k in sd15_unet_keys()}
        elif kind == "vae":
            sd = {}
            for k, v in want.items():
                for old, new in LEGACY_VAE_NAMES.items():
                    k = k.replace(f"attentions.0.{new}.",
                                  f"attentions.0.{old}.")
                sd[k] = v
        else:
            sd = dict(want, **{"text_model.embeddings.position_ids":
                               torch.arange(77, device=dev)[None]})
        missing = load_pretrained(models[key], sd, kind)
        got = models[key].state_dict()
        multiview = sorted(k for k in got if any(
            f".{m}." in k for m in MULTIVIEW_MODULES))
        if missing != (multiview if kind == "unet" else []):
            raise AssertionError(f"{key}: not loaded {missing[:5]} "
                                 f"({len(missing)})")
        differ = [k for k in want if k not in missing
                  and not torch.equal(got[k], want[k])]
        if differ:
            raise AssertionError(f"{key}: loaded tensors differ from the "
                                 f"checkpoint: {differ[:5]}")
        report[key] = {"src_keys": len(sd), "missing": len(missing)}
    del src
    return report


def model_levels(unet, latent_hw) -> list:
    """``attention_levels`` of a built UNet (its block widths and head
    count, its attn4 form) at latent size ``latent_hw``."""
    heads = unet.down_blocks[0].attentions[0].transformer_blocks[0] \
        .attn1.heads
    return attention_levels(
        latent_hw, unet.block_out_channels, heads,
        N_CAM if unet.neighboring_attn_type == "self" else 0)


def phase_generate(profile_dir, name=None, timed_calls=TIMED_GENERATIONS,
                   loader=False, cn_kv=None, extra=()):
    """Image generation at full SD v1.5 width, B=2 x 6 views: the flagship
    (phase 4), or the config ``name`` (``occ_bg_fusionp`` in phase
    ``fusionp``, the HD geometries in phase ``hd``, there with ``loader``:
    the UNet, VAE and CLIP weights through the checkpoint loader), under
    the config overrides ``extra`` (attn4's forms in phase ``options``).
    One warm-up call, then ``timed_calls`` timed calls, each checked by
    ``run_generations``.  -> (launches of the last call, those of them on
    the templates)."""
    t0 = time.perf_counter()
    cfg, batch, pipe = _flagship("cuda", name=name, loader=loader,
                                 extra=extra)
    torch.cuda.synchronize()
    log(f"# models built and cast in {time.perf_counter() - t0:.1f} s")
    tag = _tag(cfg)
    counts, template, s, _ = run_generations(pipe, batch, tag, timed_calls,
                                             cn_kv)
    if profile_dir:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        profile_run(lambda: pipe(batch, generator=gen), s, profile_dir,
                    _named(tag, "generation"))
    del pipe
    torch.cuda.empty_cache()
    return counts, template


def run_generations(pipe, batch, tag: str, timed_calls: int, cn_kv=None,
                    **call):
    """One warm-up call of ``pipe(batch, generator, **call)`` (seed
    ``SEED``), then ``timed_calls`` timed calls (seeds ``SEED + i``), each
    checked for shape, finiteness, range and the kernels' launches per
    generation (``generate_launches_per_generation``, per latent level,
    with the UNet's attn4 form, the pipeline's ControlNet cache and the
    call's steps; the calls outside ``sm90_in_scope`` on the templates:
    none at full width but the ``self`` form's d = 160).  With ``cn_kv``
    (the ControlNets' attn2 keys: 78 with the box adapter) the warm-up
    call's recorded kernel FLOPs must equal ``generate_kernel_flops``' per
    wrapper.  Logs the phase row.  -> (launches of the last call, those of
    them on the templates, median s / generation, the warm-up's
    images)."""
    from dualdiff_tpu_torch.ops import attention as A

    from dualdiff_tpu_torch.pipeline.bev_controlnet import OVERRIDES

    cfg, models = pipe.cfg, pipe.models
    run = pipe.settings({k: v for k, v in call.items() if k in OVERRIDES})
    steps = run["num_inference_steps"]
    h, w = cfg.dataset.image_size
    lh, lw = h // 8, w // 8
    unet = models["unet"]
    layers, n_cn = len(unet.down_blocks[0].resnets), len(models["controlnets"])
    levels = model_levels(unet, (lh, lw))
    form, cache = attn4_form(unet), pipe.cn_cache_interval
    derive = functools.partial(
        generate_launches_per_generation, layers, n_cn, steps, levels,
        fusionp=tag == "fusionp", attn4=form, cn_cache=cache)
    expect, template = derive(), derive(template_only=True)
    gen = torch.Generator(device="cuda")
    times, counts, first = [], None, None
    torch.cuda.reset_peak_memory_stats()
    flops = None
    for i in range(1 + timed_calls):
        gen.manual_seed(SEED + i)
        A.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with A.recorded_kernel_flops() if i == 0 and cn_kv \
                else contextlib.nullcontext() as rec:
            out = pipe(batch, generator=gen, **call)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rec is not None:
            flops = rec.by_wrapper
            want = generate_kernel_flops(
                layers, n_cn, steps, levels, unet.block_out_channels,
                2 * B * N_CAM, cn_kv, attn4=form, cn_cache=cache)
            if flops != {k: float(v) for k, v in want.items() if v}:
                raise AssertionError(f"kernel FLOPs {flops} != {want}")
        counts = launch_counts(A)
        if _wrappers(counts) != expect:
            raise AssertionError(f"kernel launches {counts} != {expect}")
        check_sm90_launches(counts, template)
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
        else:
            first = out
    s = sorted(times)[len(times) // 2]
    row = {"phase": f"{tag} generate".strip(),
           "config": f"{cfg.task_id} {h}x{w}",
           "batch": B, "views": N_CAM, "steps": steps,
           "cfg_scale": run["guidance_scale"], "scheduler": run["scheduler"],
           "cn_cache_interval": cache, "attn4": form,
           "connector": unet.zero_module_type,
           "latent_hw": [lh, lw], "levels": levels, "s_per_generation": s,
           "s_per_generation_all": times, "samples_per_s": B / s,
           "images_per_s": B * N_CAM / s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches_per_generation": counts,
           "template_launches_per_generation": template}
    if flops is not None:
        row["kernel_flops_per_generation"] = flops
    log(json.dumps(row))
    if tag:
        log(f"{tag} s/generation: {s}")
        log(f"{tag} images/s: {B * N_CAM / s}")
    return counts, template, s, first


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


def phase_reference(video=False, fusionp=False, name=None):
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
    launch (phase ``fusionp_reference``).  ``name``: another config at
    256x128 (``+exp=224x400`` in phase ``variants_reference``)."""
    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.utils.config import FUSIONP

    extra = ["runner.pipeline_param.num_inference_steps=3"]
    if not fusionp:
        extra.append("dataset.image_size=[256, 128]")
    if video:
        extra += ["video.num_frames=2", "runner.pipeline_param.vae_slicing=5"]
    variant = name is not None
    name = FUSIONP if fusionp else name
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
        else "variants_reference" if variant else "reference"
    row = {"phase": phase, "shape": list(got.shape),
           "max_abs_err": err.max().item(),
           "mean_abs_err": err.mean().item(), "tol_mean": 1e-2,
           "launches": launch_counts(A)}
    log(json.dumps(row))
    if not row["mean_abs_err"] <= row["tol_mean"]:
        raise AssertionError("bf16 generation on the card disagrees with the "
                             "float32 CPU reference")
    # the tiny SFA+ stage 2 (d = 4) is outside the sm90 kernel's scope
    check_sm90_launches(row["launches"], {
        "flash_attention_fwd": row["launches"]["flash_attention_fwd"]}
        if fusionp else None)
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


def phase_train(profile_dir, name=None, timed_steps=TIMED_TRAIN_STEPS,
                extra=()):
    """The flagship training step (or that of the config ``name``:
    ``occ_bg_fusionp`` in phase ``fusionp``, the HD geometries in phase
    ``hd``) at full SD v1.5 width: seeded random weights, B = 1 x 6 views,
    bf16, remat on, AdamW with a bf16 first moment and the warmup-cosine
    schedule; one warm-up step, then ``timed_steps`` timed steps.  Checks
    finite loss and grad_norm > 0 every step, the kernels' launches per
    step (``train_launches_per_step``, per latent level; the calls outside
    ``sm90_in_scope`` on the templates), and that the trainables (float32
    master copies) moved while every frozen parameter stayed as it was.
    The learning rate of step 0 is exactly 0 (warmup from 0), so the
    comparison starts after step 1.  ``extra``: config overrides.  With
    the box adapter its projections start as copies of their base ones,
    bit for bit (``init_box_adapter_from_base``, as a fresh trainer), and
    every one of them must move; with tone guidance every step's ``tone``
    must be finite and above 0.  -> {"run": the run's launches,
    "step": one step's, "run_template", "step_template": those of them on
    the templates}."""
    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.runner.factory import (build_models,
                                                   randomize_weights)
    from dualdiff_tpu_torch.runner.train_state import (
        BOX_ADAPTER_BASE, init_box_adapter_from_base)
    from dualdiff_tpu_torch.runner.trainer import MultiviewTrainer
    from dualdiff_tpu_torch.utils.config import FLAGSHIP, load_config

    t0 = time.perf_counter()
    cfg = load_config(name or FLAGSHIP, list(extra))
    models = build_models(cfg, device="cuda")
    for m in (models["unet"], models["vae"], models["text_encoder"],
              *models["controlnets"]):
        randomize_weights(m, SEED)
    adapter = bool(cfg.get("use_box_adapter", False))
    if adapter:
        copied = init_box_adapter_from_base(models)
        differ = [f"{name}.{proj}" for cn in models["controlnets"]
                  for name, m in cn.named_modules()
                  if getattr(m, "box_adapter", False)
                  for proj, base in BOX_ADAPTER_BASE.items()
                  if not torch.equal(getattr(m, proj).weight,
                                     getattr(m, base).weight)]
        if not copied or differ:
            raise AssertionError(f"box adapter init: {copied} copied, "
                                 f"differ from their base {differ[:5]}")
        log(f"# box adapter: {copied} projections start as their base "
            f"ones, bit for bit")
    tone = bool(cfg.get("use_tone_guidance", False))
    n_steps = 1 + timed_steps
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
    tag = _tag(cfg)
    derive = functools.partial(
        train_launches_per_step, layers, len(models["controlnets"]),
        bool(cfg.runner.enable_unet_checkpointing)
        and bool(cfg.runner.enable_controlnet_checkpointing),
        model_levels(models["unet"], (h // 8, w // 8)),
        fusionp=tag == "fusionp", attn4=attn4_form(models["unet"]))
    expect, template = derive(), derive(template_only=True)
    steps, snap = [], {}
    run_counts = dict.fromkeys(launch_counts(A), 0)

    def on_metrics(step, m):
        counts = launch_counts(A)
        A.reset_launch_counts()
        for k, v in counts.items():
            run_counts[k] += v
        log(f"# train step {step}: " + ", ".join(
            f"{k} {m[k]:.6f}" for k in ("loss", "mse", "aug_loss", "tone",
                                        "grad_norm") if k in m)
            + f", {m['step_time_s']:.3f} s (batch assembly "
            f"{m['data_time_s']:.3f} s)")
        if _wrappers(counts) != expect:
            raise AssertionError(f"kernel launches {counts} != {expect}")
        check_sm90_launches(counts, template)
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            raise AssertionError(f"step {step}: loss {m['loss']}, grad_norm "
                                 f"{m['grad_norm']}")
        if tone and not (math.isfinite(m["tone"]) and m["tone"] > 0):
            raise AssertionError(f"step {step}: tone {m['tone']}")
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
    row = {"phase": f"{tag} train".strip(),
           "config": f"{cfg.task_id} {h}x{w}",
           "batch": B_TRAIN, "views": N_CAM, "steps": n_steps,
           "s_per_step": s, "s_per_step_all": times,
           "batch_assembly_s": data,
           "images_per_s": B_TRAIN * N_CAM / s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "loss": [m["loss"] for m in steps],
           **({"tone": [m["tone"] for m in steps]} if tone else {}),
           "grad_norm": [m["grad_norm"] for m in steps],
           "trainable_tensors": len(opt.master),
           "trainable_tensors_with_grad": len(got_grad),
           "trainable_tensors_moved": len(moved),
           "trainable_tensors_required_to_move": len(must_move),
           "trainable_tensors_without_grad": sorted(set(opt.master)
                                                    - got_grad),
           "frozen_tensors_changed": len(frozen_changed),
           "launches_per_step": expect, "launches_run": run_counts,
           "template_launches_per_step": template}
    log(json.dumps(row))
    if tag:
        log(f"{tag} s/step: {s}")
        log(f"{tag} train images/s: {B_TRAIN * N_CAM / s}")
    elif name is None and not extra:  # phase ddp's yardstick
        KEPT["train_s_per_step"] = s
    if frozen_changed:
        raise AssertionError(f"frozen parameters changed: "
                             f"{frozen_changed[:5]}")
    if must_move - moved:
        raise AssertionError(f"trainables that did not move: "
                             f"{sorted(must_move - moved)[:5]}")
    still = [k for k in opt.master if k.split(".")[-2] in BOX_ADAPTER_BASE
             and k not in moved]
    if adapter and still:
        raise AssertionError(f"box adapter leaves that did not move: "
                             f"{still[:5]}")
    # a few trainables see a gradient only in some steps (the learned
    # uncond camera only when the CFG switch drops a sample); 844 of 844
    # did in the flagship's seeded run on an H100 80GB HBM3 at 700 W
    if len(got_grad) < 0.9 * len(opt.master):
        raise AssertionError(f"only {len(got_grad)} of {len(opt.master)} "
                             "trainable tensors got a gradient")
    if profile_dir:
        batch = trainer._build_batch(next(trainer._batch_plan(0)))
        profile_run(lambda: trainer.train_step(batch), s, profile_dir,
                    _named(tag, "train_step"))
    del trainer, models, snap
    torch.cuda.empty_cache()
    return {"run": run_counts, "step": expect, "step_template": template,
            "run_template": {k: v * n_steps for k, v in template.items()}}


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


def gate_reading(device: str, fp32: bool = False, video: bool = False,
                 fusionp: bool = False, variants: bool = False,
                 batch: int = 1, mesh=None, frames: int = TRAIN_FRAMES):
    """One tiny loss + backward of the gate's set (see
    ``train_reference_readings``) on ``device``, in float32 with ``fp32``,
    else in the config's bf16: seeded weights drawn on the CPU in float32,
    ``batch`` samples (clip 0 of ``frames`` frames with ``video``) and the
    draws of ``torch.Generator`` seed ``SEED`` for them.  Under ``mesh``
    this rank's rows and cameras of the batch and the draws (a clip's
    frames split where the data ranks outnumber the clips; the loss takes
    the mesh's ``Split``), the gradients averaged over the ranks
    (``average_gradients``) and the loss their mean.  -> (loss,
    ``_trainable_grads``, launches)."""
    import numpy as np

    from dualdiff_tpu_torch.data.collate import collate_fn
    from dualdiff_tpu_torch.data.tokenizer import HashTokenizer
    from dualdiff_tpu_torch.data.video import (SyntheticNuScenesVideo,
                                               collate_video)
    from dualdiff_tpu_torch.diffusion.schedule import DiffusionSchedule
    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.parallel import mesh as M
    from dualdiff_tpu_torch.runner.conds import prepare_batch, to_device
    from dualdiff_tpu_torch.runner.factory import (build_models,
                                                   randomize_weights)
    from dualdiff_tpu_torch.runner.rewards import make_rgd_reward
    from dualdiff_tpu_torch.runner.train_state import (named_roots,
                                                       partition_params,
                                                       trainable_predicate)
    from dualdiff_tpu_torch.runner.trainer import (make_draws, make_loss_fn,
                                                   shard_draws)
    from dualdiff_tpu_torch.utils.config import (FLAGSHIP, FUSIONP, OCC_BG,
                                                 RGD_STAGE2, load_config)

    name = RGD_STAGE2 if video else FUSIONP if fusionp else \
        OCC_BG if variants else FLAGSHIP
    extra = ["dataset.image_size=[256, 128]"]
    if variants:
        extra += VARIANTS_TRAIN
    frames = frames if video else 1
    if video:
        extra.append(f"video.num_frames={frames}")
    if fp32:
        extra.append("runner.mixed_precision=fp32")
    cfg = load_config(name, extra)
    models = build_models(cfg, tiny=True, device="cpu")
    for _, m in named_roots(models):
        randomize_weights(m, SEED)
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
    for _, m in named_roots(models):
        m.to(device, models["dtype"])
    trainable, _ = partition_params(models, trainable_predicate(
        str(cfg.model.unet.trainable_state)))
    h, w = cfg.dataset.image_size
    rng = np.random.default_rng(SEED)
    if video:
        clips = SyntheticNuScenesVideo(num_clips=2, num_frames=frames,
                                       image_size=(h, w))
        collated = collate_video([clips[0]], cfg, HashTokenizer(), rng=rng)
    else:
        ds = _train_batch(cfg, batch)
        collated = collate_fn([ds[i] for i in range(batch)], cfg,
                              HashTokenizer(), rng=rng)
    host = prepare_batch(collated, "cpu")
    draws = make_draws(torch.Generator().manual_seed(SEED), cfg,
                       batch * frames, N_CAM, (h // 8, w // 8), 1000,
                       frames=frames)
    split = None
    if mesh is not None:
        host = M.shard_batch(host, mesh, N_CAM)
        draws = shard_draws(draws, mesh, N_CAM)
        split = mesh.split(N_CAM, batch * frames // mesh.data, frames)
    draws = {k: None if v is None else v.to(device) for k, v in draws.items()}
    reward = dict(reward_fn=make_rgd_reward(cfg), reward_weight=float(
        cfg.video.rgd.reward_weight)) if video else {}
    cap, flash_min = A.T_SCORE_CAP, A.FLASH_MIN_LEN
    if video:
        A.T_SCORE_CAP = 2 ** 18
    if fusionp:
        A.FLASH_MIN_LEN = 512
    try:
        A.reset_launch_counts()
        loss, _ = make_loss_fn(models, cfg, DiffusionSchedule.create(),
                               (h // 8, w // 8),
                               tuple(cfg.model.get("ors_frame_hw")),
                               frames=frames, split=split, **reward)(
            to_device(host, device), draws)
        loss.backward()
    finally:
        A.T_SCORE_CAP, A.FLASH_MIN_LEN = cap, flash_min
    launches = launch_counts(A)
    grads = _trainable_grads(models)
    loss = loss.detach()
    if mesh is not None:  # a leaf no gradient reached on any rank: None
        # on the device: NCCL reduces no host tensor
        averaged = M.average_gradients({
            k: torch.zeros(trainable[k].shape, device=device) if g is None
            else g.to(device) for k, g in grads.items()})
        grads = {k: None if g is None and not averaged[k].any()
                 else averaged[k].cpu() for k, g in grads.items()}
        loss = M.all_mean(loss)
    return float(loss), grads, launches


def train_reference_readings(device: str = "cuda", video: bool = False,
                             fusionp: bool = False,
                             variants: bool = False) -> dict:
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
    prints the readings).  ``variants``: the tiny ``occ_bg`` set with
    ``VARIANTS_TRAIN`` (the box adapter, the camera token in the time
    embedding, tone guidance's decode under grad)."""
    kinds = dict(video=video, fusionp=fusionp, variants=variants)
    phase = "video_train_reference" if video else \
        "fusionp_train_reference" if fusionp else \
        "variants_train_reference" if variants else "train_reference"
    return gate_row(phase, gate_reading("cpu", fp32=True, **kinds),
                    gate_reading(device, **kinds))


def gate_row(phase: str, cpu, dev) -> dict:
    """The gate's row (``_reference_gate`` reads it) of two
    ``gate_reading`` results: float32 on the CPU and bf16 on the
    device."""
    (loss_cpu, g_cpu, _), (loss_gpu, g_gpu, launches) = cpu, dev
    errs = leaf_grad_errors(g_cpu, g_gpu)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    return {"phase": phase,
            "loss_cpu_f32": loss_cpu, "loss_gpu_bf16": loss_gpu,
            "loss_rel_err": abs(loss_gpu - loss_cpu) / abs(loss_cpu),
            "trainable_leaves": len(errs),
            "leaves_without_grad": sum(g_cpu.get(k) is None for k in errs),
            "worst_leaf_rel_err": dict(worst[:5]), "launches": launches,
            "tol": {"loss_rel_err": LOSS_REL_TOL, "leaf_rel_err": LEAF_TOL,
                    "leaf_floor": LEAF_FLOOR}, "leaf_rel_err": errs}


def _reference_gate(row: dict, kernels, out_of_scope=None) -> None:
    """The loss within ``LOSS_REL_TOL`` relative, every trainable leaf's
    gradient within ``LEAF_TOL``, each of ``kernels`` launched and every
    in-scope call of an sm90-routed wrapper (every call but the
    ``out_of_scope`` ones, {wrapper: calls}) on its sm90 kernel."""
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
    _reference_gate(train_reference_readings(), TRAIN_GATE_KERNELS)


def phase_fusionp(profile_dir):
    """SFA+ (``occ_bg_fusionp``: one ControlNet on the occupancy image with
    per-view boxes and two-stage SFA+) at full SD v1.5 width and 224x400:
    phase 4's generation and phase 6's training step on its config, each
    with its own derived launch counts (SFA+ stage 2 on
    ``flash_attention_fwd`` once per generation, on ``FlashAttention`` once
    per step)."""
    from dualdiff_tpu_torch.utils.config import FUSIONP

    gen = timed("fusionp generate", phase_generate, profile_dir, FUSIONP)
    train = timed("fusionp train", phase_train, profile_dir, FUSIONP)
    return {"fusionp": ("occ_bg_fusionp generation", *gen),
            "fusionp_train": (f"occ_bg_fusionp training run of "
                              f"{1 + TIMED_TRAIN_STEPS} steps", train["run"],
                              train["run_template"])}, \
        {"occ_bg_fusionp": (train["step"], train["step_template"])}


def phase_hd(profile_dir):
    """HD at full SD v1.5 width (phase ``hd``): ``bench.py``'s
    ``BENCH_OVERLAY`` geometries (``configs/exp-hd/256x704.yaml`` and
    ``432x768.yaml``, the flagship otherwise).  For each: phase 4's
    generation (``TIMED_HD_GENERATIONS`` timed calls) with the UNet's,
    VAE's and CLIP's weights through the checkpoint loader
    (``load_sd15_shaped``), and phase 6's training step
    (``TIMED_HD_TRAIN_STEPS`` timed steps), each with its launches derived
    per latent level: the top level (2816 / 5184 tokens, d = 40) over
    ``T_SCORE_CAP`` on the capped routes, the second (704 / 1296 tokens,
    d = 80) on the whole-K ones, every call on the sm90 kernels
    (``check_sm90_launches`` with no call out of scope).  A run that does not fit
    in the card's memory fails the phase and says so."""
    from dualdiff_tpu_torch.utils.config import HD_256X704, HD_432X768

    paths, per_step = {}, {}
    for name in (HD_256X704, HD_432X768):
        geom = name.rsplit("_", 1)[1]
        tag = f"hd_{geom}"
        try:
            gen = timed(f"{tag} generate", phase_generate, profile_dir, name,
                        TIMED_HD_GENERATIONS, True)
            train = timed(f"{tag} train", phase_train, profile_dir, name,
                          TIMED_HD_TRAIN_STEPS)
        except torch.OutOfMemoryError:
            total = torch.cuda.get_device_properties(0).total_memory
            log(f"# {tag}: out of the card's memory ({total / 2 ** 30:.1f} "
                f"GiB; peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
                f" GiB): phase hd fails, nothing is cut to fit")
            raise
        paths[tag] = (f"{geom} generation", *gen)
        paths[f"{tag}_train"] = (f"{geom} training run of "
                                 f"{1 + TIMED_HD_TRAIN_STEPS} steps",
                                 train["run"], train["run_template"])
        per_step[geom] = (train["step"], train["step_template"])
    return paths, per_step


def phase_fusionp_reference():
    """The tiny ``occ_bg_fusionp`` set with SFA+ stage 2 at d = 4 on the
    split-layout kernels: phase 5's generation gate at 224x400 (1400 x
    1400) and phase 7's training gate, the SFA+ leaves included, at 256x128
    with ``FLASH_MIN_LEN`` lowered to 512 (``train_reference_readings``)."""
    phase_reference(fusionp=True)
    # the tiny SFA+ stage 2 (d = 4) is outside the sm90 kernels' scope:
    # every call of the split-layout training wrappers
    split = ("flash_attention_lse_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    row = train_reference_readings(fusionp=True)
    _reference_gate(row, split + (
        "packed_attention_lse_fwd", SM90_LSE, SM90_DQ, SM90_DKV),
        {k: row["launches"][k] for k in split})


def phase_variants(profile_dir):
    """The shipped exp variants at full SD v1.5 width, seeded random
    weights, bf16, 224x400 (``VARIANTS``): the ``+exp=224x400`` baseline
    (one ControlNet on the BEV map, per-view boxes), ``occ_bg_adapter``
    (the box adapter: the ControlNet's attn2 over the 78 text keys on the
    kernels, the box and class tokens on einsum), ``occ_bg_camtemb_fusion``
    (the camera token in the time embedding, SFA) and ``occ_bg_tone`` (the
    MSCN loss through the VAE decode under grad): phase 4's generation and
    phase 6's training step at B = 1 x 6 on each config (no generation for
    tone guidance, a training loss), each with its launches derived for one
    ControlNet and every call on the sm90 kernels, the generations' kernel
    FLOPs equal to ``generate_kernel_flops`` (the adapter's attn2 at
    ``KV_ADAPTER`` keys).  -> (paths, per_step) for ``kernels_line``."""
    from dualdiff_tpu_torch.utils.config import load_config

    paths, per_step = {}, {}
    for name, (gens, steps) in VARIANTS.items():
        cfg = load_config(name)
        tag = _tag(cfg)
        if gens:
            adapter = bool(cfg.get("use_box_adapter", False))
            gen = timed(f"{tag} generate", phase_generate, profile_dir, name,
                        gens, cn_kv=KV_ADAPTER if adapter else KV_CROSS)
            paths[tag] = (f"{cfg.task_id} generation", *gen)
        train = timed(f"{tag} train", phase_train, profile_dir, name, steps,
                      [f"runner.train_batch_size={B_TRAIN}"])
        paths[f"{tag}_train"] = (f"{cfg.task_id} training run of "
                                 f"{1 + steps} steps", train["run"],
                                 train["run_template"])
        per_step[str(cfg.task_id)] = (train["step"], train["step_template"])
    return paths, per_step


def phase_variants_reference():
    """Phase 5's generation gate on the tiny ``+exp=224x400`` set (the
    BEV map resized to the 32x16 latents) and phase 7's training gate on the
    tiny ``occ_bg`` set with ``VARIANTS_TRAIN``: the adapter's and
    ``adm_proj``'s leaves and the tone term's gradient through the decode
    among the leaves held to ``LEAF_TOL``."""
    from dualdiff_tpu_torch.utils.config import BASELINE

    phase_reference(name=BASELINE)
    _reference_gate(train_reference_readings(variants=True), (
        "packed_attention_lse_fwd", "packed_attention_bwd_dq",
        "packed_attention_bwd_dkv", SM90_LSE, SM90_DQ, SM90_DKV))


def option_kernel_cases():
    """The attention shapes attn4's other forms give the kernels at 224x400
    (``attention_levels``: 1400, 350 and 91 tokens a view at d = 40, 80
    and 160), with batched CFG (2 x B samples of ``N_CAM`` views) and,
    under grad, ``B_TRAIN`` samples: -> (inference cases as
    ``kernel_cases``, training cases as ``train_kernel_cases``)."""
    levels = attention_levels((28, 50), (C, 2 * C, 4 * C, 4 * C), HEADS)
    rows, train = 2 * B * N_CAM, B_TRAIN * N_CAM
    fwd = [
        ("packed_attention_fwd", "attn4 add over other pairs: [q; q] over "
         "both neighbours", 2 * rows, L, L, C, HEADS, 0),
        ("packed_attention_capped_fwd", "attn4 concat: both neighbours' "
         "keys", rows, L, 2 * L, C, HEADS, 0),
    ]
    grad = [("attn4 concat under grad", train, L, 2 * L, C, HEADS)]
    for i, (t, d) in enumerate(levels):
        lq = N_CAM * t
        fwd.append((_fwd_kernel(lq, lq), f"attn4 self, level {i}, d={d}",
                    2 * B, lq, lq, d * HEADS, HEADS, 0))
        grad.append((f"attn4 self under grad, level {i}, d={d}", B_TRAIN, lq,
                     lq, d * HEADS, HEADS))
    return fwd, grad


def phase_options(profile_dir):
    """The pipeline's generation options and attn4's other forms at full
    SD v1.5 width (phase ``options``), seeded random weights, bf16,
    224x400, B = 2 x 6 views:

    * on the flagship's model set (``OPTION_GENERATIONS``): DDIM-20,
      UniPC-20 with the ControlNet cache at k = 2 and 3, a per-call
      override (10 steps, guidance 3.5) and views ``PINNED_VIEWS`` pinned
      to the VAE-encoded synthetic images (``encode_mode``), whose
      unpinned views must differ from the same seed's unpinned call;
    * attn4's forms and connectors (``OPTION_ATTN4``): a generation each
      and, for ``self`` and ``add`` over other pairs, a training step
      (phase 6's checks, ``TIMED_OPTION_STEPS`` timed steps);
    * every attention shape those forms give the kernels
      (``option_kernel_cases``: the sm90 forward at 4 x 8400 x 8400, the
      templates at d = 160 among them), each held to its plain version at
      phase 3's tolerance and timed from a CUDA graph beside its bound and
      SDPA's fastest dispatch.

    Each generation's launches equal ``generate_launches_per_generation``
    with its attn4 form, cache and steps, its kernel FLOPs
    ``generate_kernel_flops``; each step's ``train_launches_per_step``.
    Alone: ``python3 -c "import chip_smoke as s; s.phase_device();
    s.phase_build(); s.phase_options(None)"``.  -> (paths, per_step, kernel
    rows) for ``kernels_line``."""
    from dualdiff_tpu_torch.ops import attention as A

    rows = {}
    clock_hz = sm_clock_hz()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    fwd_cases, grad_cases = option_kernel_cases()
    for case in fwd_cases:
        for kern, row in forward_kernel_rows(A, g, *case,
                                             clock_hz=clock_hz).items():
            rows.setdefault(kern, []).append(row)
    for case in grad_cases:
        for kern, row in train_kernel_rows(A, g, *case,
                                           clock_hz=clock_hz).items():
            rows.setdefault(kern, []).append(row)
        torch.cuda.empty_cache()
    # the flagship's models live only inside this call, so that the forms'
    # peaks do not hold them
    paths, per_step = _option_generations(), {}
    torch.cuda.empty_cache()
    for tag, (extra, train) in OPTION_ATTN4.items():
        gen_counts = timed(f"{tag} generate", phase_generate, profile_dir,
                           None, TIMED_OPTION_CALLS, cn_kv=KV_CROSS,
                           extra=extra)
        paths[tag] = (f"{tag} generation", *gen_counts)
        if train:
            step = timed(f"{tag} train", phase_train, profile_dir, None,
                         TIMED_OPTION_STEPS,
                         extra + [f"runner.train_batch_size={B_TRAIN}"])
            paths[f"{tag}_train"] = (f"{tag} training run of "
                                     f"{1 + TIMED_OPTION_STEPS} steps",
                                     step["run"], step["run_template"])
            per_step[tag] = (step["step"], step["step_template"])
    return paths, per_step, rows


def _option_generations() -> dict:
    """Phase ``options``' generations on the flagship's model set:
    ``OPTION_GENERATIONS`` and the views ``PINNED_VIEWS`` given, each
    through ``run_generations``; the pinned call's unpinned views must
    differ from the same seed's unpinned call.  -> {tag: (unit, launches,
    those on the templates)}."""
    from dualdiff_tpu_torch.pipeline.bev_controlnet import \
        BEVControlNetPipeline
    from dualdiff_tpu_torch.runner.conds import prepare_batch
    from dualdiff_tpu_torch.utils.config import FLAGSHIP, load_config

    t0 = time.perf_counter()
    _, batch, pipe = _flagship("cuda")
    models = pipe.models
    gen = torch.Generator(device="cuda")
    unpinned = pipe(batch, generator=gen.manual_seed(SEED))
    log(f"# options: models built, unpinned reference in "
        f"{time.perf_counter() - t0:.1f} s")
    paths = {}
    for tag, (extra, call) in OPTION_GENERATIONS.items():
        opt = BEVControlNetPipeline(load_config(FLAGSHIP, extra), models,
                                    device="cuda")
        counts, template, _, _ = timed(
            tag, run_generations, opt, batch, tag, TIMED_OPTION_CALLS,
            KV_CROSS, **call)
        paths[tag] = (f"{tag} generation", counts, template)
    # given views: the synthetic images through the VAE encoder's mode
    t = prepare_batch(batch, pipe.device)
    px = t["pixel_values"]
    with torch.no_grad():
        lat = models["vae"].encode_mode(
            px.reshape(-1, *px.shape[2:]).permute(0, 3, 1, 2)
            .to(models["dtype"]))
    lat = lat.float().reshape(B, N_CAM, *lat.shape[1:]).permute(0, 1, 3, 4,
                                                                2)
    mask = torch.zeros(B, N_CAM, device=pipe.device)
    mask[:, list(PINNED_VIEWS)] = 1.0
    counts, template, _, pinned = timed(
        "pinned", run_generations, pipe, t, "pinned", TIMED_OPTION_CALLS,
        KV_CROSS, conditional_latents=lat, conditional_mask=mask)
    paths["pinned"] = ("pinned generation", counts, template)
    free = [n for n in range(N_CAM) if n not in PINNED_VIEWS]
    moved = (pinned[:, free] - unpinned[:, free]).abs().max().item()
    log(json.dumps({"phase": "pinned views", "views": list(PINNED_VIEWS),
                    "unpinned_views_max_abs_change": moved}))
    if not moved > 1e-6:
        raise AssertionError("pinning did not move the unpinned views")
    return paths


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


def phase_cache(profile_dir):
    """The flagship training step at ``bench.py``'s training point (phase
    ``cache``): ``B_CACHE`` x 6 views, the conditioning cache on, seeded
    random weights, bf16, remat, AdamW.

    1. The first planned batch through the uncached loss (its raw batch)
       and the cached one with the same draws, forward only: the losses
       within ``CACHE_LOSS_RTOL``.
    2. ``run()`` over ``CACHE_EPOCHS`` epochs of ``CACHE_SAMPLES`` samples
       (the cache emptied first): the precompute runs once a batch in the
       first epoch and never after, and every later epoch is served each
       sample's first-epoch moments and rays bit for bit.
    3. Every step's launches equal ``train_launches_per_step``
       (``check_sm90_launches`` too), with a finite loss and grad_norm > 0.
    4. s/step (median of the steps after the first epoch), images/s, peak
       GiB (after the first epoch) and the cache's MB.

    -> as ``phase_train``."""
    import numpy as np

    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.runner.conds import prepare_batch
    from dualdiff_tpu_torch.runner.factory import (build_models,
                                                   randomize_weights)
    from dualdiff_tpu_torch.runner.train_state import named_roots
    from dualdiff_tpu_torch.runner.trainer import (MultiviewTrainer,
                                                   make_draws, make_loss_fn)
    from dualdiff_tpu_torch.utils.config import load_config

    t0 = time.perf_counter()
    cfg = load_config(overrides=["runner.cache_conditioning=true",
                                 f"runner.train_batch_size={B_CACHE}"])
    models = build_models(cfg, device="cuda")
    for _, m in named_roots(models):
        randomize_weights(m, SEED)
    ds = _train_batch(cfg, CACHE_SAMPLES)
    trainer = MultiviewTrainer(cfg, ds, models=models)
    torch.cuda.synchronize()
    log(f"# cached training built in {time.perf_counter() - t0:.1f} s")

    epoch, i, idxs = plan = next(trainer._batch_plan(0))
    rng = np.random.default_rng([int(cfg.seed), epoch, i])
    raw = prepare_batch(trainer._collate_items([ds[j] for j in idxs], rng),
                        trainer.device)
    cached = trainer._build_batch(plan)
    draws = make_draws(trainer.generator, cfg, B_CACHE, N_CAM,
                       trainer.latent_hw, trainer.schedule.num_train_timesteps,
                       trainer.device)
    uncached_fn = make_loss_fn(models, cfg, trainer.schedule,
                               trainer.latent_hw, trainer.image_hw)
    with torch.no_grad():
        want = float(uncached_fn(raw, draws)[0])
        got = float(trainer.loss_fn(cached, draws)[0])
    rel = abs(got - want) / abs(want)
    log(f"# cached loss {got!r}, uncached {want!r}: {rel:.3e} relative "
        f"(limit {CACHE_LOSS_RTOL})")
    if not rel <= CACHE_LOSS_RTOL:
        raise AssertionError(f"cached loss {got} against uncached {want}")
    del raw, cached

    trainer._cond_cache.clear()
    trainer._cond_cache_bytes = 0
    calls = [0]
    precompute, build = trainer._precompute, trainer._build_batch

    def counting(batch):
        calls[0] += 1
        return precompute(batch)

    served = [{} for _ in range(CACHE_EPOCHS)]

    def recording(plan):
        batch = build(plan)
        for row, j in enumerate(plan[2]):
            served[plan[0]][j] = (batch["latent_moments"][row].cpu(),
                                  batch["ors_rays"][row].cpu())
        return batch

    trainer._precompute, trainer._build_batch = counting, recording
    layers = len(models["unet"].down_blocks[0].resnets)
    h, w = cfg.dataset.image_size
    derive = functools.partial(
        train_launches_per_step, layers, len(models["controlnets"]),
        bool(cfg.runner.enable_unet_checkpointing)
        and bool(cfg.runner.enable_controlnet_checkpointing),
        model_levels(models["unet"], (h // 8, w // 8)))
    expect, template = derive(), derive(template_only=True)
    spe = trainer.steps_per_epoch
    first_epoch_calls, steps = [], []
    run_counts = dict.fromkeys(launch_counts(A), 0)

    def on_metrics(step, m):
        counts = launch_counts(A)
        A.reset_launch_counts()
        for k, v in counts.items():
            run_counts[k] += v
        log(f"# cached train step {step}: loss {m['loss']:.6f}, grad_norm "
            f"{m['grad_norm']:.6f}, {m['step_time_s']:.3f} s (batch "
            f"assembly {m['data_time_s']:.3f} s), precompute calls "
            f"{calls[0]}")
        if _wrappers(counts) != expect:
            raise AssertionError(f"kernel launches {counts} != {expect}")
        check_sm90_launches(counts, template)
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                and m["grad_norm"] > 0):
            raise AssertionError(f"step {step}: {m}")
        steps.append(m)
        if step == spe:
            first_epoch_calls.append(calls[0])
            torch.cuda.reset_peak_memory_stats()

    A.reset_launch_counts()
    trainer.run(CACHE_EPOCHS * spe, on_metrics)
    if first_epoch_calls != [spe] or calls[0] != spe:
        raise AssertionError(f"precompute calls: {first_epoch_calls} in the "
                             f"first epoch, {calls[0]} in all, not {spe}")
    for e in range(1, CACHE_EPOCHS):
        if set(served[e]) != set(served[0]) or not all(
                torch.equal(a, b) for j in served[0]
                for a, b in zip(served[e][j], served[0][j])):
            raise AssertionError(f"epoch {e} was not served the first "
                                 f"epoch's entries bit for bit")
    times = sorted(m["step_time_s"] for m in steps[spe:])
    s = times[len(times) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cache_mb = trainer._cond_cache_bytes / 2 ** 20
    row = {"phase": "cache", "config": f"{cfg.task_id} {h}x{w}, "
           f"runner.cache_conditioning=true", "batch": B_CACHE,
           "views": N_CAM, "steps": len(steps),
           "cached_loss": got, "uncached_loss": want,
           "loss_rel_err": rel, "precompute_calls": calls[0],
           "s_per_step": s, "s_per_step_all": [m["step_time_s"]
                                              for m in steps],
           "images_per_s": B_CACHE * N_CAM / s, "peak_mem_gib": peak,
           "cache_entries": len(trainer._cond_cache), "cache_mb": cache_mb,
           "loss": [m["loss"] for m in steps],
           "launches_per_step": expect, "launches_run": run_counts}
    log(json.dumps(row))
    log(f"cache s/step: {s}")
    log(f"cache train images/s: {B_CACHE * N_CAM / s}")
    log(f"cache peak GiB: {peak}")
    log(f"cache MB: {cache_mb}")
    if profile_dir:
        batch = build(next(trainer._batch_plan(0)))
        profile_run(lambda: trainer.train_step(batch), s, profile_dir,
                    "cache_train_step")
    del trainer, models
    torch.cuda.empty_cache()
    return {"run": run_counts, "step": expect, "step_template": template,
            "run_template": {k: v * len(steps) for k, v in template.items()}}


def phase_bench() -> dict:
    """``python -m dualdiff_tpu_torch.bench`` with ``BENCH_ENV`` in a
    subprocess (phase ``bench``); its sections' output goes to the log.
    Checks the line: the headline (frames/s) and the training section's
    value above 0, each ``0 < mfu_corrected <= 1`` against the card's
    bf16 peak (``utils.flops.device_peak_flops``: this card must have
    one), the numerics pin ``ok``, and the generation's recorded kernel
    FLOPs and launches equal to ``generate_kernel_flops`` and
    ``generate_launches_per_generation`` at the bench's point.  -> the
    line."""
    from dualdiff_tpu_torch.runner.factory import build_models
    from dualdiff_tpu_torch.utils.config import load_config
    from dualdiff_tpu_torch.utils.flops import device_peak_flops

    if device_peak_flops() is None:
        raise AssertionError(f"no bf16 peak for "
                             f"{torch.cuda.get_device_name(0)}")
    torch.cuda.empty_cache()
    env = dict(os.environ, **BENCH_ENV)
    env.pop("BENCH_MODE", None)
    p = subprocess.run([sys.executable, "-m", "dualdiff_tpu_torch.bench"],
                       env=env, cwd=os.path.dirname(os.path.abspath(
                           __file__)), capture_output=True, text=True,
                       timeout=900)
    for text in (p.stderr, p.stdout):
        for ln in (text or "").strip().splitlines():
            log(f"#   bench: {ln}")
    if p.returncode != 0:
        raise AssertionError(f"the bench exited {p.returncode}")
    line = json.loads(p.stdout.strip().splitlines()[-1])
    det = line["detail"]
    train = det["train"]
    for name, sec in (("gen", line), ("train", train)):
        u = (sec["detail"] if sec is line else sec).get("mfu_corrected")
        if not (sec.get("value") or 0) > 0 or u is None or not 0 < u <= 1:
            raise AssertionError(f"bench {name}: value {sec.get('value')}, "
                                 f"mfu_corrected {u}")
    if det["numerics_pin"]["status"] != "ok":
        raise AssertionError(f"numerics pin: {det['numerics_pin']}")
    cfg = load_config()
    h, w = cfg.dataset.image_size
    unet = build_models(cfg, device="meta")["unet"]
    levels = model_levels(unet, (h // 8, w // 8))
    layers, n_cn = len(unet.down_blocks[0].resnets), 2
    steps = int(cfg.runner.pipeline_param.num_inference_steps)
    flops = generate_kernel_flops(layers, n_cn, steps, levels,
                                  unet.block_out_channels, 2 * B * N_CAM)
    launches = generate_launches_per_generation(layers, n_cn, steps, levels)
    want = {k: v for k, v in launches.items() if v}
    if det["kernel_flops"] != sum(flops.values()) or det["launches"] != want:
        raise AssertionError(f"bench kernel FLOPs {det['kernel_flops']} "
                             f"and launches {det['launches']}, derived "
                             f"{sum(flops.values())} and {want}")
    log(json.dumps({"phase": "bench", "line": line}))
    log(f"bench frames/s: {line['value']}, mfu_corrected "
        f"{det['mfu_corrected']}; train images/s: {train['value']}, "
        f"mfu_corrected {train['mfu_corrected']}")
    return line


def package_probe() -> dict:
    """{package: whether it imports here} for the packages the port does
    not assume (``OPTIONAL_PACKAGES``)."""
    import importlib

    out = {}
    for name in OPTIONAL_PACKAGES:
        try:
            importlib.import_module(name)
            out[name] = True
        except Exception:  # absent, or broken on import: not there
            out[name] = False
    return out


def _tool(name: str, args, timeout: int = TOOLS_TIMEOUT):
    """``python -m dualdiff_tpu_torch.tools.<name> <args>`` in a
    subprocess from the checkout's root, its output to the log.  Raises on
    a non-zero exit and on a logged validation failure.  -> (its standard
    output, then its standard error; wall seconds)."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", f"dualdiff_tpu_torch.tools."
                        f"{name}", *args], cwd=os.path.dirname(
                            os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    for text in (p.stderr, p.stdout):
        for ln in (text or "").strip().splitlines():
            log(f"#   {name}: {ln}")
    if p.returncode != 0:
        raise AssertionError(f"tools.{name} exited {p.returncode}")
    if "validation failed" in (p.stderr or "") + (p.stdout or ""):
        raise AssertionError(f"tools.{name} logged a failed validation")
    return (p.stdout or "") + (p.stderr or ""), wall


def _printed_launches(stdout: str) -> list:
    """The ``launches {...}`` lines the test and val_set_gen tools print,
    one per generation."""
    return [json.loads(ln.split(" ", 1)[1]) for ln in stdout.splitlines()
            if ln.startswith("launches ")]


def _check_launches(counts: dict, expect: dict, what: str) -> None:
    got = _launches(**{k: v for k, v in counts.items() if k in REPLACES})
    if got != expect:
        raise AssertionError(f"{what}: kernel launches {counts} != {expect}")
    check_sm90_launches(counts)


def _add(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _differs(a: dict, b: dict) -> list:
    """Names whose tensors are not equal bit for bit (on the host)."""
    return [k for k in a if not torch.equal(a[k].cpu(), b[k].cpu())]


def _max_diff(a: dict, b: dict) -> float:
    return max((float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a),
               default=0.0)


def phase_tools():
    """A training run through the port's own entry points at full SD v1.5
    width (the flagship, 224x400, bf16, seeded random weights), in a
    temporary directory that it deletes (free disk checked first against
    the reckoned bytes):

    1. ``tools.train`` (``TOOLS_ARGS``: runner=debug, 4 micro-steps at
       ``gradient_accumulation_steps=2``, checkpoints at 2 and 4, a
       validation at 4) in a subprocess: ``checkpoint-2`` and
       ``checkpoint-4`` with ``count`` 1 and 2, four finite
       ``metrics.jsonl`` lines, the 448 x 1200 validation grid, the export
       directories, no logged validation failure.
    2. Resume in this process: a fresh trainer loads ``checkpoint-2`` and
       runs steps 3-4; its masters must equal ``checkpoint-4``'s bit for
       bit.  Where they do not, the same two steps run twice more from
       ``checkpoint-2``: if those two differ too, the card is not
       deterministic there and the resumed masters must lie within 4x the
       spread of the repeats (logged as such); else the phase fails.
       Times the load and reads the step's peak with the accumulators
       (the saves' and the export's bytes and seconds come from the train
       tool's log).
    3. The export through ``load_pretrained_dir`` into a fresh full-width
       model set: no unknown key, nothing missing, every tensor equal to
       the exported one, the trainables equal to ``checkpoint-4``'s
       masters.
    4. ``tools.test`` from ``checkpoint-4``: the 448 x 1200 grid.
    5. ``tools.val_set_gen`` over ``TOOLS_VAL_SAMPLES`` samples with
       ``gen_naming=original``: every JPEG's frame header 900 x 1600
       (``back_resize`` 896 x 1600 plus ``back_pad``'s 4 rows); a rerun
       skips both samples and rewrites no file.
    6. Every micro-step's launches (the subprocess's and the resumed
       ones) equal ``train_launches_per_step``, every generation's (the
       validation, the test tool's, val_set_gen's) equal
       ``generate_launches_per_generation`` at runner=debug's steps, each
       through ``check_sm90_launches``.

    -> (launches of the whole phase, one micro-step's derivation)."""
    import shutil
    import statistics
    import tempfile

    from dualdiff_tpu_torch.data.wrappers import build_dataset
    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.runner.factory import build_models
    from dualdiff_tpu_torch.runner.train_state import (partition_params,
                                                       trainable_predicate)
    from dualdiff_tpu_torch.runner.trainer import (CHECKPOINT_FILE,
                                                   EXPORT_FILE,
                                                   MultiviewTrainer)
    from dualdiff_tpu_torch.runner.weights import (from_diffusers,
                                                   load_pretrained_dir,
                                                   read_checkpoint)
    from dualdiff_tpu_torch.utils.config import compose
    from dualdiff_tpu_torch.utils.image_io import jpeg_size, read_png

    cfg, _ = compose(TOOLS_ARGS)
    r = cfg.runner
    k = int(r.gradient_accumulation_steps)
    h, w = cfg.dataset.image_size
    tiny = bool(cfg.get("tiny_models", False))  # a CPU rehearsal's
    meta = build_models(cfg, tiny=tiny, device="meta")
    trainable, _ = partition_params(meta, trainable_predicate(
        str(cfg.model.unet.trainable_state),
        bool(cfg.model.controlnet.bbox_embedder_param.get(
            "trainable_class_token", False))))
    n_t = sum(p.numel() for p in trainable.values())
    mu_bytes = 2 if str(r.adam_mu_dtype) == "bf16" else 4
    ckpt_bytes = n_t * (4 + mu_bytes + 4 + (4 if k > 1 else 0))
    export_bytes = 4 * sum(p.numel() for m in (meta["unet"],
                                               *meta["controlnets"])
                           for p in m.parameters())
    need = 2 * ckpt_bytes + export_bytes
    layers = len(meta["unet"].down_blocks[0].resnets)
    levels = model_levels(meta["unet"], (h // 8, w // 8))
    remat = bool(r.enable_unet_checkpointing) and bool(
        r.enable_controlnet_checkpointing)
    step_want = train_launches_per_step(layers, len(meta["controlnets"]),
                                        remat, levels,
                                        attn4=attn4_form(meta["unet"]))
    gen_want = generate_launches_per_generation(
        layers, len(meta["controlnets"]),
        int(r.pipeline_param.num_inference_steps), levels)
    del meta, trainable
    total: dict = {}
    row = {"phase": "tools", "config": " ".join(TOOLS_ARGS),
           "trainable_params": n_t, "reckoned_checkpoint_bytes": ckpt_bytes,
           "reckoned_export_bytes": export_bytes}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    try:
        free = shutil.disk_usage(tmp).free
        row["disk_free_bytes"] = free
        log(f"# tools: {tmp}, {free / 1e9:.1f} GB free, {need / 1e9:.1f} GB "
            f"reckoned ({n_t / 1e6:.1f}M trainables: a checkpoint "
            f"{ckpt_bytes / 1e9:.2f} GB, the export {export_bytes / 1e9:.2f}"
            f" GB)")
        if free < 1.1 * need:
            raise AssertionError(f"{free} bytes free in {tmp}: under the "
                                 f"{need} bytes the run writes, and 10%")
        torch.cuda.empty_cache()
        run = os.path.join(tmp, "run")

        # 1. the train tool
        log_text, row["train_tool_s"] = _tool("train", TOOLS_ARGS
                                              + [f"log_root={run}"])
        saves = re.findall(r"saved checkpoint \S+ \((\d+) bytes, ([\d.]+) s\)",
                           log_text)
        export = re.findall(r"exported \S+ \((\d+) bytes, ([\d.]+) s\)",
                            log_text)
        if len(saves) != 2 or len(export) != 1:
            raise AssertionError(f"train tool: saves {saves}, export "
                                 f"{export}")
        row["checkpoint_bytes"] = int(saves[0][0])
        row["save_s"] = [float(t) for _, t in saves]
        row["export_bytes"], row["export_s"] = int(export[0][0]), float(
            export[0][1])
        states = {}
        for step in (2, 4):
            path = os.path.join(run, f"checkpoint-{step}", CHECKPOINT_FILE)
            states[step] = torch.load(path, map_location="cpu",
                                      weights_only=True, mmap=True)
            opt = states[step]["optimizer"]
            if (states[step]["step"], opt["count"], opt["mini_step"]) != (
                    step, step // k, 0):
                raise AssertionError(f"checkpoint-{step}: step "
                                     f"{states[step]['step']}, count "
                                     f"{opt['count']}, mini_step "
                                     f"{opt['mini_step']}")
            row[f"checkpoint_{step}_bytes"] = os.path.getsize(path)
        with open(os.path.join(run, "metrics.jsonl")) as f:
            lines = [json.loads(ln) for ln in f]
        if [ln["step"] for ln in lines] != [1, 2, 3, 4] or not all(
                math.isfinite(ln[f"train/{m}"]) for ln in lines
                for m in ("loss", "grad_norm")):
            raise AssertionError(f"metrics.jsonl: {lines}")
        for ln in lines:
            _check_launches(ln["launches"], step_want,
                            f"train tool step {ln['step']}")
            _add(total, ln["launches"])
        row["tool_s_per_micro_step"] = [ln["train/step_time_s"]
                                        for ln in lines]
        row["loss"] = [ln["train/loss"] for ln in lines]
        val_dir = os.path.join(run, "val", "step-4")
        grid = read_png(os.path.join(val_dir, "0_gen0.png"))
        if grid.shape != (2 * h, 3 * w, 3):
            raise AssertionError(f"validation grid {grid.shape}")
        with open(os.path.join(val_dir, "launches.json")) as f:
            val_launches = json.load(f)
        _check_launches(val_launches, gen_want, "validation generation")
        _add(total, val_launches)
        cdirs = list(cfg.model.controlnet_dir)
        exports = {f"controlnet_{i}": d for i, d in enumerate(cdirs)}
        exports["unet"] = str(cfg.model.unet_dir)
        for d in exports.values():
            if not os.path.exists(os.path.join(run, d, EXPORT_FILE)):
                raise AssertionError(f"no export in {d}")

        # 2. resume in this process
        rcfg, _ = compose(TOOLS_ARGS + [f"log_root={run}",
                                        "runner.checkpointing_steps=0"])
        trainer = MultiviewTrainer(rcfg, build_dataset(rcfg, "train"),
                                   device=rcfg.get("device"))
        ckpt2 = os.path.join(run, "checkpoint-2")
        resumed_steps = []

        def on_metrics(step, m):
            counts = launch_counts(A)
            A.reset_launch_counts()
            _check_launches(counts, step_want, f"resumed step {step}")
            _add(total, {k_: v for k_, v in counts.items() if v})
            resumed_steps.append(m["step_time_s"])

        def resume():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.load_checkpoint(ckpt2)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            A.reset_launch_counts()
            trainer.run(4, on_metrics)
            return load_s, {n: v.to("cpu", copy=True)
                            for n, v in trainer.optimizer.master.items()}

        row["load_s"], got = resume()
        row["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        want = states[4]["optimizer"]["master"]
        differ = _differs(got, want)
        row["resumed_masters_differ"] = len(differ)
        if differ:
            log(f"# tools: resumed masters differ from checkpoint-4's in "
                f"{len(differ)} of {len(got)} tensors (max "
                f"{_max_diff(got, want):.3e}); two more runs from "
                f"checkpoint-2")
            _, a = resume()
            _, b = resume()
            spread = _max_diff(a, b)
            row["repeat_spread"] = spread
            row["resumed_max_diff"] = _max_diff(got, want)
            if spread == 0.0:
                raise AssertionError(
                    f"the card repeats steps 3-4 bit for bit, but the "
                    f"resumed masters differ from checkpoint-4's: "
                    f"{differ[:5]}")
            log(f"# tools: NOT DETERMINISTIC on this card: two runs of "
                f"steps 3-4 from checkpoint-2 differ by up to {spread:.3e}")
            if row["resumed_max_diff"] > 4 * spread:
                raise AssertionError(
                    f"resumed masters off checkpoint-4's by "
                    f"{row['resumed_max_diff']} beyond 4x the card's "
                    f"repeat spread {spread}")
        row["resume_bit_equal"] = not differ
        row["resumed_s_per_micro_step"] = resumed_steps[:2]
        shutil.rmtree(ckpt2)
        del trainer, got, states[2]
        torch.cuda.empty_cache()

        # 3. the export round trip
        fresh = build_models(cfg, tiny=tiny,
                             device=cfg.get("device") or "cuda")
        report = load_pretrained_dir(fresh, run)
        nets = {"unet": fresh["unet"], **{
            f"controlnet_{i}": cn for i, cn in enumerate(fresh["controlnets"])}}
        for key, module in nets.items():
            info = report[key]
            if info is None or not info["file"].endswith(
                    os.path.join(exports[key], EXPORT_FILE)) \
                    or info["missing"]:
                raise AssertionError(f"export of {key}: {info}")
            src = from_diffusers(read_checkpoint(info["file"]),
                                 "unet" if key == "unet" else "controlnet")
            own = module.state_dict()
            if set(src) != set(own) or _differs(src, own):
                raise AssertionError(f"export of {key} did not load back "
                                     f"bit for bit")
            masters = {n.split("/", 1)[1]: v for n, v in want.items()
                       if n.startswith(key + "/")}
            if _differs(masters, {n: src[n] for n in masters}):
                raise AssertionError(f"export of {key}: trainables differ "
                                     f"from checkpoint-4's masters")
        row["export_tensors"] = {k_: len(m.state_dict())
                                 for k_, m in nets.items()}
        del fresh, nets, states, want
        torch.cuda.empty_cache()

        # 4. the test tool
        out, row["test_tool_s"] = _tool("test", [
            f"resume_from_checkpoint={run}/checkpoint-4",
            f"log_root={os.path.join(tmp, 'test')}",
            "runner.validation_index=[0]"])
        printed = _printed_launches(out)
        if len(printed) != 1:
            raise AssertionError(f"test tool: {len(printed)} generations")
        _check_launches(printed[0], gen_want, "test tool generation")
        _add(total, printed[0])
        grid = read_png(os.path.join(tmp, "test", "test_out", "0_gen.png"))
        if grid.shape != (2 * h, 3 * w, 3):
            raise AssertionError(f"test tool grid {grid.shape}")

        # 5. val_set_gen
        vsg = os.path.join(tmp, "vsg")
        args = TOOLS_ARGS + [f"resume_from_checkpoint={run}/checkpoint-4",
                             f"log_root={vsg}", "gen_naming=original",
                             f"dataset.num_samples={TOOLS_VAL_SAMPLES}"]
        out, row["val_set_gen_s"] = _tool("val_set_gen", args)
        printed = _printed_launches(out)
        if len(printed) != TOOLS_VAL_SAMPLES:
            raise AssertionError(f"val_set_gen: {len(printed)} generations")
        for c in printed:
            _check_launches(c, gen_want, "val_set_gen generation")
            _add(total, c)
        samples = os.path.join(vsg, "val_set_gen", "samples")
        files = sorted(os.path.join(samples, cam, f)
                       for cam in os.listdir(samples)
                       for f in os.listdir(os.path.join(samples, cam)))
        back = tuple(a + b for a, b in zip(
            cfg.dataset.back_resize, (cfg.dataset.back_pad[1]
                                      + cfg.dataset.back_pad[3],
                                      cfg.dataset.back_pad[0]
                                      + cfg.dataset.back_pad[2])))
        sizes = {jpeg_size(f) for f in files}
        if len(files) != TOOLS_VAL_SAMPLES * N_CAM or sizes != {back} \
                or not all(f.endswith(".jpg") for f in files):
            raise AssertionError(f"val_set_gen wrote {len(files)} files of "
                                 f"{sizes}, want {back}")
        mtimes = {f: os.path.getmtime(f) for f in files}
        out, row["val_set_gen_rerun_s"] = _tool("val_set_gen", args)
        if f"0 generated, {TOOLS_VAL_SAMPLES} skipped" not in out or any(
                os.path.getmtime(f) != t for f, t in mtimes.items()):
            raise AssertionError("val_set_gen's rerun did not skip")
        row["val_set_gen_files"] = len(files)
        row["jpeg_size"] = list(back)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row["s_per_micro_step"] = statistics.median(
        row["tool_s_per_micro_step"][1:] + row["resumed_s_per_micro_step"])
    row["launches_per_micro_step"] = step_want
    row["launches_per_generation"] = gen_want
    total = {**dict.fromkeys(list(REPLACES) + list(SM90_ROUTES), 0), **total}
    row["launches_run"] = total
    log(json.dumps(row))
    log(f"tools s/micro-step (k = {k}): {row['s_per_micro_step']}")
    log(f"tools peak GiB with the accumulators: {row['peak_mem_gib']}")
    log(f"tools checkpoint bytes {row['checkpoint_bytes']}, save "
        f"{row['save_s']} s, load {row['load_s']:.2f} s; export bytes "
        f"{row['export_bytes']}, {row['export_s']:.2f} s")
    return total, step_want


# phase nuscenes: the set it writes (create_data.py's schema), two train
# scenes of 3 samples and one val scene of 2
NUSC_SPLITS = {"train": (("scene-0001", 3), ("scene-0002", 3)),
               "val": (("scene-0003", 2),)}
NUSC_CAMS = ("CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
             "CAM_BACK_RIGHT", "CAM_BACK", "CAM_BACK_LEFT")
NUSC_WORKERS = (0, 2)  # runner.num_workers timed for the batch build
NUSC_DECODE_MEAN = 0.03  # tests/test_native.py's bound, native vs PIL
INCEPTION_TOL = 1e-4  # card vs CPU pool3, of the largest activation
INCEPTION_BATCH, I3D_BATCH, I3D_FRAMES, FVD_CLIPS = 16, 4, 16, 4
TIMED_METRIC_CALLS = 5  # Inception and I3D calls timed (cuda_ms)
# words laid over phase nuscenes' (a CPU rehearsal adds tiny_models=true,
# device=cpu and a small image size)
NUSC_ARGS: list = []
# phase explore: the explore tools' words (the explore preset on the
# flagship, synthetic data) and the tolerance of a probability row's sum
EXPLORE_ARGS = ["--config-name", "explore_config",
                "+exp=dual_branch_augloss_fusion",
                "dataset=Nuscenes_synthetic"]
EXPLORE_ROW_TOL = 1e-3
# phase ddp: two ranks on the one card over gloo, one row each of a global
# batch of DDP_B; the generation gate (phase 5's) on each row
DDP_RANKS = DDP_B = 2
DDP_TIMEOUT = 900
GEN_MEAN_TOL = 1e-2
# (label, tiny, config overrides) of the generations phase ddp holds
DDP_GENERATIONS = (("224x400", False, ()),
                   ("tiny_256x128", True, ("dataset.image_size=[256, 128]",
                                           "runner.pipeline_param."
                                           "num_inference_steps=20")))
# phase ddp's splits: the (1, 2) mesh, 3 of the 6 cameras a rank, and one
# clip of SPLIT_FRAMES frames over the 2 data ranks, 2 frames a rank
SPLIT_FRAMES = 4
# what one phase leaves for a later one in the same process
KEPT = {}


def toolchain_probe() -> dict:
    """{g++, make, jpeglib.h: whether each is there}: the native binding's
    build needs g++ and libjpeg's header."""
    import shutil

    gxx = shutil.which("g++")
    out = {"g++": gxx is not None, "make": shutil.which("make") is not None,
           "jpeglib.h": False}
    if gxx:
        p = subprocess.run([gxx, "-E", "-x", "c++", "-"],
                           input="#include <jpeglib.h>\n", text=True,
                           capture_output=True, timeout=60)
        out["jpeglib.h"] = p.returncode == 0
    return out


def write_nuscenes_set(root: str, image_size=(224, 400)) -> list:
    """A small nuScenes-format set under ``root``, written with the port's
    own code: the infos pkls in ``tools/create_data.py``'s schema
    (``NUSC_SPLITS``; geometry, boxes and captions from the seeded
    synthetic samples), six 1600 x 900 camera frames (JPEGs written by
    ``utils.image_io.write_jpeg``, quality 90), one per camera, copied into
    every sample; per token an ``occ_proj`` ``.npy`` panorama
    (``image_size`` a view),
    an Occ3D ``labels.npz`` of 200 x 200 x 16 and 40-point map vectors
    (x, y) in a ``.pkl``.  -> the roots as ``compose`` words."""
    import pickle
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes
    from dualdiff_tpu_torch.utils.config import load_config
    from dualdiff_tpu_torch.utils.image_io import write_jpeg

    classes = list(load_config().dataset.object_classes)
    dirs = {d: os.path.join(root, d) for d in ("nusc", "infos", "occ_proj",
                                               "occ3d", "map_vec")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    yy, xx = np.mgrid[0:900, 0:1600]

    def frame(c):
        base = np.stack([128 + 90 * np.sin(xx / (40.0 + 9 * c) + k)
                         * np.cos(yy / (30.0 + 5 * c)) for k in range(3)], -1)
        noise = np.random.default_rng(SEED + c).normal(0, 12, base.shape)
        path = os.path.join(root, f"frame{c}.jpg")
        write_jpeg(path, np.clip(base + noise, 0, 255).astype(np.uint8),
                   quality=90)
        return path

    with ThreadPoolExecutor(len(NUSC_CAMS)) as ex:
        frames = list(ex.map(frame, range(len(NUSC_CAMS))))
    geometry = SyntheticNuScenes(num_samples=8, image_size=image_size,
                                 seed=SEED)
    rng = np.random.default_rng(SEED)
    i = 0
    for split, scenes in NUSC_SPLITS.items():
        infos = []
        for scene, n in scenes:
            for k in range(n):
                s, tok = geometry[i], f"{scene}-{k:02d}"
                cams = {}
                for c, cam in enumerate(NUSC_CAMS):
                    rel = os.path.join("samples", cam, tok + ".jpg")
                    os.makedirs(os.path.dirname(os.path.join(
                        dirs["nusc"], rel)), exist_ok=True)
                    shutil.copyfile(frames[c], os.path.join(dirs["nusc"], rel))
                    cams[cam] = {
                        "data_path": rel,
                        "cam_intrinsic": s["camera_intrinsics"][c, :3, :3]
                        .astype(np.float64),
                        "sensor2lidar_rotation": s["camera2lidar"][c, :3, :3]
                        .astype(np.float64),
                        "sensor2lidar_translation": s["camera2lidar"][c, :3, 3]
                        .astype(np.float64)}
                e2g = np.eye(4)
                e2g[:3, 3] = (600.0 + 10 * i, 1600.0, 0.0)
                infos.append({
                    "token": tok, "scene": scene,
                    "timestamp": 1_000_000 * (i + 1),
                    "location": s["location"],
                    "description": s["description"],
                    "timeofday": s["timeofday"], "cams": cams,
                    "lidar2ego": np.eye(4, dtype=np.float32),
                    "ego2global": e2g.astype(np.float32),
                    "gt_boxes": s["gt_bboxes_3d"],
                    "gt_names": [classes[j] for j in s["gt_labels_3d"]],
                    "visibility": s["visibility"]})
                np.save(os.path.join(dirs["occ_proj"], tok + ".npy"),
                        s["occ_proj_image"])
                os.makedirs(os.path.join(dirs["occ3d"], tok))
                np.savez(os.path.join(dirs["occ3d"], tok, "labels.npz"),
                         semantics=s["occ_labels"])
                n_vec = int(rng.integers(4, 12))
                with open(os.path.join(dirs["map_vec"], tok + ".pkl"),
                          "wb") as f:
                    pickle.dump((rng.uniform(-40, 40, (n_vec, 40, 2))
                                 .astype(np.float32),
                                 rng.integers(0, 3, n_vec)), f)
                i += 1
        with open(os.path.join(dirs["infos"],
                               f"nuscenes_infos_{split}.pkl"), "wb") as f:
            pickle.dump({"infos": infos,
                         "metadata": {"version": "v1.0-mini"}}, f)
    return ["dataset=Nuscenes", f"dataset.dataset_root={dirs['nusc']}",
            f"dataset.dataset_process_root={dirs['infos']}/",
            f"dataset.occ_proj_root={dirs['occ_proj']}",
            f"dataset.occ3d_root={dirs['occ3d']}",
            f"dataset.map_vec_root={dirs['map_vec']}"]


def _check_sample(s, h: int, w: int) -> None:
    """A reader sample's keys, shapes and dtypes, finite where float."""
    import numpy as np

    want = {"img": ((N_CAM, h, w, 3), np.float32),
            "gt_masks_bev": ((18, 200, 200), np.uint8),
            "camera_intrinsics": ((N_CAM, 4, 4), np.float32),
            "lidar2camera": ((N_CAM, 4, 4), np.float32),
            "camera2lidar": ((N_CAM, 4, 4), np.float32),
            "lidar2image": ((N_CAM, 4, 4), np.float32),
            "img_aug_matrix": ((N_CAM, 4, 4), np.float32),
            "occ_proj_image": ((h, N_CAM * w, 3), np.float32),
            "occ_labels": ((200, 200, 16), np.uint8),
            "occ_cam_K": ((N_CAM, 3, 3), np.float32),
            "occ_cam_T": ((N_CAM, 4, 4), np.float32)}
    for key, (shape, dtype) in want.items():
        v = s[key]
        if v.shape != shape or v.dtype != dtype or (
                dtype == np.float32 and not np.isfinite(v).all()):
            raise AssertionError(f"{s['token']} {key}: {v.shape} {v.dtype}")
    n = len(s["gt_labels_3d"])
    vec = s["map_vec_boxes"]
    if s["gt_bboxes_3d"].shape != (n, 7) or s["gt_labels_3d"].dtype \
            != np.int64 or vec.ndim != 3 or vec.shape[1:] != (40, 3) \
            or len(s["map_vec_classes"]) != len(vec) \
            or not (-1 <= s["img"]).all() or not (s["img"] <= 1).all():
        raise AssertionError(f"{s['token']}: boxes {s['gt_bboxes_3d'].shape},"
                             f" labels {n}, map vectors {vec.shape}")
    if len(s["filenames"]) != N_CAM or s["gt_masks_bev"].any():
        raise AssertionError(f"{s['token']}: {len(s['filenames'])} files, "
                             f"masks not the flagship's zeros")


def phase_nuscenes():
    """Real nuScenes data in, scores out, on the port's own reader and
    tools (the flagship at full width, bf16, seeded weights), in a
    temporary directory that it deletes:

    1. The native binding (``data/native.py``) built from its source:
       ``# native`` with the compiler, libjpeg and the build time.  Where
       g++ and ``jpeglib.h`` are there a failed build fails the phase, and
       18 x 200 x 200 masks pack and unpack bit for bit; without libjpeg
       the reader and the FID tool decode the JPEGs through PIL (the
       reader's own path).
    2. ``write_nuscenes_set``: 6 + 2 samples of 1600 x 900 frames, with
       the occupancy panoramas, Occ3D labels and map vectors.
    3. ``build_dataset(compose(["dataset=Nuscenes", roots]))``: every
       sample's shapes and dtypes (``_check_sample``; the flagship's
       ``missing_bev`` is zeros: no h5py, no devkit needed); the native
       decode within ``NUSC_DECODE_MEAN`` of the reader's own PIL path on
       one image.
    4. One trainer (models built once): the batch build timed over the
       train split at ``runner.num_workers`` 0 and 2 (sample, collate, to
       the card; ``prefetch_map`` as ``run()`` builds them), one training
       step on the reader's batch and one UniPC-20 generation of a val
       sample: finite loss and grad_norm, the image's shape, range and
       finiteness, launches equal to ``train_launches_per_step`` and
       ``generate_launches_per_generation``, each through
       ``check_sm90_launches``.
    5. ``tools.val_set_gen`` (in this process, 2 sampler steps, seeded
       weights; phase ``tools`` deleted its export) over the val split,
       its launches per generation derived; ``tools.fid_score`` in config
       mode over its samples and the set's real val images with seeded
       Inception weights in a ``pretrained/`` of the temporary directory
       (the working directory), ``fid.require_all``: finite, every token
       x sensor paired; the card's Inception activations on the real
       images within ``INCEPTION_TOL`` of the same model on the CPU
       (float32, TF32 off); Inception images/s at batch 16 and I3D clips/s
       on 16 x 224 x 224 clips (batch 4); ``tools.fvd_score`` over two
       folders of ``FVD_CLIPS`` seeded clips with seeded I3D weights.

    -> (launches of the phase, one step's derivation)."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np

    from dualdiff_tpu_torch.data import native
    from dualdiff_tpu_torch.data.collate import collate_fn
    from dualdiff_tpu_torch.data.prefetch import prefetch_map
    from dualdiff_tpu_torch.data.wrappers import build_dataset
    from dualdiff_tpu_torch.metrics.fid import InceptionV3, seeded_init_
    from dualdiff_tpu_torch.metrics.fid_import import export_pt_inception
    from dualdiff_tpu_torch.metrics.i3d import InceptionI3d
    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.pipeline.bev_controlnet import \
        BEVControlNetPipeline
    from dualdiff_tpu_torch.runner.trainer import MultiviewTrainer
    from dualdiff_tpu_torch.tools import fid_score, fvd_score, val_set_gen
    from dualdiff_tpu_torch.utils.config import compose

    t_phase = time.perf_counter()
    row = {"phase": "nuscenes"}
    total: dict = {}
    probe = toolchain_probe()
    st = native.status()
    row["native"] = {k: st[k] for k in ("path", "compiler", "libjpeg",
                                        "build_s")}
    log(f"# native: {json.dumps({**row['native'], **probe})}")
    if probe["g++"] and probe["jpeglib.h"]:
        if st["path"] == "unavailable":
            raise AssertionError(f"native build failed with g++ and "
                                 f"jpeglib.h there: {st['reason']}")
        masks = (np.random.default_rng(SEED).random((18, 200, 200))
                 > 0.5).astype(np.uint8)
        if not np.array_equal(native.unpack_masks(native.pack_masks(masks),
                                                  18), masks):
            raise AssertionError("native mask codec: round trip differs")
    else:
        log(f"# native: no {'g++' if not probe['g++'] else 'jpeglib.h'}; "
            f"the reader and the FID tool take their own (PIL) decode: "
            f"{st['reason']}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nuscenes_")
    cwd = os.getcwd()
    try:
        h, w = compose(NUSC_ARGS)[0].dataset.image_size
        t0 = time.perf_counter()
        roots = write_nuscenes_set(tmp, (h, w))
        row["write_set_s"] = time.perf_counter() - t0
        words = ["+exp=dual_branch_augloss_fusion"] + roots + NUSC_ARGS
        cfg, _ = compose(words)
        dev = cfg.get("device") or "cuda"
        train_set, val = build_dataset(cfg, "train"), build_dataset(cfg, "val")
        if (len(train_set), len(val)) != (6, 2) or train_set.missing_bev \
                != "zeros":
            raise AssertionError(f"reader: {len(train_set)} + {len(val)} "
                                 f"samples, missing_bev "
                                 f"{train_set.missing_bev}")
        for ds in (train_set, val):
            for i in range(len(ds)):
                _check_sample(ds[i], h, w)
        img0 = os.path.join(train_set.dataset_root,
                            train_set.infos[0]["cams"]["CAM_FRONT"][
                                "data_path"])
        own = train_set._load_image(img0)
        if native.available():
            got = native.load_images_batch([img0], train_set.resize_ratio,
                                           h, w)
            if got is None:
                raise AssertionError("native decode failed on the set")
            row["decode_mean_abs"] = float(np.abs(got[0] - own).mean())
            if not row["decode_mean_abs"] < NUSC_DECODE_MEAN:
                raise AssertionError(f"native decode off the reader's own "
                                     f"path by {row['decode_mean_abs']}")

        # 4. one trainer: batch build, a step, a generation
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = MultiviewTrainer(cfg, train_set, device=dev)
        torch.cuda.synchronize()
        row["trainer_build_s"] = time.perf_counter() - t0
        plan = list(trainer._batch_plan(0))
        for workers in NUSC_WORKERS:
            t0 = time.perf_counter()
            for _ in prefetch_map(trainer._build_batch, plan,
                                  num_workers=workers):
                pass
            torch.cuda.synchronize()
            row[f"batch_build_s_workers_{workers}"] = (
                time.perf_counter() - t0) / len(plan)
        models = trainer.models
        layers = len(models["unet"].down_blocks[0].resnets)
        levels = model_levels(models["unet"], (h // 8, w // 8))
        n_cn = len(models["controlnets"])
        step_want = train_launches_per_step(
            layers, n_cn, bool(cfg.runner.enable_unet_checkpointing)
            and bool(cfg.runner.enable_controlnet_checkpointing), levels,
            attn4=attn4_form(models["unet"]))
        steps = int(cfg.runner.pipeline_param.num_inference_steps)
        gen_want = generate_launches_per_generation(layers, n_cn, steps,
                                                    levels)
        metrics = {}
        A.reset_launch_counts()
        trainer.run(1, lambda step, m: metrics.update(m))
        counts = launch_counts(A)
        _check_launches(counts, step_want, "step on the reader's batch")
        _add(total, counts)
        if not (math.isfinite(metrics["loss"])
                and math.isfinite(metrics["grad_norm"])
                and metrics["grad_norm"] > 0):
            raise AssertionError(f"step on the reader's batch: {metrics}")
        row.update(loss=metrics["loss"], grad_norm=metrics["grad_norm"],
                   step_s=metrics["step_time_s"],
                   step_data_s=metrics["data_time_s"])
        pipe = BEVControlNetPipeline(cfg, models, trainer.schedule,
                                     device=trainer.device)
        batch = collate_fn([val[0]], cfg, trainer.tokenizer, is_train=False,
                           rng=np.random.default_rng(SEED))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        A.reset_launch_counts()
        imgs = pipe(batch, generator=gen)
        torch.cuda.synchronize()
        row["generation_s"] = time.perf_counter() - t0
        counts = launch_counts(A)
        _check_launches(counts, gen_want, "generation on the reader's batch")
        _add(total, counts)
        if tuple(imgs.shape) != (1, N_CAM, h, w, 3) or not bool(
                torch.isfinite(imgs).all()) or float(imgs.min()) < 0 \
                or float(imgs.max()) > 1:
            raise AssertionError(f"generation {tuple(imgs.shape)}, range "
                                 f"[{float(imgs.min())}, "
                                 f"{float(imgs.max())}]")
        row["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del trainer, models, pipe, imgs
        torch.cuda.empty_cache()

        # 5. val_set_gen, fid_score, the metrics' timings, fvd_score
        vsg = os.path.join(tmp, "vsg")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            val_set_gen.main(words + [
                "runner.pipeline_param.num_inference_steps=2",
                f"log_root={vsg}"])
        row["val_set_gen_s"] = time.perf_counter() - t0
        for ln in out.getvalue().splitlines():
            log(f"#   val_set_gen: {ln}")
        printed = _printed_launches(out.getvalue())
        gen2_want = generate_launches_per_generation(layers, n_cn, 2, levels)
        if len(printed) != len(val):
            raise AssertionError(f"val_set_gen: {len(printed)} generations")
        for c in printed:
            _check_launches(c, gen2_want, "val_set_gen generation")
            _add(total, c)
        torch.cuda.empty_cache()
        os.makedirs(os.path.join(tmp, "pretrained"))
        torch.save(export_pt_inception(seeded_init_(InceptionV3(), SEED)),
                   os.path.join(tmp, "pretrained", fid_score.WEIGHTS))
        torch.save(seeded_init_(InceptionI3d(), SEED).state_dict(),
                   os.path.join(tmp, "pretrained", "i3d_pretrained_400.pt"))
        os.chdir(tmp)
        samples = os.path.join(vsg, "val_set_gen", "samples")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            fid = fid_score.main(words + [f"fid.rootb={samples}",
                                          "fid.require_all=true"])
        row["fid_score_s"] = time.perf_counter() - t0
        log(f"#   fid_score: {out.getvalue().strip()}")
        pairs = len(val) * N_CAM
        if not math.isfinite(fid) or f"({pairs} real vs {pairs} generated" \
                not in out.getvalue():
            raise AssertionError(f"fid_score: {fid}, {out.getvalue()}")
        row["fid"] = fid
        reals, _ = fid_score.pair_real_generated(
            val, list(cfg.dataset.view_order), str(cfg.dataset.dataset_root),
            samples, require_all=True)
        transform = functools.partial(
            fid_score.train_matching_transform,
            resize_ratio=float(cfg.dataset.augment2d.resize[0][0]),
            target_hw=(h, w))
        acts = {}
        for device in (dev, "cpu"):
            extract, size, label = fid_score.build_extractor(device=device)
            acts[device] = fid_score.activations_for_paths(
                reals, extract, size, transform=transform)
            if device == dev:
                x = np.random.default_rng(SEED).random(
                    (INCEPTION_BATCH, *size, 3)).astype(np.float32)
                row["inception_images_per_s"] = INCEPTION_BATCH * 1e3 \
                    / cuda_ms(lambda: extract(x), TIMED_METRIC_CALLS)
        err = float(np.abs(acts[dev] - acts["cpu"]).max())
        row["inception_card_vs_cpu"] = err
        row["inception_max_abs"] = float(np.abs(acts["cpu"]).max())
        if label != "inception_pool3" or not err <= INCEPTION_TOL * \
                row["inception_max_abs"]:
            raise AssertionError(f"Inception ({label}) on the card off the "
                                 f"CPU by {err}")
        from dualdiff_tpu_torch.metrics.fvd import build_i3d_extractor

        extract, _ = build_i3d_extractor(os.path.join(
            "pretrained", "i3d_pretrained_400.pt"), device=dev)
        clips = torch.rand(I3D_BATCH, I3D_FRAMES, 224, 224, 3,
                           generator=torch.Generator().manual_seed(SEED)
                           ) * 2 - 1
        row["i3d_clips_per_s"] = I3D_BATCH * 1e3 / cuda_ms(
            lambda: extract(clips), TIMED_METRIC_CALLS)
        for d, shift in (("fvd_real", 0.2), ("fvd_gen", 0.3)):
            os.makedirs(d)
            rng = np.random.default_rng(SEED + int(10 * shift))
            for i in range(FVD_CLIPS):
                np.savez(os.path.join(d, f"c{i}.npz"), frames=(
                    (rng.random((I3D_FRAMES, 224, 224, 3)) * 0.5 + shift)
                    * 255).astype(np.uint8))
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            fvd = fvd_score.main(["--real", "fvd_real", "--gen", "fvd_gen",
                                  "--device", dev])
        row["fvd_score_s"] = time.perf_counter() - t0
        log(f"#   fvd_score: {out.getvalue().strip()}")
        if not math.isfinite(fvd) or "FVD[i3d_logits]" not in out.getvalue():
            raise AssertionError(f"fvd_score: {fvd}, {out.getvalue()}")
        row["fvd"] = fvd
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    row["launches_per_step"] = step_want
    row["launches_per_generation"] = gen_want
    total = {**dict.fromkeys(list(REPLACES) + list(SM90_ROUTES), 0), **total}
    row["launches_run"] = total
    row["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps(row))
    log(f"nuscenes batch build s at num_workers 0 / 2: "
        f"{row['batch_build_s_workers_0']:.4f} / "
        f"{row['batch_build_s_workers_2']:.4f}; step {row['step_s']:.3f} s, "
        f"generation {row['generation_s']:.3f} s; FID {fid:.4f}, FVD "
        f"{fvd:.4f}; Inception {row['inception_images_per_s']:.1f} "
        f"images/s, I3D {row['i3d_clips_per_s']:.2f} clips/s")
    return total, step_want


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


def phase_explore():
    """The explore tools on the card (see the module docstring, phase 22).
    -> the launches of the capture-off forward after the tools."""
    import shutil
    import tempfile

    import numpy as np

    from dualdiff_tpu_torch.data.wrappers import build_dataset
    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.runner.explore import Probe
    from dualdiff_tpu_torch.runner.factory import (build_models,
                                                   randomize_weights)
    from dualdiff_tpu_torch.runner.trainer import MultiviewTrainer
    from dualdiff_tpu_torch.tools import explore_attn, explore_unet
    from dualdiff_tpu_torch.utils.config import compose

    t0 = time.perf_counter()
    cfg, _ = compose(EXPLORE_ARGS)
    tiny = bool(cfg.get("tiny_models", False))  # a CPU rehearsal's
    dev = "cpu" if tiny else "cuda"
    models = build_models(cfg, tiny=tiny, device=dev)
    for m in (models["unet"], models["vae"], models["text_encoder"],
              *models["controlnets"]):
        randomize_weights(m, SEED)
    trainer = MultiviewTrainer(cfg, build_dataset(cfg, "val"), device=dev,
                               models=models)
    probe = Probe(trainer, int(cfg.explore_t))

    def forward():
        """The capture-off ControlNets + UNet forward and its launches."""
        A.reset_launch_counts()
        out = probe.unet(*probe.residuals(), captured=False)
        torch.cuda.synchronize()
        return out, launch_counts(A)

    before, counts_before = forward()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_explore_")
    try:
        t1 = time.perf_counter()
        maps = explore_attn.run(probe, os.path.join(tmp, "attn_maps"))
        feats = explore_unet.run(probe, os.path.join(tmp, "unet_features"))
        torch.cuda.synchronize()
        tools_s = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        pngs = sorted(os.listdir(os.path.join(tmp, "attn_maps")))
        written = sorted(os.listdir(os.path.join(tmp, "unet_features")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    n_probs, worst_row = 0, 0.0
    for net, store in maps.items():
        for key, v in store.items():
            if not key.endswith("/attn_probs"):
                continue
            if v.dtype != torch.float32 or not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{net} {key}: {v.dtype}, not finite "
                                     f"float32 probabilities")
            worst_row = max(worst_row,
                            float((v.sum(-1) - 1).abs().max()))
            n_probs += 1
    if worst_row > EXPLORE_ROW_TOL:
        raise AssertionError(f"a probability row sums to 1 +- {worst_row}")
    blocks = [f"down_block_{i}_out" for i in range(4)] + ["mid_block_out"] \
        + [f"up_block_{i}_out" for i in range(4)]
    if sorted(feats) != sorted(blocks) or not all(
            np.isfinite(f).all() for f in feats.values()):
        raise AssertionError(f"block features {sorted(feats)}: not the "
                             f"nine, or not finite")
    n_views = probe.N
    if "block_features.npz" not in written or len(written) != \
            9 * n_views + 1 or not pngs:
        raise AssertionError(f"explore files: {len(pngs)} maps, "
                             f"{len(written)} block files")
    after, counts = forward()
    check_sm90_launches(counts)
    if counts != counts_before or not counts.get("packed_attention_nbr_fwd"):
        raise AssertionError(f"capture-off launches {counts} (before the "
                             f"tools {counts_before})")
    diff = float((after.float() - before.float()).abs().max())
    tol = 2 ** -7 * float(before.float().abs().max())
    if not diff <= tol:
        raise AssertionError(f"capture-off output moved by {diff} > {tol}")
    row = {"phase": "explore", "config": " ".join(EXPLORE_ARGS),
           "seconds": time.perf_counter() - t0, "tools_s": tools_s,
           "peak_gib": peak, "attn_probs": n_probs, "maps_png": len(pngs),
           "worst_row_sum_err": worst_row,
           "block_shapes": {k: list(v.shape) for k, v in feats.items()},
           "capture_off_max_diff": diff,
           "capture_off_launches": _wrappers(counts)}
    log(f"# explore: {row['seconds']:.1f} s, peak {peak:.2f} GiB")
    log(json.dumps(row))
    del maps, feats, probe, trainer, models
    torch.cuda.empty_cache()
    return counts


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> dict:
    """The launcher's variables for rank ``rank`` of ``world`` on this
    host."""
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                MASTER_ADDR="localhost", MASTER_PORT=str(port))


def differs_from_rank0(tensors: dict) -> list:
    """The names of ``tensors`` whose bytes differ from rank 0's tensor of
    that name (none on rank 0): each tensor's SHA-256 on the host, rank
    0's digests broadcast (``broadcast_object``)."""
    import hashlib

    from dualdiff_tpu_torch.parallel import mesh as M

    mine = {k: hashlib.sha256(t.detach().contiguous().reshape(-1)
                              .view(torch.uint8).cpu().numpy()).hexdigest()
            for k, t in tensors.items()}
    rank0 = M.broadcast_object(mine)
    return [k for k, d in mine.items() if rank0.get(k) != d]


def split_ring_row(A, view0: int, n_local: int, b: int = 2) -> dict:
    """Row 2 under a view split at the main path's 1400-token level (d =
    40) on ``b`` samples, a B = 1 generation's CFG pair: q holds the
    ``n_local`` views ``view0 ..`` of each sample, k and v all 6
    (``packed_attention_nbr_fwd(..., n_local=, view0=)``).  The sm90
    kernel (the path's route) and the template instance, each against the
    plain version within phase 3's tolerance and bit for bit against the
    matching rows of the same kernel's whole-ring call; times from CUDA
    graphs, the bound of the split call's own bytes (q, the neighbour
    views' K/V and the output, once each) and FLOPs, and the two-call
    yardstick (``stacked_sdpa_call`` on the rank's views).  Raises when a
    check fails."""
    g = torch.Generator(device="cuda").manual_seed(SEED + view0)
    q, k, v = (torch.randn(b * N_CAM, L, C, generator=g, device="cuda")
               .bfloat16() for _ in range(3))
    mine = lambda t: t.view(b, N_CAM, L, C)[:, view0:view0 + n_local] \
        .reshape(b * n_local, L, C).contiguous()
    ql = mine(q)
    ring = functools.partial(A.packed_attention_nbr_fwd, ql, k, v, HEADS,
                             N_CAM, n_local=n_local, view0=view0)
    variants = {"sm90": ring,
                "template": functools.partial(ring, route="template")}
    whole = {"sm90": mine(A.packed_attention_nbr_fwd(q, k, v, HEADS, N_CAM)),
             "template": mine(A.packed_attention_nbr_fwd(
                 q, k, v, HEADS, N_CAM, route="template"))}
    plain = lambda: A.attention_packed_neighbors_plain(
        ql, k, v, HEADS, N_CAM, n_local=n_local, view0=view0)
    want = plain()
    tol = 2.0 ** -7 * want.float().abs().max().item() + 1e-3
    errs, bit = {}, {}
    for name, run in variants.items():
        got = run()
        torch.cuda.synchronize()
        errs[name] = _max_err(got, want)
        bit[name] = bool(torch.equal(got, whole[name]))
        del got
    times = {name: graph_ms(run) for name, run in variants.items()}
    by_backend = sdpa_ms(stacked_sdpa_call(ql, k, v, HEADS, N_CAM, n_local,
                                           view0),
                         (2 * b * n_local, HEADS, L, L))
    sdpa_name, stacked = fastest(by_backend)
    read = len({(view0 + i + o) % N_CAM for i in range(n_local)
                for o in (-1, 1)})  # neighbour views a sample
    nbytes = 2 * (2 * ql.numel() + 2 * b * read * L * C)
    bound_ms, bound_by = bound(nbytes, 8 * b * n_local * L * L * C)
    row = {"kernel": SM90_NBR, "wrapper": "packed_attention_nbr_fwd",
           "replaces": REPLACES["packed_attention_nbr_fwd"],
           "case": f"attn4 ring, view split: views {view0}.."
                   f"{view0 + n_local - 1} of {N_CAM}",
           "shape": {"b": b, "n_local": n_local, "view0": view0, "lq": L,
                     "lk": L, "c": C, "heads": HEADS, "head_dim": C // HEADS,
                     "n_cam": N_CAM, "kv_views_read": read},
           "max_abs_err": errs["sm90"], "tol": tol,
           "max_abs_err_by_variant": errs,
           "bit_equal_to_whole_ring_rows": bit,
           "kernel_ms": times["sm90"], "kernel_ms_by_variant": times,
           "plain_ms": cuda_ms(plain, 3), "library_ms": None,
           "stacked_sdpa_ms": stacked,
           "stacked_sdpa": f"_nbr_stacked gather + SDPA ({sdpa_name}) + "
                           f"sum of the halves, on the rank's views",
           "stacked_sdpa_ms_by_backend": by_backend,
           "bound_ms": bound_ms, "bound_by": bound_by}
    log(json.dumps(row))
    for name, err in errs.items():
        if not (err <= tol and math.isfinite(err)):
            raise AssertionError(f"split ring {name} disagrees with its "
                                 f"plain version: {err} > {tol}")
    if not all(bit.values()):
        raise AssertionError(f"split ring rows differ from the whole "
                             f"ring's: {bit}")
    del q, k, v, ql, whole, want
    torch.cuda.empty_cache()
    return row


def clip_step_reading(dev, mesh=None, frames: int = SPLIT_FRAMES,
                      name: str = None) -> dict:
    """Stage 1 (``video_16f``; ``name``: another video config, as
    ``rgd_stage2``) at full width on one clip of ``frames`` frames (seeded
    weights, bf16, remat, AdamW): a warm-up step and a timed one.  Under
    ``mesh`` (2 data ranks) each rank holds ``frames / 2`` frames of the
    clip (the frame split).  -> s per step, the memory allocated before
    the timed step (``base_gib``: weights, optimizer state, what the
    process held before) and its peak, launches held to
    ``video_train_launches_per_step`` on the sm90 kernels, and per step
    the ``gather`` calls, bytes received and host seconds."""
    from dualdiff_tpu_torch.data.video import SyntheticNuScenesVideo
    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.parallel.collectives import STATS
    from dualdiff_tpu_torch.runner.factory import (build_models,
                                                   randomize_weights)
    from dualdiff_tpu_torch.runner.train_state import named_roots
    from dualdiff_tpu_torch.runner.trainer import batch_rows
    from dualdiff_tpu_torch.runner.video_trainer import VideoTrainer
    from dualdiff_tpu_torch.utils.config import VIDEO_16F, load_config

    cfg = load_config(name or VIDEO_16F, [f"video.num_frames={frames}",
                                          "runner.train_batch_size=1"])
    h, w = cfg.dataset.image_size
    models = build_models(cfg, device=dev)
    for _, m in named_roots(models):
        randomize_weights(m, SEED)
    clips = SyntheticNuScenesVideo(num_clips=1, num_frames=frames,
                                   image_size=(h, w))
    trainer = VideoTrainer(cfg, clips, device=dev, models=models, mesh=mesh)
    split = trainer.split
    if (mesh is None) != (split is None) or (
            split is not None and split.frame_ranks != mesh.data):
        raise AssertionError(f"clip split {split} on {mesh}")
    batch = trainer._build_batch((0, 0, [0]))
    expect = video_train_launches_per_step(
        len(models["unet"].down_blocks[0].resnets), len(models["controlnets"]),
        bool(cfg.runner.enable_unet_checkpointing)
        and bool(cfg.runner.enable_controlnet_checkpointing),
        bool(cfg.video.rgd.enable), (h // 8) * (w // 8))
    steps = []
    for i in range(2):
        A.reset_launch_counts()
        STATS.reset()
        torch.cuda.synchronize(dev)
        if i:
            base = torch.cuda.memory_allocated(dev) / 2 ** 30
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        counts = launch_counts(A)
        if _wrappers(counts) != expect:
            raise AssertionError(f"clip step launches {counts} != {expect}")
        check_sm90_launches(counts)
        if not (math.isfinite(m["loss"]) and m["grad_norm"] > 0):
            raise AssertionError(f"clip step {i}: {m}")
        steps.append({"s": dt, "loss": m["loss"], "grad_norm": m["grad_norm"],
                      "gather_calls": STATS.calls,
                      "gather_bytes": STATS.bytes,
                      "gather_s": STATS.seconds})
    out = {"frames_here": batch_rows(batch)[0], "views": N_CAM,
           "s_per_step": steps[1]["s"], "warmup_s": steps[0]["s"],
           "base_gib": base,
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "launches_per_step": counts, "steps": steps}
    del trainer, models, batch
    torch.cuda.empty_cache()
    return out


CLIP_PEAK_STEPS = (("video_16f", 2), ("video_16f", 4), ("video_16f", 8),
                   ("video_16f", 16), ("rgd_stage2", 2), ("rgd_stage2", 4),
                   ("rgd_stage2", 16))


def clip_peaks() -> int:
    """``chip_smoke.py --clip-peaks``: how a video training step's memory
    grows with the clip's frames, one process on the card, a one-off read
    outside the smoke's phases.  Builds the libraries, times row 2 under a
    view split alone on the card (``split_ring_row`` on views 0..2 and
    3..5), then runs ``clip_step_reading`` for each of
    ``CLIP_PEAK_STEPS`` (stage 1 ``video_16f`` and stage 2 ``rgd_stage2``
    at a number of frames), one after the other, each reading's models
    freed before the next, and prints a JSON line per reading: the memory
    allocated before the timed step (``base_gib``) and its peak, or the
    out-of-memory error."""
    import gc

    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.utils.config import RGD_STAGE2, VIDEO_16F

    configs = {"video_16f": VIDEO_16F, "rgd_stage2": RGD_STAGE2}
    phase_device()
    phase_build()
    log(card())
    for view0 in (0, N_CAM // 2):
        split_ring_row(A, view0, N_CAM // 2)
    dev = torch.device("cuda")
    for name, frames in CLIP_PEAK_STEPS:
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated() / 2 ** 30
        try:
            r = clip_step_reading(dev, frames=frames, name=configs[name])
            r = {k: r[k] for k in ("frames_here", "s_per_step", "warmup_s",
                                   "base_gib", "peak_gib")}
        except torch.OutOfMemoryError as e:
            r = {"oom": str(e)[:300]}
        log(json.dumps({"config": name, "frames": frames,
                        "allocated_before_gib": before, **r}))
    return 0


def ring_calls_on_rank(pipe, batch, lat, views) -> dict:
    """One denoising step of this rank's cameras of ``batch`` (``views``:
    the ``(1, 2)`` mesh) in which every call of row 2
    (``packed_attention_nbr_fwd``: q on the rank's views, K/V gathered) is
    held to the whole ring: q gathered over the view group, the whole ring
    run on it and the same K/V, and the rows of this rank's cameras there,
    bit for bit.  Both ranks make the same calls in the same order, so
    their gathers meet; a wrong ``view0`` or a gather out of rank order
    gives other rows.  -> {calls, equal, max_abs_diff, view0 (those
    passed)}."""
    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.parallel.collectives import gather

    cams = views.cams(N_CAM)
    seen = {"calls": 0, "equal": 0, "max_abs_diff": 0.0, "view0": set()}
    fn = A.packed_attention_nbr_fwd

    @functools.wraps(fn)  # its own launch count: these launches are checks
    def call(q, k, v, heads, n_cam, scale=None, **kw):
        out = fn(q, k, v, heads, n_cam, scale, **kw)
        n = cams.stop - cams.start
        rows = lambda t, m: t.view(-1, m, *t.shape[1:])
        whole = fn(gather(rows(q, n), views.view_group, 1).reshape(k.shape),
                   k, v, heads, n_cam, scale)
        mine = rows(whole, n_cam)[:, cams.start:cams.stop].reshape(q.shape)
        seen["calls"] += 1
        seen["equal"] += torch.equal(out, mine)
        seen["max_abs_diff"] = max(seen["max_abs_diff"], _max_err(out, mine))
        seen["view0"].add(kw.get("view0", 0))
        return out

    A.packed_attention_nbr_fwd = call
    try:
        pipe(batch, latents=lat, num_inference_steps=1)
    finally:
        A.packed_attention_nbr_fwd = fn
    return dict(seen, view0=sorted(seen["view0"]))


def ddp_split_rank(mesh, dev) -> dict:
    """Phase ddp's splits on one rank (see the module docstring): row 2 on
    this rank's views of the ``(1, 2)`` mesh (``split_ring_row``); its 3
    cameras of the flagship's UniPC-20 generation of row 0 alone (B = 1,
    the noise of the global draw), launches derived; the 256x128 gate's
    gradient on the ``(1, 2)`` mesh (B = 2) and on the frame split (one
    tiny RGD clip of ``SPLIT_FRAMES`` frames, 2 a rank); the full-width
    frame-split stage-1 step (``clip_step_reading``).  After the timed
    generation, one step of it with every ring call held to the whole
    ring (``ring_calls_on_rank``)."""
    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.parallel import mesh as M
    from dualdiff_tpu_torch.parallel.collectives import STATS
    from dualdiff_tpu_torch.runner.conds import prepare_batch

    views = M.create_mesh(data=1, view=mesh.world)
    cams = views.cams(N_CAM)
    out = {"view_cams": [cams.start, cams.stop]}
    for turn in range(mesh.world):  # one rank at a time on the card
        if turn == mesh.rank:
            out["ring_row"] = split_ring_row(A, cams.start,
                                             cams.stop - cams.start)
        M.barrier()

    cfg, batch, pipe = _flagship("cuda", mesh=views)
    h, w = cfg.dataset.image_size
    unet = pipe.models["unet"]
    lat = torch.randn((DDP_B, 1, h // 8, w // 8, 4), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(SEED))
    row0 = M.shard_batch(prepare_batch(batch, "cpu"),
                         M.Mesh(world=DDP_B, rank=0, data=DDP_B))
    expect = generate_launches_per_generation(
        len(unet.down_blocks[0].resnets), len(pipe.models["controlnets"]),
        int(cfg.runner.pipeline_param.num_inference_steps),
        model_levels(unet, (h // 8, w // 8)), attn4=attn4_form(unet))
    A.reset_launch_counts()
    STATS.reset()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    images = pipe(row0, latents=lat[:1])
    torch.cuda.synchronize(dev)
    out["view_generation_s"] = time.perf_counter() - t0
    counts = launch_counts(A)
    if _wrappers(counts) != expect:
        raise AssertionError(f"rank {mesh.rank} view-split generation "
                             f"launches {counts} != {expect}")
    check_sm90_launches(counts)
    out.update(view_generation_launches=counts,
               view_gather={"calls": STATS.calls, "bytes": STATS.bytes,
                            "seconds": STATS.seconds},
               view_images=images.cpu(),
               view_ring_calls=ring_calls_on_rank(pipe, row0, lat[:1],
                                                  views))
    del pipe, images, unet
    torch.cuda.empty_cache()

    for key, kw, grid in (("view_gate", {"batch": DDP_B}, views),
                          ("frame_gate", {"video": True,
                                          "frames": SPLIT_FRAMES}, mesh)):
        loss, grads, launches = gate_reading("cuda", mesh=grid, **kw)
        check_sm90_launches(launches)
        out[key] = (loss, grads if mesh.rank == 0 else None, launches)
        del grads
    out["frame_step"] = clip_step_reading(dev, mesh)
    return out


def ddp_rank(out_dir: str) -> int:
    """One rank of phase ``ddp`` (``chip_smoke.py --ddp-rank DIR``, with
    the launcher's variables set): the 256x128 gate's averaged gradient,
    this rank's row of the flagship generation, and one warm-up and one
    timed flagship step on the global batch, with the checks that need
    the ranks together; then the splits (``ddp_split_rank``).  Writes
    ``DIR/rank<r>.pt``."""
    import gc

    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.parallel import mesh as M
    from dualdiff_tpu_torch.runner import trainer as T
    from dualdiff_tpu_torch.runner.factory import (build_models,
                                                   randomize_weights)
    from dualdiff_tpu_torch.utils.config import FLAGSHIP, load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    backend = M.init_from_env()
    mesh = M.create_mesh()
    dev = M.rank_device()
    torch.cuda.set_device(dev)
    out = {"rank": mesh.rank, "world": mesh.world, "backend": backend,
           "device": str(dev)}

    # the 256x128 gate: this rank's row, the gradients averaged
    loss, grads, launches = gate_reading("cuda", batch=DDP_B, mesh=mesh)
    check_sm90_launches(launches)
    out["gate"] = (loss, grads if mesh.rank == 0 else None, launches)
    del grads

    # this rank's row of the generation: the flagship at full width, and
    # the tiny set at phase 5's 256x128
    out["rows"] = list(range(DDP_B))[mesh.rows(DDP_B)]
    out["images"], out["generation_s"] = {}, {}
    for size, tiny, extra in DDP_GENERATIONS:
        cfg, batch, pipe = _flagship("cuda", tiny=tiny, extra=extra,
                                     mesh=mesh)
        unet = pipe.models["unet"]
        h, w = cfg.dataset.image_size
        expect = generate_launches_per_generation(
            len(unet.down_blocks[0].resnets),
            len(pipe.models["controlnets"]),
            int(cfg.runner.pipeline_param.num_inference_steps),
            model_levels(unet, (h // 8, w // 8)), attn4=attn4_form(unet))
        A.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images = pipe(batch, generator=torch.Generator(device=dev)
                      .manual_seed(SEED))
        torch.cuda.synchronize()
        out["generation_s"][size] = time.perf_counter() - t0
        counts = launch_counts(A)
        if _wrappers(counts) != expect:
            raise AssertionError(f"rank {mesh.rank} {size} generation "
                                 f"launches {counts} != {expect}")
        check_sm90_launches(counts)
        if not tiny:
            out["generation_launches"] = counts
        out["images"][size] = images.cpu()
        del pipe, images, unet
        torch.cuda.empty_cache()

    # the flagship step on the global batch: a warm-up step and a timed one
    cfg = load_config(FLAGSHIP, [f"runner.train_batch_size={DDP_B}",
                                 "runner.lr_warmup_steps=0"])
    models = build_models(cfg, device=dev)
    for m in (models["unet"], models["vae"], models["text_encoder"],
              *models["controlnets"]):
        randomize_weights(m, SEED)
    trainer = T.MultiviewTrainer(cfg, _train_batch(cfg, 2 * DDP_B),
                                 device=dev, models=models)
    if trainer.mesh != mesh:
        raise AssertionError(f"trainer mesh {trainer.mesh} != {mesh}")
    layers = len(models["unet"].down_blocks[0].resnets)
    derive = functools.partial(
        train_launches_per_step, layers, len(models["controlnets"]),
        bool(cfg.runner.enable_unet_checkpointing)
        and bool(cfg.runner.enable_controlnet_checkpointing),
        model_levels(models["unet"], (h // 8, w // 8)),
        attn4=attn4_form(models["unet"]))
    expect, template = derive(), derive(template_only=True)
    opt, seen, steps = trainer.optimizer, {}, []
    step, average = opt.step, T.average_gradients
    reduce = {"seconds": 0.0, "bytes": 0}

    def recording(g=None):
        seen["grads"] = g
        return step(g)

    def timed_average(grads):
        """The trainer's all-reduce, timed between synchronisations."""
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = average(grads)
        torch.cuda.synchronize(dev)
        reduce["seconds"] += time.perf_counter() - t0
        reduce["bytes"] += sum(v.numel() * v.element_size()
                               for v in out.values())
        return out

    def on_metrics(i, m):
        counts = launch_counts(A)
        if _wrappers(counts) != expect:
            raise AssertionError(f"rank {mesh.rank} step launches {counts} "
                                 f"!= {expect}")
        check_sm90_launches(counts, template)
        steps.append(dict(m, step=i, launches=counts,
                          all_reduce=dict(reduce)))
        A.reset_launch_counts()
        reduce.update(seconds=0.0, bytes=0)
        torch.cuda.reset_peak_memory_stats(dev)

    opt.step = recording
    T.average_gradients = timed_average
    A.reset_launch_counts()
    try:
        trainer.run(2, on_metrics)
    finally:
        T.average_gradients = average
    if len(steps) != 2 or not all(
            math.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in steps):
        raise AssertionError(f"rank {mesh.rank} steps {steps}")
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out["steps"] = [{k: v for k, v in m.items() if k != "launches"}
                    for m in steps]
    out["launches_per_step"] = steps[-1]["launches"]
    out["trainable_tensors"] = len(opt.master)
    grads = {f"grad/{k}": v for k, v in seen["grads"].items()}
    state = {f"master/{k}": v for k, v in opt.master.items()}
    t0 = time.perf_counter()
    out["differ_from_rank0"] = differs_from_rank0({**grads, **state})
    out["compare_s"] = time.perf_counter() - t0
    out["compared_tensors"] = len(grads) + len(state)
    del trainer, models, grads, state, seen, opt, step, recording
    gc.collect()
    torch.cuda.empty_cache()
    out["split"] = ddp_split_rank(mesh, dev)
    out["rank_s"] = time.perf_counter() - t_start
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    M.barrier()
    M.destroy()
    return 0


def nccl_probe() -> int:
    """``chip_smoke.py --nccl-probe`` with a one-rank launcher's variables:
    ``init_from_env`` on a card of its own (``nccl``) and one
    ``all_reduce`` (``all_mean``); prints a JSON line."""
    from dualdiff_tpu_torch.parallel import mesh as M

    t0 = time.perf_counter()
    backend = M.init_from_env()
    dev = M.rank_device()
    x = torch.arange(4, device=dev, dtype=torch.float32)
    y = M.all_mean(x)
    ok = bool(torch.equal(y, x))
    M.destroy()
    print(json.dumps({"backend": backend, "device": str(dev),
                      "all_reduce_ok": ok,
                      "seconds": time.perf_counter() - t0}))
    return 0 if ok and backend == "nccl" else 1


# the inference wrappers a generation calls
GEN_WRAPPERS = ("packed_attention_fwd", "packed_attention_nbr_fwd",
                "packed_attention_capped_fwd", "flash_attention_fwd")


def split_equal(run, args, out):
    """(whether ``run`` on each half of the first dimension of the tensor
    arguments, concatenated, is bit-equal to ``out``, the largest
    difference), or None when the call cannot be halved."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    outs = out if isinstance(out, tuple) else (out,)
    n = tensors[0].shape[0] if tensors else 0
    if n < 2 or n % 2 or any(t.shape[0] != n for t in tensors) or \
            any(not isinstance(o, torch.Tensor) or o.shape[0] != n
                for o in outs):
        return None
    parts = []
    for half in (slice(0, n // 2), slice(n // 2, n)):
        got = run(*[a[half] if isinstance(a, torch.Tensor) else a
                    for a in args])
        parts.append(got if isinstance(got, tuple) else (got,))
    diff = 0.0
    for i, o in enumerate(outs):
        cat = torch.cat([p[i] for p in parts])
        diff = max(diff, float((cat.float() - o.float()).abs().max()))
    return diff == 0.0, diff


def view_split_equal(run, args, out, ring: bool):
    """(whether ``run`` on each half of the cameras of its rows (rows fold
    (sample, camera), ``N_CAM`` a sample; the ring's q on a rank's views
    with ``n_local`` / ``view0`` and the whole K/V) is bit-equal to the
    matching rows of ``out``, the largest difference), or None when the
    call's rows are not whole samples of ``N_CAM`` cameras."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    n = tensors[0].shape[0] if tensors else 0
    if not n or n % N_CAM or not isinstance(out, torch.Tensor) or \
            any(t.shape[0] != n for t in tensors):
        return None
    half = N_CAM // 2
    same, diff = True, 0.0
    for v0 in (0, half):
        sel = lambda t: t.view(n // N_CAM, N_CAM, *t.shape[1:])[
            :, v0:v0 + half].reshape(-1, *t.shape[1:])
        got = run(sel(args[0]), *args[1:], n_local=half, view0=v0) if ring \
            else run(*[sel(a) if isinstance(a, torch.Tensor) else a
                       for a in args])
        same = same and torch.equal(got, sel(out))
        diff = max(diff, _max_err(got, sel(out)))
    return same, diff


def halved_calls(pipe, batch, lat, modules: bool = False,
                 views: bool = False) -> dict:
    """One denoising step of ``batch`` from ``lat`` in which every call of
    the ``GEN_WRAPPERS`` (with ``modules``, of every leaf module of the
    networks too) is run again on each half of its first dimension
    (``split_equal``), or with ``views`` on each half of its cameras as a
    rank of the ``(1, 2)`` mesh runs it (``view_split_equal``).  ->
    {wrapper or module type: {calls, halved, batch_dependent (halves not
    bit-equal to the whole), max_abs_diff}}."""
    import collections

    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.runner.train_state import named_roots

    seen = collections.defaultdict(lambda: {"calls": 0, "halved": 0,
                                            "batch_dependent": 0,
                                            "max_abs_diff": 0.0})

    def note(kind, res):
        row = seen[kind]
        row["calls"] += 1
        if res is not None:
            row["halved"] += 1
            row["batch_dependent"] += not res[0]
            row["max_abs_diff"] = max(row["max_abs_diff"], res[1])

    def hook(module, args, kwargs, out):
        if any(isinstance(v, torch.Tensor) for v in kwargs.values()):
            return note(type(module).__name__, None)
        with torch.no_grad():
            note(type(module).__name__, split_equal(
                lambda *a: module.forward(*a, **kwargs), args, out))

    handles = []
    if modules:
        for _, root in named_roots(pipe.models):
            for m in root.modules():
                if not any(True for _ in m.children()):
                    handles.append(m.register_forward_hook(
                        hook, with_kwargs=True))

    def wrap(name, fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            out = fn(*args, **kw)
            run = lambda *a, **k: fn(*a, **{**kw, **k})
            note(name, view_split_equal(
                run, args, out, name == "packed_attention_nbr_fwd")
                if views else split_equal(run, args, out))
            return out
        return call

    saved = {n: getattr(A, n) for n in GEN_WRAPPERS}
    for n, fn in saved.items():
        setattr(A, n, wrap(n, fn))
    try:
        pipe(batch, latents=lat, num_inference_steps=1)
    finally:
        for n, fn in saved.items():
            setattr(A, n, fn)
        for h in handles:
            h.remove()
    return dict(seen)


def ddp_generation_readings(res) -> dict:
    """The ranks' generated rows (``res``: the ranks' results) against one
    process on the card, the same weights, batch and initial noise (the
    global draw of ``torch.Generator`` seed ``SEED``): at full width each
    row against one process's generation of that row alone (B = 1: the
    ranks' batch per row; bf16 sums there depend on the batch, so the
    one-process B = 2 rows differ from its B = 1 rows, read here as
    ``one_process_b2_vs_b1``, mean), and at 256x128 against one process's
    B = 2 generation.  -> mean (``*_mean_err``) and max absolute errors
    per row, and at full width ``halved_kernel_calls`` (``halved_calls``
    of one step at B = 2: the attention kernels' share of the batch's
    rows).  The ``(1, 2)`` mesh's cameras of row 0 against the same
    one-process row (``view_split_vs_b1_mean``, ``view_split_max``; every
    call there has half the rows, and cuBLAS and cuDNN give a row other
    bits in another row count, so this reads what a batch change reads,
    ``one_process_b2_vs_b1``), and ``view_split_kernel_calls``: every
    attention kernel call of one step of row 0 run again as each rank runs
    it, on its 3 cameras (``halved_calls(..., views=True)``)."""
    from dualdiff_tpu_torch.parallel import mesh as M
    from dualdiff_tpu_torch.runner.conds import prepare_batch, to_device

    out = {}
    for size, tiny, extra in DDP_GENERATIONS:
        cfg, batch, pipe = _flagship("cuda", tiny=tiny, extra=extra)
        h, w = cfg.dataset.image_size
        dev = pipe.device
        lat = torch.randn((DDP_B, 1, h // 8, w // 8, 4), device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(SEED))
        whole = pipe(batch, latents=lat).cpu()
        if tiny:
            want = whole
        else:
            t = prepare_batch(batch, "cpu")
            want = torch.cat([pipe(to_device(M.shard_batch(
                t, M.Mesh(world=DDP_B, rank=r, data=DDP_B)), dev),
                latents=lat[r:r + 1]).cpu() for r in range(DDP_B)])
            out["one_process_b2_vs_b1"] = [
                float((whole[r] - want[r]).abs().mean()) for r in range(DDP_B)]
            out["halved_kernel_calls"] = halved_calls(pipe, batch, lat)
            row0 = to_device(M.shard_batch(t, M.Mesh(
                world=DDP_B, rank=0, data=DDP_B)), dev)
            out["view_split_kernel_calls"] = halved_calls(
                pipe, row0, lat[:1], views=True)
            errs = [(r["split"]["view_images"][0] - want[0][slice(
                *r["split"]["view_cams"])]).abs() for r in res]
            out["view_split_vs_b1_mean"] = [float(e.mean()) for e in errs]
            out["view_split_max"] = [float(e.max()) for e in errs]
        errs = [(r["images"][size] - want[r["rows"]]).abs() for r in res]
        out[f"{size}_vs_{'b2' if tiny else 'b1'}_mean_err"] = [
            float(e.mean()) for e in errs]
        out[f"{size}_max_err"] = [float(e.max()) for e in errs]
        del pipe
        torch.cuda.empty_cache()
    return out


VIDEO_GATE_KERNELS = ("packed_attention_capped_lse_fwd",
                      "packed_attention_lse_fwd", "packed_attention_bwd_dq",
                      "packed_attention_bwd_dkv", SM90_LSE, SM90_DQ, SM90_DKV)


def phase_ddp():
    """Data parallelism over processes on the card (see the module
    docstring, phase 23).  -> (the rank-0 launches of one generation row,
    of one step, and the splits': {"ring_rows": ``split_ring_row`` of
    each rank, "view_generation": rank 0's launches of its cameras of a
    generation, "frame_step": rank 0's launches of its frames' step})."""
    import gc
    import shutil
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    left = torch.cuda.memory_allocated() / 2 ** 30
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    me = os.path.abspath(__file__)
    root = os.path.dirname(me)
    port = _free_port()

    def spawn(args, env):
        return subprocess.Popen([sys.executable, me, *args], cwd=root,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    procs = []
    try:
        ranks = [spawn(["--ddp-rank", tmp], _rank_env(r, DDP_RANKS, port))
                 for r in range(DDP_RANKS)]
        nccl = spawn(["--nccl-probe"], _rank_env(0, 1, _free_port()))
        procs = ranks + [nccl]
        # meanwhile, on the host: the one-process float32 gradients
        cpu = gate_reading("cpu", fp32=True, batch=DDP_B)
        cpu_clip = gate_reading("cpu", fp32=True, video=True,
                                frames=SPLIT_FRAMES)
        outs = [p.communicate(timeout=DDP_TIMEOUT)[0] for p in ranks]
        nccl_out = nccl.communicate(timeout=DDP_TIMEOUT)[0]
        for r, (p, o) in enumerate(zip(ranks, outs)):
            if p.returncode != 0:
                raise AssertionError(f"ddp rank {r} failed:\n{o[-6000:]}")
        if nccl.returncode != 0:
            raise AssertionError(f"nccl probe failed:\n{nccl_out[-4000:]}")
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False) for r in range(DDP_RANKS)]
    finally:
        for p in procs:  # a failed phase leaves no rank waiting on another
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    probe = json.loads(nccl_out.strip().splitlines()[-1])

    # the ranks: gloo on the one card, bit for bit after the step
    if [(r["rank"], r["world"], r["backend"]) for r in res] != \
            [(i, DDP_RANKS, "gloo") for i in range(DDP_RANKS)]:
        raise AssertionError(f"ranks {[r['backend'] for r in res]}")
    for r in res:
        if r["differ_from_rank0"]:
            raise AssertionError(f"rank {r['rank']}: "
                                 f"{len(r['differ_from_rank0'])} tensors "
                                 f"differ from rank 0's: "
                                 f"{r['differ_from_rank0'][:5]}")
    losses = [[m["loss"] for m in r["steps"]] for r in res]
    if any(x != losses[0] for x in losses):
        raise AssertionError(f"the ranks' losses differ: {losses}")
    # the 256x128 gate: the ranks' averaged gradient against one process
    gate = gate_row("ddp train_reference", cpu, res[0]["gate"])
    _reference_gate(gate, TRAIN_GATE_KERNELS)
    for r in res[1:]:
        if not all(r["gate"][2][k] > 0 for k in TRAIN_GATE_KERNELS):
            raise AssertionError(f"rank {r['rank']} gate launches "
                                 f"{r['gate'][2]}")
    # the generation: each rank's rows against one process's
    rows = [r["rows"] for r in res]
    if sorted(sum(rows, [])) != list(range(DDP_B)):
        raise AssertionError(f"generation rows {rows}")
    gen = ddp_generation_readings(res)
    log(json.dumps({"phase": "ddp generation", **gen}))
    worst = max(max(v) for k, v in gen.items() if k.endswith("_mean_err"))
    if not worst <= GEN_MEAN_TOL:
        raise AssertionError(f"generated rows off one process's: {gen}")
    # the view split's rows: no further from one process's than its own
    # B = 2 rows are from its B = 1 rows (the same cause, another row
    # count in every GEMM and convolution), whose kernel calls are
    # bit-equal below
    if not max(gen["view_split_vs_b1_mean"]) <= max(
            GEN_MEAN_TOL, *gen["one_process_b2_vs_b1"]):
        raise AssertionError(f"view-split rows off one process's: {gen}")
    for key in ("halved_kernel_calls", "view_split_kernel_calls"):
        halved = gen[key]
        if not all(halved.get(k, {}).get("calls") for k in (
                "packed_attention_fwd", "packed_attention_nbr_fwd")) or any(
                v["batch_dependent"] or v["halved"] != v["calls"]
                for v in halved.values()):
            raise AssertionError(f"an attention kernel's rows depend on the "
                                 f"batch or the cameras at full width "
                                 f"({key}): {halved}")
    splits = ddp_split_readings(res, cpu, cpu_clip)
    if not probe["all_reduce_ok"] or probe["backend"] != "nccl":
        raise AssertionError(f"nccl probe {probe}")
    timed_steps = [r["steps"][-1] for r in res]
    smi = card()
    row = {"phase": "ddp", "card": smi, "ranks": DDP_RANKS, "backend": "gloo",
           "batch_global": DDP_B, "left_on_card_gib": left,
           "s_per_step": [m["step_time_s"] for m in timed_steps],
           "s_per_step_warmup": [r["steps"][0]["step_time_s"] for r in res],
           "s_per_step_phase6": KEPT.get("train_s_per_step"),
           "all_reduce_s_per_step": [m["all_reduce"]["seconds"]
                                     for m in timed_steps],
           "all_reduce_bytes_per_step": [m["all_reduce"]["bytes"]
                                         for m in timed_steps],
           "peak_gib_per_rank": [r["peak_gib"] for r in res],
           "generation_s_per_rank": [r["generation_s"] for r in res],
           "generation": gen,
           "gate_worst_leaf": next(iter(gate["worst_leaf_rel_err"].items())),
           "trainable_tensors":
           res[0]["trainable_tensors"],
           "tensors_bit_identical": res[0]["compared_tensors"],
           "compare_s": res[0]["compare_s"],
           "loss": losses[0], "launches_per_step": res[0]["launches_per_step"],
           "nccl_probe": probe, "rank_s": [r["rank_s"] for r in res],
           "splits": splits, "seconds": time.perf_counter() - t0}
    log(f"# ddp ({smi}): {DDP_RANKS} ranks, s/step {row['s_per_step']} "
        f"(phase 6: {row['s_per_step_phase6']}), all-reduce "
        f"{row['all_reduce_s_per_step']} s and "
        f"{row['all_reduce_bytes_per_step'][0]} bytes per step, peak "
        f"{row['peak_gib_per_rank']} GiB per rank")
    log(f"# ddp splits ({smi}): view split s/generation "
        f"{splits['view_generation_s_per_rank']}, frame split s/step "
        f"{splits['frame_split']['s_per_step']} (one process "
        f"{splits['one_process_clip']['s_per_step']}), peak "
        f"{splits['frame_split']['peak_gib_per_rank']} GiB per rank "
        f"(one process {splits['one_process_clip']['peak_gib']})")
    log(json.dumps(row))
    sp = res[0]["split"]
    return res[0]["generation_launches"], res[0]["launches_per_step"], {
        "ring_rows": [r["split"]["ring_row"] for r in res],
        "view_generation": sp["view_generation_launches"],
        "frame_step": sp["frame_step"]["launches_per_step"]}


def ddp_split_readings(res, cpu, cpu_clip) -> dict:
    """The parent's checks of the ranks' splits (``ddp_split_rank``): the
    cameras each rank of the ``(1, 2)`` mesh held; both split steps'
    averaged 256x128 gradients against one process's float32 gradient on
    the CPU under phase 7's gate (``cpu``: B = 2 of the tiny flagship;
    ``cpu_clip``: the tiny RGD clip of ``SPLIT_FRAMES`` frames); the
    frame-split step's launches equal on both ranks; then, with the ranks
    gone, one process's full-width step of the whole clip
    (``clip_step_reading``: its peak, the linear extrapolation's test).
    -> the readings."""
    split = [r["split"] for r in res]
    if [sp["view_cams"] for sp in split] != [[0, 3], [3, 6]]:
        raise AssertionError(f"view-split cameras "
                             f"{[sp['view_cams'] for sp in split]}")
    for sp in split:
        ring = sp["view_ring_calls"]
        if not ring["calls"] or ring["equal"] != ring["calls"] or \
                ring["view0"] != [sp["view_cams"][0]]:
            raise AssertionError(f"a rank's ring calls are not the whole "
                                 f"ring's rows of its cameras: {ring}")
    gates = {}
    for key, ref, kernels in (("view_gate", cpu, TRAIN_GATE_KERNELS),
                              ("frame_gate", cpu_clip, VIDEO_GATE_KERNELS)):
        gate = gate_row(f"ddp {key} train_reference", ref, split[0][key])
        _reference_gate(gate, kernels)
        for sp in split[1:]:
            if not all(sp[key][2][k] > 0 for k in kernels):
                raise AssertionError(f"{key} launches {sp[key][2]}")
        gates[key] = {"worst_leaf": next(iter(
            gate["worst_leaf_rel_err"].items())),
            "loss_rel_err": gate["loss_rel_err"]}
    steps = [sp["frame_step"] for sp in split]
    if steps[0]["launches_per_step"] != steps[1]["launches_per_step"] or \
            [st["frames_here"] for st in steps] != [SPLIT_FRAMES // 2] * 2:
        raise AssertionError(f"frame-split steps {steps}")
    torch.cuda.empty_cache()
    one = clip_step_reading(torch.device("cuda"))
    return {
        "view_generation_s_per_rank": [sp["view_generation_s"]
                                       for sp in split],
        "view_gather_per_generation": [sp["view_gather"] for sp in split],
        "view_ring_calls": [sp["view_ring_calls"] for sp in split],
        "gates": gates,
        "frame_split": {
            "frames": SPLIT_FRAMES, "frames_per_rank": SPLIT_FRAMES // 2,
            "s_per_step": [st["s_per_step"] for st in steps],
            "warmup_s": [st["warmup_s"] for st in steps],
            "peak_gib_per_rank": [st["peak_gib"] for st in steps],
            "base_gib_per_rank": [st["base_gib"] for st in steps],
            "gather_per_step": [{k: st["steps"][1][k] for k in (
                "gather_calls", "gather_bytes", "gather_s")}
                for st in steps],
            "loss": [st["steps"][1]["loss"] for st in steps],
            "launches_per_step": steps[0]["launches_per_step"]},
        "one_process_clip": {k: one[k] for k in (
            "s_per_step", "warmup_s", "base_gib", "peak_gib",
            "frames_here")}}


def split_ring_entry(rows, paths) -> dict:
    """The kernels line's entry of row 2 under a view split
    (``split_ring_row`` on each rank's views): the sm90 ring kernel with
    ``n_local`` / ``view0``, its launches those of rank 0's cameras of a
    generation (path ``ddp view split``)."""
    main = rows[0]
    _, counts, _ = paths["ddp view split"]
    return {
        "name": f"{SM90_NBR}:packed_attention_nbr_fwd (view split)",
        "route": "cuda", "source": SM90_ROUTES[SM90_NBR][1],
        "replaces": REPLACES["packed_attention_nbr_fwd"],
        "launches": counts[SM90_NBR],
        "launches_per": paths["ddp view split"][0],
        "launches_by_path": {u: c.get(SM90_NBR, 0)
                             for u, c, _ in paths.values()},
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None, "shape": main["shape"],
        "ms_by_variant": main["kernel_ms_by_variant"],
        "stacked_sdpa_ms": main["stacked_sdpa_ms"],
        "stacked_sdpa": main["stacked_sdpa"],
        "bit_equal_to_whole_ring_rows": [r["bit_equal_to_whole_ring_rows"]
                                         for r in rows]}


def kernels_line(results, paths, per_step):
    """One entry per kernel: its main-path shape's times and the launches
    of the path it serves (``KERNEL_PATH``), with their unit, and its
    launches on every path and in one step of every training path.
    ``paths``: {path: (unit, launches, those of them on the templates)};
    ``per_step``: {training path: (launches of one step, those on the
    templates)}.  The units: one generation for the flagship inference
    kernels, one clip for the capped kernel, the whole training run for
    the training kernels, both stages' video training runs for the capped
    training forward, one ``occ_bg_fusionp`` generation for the
    split-layout forward and its training run for the split-layout
    training kernels.

    Each sm90 kernel (the forward, the forward with lse, the ring and the
    backward's two) has one entry per TPU kernel it replaces, named
    ``<sm90 kernel>:<wrapper>``: the launches of that wrapper that took the
    sm90 kernel (``check_sm90_launches`` held on every path; all of them
    at 224x400), and its times at that wrapper's main-path shape.  Those
    wrappers' own entries are the template instances of ``attention.cu``
    and ``attention_train.cu``: their times are the template's at the same
    shapes, and their launches the template's (calls outside
    ``sm90_in_scope``: none on these paths)."""
    for _, c, t in paths.values():
        check_sm90_launches(c, t)

    def entry(name, source, replaces, rows, kern, template):
        main = rows[0]  # the dominant main-path shape
        of = (lambda c, t: t.get(kern, 0)) if template \
            else (lambda c, t: c[kern] - t.get(kern, 0))
        unit, c, t = paths[KERNEL_PATH[kern]]
        e = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": of(c, t),
            "launches_per": unit,
            "launches_by_path": {u: of(c, t) for u, c, t in paths.values()},
            "launches_per_train_step": {p: of(c, t) for p, (c, t)
                                        in per_step.items()},
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
        sm90 = _sm90_kernel_of(kern)
        out.append(entry(kern, SOURCE[kern], REPLACES[kern], rows, kern,
                         True))
        out[-1]["routed_to"] = f"{sm90}:{kern}"
        out.append(entry(f"{sm90}:{kern}", SM90_ROUTES[sm90][1],
                         SM90_REPLACES[kern],
                         [r for r in results[sm90] if r["wrapper"] == kern],
                         kern, False))
        out[-1]["sm90_launches_by_path"] = {u: c[sm90]
                                            for u, c, _ in paths.values()}
    return {"kernels": out}


def main() -> int:
    args = sys.argv[1:]
    if "--ddp-rank" in args:
        return ddp_rank(args[args.index("--ddp-rank") + 1])
    if "--nccl-probe" in args:
        return nccl_probe()
    if "--clip-peaks" in args:
        return clip_peaks()
    profile_dir = args[args.index("--profile") + 1] \
        if "--profile" in args else None
    t_start = time.perf_counter()
    smi = phase_device()
    log(f"# packages: {json.dumps({**package_probe(), **toolchain_probe()})}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    timed("build", phase_build)
    results = timed("kernels", phase_kernels)
    # what phase 3 leaves allocated sits under every later phase's peak
    log(f"# allocated after phase 3: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB")
    # path -> (unit, launches, those on the templates); training path ->
    # (launches of one step, those on the templates)
    paths, per_step = {}, {}
    paths["generate"] = ("generation", *timed("generate", phase_generate,
                                              profile_dir))
    timed("reference", phase_reference)
    train = timed("train", phase_train, profile_dir)
    paths["train"] = (f"training run of {1 + TIMED_TRAIN_STEPS} steps",
                      train["run"], train["run_template"])
    per_step["flagship"] = (train["step"], train["step_template"])
    timed("train_reference", phase_train_reference)
    paths["video"] = ("clip", timed("video", phase_video, profile_dir), {})
    timed("video_reference", phase_reference, video=True)
    stages, stage_step = timed("video_train", phase_video_train, profile_dir)
    paths["video_train"] = (
        f"video training runs of {1 + TIMED_VIDEO_TRAIN_STEPS} steps, stage "
        f"1 and stage 2", {k: sum(c[k] for c in stages.values())
                           for k in next(iter(stages.values()))}, {})
    per_step.update({f"video {st}": (c, {}) for st, c in stage_step.items()})
    timed("video_train_reference", phase_video_train_reference)
    more_paths, more_steps = timed("fusionp", phase_fusionp, profile_dir)
    paths.update(more_paths)
    per_step.update(more_steps)
    timed("fusionp_reference", phase_fusionp_reference)
    more_paths, more_steps = timed("variants", phase_variants, profile_dir)
    paths.update(more_paths)
    per_step.update(more_steps)
    timed("variants_reference", phase_variants_reference)
    more_paths, more_steps, more_rows = timed("options", phase_options,
                                              profile_dir)
    paths.update(more_paths)
    per_step.update(more_steps)
    for kern, rows in more_rows.items():
        results.setdefault(kern, []).extend(rows)
    more_paths, more_steps = timed("hd", phase_hd, profile_dir)
    paths.update(more_paths)
    per_step.update(more_steps)
    cache = timed("cache", phase_cache, profile_dir)
    paths["cache"] = (f"cached training run of {CACHE_EPOCHS} epochs at "
                      f"B = {B_CACHE}", cache["run"], cache["run_template"])
    per_step["cache"] = (cache["step"], cache["step_template"])
    timed("bench", phase_bench)
    tools, tools_step = timed("tools", phase_tools)
    paths["tools"] = ("tools phase: 4 micro-steps at k = 2 in the train "
                      "tool, 2 resumed, 4 generations at 2 steps", tools, {})
    per_step["tools micro-step"] = (tools_step, {})
    nusc, nusc_step = timed("nuscenes", phase_nuscenes)
    paths["nuscenes"] = ("nuscenes phase: a step and a UniPC-20 generation "
                         "on the reader's batches, val_set_gen's 2 "
                         "generations at 2 steps", nusc, {})
    per_step["nuscenes"] = (nusc_step, {})
    paths["explore"] = ("explore phase: the capture-off ControlNets + UNet "
                        "forward after the explore tools",
                        timed("explore", phase_explore), {})
    gen_row, ddp_step, splits = timed("ddp", phase_ddp)
    paths["ddp"] = ("ddp phase, rank 0 of 2: its row of a UniPC-20 "
                    "generation and one step", {
                        k: gen_row[k] + ddp_step[k] for k in gen_row}, {})
    per_step["ddp rank"] = (ddp_step, {})
    paths["ddp view split"] = (
        "ddp phase, rank 0 of the (1, 2) mesh: its 3 cameras of a UniPC-20 "
        "generation of one sample", splits["view_generation"], {})
    per_step["ddp frame split rank"] = (splits["frame_step"], {})
    log(f"# all phases: {time.perf_counter() - t_start:.1f} s")
    line = kernels_line(results, paths, per_step)
    line["kernels"].append(split_ring_entry(splits["ring_rows"], paths))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
