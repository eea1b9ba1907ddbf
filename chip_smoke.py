#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``dualdiff_tpu_torch``) on one card.

    python3 chip_smoke.py                # the default run; one CUDA card
    python3 chip_smoke.py --profile DIR  # also writes a kernel-time
                                         # breakdown of one generation to
                                         # DIR/profile_generation.txt

Phases, in order; any failure exits non-zero:

1. device   requires CUDA; prints the card's name and power limit.
2. build    compiles every CUDA kernel from ``dualdiff_tpu_torch/csrc``.
3. kernels  each kernel against its plain PyTorch version at the shapes the
            flagship path gives it (bf16 inputs; plain version in float32,
            rounded once), with times of the kernel, the plain version, one
            PyTorch library call where one computes the same function, and
            the least time the card could take (bound).
4. generate the flagship dual-branch 224x400 generation at full SD v1.5
            width (two ControlNets, seeded random weights, bf16), B=2 x 6
            views, UniPC-20, CFG 2: one warm-up call and timed calls; checks
            shape, finiteness, range and the kernels' launch counts per call.
5. reference the tiny model set at 256x128, 3 steps, on the card in bf16
            against the same weights on the CPU in float32 (plain path).

The line before the last is the ``kernels`` JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, NVIDIA data sheet (SXM)
H100_BYTES_PER_S = 3.35e12
SEED = 0
TIMED_GENERATIONS = 3

# main-path kernel shapes: CFG batch 2*B*N = 24 rows, the 28x50 = 1400-token
# latent level at C = 320 with 8 heads (d = 40); cross-attention KV
# 1 camera + 77 text + 80 box tokens = 158 in the UNet and both ControlNets
B, N_CAM, L, C, HEADS = 2, 6, 1400, 320, 8
KV_CROSS = 1 + 77 + 80
# the TPU kernel each CUDA kernel replaces
REPLACES = {
    "packed_attention_fwd": "dualdiff_tpu/ops/attention.py:468",      # _fwd_kernel_t
    "packed_attention_nbr_fwd": "dualdiff_tpu/ops/attention.py:671",  # _fwd_kernel_t_nbr
}


def log(msg: str) -> None:
    print(msg, flush=True)


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
                if "registers" in line or "spill" in line:
                    log(f"#   {line.strip()}")


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls after one warm-up,
    with CUDA events."""
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
        ("packed_attention_fwd", "ragged, d=80", 3, 777, 333, 320, 4, 0),
        ("packed_attention_nbr_fwd", "attn4 camera ring", 2 * B * N_CAM, L, L,
         C, HEADS, N_CAM),
        ("packed_attention_nbr_fwd", "ragged ring, d=80", 2 * 3, 701, 701,
         320, 4, 3),
    ]


def phase_kernels():
    from dualdiff_tpu_torch.ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(SEED)
    results = {}
    for kern, label, b, lq, lk, c, heads, n_cam in kernel_cases():
        q = torch.randn(b, lq, c, generator=g, device="cuda").bfloat16()
        k = torch.randn(b, lk, c, generator=g, device="cuda").bfloat16()
        v = torch.randn(b, lk, c, generator=g, device="cuda").bfloat16()
        d = c // heads
        if n_cam:
            run = lambda: A.packed_attention_nbr_fwd(q, k, v, heads, n_cam)
            plain = lambda: A.attention_packed_neighbors_plain(
                q, k, v, heads, n_cam)
            library = None  # no single PyTorch call computes the ring sum
            flops = 8 * b * lq * lk * c
        else:
            run = lambda: A.packed_attention_fwd(q, k, v, heads)
            plain = lambda: A.attention_packed_plain(q, k, v, heads)
            split = lambda t: t.view(b, t.shape[1], heads, d).transpose(1, 2)
            library = lambda: torch.nn.functional.scaled_dot_product_attention(
                split(q), split(k), split(v))
            flops = 4 * b * lq * lk * c
        got = run()
        torch.cuda.synchronize()
        want = plain()
        err = (got.float() - want.float()).abs().max().item()
        # bf16 output: one rounding of |o| <= max|v| is 2^-8 relative; the
        # kernel also rounds P to bf16 for the P.V product (2^-9 relative
        # per term, averaging out over the keys)
        tol = 2.0 ** -7 * want.float().abs().max().item() + 1e-3
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        bound_ms, bound_by = bound(nbytes, flops)
        row = {
            "kernel": kern, "replaces": REPLACES[kern], "case": label,
            "shape": {
                "b": b, "lq": lq, "lk": lk, "c": c, "heads": heads,
                "head_dim": d, "n_cam": n_cam},
            "max_abs_err": err, "tol": tol,
            "kernel_ms": cuda_ms(run, 20), "plain_ms": cuda_ms(plain, 3),
            "library_ms": cuda_ms(library, 20) if library else None,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log(json.dumps(row))
        if not (err <= tol and math.isfinite(err)):
            raise AssertionError(f"{kern} [{label}] disagrees with its plain "
                                 f"version: max abs err {err} > {tol}")
        results.setdefault(kern, []).append(row)
    return results


def _flagship(device, tiny=False, extra=(), weights_from=None):
    """(cfg, collated B=2 synthetic batch, pipeline) with seeded random
    weights, or the weights of the models in ``weights_from``."""
    import numpy as np

    from dualdiff_tpu_torch.data.collate import collate_fn
    from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes
    from dualdiff_tpu_torch.data.tokenizer import HashTokenizer
    from dualdiff_tpu_torch.pipeline.bev_controlnet import \
        BEVControlNetPipeline
    from dualdiff_tpu_torch.runner.factory import (build_models,
                                                   randomize_weights)
    from dualdiff_tpu_torch.utils.config import load_config

    cfg = load_config(overrides=extra)
    h, w = cfg.dataset.image_size
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


def phase_generate(profile_dir):
    from dualdiff_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    cfg, batch, pipe = _flagship("cuda")
    torch.cuda.synchronize()
    log(f"# models built and cast in {time.perf_counter() - t0:.1f} s")
    steps = int(cfg.runner.pipeline_param.num_inference_steps)
    h, w = cfg.dataset.image_size
    lh, lw = h // 8, w // 8
    # from the code: per model evaluation the UNet's 5 transformer blocks at
    # 1400 tokens (down_blocks_0: 2, up_blocks_3: 3) and each ControlNet's 2
    # (down_blocks_0) run attn1 + attn2 -> 18; attn4 runs in the UNet's 5
    expect = {"packed_attention_fwd": 18 * steps,
              "packed_attention_nbr_fwd": 5 * steps}
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
        counts = {fn.__name__: fn.launches for fn in A.KERNEL_WRAPPERS}
        if counts != expect:
            raise AssertionError(f"kernel launches {counts} != {expect}")
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
    row = {"phase": "generate", "config": "dual_branch_augloss_fusion 224x400",
           "batch": B, "views": N_CAM, "steps": steps, "cfg_scale": float(
               cfg.runner.pipeline_param.guidance_scale),
           "latent_hw": [lh, lw], "s_per_generation": s,
           "s_per_generation_all": times, "samples_per_s": B / s,
           "images_per_s": B * N_CAM / s,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches_per_generation": counts}
    log(json.dumps(row))
    if profile_dir:
        profile_generation(pipe, batch, s, profile_dir)
    del pipe
    torch.cuda.empty_cache()
    return counts


_CATEGORIES = (  # kernel-name fragment -> category, first match wins
    ("attention_kernel", "attention kernels (csrc/attention.cu)"),
    ("fprop", "convolution (cuDNN)"), ("conv", "convolution (cuDNN)"),
    ("gemm", "matmul (cuBLAS / CUTLASS)"), ("nvjet", "matmul (cuBLAS / CUTLASS)"),
    ("softmax", "softmax (einsum levels)"),
    ("layer_norm", "norm statistics"), ("reduce_kernel", "norm statistics"),
    ("copy", "copies and dtype casts"), ("elementwise", "elementwise"),
)


def profile_generation(pipe, batch, wall_unprofiled: float,
                       out_dir: str) -> None:
    """Device time of one generation by kernel and by category
    (torch.profiler); the idle share is taken against the unprofiled wall
    time, since the profiler itself slows the host."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(batch, generator=gen)
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
    with open(os.path.join(out_dir, "profile_generation.txt"), "w") as f:
        f.write(f"profiled wall {wall:.3f} s, unprofiled wall "
                f"{wall_unprofiled:.3f} s, device busy {busy:.3f} s\n")
        for cat, (ms, n) in sorted(cats.items(), key=lambda x: -x[1][0]):
            f.write(f"{ms:10.2f} ms {n:7d}  [{cat}]\n")
        for us, n, key in rows[:40]:
            f.write(f"{us / 1e3:10.2f} ms {n:7d}  {key[:160]}\n")
    log(json.dumps({"phase": "profile", "device_busy_s": busy,
                    "wall_s": wall_unprofiled, "profiled_wall_s": wall,
                    "idle_share": max(0.0, 1.0 - busy / wall_unprofiled),
                    "by_category_ms": {c: v[0] for c, v in cats.items()}}))


def phase_reference():
    """Tiny models, 256x128, 3 steps: bf16 on the card (kernels) against
    float32 on the CPU (plain versions), same weights and noise.  Mean
    absolute error on the [0, 1] images at most 1e-2: bf16 weights and
    activations through every layer and step (3.1e-3 measured on an
    H100 80GB HBM3 at 700 W)."""
    extra = ["dataset.image_size=[256, 128]",
             "runner.pipeline_param.num_inference_steps=3"]
    _, batch, cpu_pipe = _flagship(
        "cpu", tiny=True, extra=extra + ["runner.mixed_precision=fp32"])
    cpu_models = cpu_pipe.models
    with torch.no_grad():
        # cam2token reads raw intrinsics (fx ~ 1266): a random kernel makes
        # the camera token ~400 and the cross-attention softmax one-hot,
        # where bf16 rounding alone flips the winner
        for cn in cpu_models["controlnets"]:
            cn.cam2token.weight.mul_(0.01)
    cfg, _, gpu_pipe = _flagship("cuda", tiny=True, extra=extra,
                                 weights_from=cpu_models)
    h, w = cfg.dataset.image_size
    lat = torch.randn((B, 1, h // 8, w // 8, 4),
                      generator=torch.Generator().manual_seed(SEED))
    want = cpu_pipe(batch, latents=lat)
    got = gpu_pipe(batch, latents=lat).cpu()
    err = (got - want).abs()
    row = {"phase": "reference", "max_abs_err": err.max().item(),
           "mean_abs_err": err.mean().item(), "tol_mean": 1e-2}
    log(json.dumps(row))
    if not row["mean_abs_err"] <= row["tol_mean"]:
        raise AssertionError("bf16 generation on the card disagrees with the "
                             "float32 CPU reference")


def kernels_line(results, counts):
    out = []
    for kern, rows in results.items():
        main = rows[0]  # the dominant main-path shape
        out.append({
            "name": kern, "route": "cuda",
            "source": "dualdiff_tpu_torch/csrc/attention.cu",
            "replaces": REPLACES[kern], "launches": counts[kern],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
        })
    return {"kernels": out}


def main() -> int:
    args = sys.argv[1:]
    profile_dir = args[args.index("--profile") + 1] \
        if "--profile" in args else None
    smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    results = phase_kernels()
    counts = phase_generate(profile_dir)
    phase_reference()
    print(json.dumps(kernels_line(results, counts)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
