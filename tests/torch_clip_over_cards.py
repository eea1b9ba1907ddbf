"""One 16-frame clip's training step with its frames split over ranks of a
card each (NCCL), the JAX package's frame axis on a four-card host: a
one-off read, not a test (pytest does not collect it)::

    python -m tests.torch_clip_over_cards [ranks]    # 4 by default

The parent spawns ``ranks`` processes of this module (``--rank DIR``, with
the launcher's variables; ``init_from_env`` joins them over NCCL, a card
each) and meanwhile computes on the CPU one process's float32 gradient of
the tiny RGD stage-2 clip of ``FRAMES`` frames at 256x128
(``chip_smoke.gate_reading``).  Each rank, holding ``FRAMES / ranks``
frames of the clip:

1. the same tiny clip's bf16 gradient on the ``(data=ranks)`` mesh, the
   ranks' gradients averaged (``gate_reading(..., mesh=)``);
2. at full width (224x400, seeded weights, bf16, remat) one clip of
   ``FRAMES`` frames, stage 2 (``rgd_stage2``: LoRA, the reward decoding
   every frame under grad) and stage 1 (``video_16f``), a warm-up and a
   timed step each (``chip_smoke.clip_step_reading``: s/step, the memory
   before the timed step and its peak, launches held to their derivation,
   the gathered bytes and host seconds).

The parent holds rank 0's averaged gradient to the CPU's under phase 7's
gate (``chip_smoke.gate_row`` / ``_reference_gate``: loss 2e-3 relative,
every leaf 0.07) and prints one JSON line of the readings.  With fewer
cards than ranks the ranks share them over gloo.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

import chip_smoke as s

FRAMES = 16
# how the parent starts a rank (``--rank DIR`` is appended)
RANK_CMD = [sys.executable, "-m", "tests.torch_clip_over_cards"]


def rank_main(out_dir: str) -> int:
    from dualdiff_tpu_torch.parallel import mesh as M
    from dualdiff_tpu_torch.utils.config import RGD_STAGE2, VIDEO_16F

    t0 = time.perf_counter()
    backend = M.init_from_env()
    mesh = M.create_mesh()
    dev = M.rank_device()
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": mesh.rank, "world": mesh.world, "backend": backend,
           "device": str(dev)}
    loss, grads, launches = s.gate_reading("cuda", video=True, frames=FRAMES,
                                           mesh=mesh)
    out["gate"] = (loss, grads if mesh.rank == 0 else None, launches)
    del grads
    for stage, name in (("stage2", RGD_STAGE2), ("stage1", VIDEO_16F)):
        out[stage] = s.clip_step_reading(dev, mesh, frames=FRAMES, name=name)
    out["rank_s"] = time.perf_counter() - t0
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    M.barrier()
    M.destroy()
    return 0


def main(ranks: int = 4) -> int:
    s.phase_device()
    s.phase_build()
    smi = s.card()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="clip_over_cards_")
    port = s._free_port()
    procs = []
    try:
        procs = [subprocess.Popen(
            RANK_CMD + ["--rank", tmp], env=s._rank_env(r, ranks, port),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(ranks)]
        cpu = s.gate_reading("cpu", fp32=True, video=True, frames=FRAMES)
        outs = [p.communicate(timeout=1800)[0] for p in procs]
        for r, (p, o) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"rank {r} failed:\n{o[-6000:]}")
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                          weights_only=False) for r in range(ranks)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    gate = s.gate_row("clip over cards train_reference", cpu, res[0]["gate"])
    s._reference_gate(gate, s.VIDEO_GATE_KERNELS)
    keys = ("frames_here", "s_per_step", "warmup_s", "base_gib", "peak_gib")
    row = {"card": smi, "ranks": ranks, "frames": FRAMES,
           "backends": [r["backend"] for r in res],
           "devices": [r["device"] for r in res],
           "gate_worst_leaf": next(iter(gate["worst_leaf_rel_err"].items())),
           "gate_loss_rel_err": gate["loss_rel_err"],
           **{stage: {"per_rank": [{k: r[stage][k] for k in keys}
                                   for r in res],
                      "gather_per_step": [
                          {k: r[stage]["steps"][1][k] for k in (
                              "gather_calls", "gather_bytes", "gather_s")}
                          for r in res],
                      "loss": res[0][stage]["steps"][1]["loss"],
                      "launches_per_step": res[0][stage]["launches_per_step"]}
              for stage in ("stage2", "stage1")},
           "rank_s": [r["rank_s"] for r in res],
           "seconds": time.perf_counter() - t0}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if "--rank" in args:
        sys.exit(rank_main(args[args.index("--rank") + 1]))
    sys.exit(main(int(args[0]) if args else 4))
