"""The port's benchmark on one CUDA card.

    python -m dualdiff_tpu_torch.bench

Port of the repository's ``bench.py``.  It runs the port's entry points at
``bench.py``'s operating points, on synthetic inputs and seeded random
weights (bf16), and prints one JSON line, ``{"metric", "value", "unit",
"vs_baseline", "detail"}``: the flagship generation's frames/s (six-view
frame sets per second) as the headline, with the other sections' results
merged into ``detail`` under ``train``, ``video`` and ``video_train``.

Sections, each in its own process (a clean card for each):

  BENCH_MODE=gen          the flagship generation: B = 2 x 6 views, UniPC-20,
                          CFG 2, 80 box tokens; one untimed call (seed 1)
                          feeds the numerics pin, five timed calls (seeds
                          2-6); vs_baseline against 0.5 frames/s, the
                          estimated A100 figure of ``bench.py``
  BENCH_MODE=train        the flagship training step, B = 2, the
                          conditioning cache on: one warm-up step, then 20
                          steps on one cached batch
  BENCH_MODE=video_16f    a 16-frame clip (sequential CFG, VAE slicing 12):
                          one warm-up clip, three timed clips
  BENCH_MODE=video_train  the video training step on 2-frame clips, B = 1,
                          the cache on; stage 1, or stage 2 with
                          BENCH_VIDEO_EXP=rgd_stage2

With no ``BENCH_MODE`` all four run, each in a subprocess;
``BENCH_SKIP_TRAIN=1`` drops ``train``, ``BENCH_SKIP_VIDEO=1`` drops both
video sections.  The other knobs are ``bench.py``'s: ``BENCH_BATCH``,
``BENCH_MAX_BOXES``, ``BENCH_OVERLAY`` (``+exp=dual_branch_augloss_fusion``,
``+exp-hd=256x704``, ``+exp-hd=432x768`` or any other shipped image exp,
``OVERLAYS``; gen and train; the numerics pin is the flagship's),
``BENCH_TRAIN_BATCH``, ``BENCH_TRAIN_STEPS``, ``BENCH_CACHE_COND``,
``BENCH_FRAMES``, ``BENCH_SEQ_CFG``, ``BENCH_VAE_SLICING``,
``BENCH_VIDEO_ITERS``, ``BENCH_VIDEO_EXP``, ``BENCH_SAVE_PIN`` and the
section timeouts ``BENCH_GEN_TIMEOUT``, ``BENCH_TRAIN_TIMEOUT`` and
``BENCH_VIDEO_TIMEOUT`` (both video sections).  ``BENCH_CN_CACHE=k`` above 1
(gen only) sets ``cn_cache_interval=k``: the ControlNets run at every k-th
step, a secondary probe as in ``bench.py``; its numerics pin has a key of
its own (``..._cn<k>``), so a cached run is never held to the uncached
pin.

Times are host clock around work that ends in ``torch.cuda.synchronize()``;
a training section synchronises once after its loop.  FLOPs come from one
more real call under ``utils.flops.count_flops``: ``model_tflops`` what the
torch counter saw, ``kernel_tflops`` the attention kernels' hand count;
``mfu`` is the first over the card's bf16 peak, ``mfu_corrected`` both.
The generation's images are held to ``utils/bench_pins.json``
(``utils.pins``).  Every section needs a card and raises without one; a
section that fails makes the run exit non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .utils.config import VARIANTS

A100_BASELINE_FPS = 0.5  # bench.py's estimate for the reference on an A100
STEPS = 20
GUIDANCE = 2.0
B = int(os.environ.get("BENCH_BATCH", "2"))
MAX_BOXES = int(os.environ.get("BENCH_MAX_BOXES", "80"))
SEED = 0  # of the random weights
TIMED_GENERATIONS = 5
FLAGSHIP_OVERLAY = "+exp=dual_branch_augloss_fusion"
# BENCH_OVERLAY -> the port's composed config (utils.config)
# and every other shipped image exp (VARIANTS: the 224x400 baseline, the
# occ_bg ablations, occ_fg, occ3d, exp-drive-wm/192x384, ...)
OVERLAYS = {FLAGSHIP_OVERLAY: "dual_branch_augloss_fusion_224x400",
            "+exp-hd=256x704": "dual_branch_augloss_fusion_256x704",
            "+exp-hd=432x768": "dual_branch_augloss_fusion_432x768",
            "+exp=occ_bg_fusionp": "occ_bg_fusionp_224x400",
            **VARIANTS}
# the flagship at its three geometries: its metric text and its pin keys
FLAGSHIP_CONFIGS = {OVERLAYS[k] for k in (FLAGSHIP_OVERLAY, "+exp-hd=256x704",
                                          "+exp-hd=432x768")}
VIDEO_EXPS = {"video_16f": "video_16f_224x400",
              "rgd_stage2": "rgd_stage2_224x400"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (section, its key in the headline's detail, skip knob, timeout knob and
# default, the detail keys it contributes)
SECTIONS = (
    ("train", "train", "BENCH_SKIP_TRAIN", "BENCH_TRAIN_TIMEOUT", 2700,
     ("step_time_s", "train_batch_size", "mfu", "mfu_corrected",
      "peak_mem_gib", "cache_entries", "cache_mb", "section_wall_s")),
    ("video_16f", "video", "BENCH_SKIP_VIDEO", "BENCH_VIDEO_TIMEOUT", 3600,
     ("sec_per_clip", "frames_per_s", "mfu", "mfu_corrected",
      "peak_mem_gib", "section_wall_s")),
    ("video_train", "video_train", "BENCH_SKIP_VIDEO", "BENCH_VIDEO_TIMEOUT",
     3600, ("step_time_s", "frames", "images_per_s", "mfu", "mfu_corrected",
            "peak_mem_gib", "cache_entries", "cache_mb", "section_wall_s")),
)


def config_name(overlay: str) -> str:
    """The port's config of a ``BENCH_OVERLAY``; raises on one it lacks."""
    try:
        return OVERLAYS[overlay]
    except KeyError:
        raise ValueError(f"BENCH_OVERLAY={overlay!r}: the port has "
                         f"{sorted(OVERLAYS)}") from None


def _device() -> dict:
    """The card: its name, ``nvidia-smi``'s name and power limit, the
    torch and CUDA versions.  Raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError("the bench runs on a CUDA card and none is "
                           "available")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "not read"
    return {"backend": "cuda", "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def _models(cfg) -> dict:
    """``build_models`` on the card with seeded random weights (the box
    adapter's projections copied from their base ones, as a fresh trainer
    starts them)."""
    from .runner.factory import build_models, randomize_weights
    from .runner.train_state import init_box_adapter_from_base, named_roots

    models = build_models(cfg)
    for _, module in named_roots(models):
        randomize_weights(module, SEED)
    if cfg.get("use_box_adapter"):
        init_box_adapter_from_base(models)
    return models


def _branches(cfg, name: str) -> str:
    """The metric's model words: ``dual-branch`` for the flagship's
    configs (``FLAGSHIP_CONFIGS``), else the config's task and branch
    count."""
    if name in FLAGSHIP_CONFIGS:
        return "dual-branch"
    kind = "dual-branch" if cfg.use_dual_controlnet else "single-branch"
    return f"{cfg.task_id}, {kind}"


def _flops_detail(model: float, kernel: float, seconds: float,
                  per: str = "") -> dict:
    from .utils.flops import mfu

    return {f"model_tflops{per}": model / 1e12,
            f"kernel_tflops{per}": kernel / 1e12,
            f"kernel_flops{per}": kernel,
            "mfu": mfu(model, seconds),
            "mfu_corrected": mfu(model + kernel, seconds)}


def _peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _launches() -> dict:
    from .ops import attention as A

    return {fn.__name__: fn.launches for fn in A.KERNEL_WRAPPERS
            if fn.launches}


def _generate(cfg, batch, warm_seed: int, seeds) -> dict:
    """One untimed call (``warm_seed``) and timed calls (``seeds``) of the
    pipeline (peak memory over those), then one more under
    ``count_flops``.  -> the untimed call's output and the numbers."""
    from .ops import attention as A
    from .pipeline.bev_controlnet import BEVControlNetPipeline
    from .runner.conds import prepare_batch
    from .utils.flops import count_flops

    pipe = BEVControlNetPipeline(cfg, _models(cfg))
    tensors = prepare_batch(batch, pipe.device)
    gen = torch.Generator(device=pipe.device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = pipe(tensors, generator=gen.manual_seed(warm_seed))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    print(f"# first call {first_s:.1f} s (the kernels' build included)",
          flush=True)
    t0 = time.perf_counter()
    for seed in seeds:
        pipe(tensors, generator=gen.manual_seed(seed))
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / len(seeds)
    peak = _peak_gib()
    A.reset_launch_counts()
    model, kernel = count_flops(pipe, tensors,
                                generator=gen.manual_seed(seeds[0]))
    return {"out": out, "dt": dt, "first_s": first_s, "model": model,
            "kernel": kernel, "launches": _launches(), "peak_mem_gib": peak}


def gen_config(name: str):
    """The generation section's config of the port's config ``name``:
    ``bench.py``'s operating point, with ``BENCH_CN_CACHE`` above 1 as
    ``cn_cache_interval``."""
    from .utils.config import load_config

    overrides = [f"dataset.num_samples={max(B, 2)}",
                 f"runner.pipeline_param.num_inference_steps={STEPS}",
                 f"runner.pipeline_param.guidance_scale={GUIDANCE}",
                 f"runner.pipeline_param.bbox_max_length={MAX_BOXES}"]
    cn_cache = int(os.environ.get("BENCH_CN_CACHE", "0"))
    if cn_cache > 1:
        overrides.append(f"runner.pipeline_param.cn_cache_interval="
                         f"{cn_cache}")
    return load_config(name, overrides)


def gen_pin_key(cfg, name: str) -> str:
    """The numerics pin's key of a generation: the geometry, batch and box
    cap, the task for a model other than the flagship's, and the
    ControlNet cache's interval where it is on."""
    h, w = cfg.dataset.image_size
    key = f"cuda/gen_{h}x{w}_b{B}_boxes{MAX_BOXES}"
    if name not in FLAGSHIP_CONFIGS:  # another model at the same geometry
        key += f"_{cfg.task_id}"
    cn_cache = int(cfg.runner.pipeline_param.get("cn_cache_interval", 0))
    if cn_cache > 1:
        key += f"_cn{cn_cache}"
    return key


def main_gen() -> dict:
    """The headline: the flagship generation (``bench.py::main``)."""
    from .data.collate import collate_fn
    from .data.synthetic import SyntheticNuScenes
    from .data.tokenizer import build_tokenizer
    from .utils.pins import check_pin, output_stats, save_pin

    info = _device()
    overlay = os.environ.get("BENCH_OVERLAY", FLAGSHIP_OVERLAY)
    name = config_name(overlay)
    cfg = gen_config(name)
    h, w = cfg.dataset.image_size
    ds = SyntheticNuScenes(num_samples=max(B, 2), image_size=(h, w),
                           seed=int(cfg.seed))
    tok = build_tokenizer(str(cfg.model.pretrained_model_name_or_path))
    batch = collate_fn([ds[i] for i in range(B)], cfg, tok, is_train=False,
                       rng=np.random.default_rng(0))
    run = _generate(cfg, batch, 1, list(range(2, 2 + TIMED_GENERATIONS)))
    # the seed-1 images of the seed-0 batch and weights are deterministic
    # per card and library; drift beyond the band is a numerics regression
    pin_key = gen_pin_key(cfg, name)
    stats = output_stats(run["out"])
    pin = check_pin(stats, pin_key)
    if pin["status"] == "drift":
        print(f"# NUMERICS DRIFT vs pinned output ({pin_key}): "
              f"{json.dumps(pin['drift'])}", file=sys.stderr, flush=True)
    elif pin["status"] == "unpinned" and os.environ.get("BENCH_SAVE_PIN"):
        save_pin(stats, pin_key)
        pin["status"] = "pinned_now"
    dt = run["dt"]
    cn_cache = int(cfg.runner.pipeline_param.cn_cache_interval)
    cached = f", ControlNets every {cn_cache} steps" if cn_cache > 1 else ""
    return {
        "metric": f"6-view {h}x{w} frames/sec/chip (UniPC-20, CFG 2, "
                  f"{_branches(cfg, name)}{cached})",
        "value": B / dt,
        "unit": "frames/s/chip",
        # the A100 estimate describes the reference's 224x400 default
        "vs_baseline": (B / dt / A100_BASELINE_FPS
                        if overlay == FLAGSHIP_OVERLAY and cn_cache <= 1
                        else None),
        "detail": {
            "sec_per_frame": dt, "first_call_s": run["first_s"],
            "batch": B, "bbox_max_length": MAX_BOXES,
            "cn_cache_interval": cn_cache,
            "baseline_assumption_fps": A100_BASELINE_FPS,
            **_flops_detail(run["model"], run["kernel"], dt),
            "launches": run["launches"],
            "peak_mem_gib": run["peak_mem_gib"],
            "numerics_pin": pin, **info,
        },
    }


def _time_steps(trainer, steps: int) -> dict:
    """One warm-up step and ``steps`` steps on the trainer's first planned
    batch (cached when the cache is on), synchronised once after the loop
    (peak memory over those steps), then one more step under
    ``count_flops``."""
    from .runner.trainer import batch_rows, make_draws, train_step
    from .utils.flops import count_flops

    batch = trainer._build_batch(next(trainer._batch_plan(0)))
    rows, views = batch_rows(batch)

    def step():
        draws = make_draws(trainer.generator, trainer.cfg, rows, views,
                           trainer.latent_hw,
                           trainer.schedule.num_train_timesteps,
                           trainer.device, frames=trainer.frames)
        return train_step(trainer.loss_fn, trainer.optimizer, batch, draws)

    t0 = time.perf_counter()
    loss = float(step()["loss"])
    first_s = time.perf_counter() - t0
    print(f"# first step {first_s:.1f} s loss={loss:.4f}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = step()
    loss = float(metrics["loss"])  # synchronises the loop's last step
    dt = (time.perf_counter() - t0) / steps
    peak = _peak_gib()
    model, kernel = count_flops(step)
    return {"dt": dt, "first_s": first_s, "loss": loss, "model": model,
            "kernel": kernel, "peak_mem_gib": peak,
            "cache_entries": len(trainer._cond_cache),
            "cache_mb": trainer._cond_cache_bytes / 2 ** 20}


def _train_detail(run: dict, steps: int, cache: bool) -> dict:
    dt = run["dt"]
    return {"step_time_s": dt, "cache_conditioning": cache, "steps": steps,
            "first_step_s": run["first_s"], "loss": run["loss"],
            **_flops_detail(run["model"], run["kernel"], dt, "_per_step"),
            "peak_mem_gib": run["peak_mem_gib"],
            "cache_entries": run["cache_entries"],
            "cache_mb": run["cache_mb"]}


def main_train() -> dict:
    """The flagship training step (``bench.py::main_train``)."""
    from .data.synthetic import SyntheticNuScenes
    from .runner.trainer import MultiviewTrainer
    from .utils.config import load_config

    info = _device()
    steps = int(os.environ.get("BENCH_TRAIN_STEPS", "20"))
    tb = int(os.environ.get("BENCH_TRAIN_BATCH", "2"))
    cache = os.environ.get("BENCH_CACHE_COND", "1") != "0"
    name = config_name(os.environ.get("BENCH_OVERLAY", FLAGSHIP_OVERLAY))
    cfg = load_config(name, [
        "dataset.num_samples=4", "runner.max_train_steps=1000",
        "runner.num_workers=0",
        f"runner.cache_conditioning={'true' if cache else 'false'}",
        f"runner.train_batch_size={tb}"])
    h, w = cfg.dataset.image_size
    ds = SyntheticNuScenes(num_samples=4, image_size=(h, w),
                           seed=int(cfg.seed))
    run = _time_steps(MultiviewTrainer(cfg, ds, models=_models(cfg)), steps)
    return {
        "metric": f"train images/sec/chip ({h}x{w}, {_branches(cfg, name)}"
                  f"{' + FGM aug loss' if cfg.use_aug_loss else ''}"
                  ", full SD scale"
                  f"{', conditioning cache' if cache else ''})",
        "value": 6 * tb / run["dt"],
        "unit": "images/s/chip",
        "vs_baseline": None,
        "detail": {"train_batch_size": tb,
                   **_train_detail(run, steps, cache), **info},
    }


def main_video() -> dict:
    """A 16-frame clip's generation (``bench.py::main_video``)."""
    from .data.tokenizer import build_tokenizer
    from .data.video import SyntheticNuScenesVideo, collate_video
    from .utils.config import VIDEO_16F, load_config

    info = _device()
    frames = int(os.environ.get("BENCH_FRAMES", "16"))
    seq = os.environ.get("BENCH_SEQ_CFG", "1") != "0"
    slicing = int(os.environ.get("BENCH_VAE_SLICING", "12"))
    iters = int(os.environ.get("BENCH_VIDEO_ITERS", "3"))
    cfg = load_config(VIDEO_16F, [
        f"video.num_frames={frames}",
        f"runner.pipeline_param.vae_slicing={slicing}",
        f"runner.pipeline_param.sequential_cfg={'true' if seq else 'false'}"])
    h, w = cfg.dataset.image_size
    clips = SyntheticNuScenesVideo(num_clips=2, num_frames=frames,
                                   image_size=(h, w))
    tok = build_tokenizer(str(cfg.model.pretrained_model_name_or_path))
    batch = collate_video([clips[0]], cfg, tok, rng=np.random.default_rng(0))
    run = _generate(cfg, batch, 1, list(range(2, 2 + iters)))
    dt = run["dt"]
    return {
        "metric": f"{frames}-frame 6-view {h}x{w} clips/sec/chip "
                  "(UniPC-20, CFG, dual-branch, ST-Attn+temporal)",
        "value": 1.0 / dt,
        "unit": "clips/s/chip",
        "vs_baseline": None,
        "detail": {"sec_per_clip": dt, "frames_per_s": frames / dt,
                   "first_call_s": run["first_s"],
                   **_flops_detail(run["model"], run["kernel"], dt),
                   "launches": run["launches"],
                   "peak_mem_gib": run["peak_mem_gib"], **info},
    }


def main_video_train() -> dict:
    """The video training step (``bench.py::main_video_train``)."""
    from .data.video import SyntheticNuScenesVideo
    from .runner.video_trainer import VideoTrainer
    from .utils.config import load_config

    info = _device()
    steps = int(os.environ.get("BENCH_TRAIN_STEPS", "20"))
    frames = int(os.environ.get("BENCH_FRAMES", "2"))
    cache = os.environ.get("BENCH_CACHE_COND", "1") != "0"
    exp = os.environ.get("BENCH_VIDEO_EXP", "video_16f")
    if exp not in VIDEO_EXPS:
        raise ValueError(f"BENCH_VIDEO_EXP={exp!r}: the port has "
                         f"{sorted(VIDEO_EXPS)}")
    cfg = load_config(VIDEO_EXPS[exp], [
        f"video.num_frames={frames}", "runner.max_train_steps=1000",
        "runner.num_workers=0",
        f"runner.cache_conditioning={'true' if cache else 'false'}",
        "runner.train_batch_size=1"])
    h, w = cfg.dataset.image_size
    clips = SyntheticNuScenesVideo(num_clips=2, num_frames=frames,
                                   image_size=(h, w))
    run = _time_steps(VideoTrainer(cfg, clips, models=_models(cfg)), steps)
    dt = run["dt"]
    return {
        "metric": f"video train [{exp}] {frames}-frame 6-view clips/sec/chip "
                  f"({h}x{w}, ST-Attn+temporal, dual-branch, full SD scale"
                  f"{', conditioning cache' if cache else ''})",
        "value": 1.0 / dt,
        "unit": "clips/s/chip",
        "vs_baseline": None,
        "detail": {"frames": frames, "images_per_s": 6 * frames / dt,
                   **_train_detail(run, steps, cache), **info},
    }


MODES = {"gen": main_gen, "train": main_train, "video_16f": main_video,
         "video_train": main_video_train}


def run_section(mode: str, timeout_s: int) -> dict:
    """One section in its own process -> its JSON line, or ``{"error":
    ...}`` when it timed out, exited non-zero or printed no line."""
    env = dict(os.environ, BENCH_MODE=mode)
    t0 = time.time()
    try:
        p = subprocess.run([sys.executable, "-m", "dualdiff_tpu_torch.bench"],
                           env=env, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"error": f"section timed out after {timeout_s}s"}
    sys.stderr.write(p.stdout or "")
    sys.stderr.write(p.stderr or "")
    if p.returncode == 0:
        for line in reversed((p.stdout or "").strip().splitlines()):
            if line.strip().startswith("{"):
                try:
                    out = json.loads(line)
                except ValueError:
                    continue
                out.setdefault("detail", {})["section_wall_s"] = \
                    time.time() - t0
                return out
    return {"error": f"exit code {p.returncode}: " + (
        (p.stderr or p.stdout) or "no output")[-800:].strip()}


def summarize(section: dict, keys) -> dict:
    """value / unit and a subset of a section's detail, for the headline
    (``bench.py::_summarize``)."""
    if "error" in section:
        return {"error": section["error"]}
    out = {"value": section.get("value"), "unit": section.get("unit")}
    det = section.get("detail", {})
    out.update({k: det[k] for k in keys if k in det})
    return out


def merge(gen: dict, sections: dict) -> dict:
    """The one line: the ``gen`` section's result (a placeholder with its
    error when it failed) with each other section that ran (``sections``:
    {mode: result}) summarised into its ``detail``."""
    if "error" in gen:
        gen = {"metric": "6-view 224x400 frames/sec/chip "
                         "(UniPC-20, CFG 2, dual-branch)",
               "value": None, "unit": "frames/s/chip", "vs_baseline": None,
               "detail": {"error": gen["error"]}}
    detail = gen.setdefault("detail", {})
    for mode, key, _, _, _, keys in SECTIONS:
        if mode in sections:
            detail[key] = summarize(sections[mode], keys)
    return gen


def failed(line: dict) -> bool:
    """True when a section of the merged line failed."""
    det = line.get("detail", {})
    return "error" in det or any(
        isinstance(v, dict) and "error" in v
        for k, v in det.items() if k in {s[1] for s in SECTIONS})


def orchestrate() -> int:
    """Every section in its own process, one line; exit code 1 when a
    section failed."""
    gen = run_section("gen", int(os.environ.get("BENCH_GEN_TIMEOUT",
                                                 "3600")))
    sections = {}
    for mode, _, skip, timeout, default, _ in SECTIONS:
        if os.environ.get(skip, "") != "1":
            sections[mode] = run_section(
                mode, int(os.environ.get(timeout, str(default))))
    line = merge(gen, sections)
    print(json.dumps(line))
    return 1 if failed(line) else 0


def main() -> int:
    mode = os.environ.get("BENCH_MODE", "")
    if not mode:
        return orchestrate()
    if mode not in MODES:
        raise ValueError(f"BENCH_MODE={mode!r}: one of {sorted(MODES)}")
    print(json.dumps(MODES[mode]()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
