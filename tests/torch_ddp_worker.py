"""One process of ``tests/test_torch_ddp.py``'s data-parallel run on the CPU.

    python -m tests.torch_ddp_worker <weights.pt> <out.pt> <threads>

With the launcher's variables set (``RANK``, ``WORLD_SIZE`` = 2,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) it
is one rank of a two-rank gloo group; without them it is the one process
that the ranks are held to.  Each process loads the same tiny weights
(``weights.pt``: ``from_jax`` of the JAX params of
``torch_parity.tiny_setup`` under ``"image"``, of
``torch_parity.tiny_video_setup`` under ``"video"`` and of its RGD stage-2
set under ``"rgd"``, one state dict a module), then:

1. generates the global batch of 2 seed-0 synthetic samples at 256x128
   (3 UniPC steps, ``torch.Generator`` seed 0) and keeps its rows;
2. takes one ``MultiviewTrainer`` step on the global batch of those 2
   samples, recording the gradients the optimizer is handed (the averaged
   ones under the group) and the loss;
3. takes one ``VideoTrainer`` step (stage 1, tiny 2-frame clips at 256x128,
   the conditioning cache on) on a global batch of 2 clips;
4. on a ``(data=1, view=2)`` mesh, each rank holding 3 of the 6 cameras
   of both samples, 1 again from initial noise of its own for each camera
   (the lone process: that generation whole) and 2 again, from fresh
   weights (the lone process's 2 is their reference);
5. one ``VideoTrainer`` step of one 4-frame clip at 256x128, stage 1, RGD
   stage 2 (the temporal reward on) and RGD stage 2 with the reward over
   the first 2 frames, from fresh weights: on the ranks a ``(data=2)``
   mesh, so each holds 2 of the clip's frames (and rank 1 none of the
   reward's).

and saves what it read to ``out.pt``.  Imports no JAX.
"""

import os
import sys

import numpy as np
import torch

from tests import torch_parity as tp
from dualdiff_tpu_torch.data.collate import collate_fn
from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes
from dualdiff_tpu_torch.data.tokenizer import HashTokenizer
from dualdiff_tpu_torch.data.video import SyntheticNuScenesVideo
from dualdiff_tpu_torch.parallel import mesh as M
from dualdiff_tpu_torch.pipeline.bev_controlnet import BEVControlNetPipeline
from dualdiff_tpu_torch.runner.factory import build_models
from dualdiff_tpu_torch.runner.train_state import named_roots
from dualdiff_tpu_torch.runner.trainer import MultiviewTrainer
from dualdiff_tpu_torch.runner.video_trainer import VideoTrainer

B = 2  # the global batch: samples, or clips
CLIP_FRAMES = 4  # frames of the one clip split over the ranks' frames
PREFIX = 2  # the reward's frames of the clip: rank 0's two, none of rank 1's


def _recorded_step(trainer) -> dict:
    """One ``run`` step, with the gradients handed to the optimizer and
    the trainables after the update."""
    opt, seen = trainer.optimizer, {}
    step = opt.step

    def recording(grads=None):
        g = grads if grads is not None else opt.grads()
        seen.update({k: v.detach().float().clone() for k, v in g.items()})
        return step(grads)

    opt.step = recording
    metrics = trainer.run(max_steps=1)
    return {"loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
            **{k: metrics[k] for k in ("reward",) if k in metrics},
            "grads": seen,
            "trainables": {k: p.detach().clone()
                           for k, p in trainer.trainable.items()}}


def _loaded(cfg, state) -> dict:
    models = build_models(cfg, tiny=True, device="cpu")
    for root, m in named_roots(models):
        m.load_state_dict(state[root], strict=True)
    return models


def main(weights_path: str, out_path: str, threads: str) -> None:
    torch.set_num_threads(int(threads))
    out = {}
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        out["backend"] = M.init_from_env("cpu")
    mesh = M.create_mesh()
    out.update(world=mesh.world, rank=mesh.rank, data=mesh.data)
    try:  # a view axis that does not divide the ranks
        M.create_mesh(data=-1, view=mesh.world + 1)
    except ValueError as e:
        out["view_refused"] = str(e)

    cfg = tp.port_config(tp.TINY_OVERRIDES + [
        f"runner.train_batch_size={B}", "runner.checkpointing_steps=0",
        "runner.num_workers=0"])
    state = torch.load(weights_path, weights_only=True)
    models = _loaded(cfg, state["image"])

    h, w = cfg.dataset.image_size
    ds = SyntheticNuScenes(num_samples=B, image_size=(h, w),
                           seed=int(cfg.seed))
    batch = collate_fn([ds[i] for i in range(B)], cfg, HashTokenizer(),
                       is_train=False, rng=np.random.default_rng(0))
    pipe = BEVControlNetPipeline(cfg, models, device="cpu", mesh=mesh)
    out["images"] = pipe(batch, generator=torch.Generator().manual_seed(0))
    out["rows"] = list(range(B))[mesh.rows(B)]
    # initial noise of its own for each camera
    cam_noise = torch.randn((B, 6, h // 8, w // 8, 4),
                            generator=torch.Generator().manual_seed(1))
    if mesh.world == 1:
        out["cam_images"] = pipe(batch, latents=cam_noise)

    trainer = MultiviewTrainer(cfg, ds, device="cpu", models=models)
    out["step"] = _recorded_step(trainer)

    if mesh.world > 1:  # the cameras over the ranks: 3 each
        views = M.create_mesh(data=1, view=mesh.world)
        out["view_group"] = (views.data, views.view, views.data_rank,
                             views.view_rank,
                             views.view_group is not None)
        cams = views.cams(6)
        out["view_cams"] = [cams.start, cams.stop]
        pipe = BEVControlNetPipeline(cfg, _loaded(cfg, state["image"]),
                                     device="cpu", mesh=views)
        out["view_images"] = pipe(batch, latents=cam_noise)
        trainer = MultiviewTrainer(cfg, ds, device="cpu", mesh=views,
                                   models=_loaded(cfg, state["image"]))
        out["view_step"] = _recorded_step(trainer)
        out["view_split"] = trainer.split is not None

    vcfg = tp.port_config(tp.TINY_VIDEO_OVERRIDES + [
        f"runner.train_batch_size={B}",
        "runner.checkpointing_steps=0", "runner.num_workers=0",
        "runner.cache_conditioning=true"], video=True)
    vmodels = _loaded(vcfg, state["video"])
    clips = SyntheticNuScenesVideo(num_clips=B, num_frames=2,
                                   image_size=tuple(vcfg.dataset.image_size))
    video = VideoTrainer(vcfg, clips, device="cpu", models=vmodels)
    out["video"] = _recorded_step(video)
    out["video"]["cache_keys"] = sorted(video._cond_cache)

    # one clip of 4 frames; on the ranks 2 frames each
    for stage, kind, extra in (
            ("frames_stage1", True, []), ("frames_stage2", "rgd", []),
            ("frames_prefix", "rgd", [f"video.rgd.reward_frames={PREFIX}"])):
        ccfg = tp.port_config(tp.TINY_VIDEO_OVERRIDES + [
            f"video.num_frames={CLIP_FRAMES}", "runner.train_batch_size=1",
            "runner.checkpointing_steps=0", "runner.num_workers=0"] + extra,
            video=kind)
        clip = SyntheticNuScenesVideo(
            num_clips=1, num_frames=CLIP_FRAMES,
            image_size=tuple(ccfg.dataset.image_size))
        video = VideoTrainer(ccfg, clip, device="cpu", mesh=mesh,
                             models=_loaded(ccfg, state[
                                 "rgd" if kind == "rgd" else "video"]))
        out[stage] = _recorded_step(video)
        split = video.split
        out[stage]["split"] = None if split is None else (
            split.n_local, split.frame_ranks, split.frame_rank)
    M.barrier()
    torch.save(out, out_path)
    M.destroy()


if __name__ == "__main__":
    main(*sys.argv[1:4])
