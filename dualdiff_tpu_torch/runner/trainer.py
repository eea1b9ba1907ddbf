"""Training step and loop.

Port of ``dualdiff_tpu/runner/trainer.py``: the loss (VAE encode, noise,
text encode, both ControlNet branches, residual sum, multiview UNet, MSE plus
the FGM aug loss; for clips one timestep per clip and, in RGD stage 2, minus
the reward of the decoded denoised prediction), one optimizer step over the
trainable partition, and ``MultiviewTrainer``, which builds the models,
partitions them, and walks the seeded batch plan.  ``VideoTrainer``
(``video_trainer.py``) is its clip subclass.

Differences from the JAX package, by design:

* Random draws (VAE posterior noise, training noise, noise offset,
  timesteps, CFG uncond switch) come from an explicit ``torch.Generator``
  (``make_draws``), and the loss takes them as an argument, so a test can
  hand it the JAX package's own draws.  The two generators give different
  numbers from one seed.
* Every module runs in the compute dtype; the optimizer keeps float32
  master copies of the trainables (``train_state.AdamW``).  The frozen VAE
  encode and text encode run under ``torch.no_grad()``.
* Latents are NCHW, ``(B, N, 4, h, w)``; the FGM weight broadcasts over the
  channel axis and the means run over the same element count.

As in the JAX package, the VAE decode of the reward and of tone guidance
(``use_tone_guidance``: ``2 * mean((mscn(decoded x0) - mscn(pixels))^2)``,
``ops/mscn.py``, metric ``tone``) runs under grad inside a checkpoint
(``torch.utils.checkpoint`` for ``jax.checkpoint``) as a whole: only its
latent input is saved and the decode is replayed in the backward, so its
image-size activations are not alive through the UNet's backward.

The conditioning cache (``runner.cache_conditioning``, the JAX package's
``make_precompute_cond``): the frozen, parameter-independent conditioning
of a sample, its VAE posterior moments (bf16 in the compute dtype) and its
ORS ray labels (int8), is computed once per ``(sample, flipped)`` (clips:
``(clip, frame, flipped)``) and served from the host on every later epoch,
so a cached step runs neither the VAE encoder nor the ORS gather.  The
entries are CPU tensors; each batch stacks its rows into a pinned buffer
and copies it to the device.  Sizes, from the shapes: one 224x400 sample is
6 x 28 x 50 x 320 int8 rays (2,688,000 B) plus 6 x 8 x 28 x 50 bf16
moments (134,400 B), about 2.7 MB, so the default 4096 MB cap
(``runner.cond_cache_max_mb``) holds about 1,500 samples; a 432x768
sample is about 10.5 MB.  Past the cap the cache stops filling and later
samples recompute every epoch.  Flip augmentation
(``dataset.augment3d.flip_ratio``, ``data/augment.py``) runs before the
collate on the batch's own numpy generator, as in the JAX package.

Gradient accumulation (``runner.gradient_accumulation_steps = k``) is the
optimizer's (``train_state.AdamW``, ``optax.MultiSteps``' semantics):
``step`` and ``max_train_steps`` count micro-steps, as in the JAX package,
whose schedule is built over ``max_train_steps`` and advanced once per
update.  ``run()`` builds batches on ``runner.num_workers`` threads
(``data/prefetch.py``, ``runner.prefetch_factor`` ahead) and draws every
random number of a step from ``generator`` on the calling thread, so the
workers change no draw.

Checkpoints are the port's own format (the JAX package's is orbax):
``<log_root>/checkpoint-<step>/trainer_state.pt``, a ``torch.save`` of
tensors, ints and dicts that ``torch.load(weights_only=True)`` reads: the
optimizer's ``state_dict()`` (the float32 masters, the moments, ``count``
and, with accumulation, the accumulators), ``step``, and the state of
``generator``, so that a resumed run draws what an uninterrupted one
draws.  ``export_model`` writes float32 diffusers-named state dicts
(``<model.controlnet_dir[i]>/`` and ``<model.unet_dir>/``
``diffusion_pytorch_model.bin``) that ``runner/weights.py``'s
``load_pretrained_dir`` reads back.

Parallelism (``parallel/mesh.py``; the JAX trainer's ``mesh``): under a
process group the trainer takes its ``(data, view)`` mesh from
``cfg.accelerator.mesh``.  ``runner.train_batch_size`` is the global
batch; its rows (samples, or clips x frames) must divide by ``data``, and
the cameras by ``view``.  Every rank builds the same global host batch and
draws ``make_draws`` for the global batch from the same generator state,
and keeps its rows and cameras (``shard_batch``, ``shard_draws``: the CFG
switch still ranks a sample's cameras together), so the ranks together
compute what one process computes on the whole batch, as the JAX step
does with one replicated key.  Where a rank holds part of a sample's
cameras or of a clip's frames, the models get its ``Split``
(``Mesh.split``) and gather what attn4, ST-Attn, the temporal attention
and the temporal reward read from the ranks that hold it
(``parallel/collectives.py``).  Every loss term is a plain mean, so the
mean of the ranks' equal shards is the global loss: the gradients are
averaged between the backward and the optimizer's clip
(``average_gradients``), whose global norm is then the norm of the mean,
and the metrics are ``all_mean``'d.  The conditioning cache holds this
rank's rows.  Checkpoints and the export are written by rank 0 behind a
barrier; every rank loads.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..data.augment import random_flip_3d_with_views
from ..data.collate import collate_fn
from ..data.prefetch import prefetch_map
from ..data.tokenizer import build_tokenizer
from ..diffusion.schedule import DiffusionSchedule
from ..ops.fgm import fgm_heatmap
from ..ops.mscn import mscn_luminance
from ..ops.ors import occupancy_ray_sample
from ..parallel.collectives import Split, as_split
from ..parallel.mesh import Mesh, all_mean, average_gradients, barrier, \
    config_mesh, group_up, is_main, shard_batch
from .conds import compute_branch_conds, prepare_batch, to_device
from .factory import build_models
from .train_state import build_optimizer, init_box_adapter_from_base, \
    partition_params, trainable_predicate
from .weights import EXPORT_FILE, export_name, save_model_dir

__all__ = ["sample_uncond_switch", "make_draws", "shard_draws",
           "make_precompute_cond",
           "batch_rows", "make_loss_fn", "train_step", "set_category_tokens",
           "MultiviewTrainer", "CHECKPOINT_FILE", "EXPORT_FILE"]

# the file of a checkpoint directory
CHECKPOINT_FILE = "trainer_state.pt"

log = logging.getLogger(__name__)

Draws = Dict[str, Optional[torch.Tensor]]


def sample_uncond_switch(generator: torch.Generator, B: int, n_cam: int,
                         drop_ratio: float, drop_num: int,
                         device=None) -> torch.Tensor:
    """(B, n_cam) 1.0 where the camera's condition is dropped: per sample,
    with probability ``drop_ratio``, drop ``drop_num`` random cameras."""
    row = (torch.rand(B, 1, generator=generator, device=device)
           < drop_ratio).float()
    scores = torch.rand(B, n_cam, generator=generator, device=device)
    kth = scores.sort(dim=1).values[:, n_cam - drop_num][:, None]
    return row * (scores >= kth).float()


def make_draws(generator: torch.Generator, cfg, B: int, N: int,
               latent_hw: Tuple[int, int], num_train_timesteps: int,
               device=None, frames: int = 1) -> Draws:
    """Every random draw of one loss evaluation, in the JAX package's
    shapes transposed to NCHW: ``vae_noise`` (B*N, 4, h, w), ``noise``
    (B, N, 4, h, w), ``noise_offset`` ((B, 1) or (B, N), None when the
    offset is 0), ``timesteps`` ((B,) or (B, N); with ``frames > 1``, B
    folds clips x frames and one timestep per clip is repeated over its
    frames), ``uncond_switch`` (B, N)."""
    h, w = latent_hw
    rn = lambda *shape: torch.randn(*shape, generator=generator,
                                    device=device)
    offset = float(cfg.runner.noise_offset)
    same_t = bool(cfg.model.train_with_same_t)
    same_offset = bool(cfg.runner.train_with_same_offset)
    c = cfg.model.controlnet
    draws = {
        "vae_noise": rn(B * N, 4, h, w),
        "noise": rn(B, N, 4, h, w),
        "noise_offset": (rn(B, 1 if same_offset else N) if offset > 0
                         else None),
    }
    if frames > 1:
        draws["timesteps"] = torch.randint(
            0, num_train_timesteps, (B // frames,), generator=generator,
            device=device).repeat_interleave(frames)
    else:
        draws["timesteps"] = torch.randint(
            0, num_train_timesteps, (B,) if same_t else (B, N),
            generator=generator, device=device)
    draws["uncond_switch"] = sample_uncond_switch(
        generator, B, N, float(c.drop_cond_ratio), int(c.drop_cam_num),
        device)
    return draws


def shard_draws(draws: Draws, mesh: Mesh, n_cam: int) -> Draws:
    """This rank's rows and cameras of ``make_draws``' global draws (the
    ``shard_batch`` rule, ``vae_noise``'s (B*N) rows read as (B, N))."""
    vn = draws["vae_noise"]
    out = shard_batch(dict(draws, vae_noise=vn.reshape(
        -1, n_cam, *vn.shape[1:])), mesh, n_cam)
    out["vae_noise"] = out["vae_noise"].flatten(0, 1)
    return out


def make_precompute_cond(models: Dict, latent_hw: Tuple[int, int],
                         image_hw: Tuple[int, int]
                         ) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """precompute(batch) -> the frozen, parameter-independent conditioning
    of each row of a ``prepare_batch`` batch, under ``torch.no_grad()`` in
    the models' compute dtype: ``latent_moments`` (B, N, 8, h, w), the VAE
    posterior mean || logvar, and, when a branch is ORS (``occ_3d``) and
    the batch has the occupancy, ``ors_rays`` (B, N, h, w, S) int8, the ray
    labels 0..17 of ``occupancy_ray_sample``."""
    vae = models["vae"]
    need_ors = any(s.cond_kind == "occ_3d" for s in models["specs"])
    sample_point = int(models["unet"].block_out_channels[0])

    @torch.no_grad()
    def precompute(batch: Dict) -> Dict[str, torch.Tensor]:
        px = batch["pixel_values"]
        B, N = px.shape[:2]
        m = vae.encode_moments(
            px.reshape(B * N, *px.shape[2:]).permute(0, 3, 1, 2))
        out = {"latent_moments": m.reshape(B, N, *m.shape[1:])}
        if need_ors and "occ_labels" in batch:
            out["ors_rays"] = occupancy_ray_sample(
                batch["occ_labels"], batch["occ_cam_K"], batch["occ_cam_T"],
                latent_hw, image_hw, sample_point=sample_point
            ).to(torch.int8)
        return out

    return precompute


def batch_rows(batch: Dict) -> Tuple[int, int]:
    """(B, N) of a training batch: from its pixels, or from the cached
    moments when the conditioning cache dropped them."""
    x = batch["pixel_values"] if "pixel_values" in batch \
        else batch["latent_moments"]
    return int(x.shape[0]), int(x.shape[1])


def make_loss_fn(models: Dict, cfg, schedule: DiffusionSchedule,
                 latent_hw: Tuple[int, int], occ_image_hw: Tuple[int, int],
                 frames: int = 1, reward_fn=None, reward_weight: float = 0.0,
                 reward_frames: int = 0, cached_cond: bool = False,
                 split: Optional[Split] = None
                 ) -> Callable[[Dict, Draws], Tuple[torch.Tensor, Dict]]:
    """loss_fn(batch, draws) -> (loss, metrics): ``mse`` of the noise
    prediction plus, with ``use_aug_loss``, the FGM heatmap-weighted
    ``aug_loss`` and, with ``use_tone_guidance``, twice the ``tone`` term:
    the mean squared difference of ``mscn_luminance`` of the decoded
    denoised prediction x0 and of the pixels.  ``batch`` is
    ``prepare_batch`` output; for clips (``frames > 1``) its batch dim
    folds clips x frames, frame outer.

    With ``cached_cond`` the batch carries ``latent_moments`` (and
    ``ors_rays``) from ``make_precompute_cond`` in place of running the VAE
    encoder: the posterior is sampled from the moments with the same
    ``vae_noise`` draw (``AutoencoderKL.sample``), so a cached and an
    uncached loss with the same draws compute the same latents.

    With ``reward_fn`` and ``reward_weight > 0`` (RGD): the denoised
    prediction x0 of the first ``reward_frames`` frames of each clip (all
    when 0), decoded by the VAE under grad, gives ``reward =
    mean(reward_fn(images, ground truth, batch))`` (NCHW images), and the
    loss is ``mse + aug_loss - reward_weight * reward``.

    ``split`` (``Mesh.split``): the batch holds this rank's cameras of its
    samples or its frames of part of a clip; the UNet, the ControlNets'
    condition embedders and the reward (as ``reward_fn(..., split=)``)
    take it.  Under a frame split with ``reward_frames`` the ranks hold
    different counts of the prefix frames (some none); the reward's mean
    stays the one over every rank's images."""
    unet, controlnets = models["unet"], models["controlnets"]
    view0 = split.view0 if split is not None else 0
    reward_kw = {} if split is None else {"split": split}
    vae, text_encoder = models["vae"], models["text_encoder"]
    same_noise = bool(cfg.model.train_with_same_noise)
    use_aug_loss = bool(cfg.use_aug_loss)
    aug_text = bool(cfg.use_aug_text)
    use_tone = bool(cfg.get("use_tone_guidance", False))
    noise_offset = float(cfg.runner.noise_offset)

    def decode(x0):
        """(n, N, 4, h, w) -> (n*N, 3, H, W) under grad, rematerialised."""
        flat = x0.reshape(-1, *x0.shape[2:])
        return checkpoint(vae.decode, flat, use_reentrant=False)

    def loss_fn(batch: Dict, draws: Draws):
        # (B, N, H, W, 3) in [-1, 1]; absent when the conditioning cache
        # carries the moments and no loss term reads pixels
        px = batch.get("pixel_values")
        B, N = batch_rows(batch)
        with torch.no_grad():
            if cached_cond:
                mo = batch["latent_moments"]
                latents = vae.sample(mo.reshape(B * N, *mo.shape[2:]),
                                     draws["vae_noise"])
            else:
                img = px.reshape(B * N, *px.shape[2:]).permute(0, 3, 1, 2)
                latents = vae.encode(img, draws["vae_noise"])
            text, _ = text_encoder(batch["input_ids"])
            uncond, _ = text_encoder(batch["uncond_ids"])
        latents = latents.reshape(B, N, *latents.shape[1:]).float()
        if aug_text:  # (B*N, L, D) -> (B, N, L, D)
            text = text.reshape(B, N, *text.shape[1:])

        noise = draws["noise"].float()
        if same_noise:
            noise = noise[:, :1].expand_as(noise)
        if noise_offset > 0:
            noise = noise + noise_offset * draws["noise_offset"][
                ..., None, None, None]
        timesteps = draws["timesteps"]
        noisy = schedule.add_noise(latents, noise, timesteps)

        conds = compute_branch_conds(models, batch, latent_hw, occ_image_hw)
        downs = mid = kv = None
        for i, cn in enumerate(controlnets):
            d, m, k = cn(noisy, timesteps, batch["camera_param"], text,
                         conds[i], bboxes_3d=batch.get(f"boxes_{i}"),
                         encoder_hidden_states_uncond=uncond,
                         uncond_switch=draws["uncond_switch"], view0=view0)
            if downs is None:
                downs, mid, kv = d, m, k
            else:  # dual-branch residual sum
                downs = [a + b for a, b in zip(downs, d)]
                mid = mid + m
        t_flat = timesteps.reshape(-1)
        if t_flat.shape[0] == B:
            t_flat = t_flat.repeat_interleave(N)
        eps = unet(noisy.reshape(B * N, *noisy.shape[2:]), t_flat, kv,
                   down_block_additional_residuals=downs,
                   mid_block_additional_residual=mid,
                   n_cam=N if split is None else split)
        eps = eps.float().reshape(B, N, *noisy.shape[2:])

        sq = (eps - schedule.training_target(latents, noise, timesteps)) ** 2
        loss = sq.mean()
        metrics = {"mse": loss.detach()}
        if use_aug_loss and "fgm_bboxes" in batch:
            heat = fgm_heatmap(batch["fgm_bboxes"], batch["fgm_masks"],
                               batch["fgm_lidar2image"],
                               (latent_hw[1], latent_hw[0]))  # (w, h)
            aug = (sq * heat[:, :, None]).mean()  # NCHW: over channels
            loss = loss + aug
            metrics["aug_loss"] = aug.detach()
        if use_tone:
            images = decode(schedule.pred_x0_from_eps(noisy, eps, timesteps))
            gt = px.reshape(B * N, *px.shape[2:]).permute(0, 3, 1, 2)
            tone = ((mscn_luminance(images) - mscn_luminance(gt)) ** 2).mean()
            loss = loss + 2.0 * tone
            metrics["tone"] = tone.detach()
        if reward_fn is not None and reward_weight > 0:
            reward = _reward(noisy, eps, timesteps, px, batch)
            loss = loss - reward_weight * reward
            metrics["reward"] = reward.detach()
        metrics["loss"] = loss.detach()
        return loss, metrics

    def _reward(noisy, eps, timesteps, px, batch):
        x0 = schedule.pred_x0_from_eps(noisy, eps, timesteps)
        B, N = x0.shape[:2]
        keep, share = list(range(B)), B
        if reward_frames and 1 < frames and reward_frames < frames:
            # rows are frame-outer per clip: a prefix of each clip keeps
            # the frames the temporal term differentiates in order.  Under
            # a frame split the ranks keep runs of different lengths, and
            # each rank's sum is over its mean share of the frame group's
            # kept frames, so the ranks' mean is the mean over all of them
            j0, _ = (split or as_split(N)).clip_rows(B, frames)
            keep = [i for i in range(B) if (j0 + i) % frames < reward_frames]
            share = B * reward_frames / frames
        rbatch = batch if len(keep) == B else dict(batch, **{
            key: batch[key][keep] for key in (
                "fgm_bboxes", "fgm_masks", "fgm_lidar2image") if key in batch})
        # a rank with no kept frame decodes nothing; its empty slice of x0
        # keeps it in the graph, so that its reward's collectives meet the
        # other ranks' in the backward
        images = decode(x0[keep]) if keep else \
            x0.flatten()[:0].reshape(0, 3, *px.shape[2:4])
        gt = px[keep].flatten(0, 1).permute(0, 3, 1, 2)
        return reward_fn(images, gt, rbatch, **reward_kw).sum() / (share * N)

    return loss_fn


def train_step(loss_fn, optimizer, batch: Dict, draws: Draws,
               mesh: Optional[Mesh] = None) -> Dict:
    """One step: loss, gradients of the trainables, optimizer update.
    With a ``mesh`` of more than one rank, ``batch`` and ``draws`` are this
    rank's rows, the gradients are averaged over the ranks before the
    update and the metrics are their means.  -> metrics (device tensors),
    with ``grad_norm`` of the raw (averaged) gradients."""
    optimizer.zero_grad()
    loss, metrics = loss_fn(batch, draws)
    loss.backward()
    grads = None
    if mesh is not None and mesh.world > 1:
        grads = average_gradients(optimizer.grads())
        metrics = all_mean(metrics)
    metrics["grad_norm"] = optimizer.step(grads)
    return metrics


@torch.no_grad()
def set_category_tokens(models: Dict, tokenizer, class_names) -> None:
    """Every ControlNet's box class tokens <- the pooled CLIP text embedding
    of each class name (the JAX package's ``set_category_tokens``);
    embedders whose class count differs (map vectors) are left as they
    are."""
    te = models["text_encoder"]
    dev = next(te.parameters()).device
    ids = torch.as_tensor(np.asarray(tokenizer(list(class_names)), np.int64),
                          device=dev)
    _, pooled = te(ids)
    for cn in models["controlnets"]:
        tok = cn.bbox_embedder._class_tokens
        if tuple(tok.shape) == tuple(pooled.shape):
            tok.copy_(pooled)


class MultiviewTrainer:
    """Config-driven training loop of the image path.

    ``MultiviewTrainer(cfg, train_set).run(max_steps, on_metrics)`` trains
    on the card; ``device="cpu"`` runs the plain path.  ``models`` (a
    ``build_models`` dict with weights) replaces the fresh initialisation:
    ``build_models`` (the tiny sizes with ``cfg.tiny_models``) under
    ``torch.manual_seed(cfg.seed)``, so every process builds the same
    frozen weights, then the box adapter's projections copied from their
    base ones (``init_box_adapter_from_base``) and the class tokens set.
    ``on_metrics(step, metrics)`` gets ``loss``, ``mse``, ``aug_loss``,
    ``tone``, ``grad_norm``, ``step_time_s`` (host clock from batch
    assembly to the metrics on the host, which synchronises the device) and
    ``data_time_s`` (the batch assembly part of it).

    ``mesh`` (``parallel.mesh.create_mesh``): the ``(data, view)`` mesh;
    by default ``cfg.accelerator.mesh`` when a process group is up, else
    none (see the module docstring).  ``split``: this rank's ``Split``
    of the models' calls (None without a mesh, or when each rank holds
    whole samples and whole clips)."""

    frames = 1  # frames per clip; VideoTrainer sets video.num_frames

    def __init__(self, cfg, train_set, device=None,
                 models: Optional[Dict] = None, mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.train_set = train_set
        r = cfg.runner
        if mesh is None and group_up():
            mesh = config_mesh(cfg)
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.n_cam = len(cfg.dataset.neighboring_view_pair)
        rows = int(r.train_batch_size) * self.frames
        if self.mesh and rows % self.mesh.data:
            raise ValueError(
                f"runner.train_batch_size={int(r.train_batch_size)} "
                f"({rows} rows of {self.frames} frames a sample) does not "
                f"divide over data={self.mesh.data}")
        # the frame groups are formed here, by every rank at once
        self.split = None if self.mesh is None else self.mesh.split(
            self.n_cam, rows // self.mesh.data, self.frames)
        if self.split is not None:
            sp = self.split
            log.info("rank %d: cameras %d..%d of %d; %d frames of clips of "
                     "%d, with %d rank(s) holding the rest of them",
                     self.mesh.rank, sp.view0, sp.view0 + sp.n_local - 1,
                     sp.n_cam, rows // self.mesh.data, self.frames,
                     sp.frame_ranks - 1)
        # the conditioning cache: {key: {name: CPU tensor}}, keys from
        # _cond_keys; it stops filling at runner.cond_cache_max_mb
        self.cache_cond = bool(r.get("cache_conditioning", False))
        self._cond_cache: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self._cond_cache_bytes = 0
        self._cond_cache_full = False
        self._cond_cache_lock = threading.Lock()
        # cached batches drop the pixels unless a loss term reads them (the
        # RGD reward compares with the ground-truth images)
        self._needs_px = bool(cfg.get("use_tone_guidance", False)) or (
            bool(cfg.get("use_video", False))
            and bool((cfg.get("video") or {}).get("rgd", {}).get("enable")))
        self.tokenizer = build_tokenizer(
            str(cfg.model.pretrained_model_name_or_path))
        fresh = models is None
        if fresh:
            cuda = self.device.type == "cuda"
            with torch.random.fork_rng(devices=[self.device.index or 0]
                                       if cuda else []):
                torch.manual_seed(int(cfg.seed))
                tiny = bool(cfg.get("tiny_models", False))
                models = build_models(cfg, device=self.device,
                                      **({"tiny": True} if tiny else {}))
        self.models = models
        if fresh and bool(cfg.get("use_box_adapter", False)):
            init_box_adapter_from_base(self.models)
        if fresh and bool(cfg.model.controlnet.bbox_embedder_param.get(
                "use_text_encoder_init", True)):
            set_category_tokens(self.models, self.tokenizer,
                                list(cfg.dataset.object_classes))
        self.schedule = DiffusionSchedule.create()
        h, w = cfg.dataset.image_size
        self.latent_hw = (h // 8, w // 8)
        self.image_hw = tuple(cfg.model.get("ors_frame_hw", (896, 1600)))
        self._compute_steps()

        pred = trainable_predicate(
            str(cfg.model.unet.trainable_state),
            bool(cfg.model.controlnet.bbox_embedder_param.get(
                "trainable_class_token", False)))
        # float32 master copies of the trainables before the cast
        trainable, _ = partition_params(self.models, pred)
        master = {k: p.detach().float().clone() for k, p in trainable.items()}
        dtype = self.models["dtype"]
        for m in (self.models["unet"], self.models["vae"],
                  self.models["text_encoder"], *self.models["controlnets"]):
            m.to(self.device, dtype)
        self.trainable, self.frozen = partition_params(self.models, pred)
        log.info("trainable params: %.1fM, frozen: %.1fM",
                 sum(p.numel() for p in self.trainable.values()) / 1e6,
                 sum(p.numel() for p in self.frozen.values()) / 1e6)
        self.optimizer = build_optimizer(r, self.trainable,
                                         self.max_train_steps, master)
        self.loss_fn = self._make_loss_fn()
        self._precompute = make_precompute_cond(self.models, self.latent_hw,
                                                self.image_hw)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(cfg.seed))
        self.step = 0
        self.saved_step = None  # the step of the last save_checkpoint()

    def _make_loss_fn(self):
        return make_loss_fn(self.models, self.cfg, self.schedule,
                            self.latent_hw, self.image_hw,
                            cached_cond=self.cache_cond, split=self.split)

    def _flip_ratio(self) -> float:
        return float((self.cfg.dataset.get("augment3d") or {})
                     .get("flip_ratio") or 0.0)

    def _augment_items(self, items, rng):
        """-> (items, flipped flags): ``random_flip_3d_with_views`` on each
        sample, one draw of ``rng`` each; no draw at ``flip_ratio`` 0.
        Kept apart from the collate so the conditioning cache can key its
        entries by (sample, flipped)."""
        flip = self._flip_ratio()
        if flip <= 0:
            return items, [False] * len(items)
        out = [random_flip_3d_with_views(s, rng, flip) for s in items]
        return out, [o is not s for o, s in zip(out, items)]

    def _collate_items(self, items, rng, pre_augmented: bool = False) -> Dict:
        if not pre_augmented:
            items, _ = self._augment_items(items, rng)
        return collate_fn(items, self.cfg, self.tokenizer, rng=rng)

    def _compute_steps(self) -> None:
        bs = int(self.cfg.runner.train_batch_size)
        self.steps_per_epoch = max(len(self.train_set) // bs, 1)
        mts = self.cfg.runner.max_train_steps
        if mts is None:
            mts = self.steps_per_epoch * int(self.cfg.runner.num_train_epochs)
        self.max_train_steps = int(mts)

    def _batch_plan(self, epoch: int, skip: int = 0):
        """(epoch, offset, indices) of each batch of one epoch: a seeded
        permutation, a pure function of (seed, epoch)."""
        bs = int(self.cfg.runner.train_batch_size)
        rng = np.random.default_rng(int(self.cfg.seed) + epoch)
        order = rng.permutation(len(self.train_set))
        for n, i in enumerate(range(0, len(order) - bs + 1, bs)):
            if n >= skip:
                yield epoch, i, [int(j) for j in order[i:i + bs]]

    def _cond_keys(self, idxs, flips) -> list:
        """Cache keys of one planned batch, one per row of its tensors:
        (sample, flipped); ``VideoTrainer`` keys each frame."""
        return list(zip(idxs, flips))

    def _attach_cond(self, keys, batch: Dict) -> Dict:
        """A host ``prepare_batch`` batch with its raw frozen-conditioning
        inputs (pixels for the VAE encoder, the occupancy for ORS) swapped
        for their precomputed tensors: stacked from the cache when every
        row is there, else computed on the device (and cached until the
        cap).  The precomputed tensors come back in pinned memory when
        the trainer runs on the card."""
        cache = self._cond_cache
        if all(k in cache for k in keys):
            pinned = self.device.type == "cuda"
            pre = {}
            for name, first in cache[keys[0]].items():
                buf = torch.empty((len(keys), *first.shape), dtype=first.dtype,
                                  pin_memory=pinned)
                pre[name] = torch.stack([cache[k][name] for k in keys],
                                        out=buf)
        else:
            inputs = {k: batch[k].to(self.device) for k in (
                "pixel_values", "occ_labels", "occ_cam_K", "occ_cam_T")
                if k in batch}
            pre = {n: v.cpu() for n, v in self._precompute(inputs).items()}
            self._cache_rows(keys, pre)
        out = dict(batch)
        out.update(pre)
        for k in ("occ_labels", "occ_cam_K", "occ_cam_T"):
            out.pop(k, None)
        if not self._needs_px:
            out.pop("pixel_values", None)
        return out

    def _cache_rows(self, keys, pre: Dict[str, torch.Tensor]) -> None:
        """Each row of ``pre`` into the cache under its key, until the cap
        (under the cache's lock: prefetch workers fill it concurrently)."""
        cap = int(self.cfg.runner.get("cond_cache_max_mb", 4096)) * (1 << 20)
        with self._cond_cache_lock:
            if self._cond_cache_full:
                return
            for row, k in enumerate(keys):
                entry = {n: v[row].clone() for n, v in pre.items()}
                self._cond_cache[k] = entry
                self._cond_cache_bytes += sum(
                    v.numel() * v.element_size() for v in entry.values())
            if self._cond_cache_bytes > cap:
                self._cond_cache_full = True
                log.warning(
                    "conditioning cache hit its %d MB cap after %d entries; "
                    "further samples recompute every epoch (raise "
                    "runner.cond_cache_max_mb to cache more)",
                    cap >> 20, len(self._cond_cache))

    def _build_batch(self, plan) -> Dict:
        """One planned batch on the device: the samples, flipped and
        collated with the plan's own numpy generator (``default_rng([seed,
        epoch, offset])``, the JAX package's stream), and with the cache
        their precomputed conditioning (augmented first, so each key
        carries the flip its entry was computed under)."""
        epoch, i, idxs = plan
        rng = np.random.default_rng([int(self.cfg.seed), epoch, i])
        items = [self.train_set[j] for j in idxs]
        if not self.cache_cond:
            batch = prepare_batch(self._collate_items(items, rng), "cpu")
            if self.mesh is not None:
                batch = shard_batch(batch, self.mesh, self.n_cam)
            return to_device(batch, self.device)
        items, flips = self._augment_items(items, rng)
        batch = prepare_batch(
            self._collate_items(items, rng, pre_augmented=True), "cpu")
        keys = self._cond_keys(idxs, flips)
        if self.mesh is not None:  # this rank's rows, and their entries
            batch = shard_batch(batch, self.mesh, self.n_cam)
            keys = keys[self.mesh.rows(len(keys))]
        return to_device(self._attach_cond(keys, batch), self.device)

    def train_step(self, batch: Dict) -> Dict[str, float]:
        """One step on ``batch`` (this rank's rows and cameras under a
        mesh), with the draws of the global batch."""
        B, N = batch_rows(batch)
        data, view = (self.mesh.data, self.mesh.view) if self.mesh \
            else (1, 1)
        draws = make_draws(self.generator, self.cfg, B * data, N * view,
                           self.latent_hw, self.schedule.num_train_timesteps,
                           self.device, frames=self.frames)
        if self.mesh is not None:
            draws = shard_draws(draws, self.mesh, N * view)
        metrics = train_step(self.loss_fn, self.optimizer, batch, draws,
                             self.mesh)
        self.step += 1
        return {k: float(v) for k, v in metrics.items()}

    def run(self, max_steps: Optional[int] = None,
            on_metrics=None) -> Dict[str, float]:
        """Train up to ``max_steps`` (at most ``max_train_steps``) steps
        from ``self.step``, the epoch's batch plan resumed at its cursor;
        save a checkpoint at every multiple of
        ``runner.checkpointing_steps``.  Batches are built on
        ``runner.num_workers`` threads, ``runner.prefetch_factor`` ahead
        (0 workers: on this thread).  ``step_time_s``: host clock from the
        end of the last step (its ``on_metrics`` and save included) to this
        step's metrics on the host; ``data_time_s``: the wait for the
        batch within it."""
        r = self.cfg.runner
        limit = min(self.max_train_steps, max_steps or self.max_train_steps)
        ckpt_every = int(r.get("checkpointing_steps") or 0)
        workers = int(r.get("num_workers", 0) or 0)
        depth = int(r.get("prefetch_factor", 2) or 2)
        last: Dict[str, float] = {}
        while self.step < limit:
            spe = self.steps_per_epoch
            batches = prefetch_map(
                self._build_batch, self._batch_plan(self.step // spe,
                                                    skip=self.step % spe),
                num_workers=workers, depth=depth)
            try:
                t0 = time.perf_counter()
                for batch in batches:
                    t1 = time.perf_counter()
                    last = self.train_step(batch)
                    last["step_time_s"] = time.perf_counter() - t0
                    last["data_time_s"] = t1 - t0
                    if not math.isfinite(last["loss"]):
                        raise FloatingPointError(
                            f"NaN/Inf loss at step {self.step}")
                    if on_metrics:
                        on_metrics(self.step, last)
                    if ckpt_every and self.step % ckpt_every == 0:
                        self.save_checkpoint()
                    if self.step >= limit:
                        break
                    t0 = time.perf_counter()
            finally:
                batches.close()
        return last

    # ------------------------------------------------------------ checkpoints
    def checkpoint_dir(self, step: Optional[int] = None) -> str:
        """``<log_root>/checkpoint-<step>`` (this step by default)."""
        root = self.cfg.get("log_root") or "./dualdiff-tpu-log"
        step = self.step if step is None else step
        return os.path.abspath(os.path.join(root, f"checkpoint-{step}"))

    def save_checkpoint(self) -> str:
        """Write this step's checkpoint (``CHECKPOINT_FILE`` under
        ``checkpoint_dir()``, replaced whole: written beside it, then
        renamed), logging its bytes and seconds; under a process group
        rank 0 writes it (the ranks' states are equal) and every rank
        waits for it.  -> its directory."""
        t0 = time.perf_counter()
        path = self.checkpoint_dir()
        if is_main():
            os.makedirs(path, exist_ok=True)
            state = {"optimizer": self.optimizer.state_dict(),
                     "step": self.step,
                     "generator": self.generator.get_state()}
            dst = os.path.join(path, CHECKPOINT_FILE)
            torch.save(state, dst + ".tmp")
            os.replace(dst + ".tmp", dst)
            log.info("saved checkpoint %s (%d bytes, %.3f s)", path,
                     os.path.getsize(dst), time.perf_counter() - t0)
        barrier()
        self.saved_step = self.step
        return path

    def latest_checkpoint(self) -> Optional[str]:
        """The ``checkpoint-<n>`` directory with the highest ``n`` under
        ``log_root``, or None."""
        root = self.cfg.get("log_root") or "."
        if not os.path.isdir(root):
            return None
        steps = [int(d.split("-", 1)[1]) for d in os.listdir(root)
                 if d.startswith("checkpoint-")
                 and d.split("-", 1)[1].isdigit()]
        if not steps:
            return None
        return os.path.abspath(os.path.join(root, f"checkpoint-{max(steps)}"))

    def load_checkpoint(self, path: str, reset_scheduler: bool = False
                        ) -> Optional[str]:
        """Resume from ``path`` (a checkpoint directory, or ``"latest"``:
        ``latest_checkpoint()``; with none, a warning and a fresh run).
        Restores the optimizer (the live parameters from its masters),
        ``step`` and the generator.  ``reset_scheduler`` keeps the
        parameters and ``step`` but starts the moments, ``count`` and the
        accumulators from zero, as ``tx.init(params)`` does.  -> the
        directory loaded, or None."""
        if path == "latest":
            path = self.latest_checkpoint()
            if path is None:
                log.warning("no checkpoint found for resume=latest; "
                            "fresh run")
                return None
        state = torch.load(os.path.join(path, CHECKPOINT_FILE),
                           map_location="cpu", weights_only=True, mmap=True)
        self.optimizer.load_state_dict(state["optimizer"])
        if reset_scheduler:
            self.optimizer.reset_state()
        self.step = int(state["step"])
        self.generator.set_state(state["generator"])
        log.info("resumed from %s at step %d", path, self.step)
        return path

    @torch.no_grad()
    def export_state_dicts(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """{"controlnet_<i>" | "unet": float32 CPU state dict in the JAX
        exporter's names (``weight_import.export_params``; the port's names
        but the one rename ``runner/weights.py`` documents,
        ``to_out_0_lora_*`` -> ``to_out.0_lora_*``)}: the trainables from
        their float32 masters, the frozen leaves from their live values."""
        master = self.optimizer.master
        out = {}
        nets = [(f"controlnet_{i}", cn)
                for i, cn in enumerate(self.models["controlnets"])]
        for root, module in nets + [("unet", self.models["unet"])]:
            out[root] = {
                export_name(name): master.get(f"{root}/{name}", t).detach()
                .to("cpu", torch.float32, copy=True)
                for name, t in module.state_dict().items()}
        return out

    def export_model(self, root: Optional[str] = None) -> str:
        """Deployable weights: ControlNet ``i`` into
        ``<root>/<model.controlnet_dir[i]>/``, the UNet into
        ``<root>/<model.unet_dir>/``, each an ``EXPORT_FILE`` of
        ``export_state_dicts()``, logging the bytes and seconds.  ``root``:
        ``log_root`` by default.  Under a process group rank 0 writes and
        every rank waits for it.  -> ``root``."""
        t0 = time.perf_counter()
        root = root or (self.cfg.get("log_root") or "./dualdiff-tpu-log")
        if not is_main():
            barrier()
            return root
        cdirs = self.cfg.model.controlnet_dir
        if not isinstance(cdirs, list):
            cdirs = [cdirs]
        dirs = {f"controlnet_{i}": cdirs[i]
                for i in range(len(self.models["controlnets"]))}
        dirs["unet"] = str(self.cfg.model.unet_dir)
        paths = save_model_dir({dirs[key]: sd for key, sd
                                in self.export_state_dicts().items()}, root)
        nbytes = sum(os.path.getsize(p) for p in paths.values())
        log.info("exported %s (%d bytes, %.3f s)", root, nbytes,
                 time.perf_counter() - t0)
        barrier()
        return root
