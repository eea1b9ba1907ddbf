"""The explore tools' probe: one denoising forward of the ControlNets and
the UNet on the first validation sample at a fixed timestep, under
``models.layers.capture``.

Port of the set-up the JAX package's ``tools/explore_attn.py`` and
``tools/explore_unet.py`` share: the config from the CLI's words (with
``--config-name explore_config`` its ``explore_t`` / ``explore_out``),
the trainer's models (its checkpoint when ``resume_from_checkpoint`` is
set), sample 0 of the ``val`` split collated with rng 0 (the trainer's
dataset), seed-0 latent noise, and ``t = explore_t`` for every view.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..data.wrappers import build_dataset
from ..models.layers import capture
from ..utils.config import compose
from .conds import compute_branch_conds, prepare_batch
from .trainer import MultiviewTrainer

__all__ = ["Probe", "open_probe"]


class Probe:
    """The trainer's models, the prepared batch, the text context, each
    branch's
    conditioning, the noisy latents (B, N, 4, h, w) and the timesteps
    (B,) of one explore run."""

    def __init__(self, trainer: MultiviewTrainer, t_probe: int):
        self.models = trainer.models
        dev = trainer.device
        self.batch = prepare_batch(trainer._collate_items(
            [trainer.train_set[0]], np.random.default_rng(0)), dev)
        self.B, self.N = self.batch["camera_param"].shape[:2]
        self.latent_hw = trainer.latent_hw
        lh, lw = self.latent_hw
        with torch.no_grad():
            self.text, _ = self.models["text_encoder"](
                self.batch["input_ids"])
            self.conds = compute_branch_conds(
                self.models, self.batch, self.latent_hw, trainer.image_hw)
        gen = torch.Generator(device=dev).manual_seed(0)
        self.noisy = torch.randn((self.B, self.N, 4, lh, lw),
                                 generator=gen, device=dev)
        self.t = torch.full((self.B,), t_probe, dtype=torch.int64,
                            device=dev)

    @torch.no_grad()
    def controlnet(self, i: int, captured: bool = False):
        """ControlNet ``i``'s (down residuals, mid residual, context);
        ``captured``: with its capture dict as a fourth item."""
        cn = self.models["controlnets"][i]
        run = lambda: cn(self.noisy, self.t, self.batch["camera_param"],
                         self.text, self.conds[i],
                         bboxes_3d=self.batch.get(f"boxes_{i}"))
        if not captured:
            return run()
        with capture(cn) as store:
            out = run()
        return (*out, store)

    def residuals(self):
        """Every ControlNet's residuals summed, as generation sums them,
        and the first one's context: the UNet's (downs, mid, kv)."""
        downs = mid = kv = None
        for i in range(len(self.models["controlnets"])):
            d, m, k = self.controlnet(i)
            if downs is None:
                downs, mid, kv = list(d), m, k
            else:
                downs = [a + b for a, b in zip(downs, d)]
                mid = mid + m
        return downs, mid, kv

    @torch.no_grad()
    def unet(self, downs: List[torch.Tensor], mid: torch.Tensor,
             kv: torch.Tensor, captured: bool = True):
        """The UNet's forward on the probe's latents with these residuals:
        under ``capture`` -> its capture dict, else -> its output."""
        lh, lw = self.latent_hw
        run = lambda: self.models["unet"](
            self.noisy.reshape(self.B * self.N, 4, lh, lw),
            self.t.repeat_interleave(self.N), kv,
            down_block_additional_residuals=downs,
            mid_block_additional_residual=mid, n_cam=self.N)
        if not captured:
            return run()
        with capture(self.models["unet"]) as store:
            run()
        return store


def open_probe(argv: Optional[List[str]], default_out: str):
    """-> (Probe, output directory) of a CLI's words (``compose``'s, and
    ``device=cpu`` for the plain path): the trainer of the config, its
    checkpoint loaded when ``resume_from_checkpoint`` is set."""
    cfg, _ = compose(list(argv))
    out_dir = str(cfg.get("explore_out", default_out))
    trainer = MultiviewTrainer(cfg, build_dataset(cfg, "val"),
                               device=cfg.get("device"))
    if cfg.get("resume_from_checkpoint"):
        trainer.load_checkpoint(str(cfg.resume_from_checkpoint))
    return Probe(trainer, int(cfg.get("explore_t", 500))), out_dir
