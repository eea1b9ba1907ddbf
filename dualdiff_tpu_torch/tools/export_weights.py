"""Export the port's weights as diffusers-named torch state dicts: the JAX
package's ``tools/export_weights.py`` for the port.

    python -m dualdiff_tpu_torch.tools.export_weights --src <dir> \
        --out out_torch/ [config words]

``--src`` is either a training checkpoint (``<run>/checkpoint-<n>``,
holding ``trainer_state.pt``) or a weights directory
(``tools/import_weights.py``'s output, or any directory of component
subdirectories).  Each becomes ``<out>/<component>/
diffusion_pytorch_model.bin`` with the JAX exporter's names and OIHW / OI
layouts, float32:

* a checkpoint: the trainer is rebuilt from the run's config
  (``hydra/overrides.json``, then these words), the checkpoint loaded, and
  its ``export_state_dicts`` (the trainables from their float32 masters)
  written as ``controlnet_<i>`` and ``unet``, with ``vae`` and
  ``text_encoder`` from its models;
* a directory: every subdirectory the JAX exporter takes (``unet``,
  ``vae``, ``text_encoder`` and any name holding ``controlnet``) with a
  weights file is read (``read_checkpoint``; legacy VAE and CLIP names
  mapped as ``from_diffusers`` maps them) and written again.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..runner.trainer import CHECKPOINT_FILE
from ..runner.weights import (from_diffusers, read_checkpoint,
                              save_model_dir, weights_file)

# component directory -> kind, as the JAX exporter maps them (a
# ControlNet's directory is any name holding "controlnet")
KIND_BY_NAME = {"unet": "unet", "vae": "vae", "text_encoder": "clip"}


def _kind(name: str):
    return KIND_BY_NAME.get(name, "controlnet" if "controlnet" in name
                            else None)


def checkpoint_state_dicts(src: str, overrides):
    """{component: state dict} of the training checkpoint ``src``."""
    from ..data.wrappers import build_dataset
    from ..runner.trainer import MultiviewTrainer
    from .test import compose_from_checkpoint

    cfg = compose_from_checkpoint([f"resume_from_checkpoint={src}"]
                                  + list(overrides))
    trainer = MultiviewTrainer(cfg, build_dataset(cfg, "train"),
                               device=cfg.get("device"))
    trainer.load_checkpoint(src)
    out = trainer.export_state_dicts()
    out["vae"] = trainer.models["vae"].state_dict()
    out["text_encoder"] = trainer.models["text_encoder"].state_dict()
    return out


def directory_state_dicts(src: str):
    """{component: state dict} of the weights directory ``src``."""
    out = {}
    for name in sorted(os.listdir(src)):
        sub = os.path.join(src, name)
        kind = _kind(name)
        path = weights_file(sub) if kind and os.path.isdir(sub) else None
        if path is None:
            continue
        out[name] = from_diffusers(read_checkpoint(path), kind)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", required=True)
    args, overrides = ap.parse_known_args(
        list(argv if argv is not None else sys.argv[1:]))
    if os.path.exists(os.path.join(args.src, CHECKPOINT_FILE)):
        sds = checkpoint_state_dicts(args.src, overrides)
    else:
        if overrides:
            raise SystemExit(f"config words {overrides} are for a "
                             f"checkpoint; {args.src} holds no "
                             f"{CHECKPOINT_FILE}")
        sds = directory_state_dicts(args.src)
    for name, path in save_model_dir(sds, args.out).items():
        print(f"-- {name}: {len(sds[name])} tensors -> {path}")
    return sds


if __name__ == "__main__":
    main()
