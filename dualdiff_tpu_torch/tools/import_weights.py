"""Import released SD v1.5 / ControlNet checkpoints into the port's weights
directory: the JAX package's ``tools/import_weights.py`` for the port.

    python -m dualdiff_tpu_torch.tools.import_weights \
        --src pretrained/stable-diffusion-v1-5 --out pretrained/sdv15_port \
        +exp=224x400

Builds the config's models (seed ``cfg.seed``; ``tiny_models=true`` the
tiny ones, ``device=cpu`` on the CPU), reads the diffusers-layout
``--src`` (``unet/``, ``vae/``, ``text_encoder/`` and, for ControlNet
``i``, ``controlnet_<i>/``, ``controlnet/`` or ``controlnet_bg_<i+1>/``:
``runner.weights.load_pretrained_dir``), overlays each found component on
the fresh model (the modules DualDiff adds keep their init: attn4, its norm
and its zero-init connector) and writes it to ``<out>/<component>/
diffusion_pytorch_model.bin`` (``save_model_dir``: ``vae``,
``text_encoder``, ``unet``, ``controlnet_<i>``), which
``load_pretrained_dir`` reads into the trainer's and the pipeline's
models.  The JAX tool writes orbax checkpoints instead.  Prints a line per
component and returns the report.
"""

from __future__ import annotations

import argparse
import sys

import torch

from .. import resolve_device
from ..runner.factory import build_models
from ..runner.weights import load_pretrained_dir, save_model_dir
from ..utils.config import compose


def fresh_models(cfg):
    """The config's model set, seeded with ``cfg.seed`` as the trainer
    seeds it, tiny with ``tiny_models``, on ``cfg.device`` (the card when
    unset)."""
    dev = resolve_device(cfg.get("device"))
    with torch.random.fork_rng(devices=[dev.index or 0]
                               if dev.type == "cuda" else []):
        torch.manual_seed(int(cfg.seed))
        return build_models(cfg, device=dev,
                            tiny=bool(cfg.get("tiny_models", False)))


def components(models):
    """{component directory: module} of a model set."""
    out = {"vae": models["vae"], "text_encoder": models["text_encoder"],
           "unet": models["unet"]}
    out.update({f"controlnet_{i}": cn
                for i, cn in enumerate(models["controlnets"])})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", required=True)
    args, overrides = ap.parse_known_args(
        list(argv if argv is not None else sys.argv[1:]))
    cfg, _ = compose(overrides)
    models = fresh_models(cfg)
    report = load_pretrained_dir(models, args.src)
    mods = components(models)
    found = {}
    for name, rep in report.items():
        if rep is None:
            print(f"-- {name}: no weights under {args.src}; skipping")
            continue
        print(f"-- {name}: {rep['file']}: {rep['src_keys']} tensors, "
              f"{len(rep['missing'])} kept from the fresh model")
        found[name] = mods[name].state_dict()
    save_model_dir(found, args.out)
    print(f"done -> {args.out}")
    return report


if __name__ == "__main__":
    main()
