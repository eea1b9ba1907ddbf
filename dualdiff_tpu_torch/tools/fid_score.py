"""FID scoring: the JAX package's ``tools/fid_score.py`` for the port.

Two modes:

    python -m dualdiff_tpu_torch.tools.fid_score --paths DIR_A DIR_B
    python -m dualdiff_tpu_torch.tools.fid_score [--config-name test_fid] \\
        dataset=Nuscenes fid.rootb=GEN_DIR [dataset.dataset_root=...]

The config mode pairs each val sample's real camera image with its
generated twin by token x sensor (``<CAM>/<token>_<CAM>.png``, as
``val_set_gen`` names them by default, or the original file name under
``fid.rootb``; a pair without its twin is skipped with a warning, or
refused with ``fid.require_all=true``), keeps the tokens ``fid.ratio``
picks per scene (``data/scenes.py``), and gives both sides the
train-matching transform: PIL's bicubic resize by the mean of
``augment2d.resize``, then the crop that keeps the bottom rows
(``top_center_crop``).  Every image is then resized to Inception's 299 x
299 (PIL's bilinear) and scored in [0, 1].  Every image is decoded by
PIL (``data/nuscenes.read_rgb``), as the JAX tool decodes it; the resizes
are PIL's exact 8-bit arithmetic (``utils/image_io.py``).

Weights: ``pretrained/pt_inception-2015-12-05.pth`` under the working
directory (``metrics/fid_import.py``).  The JAX tool also reads an orbax
export (``pretrained/inception_fid.ckpt``); the port does not, as the card
has no orbax.  Without the file the tool scores with a seeded random
Inception (He-normal, seed 0; not the JAX tool's random weights),
labelled ``inception_random`` (relative comparisons only), and
refuses real data unless ``allow_fallback_assets=true``.  It runs on the
card unless ``--device cpu`` (or ``device=cpu``) is given.
"""

from __future__ import annotations

import os
import sys
from functools import partial
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..metrics.fid import InceptionV3, fid_from_activations, seeded_init_
from ..data.nuscenes import read_rgb
from ..metrics.fid_import import load_pt_inception
from ..utils.image_io import resize_bicubic, resize_bilinear

IMG_EXTS = (".png", ".jpg", ".jpeg")
WEIGHTS = "pt_inception-2015-12-05.pth"
INCEPTION_HW = (299, 299)


def _list_images(root):
    out = []
    for base, _, files in os.walk(root):
        out += [os.path.join(base, f) for f in files
                if f.lower().endswith(IMG_EXTS)]
    return sorted(out)


def top_center_crop(img: np.ndarray, target_hw) -> np.ndarray:
    """The horizontally centred, BOTTOM-aligned ``target_hw`` window of an
    (H, W, C) image (the name is the reference's; the crop keeps the bottom
    rows, as the training crop does), black where it runs past the image
    (as PIL's ``crop``)."""
    h, w = img.shape[:2]
    th, tw = target_hw
    left = max(0, (w - tw) // 2)
    top = max(0, h - th)
    out = np.zeros((th, tw) + img.shape[2:], img.dtype)
    win = img[top:top + th, left:left + tw]
    out[:win.shape[0], :win.shape[1]] = win
    return out


def train_matching_transform(img: np.ndarray, resize_ratio,
                             target_hw) -> np.ndarray:
    """Bicubic resize by the train ratio, then the bottom-centre crop."""
    h, w = img.shape[:2]
    img = resize_bicubic(img, (int(h * resize_ratio), int(w * resize_ratio)))
    return top_center_crop(img, target_hw)


def _load_batch(paths, size, transform=None) -> np.ndarray:
    ims = []
    for p in paths:
        im = read_rgb(p)
        if transform is not None:
            im = transform(im)
        im = resize_bilinear(im, size)  # the Inception input resize
        ims.append(im.astype(np.float32) / 255.0)
    return np.stack(ims)


def build_extractor(weights_dir: str = "pretrained",
                    require_real: bool = False, device=None):
    """-> (extract: (B, H, W, 3) numpy in [0, 1] -> (B, 2048) numpy,
    (299, 299), label)."""
    device = resolve_device(device)
    pth = os.path.join(weights_dir, WEIGHTS)
    if require_real and not os.path.exists(pth):
        raise FileNotFoundError(
            f"FID inception weights not found under {weights_dir!r} "
            f"({WEIGHTS}). A real-dataset FID on random-init features is "
            "meaningless; provide the asset or set allow_fallback_assets="
            "true to proceed anyway.")
    model = InceptionV3()
    if os.path.exists(pth):
        load_pt_inception(model, torch.load(pth, map_location="cpu",
                                            weights_only=True))
        label = "inception_pool3"
    else:
        print("# WARNING: inception weights not found; using random-init "
              "inception features (relative FID only, not comparable to "
              "published numbers)", file=sys.stderr)
        seeded_init_(model, 0)
        label = "inception_random"
    model = model.to(device)

    @torch.no_grad()
    def extract(x: np.ndarray) -> np.ndarray:
        return model(torch.from_numpy(x).to(device)).float().cpu().numpy()

    return extract, INCEPTION_HW, label


def activations_for_paths(paths, extract, size, batch=16, transform=None):
    acts = []
    for i in range(0, len(paths), batch):
        acts.append(extract(_load_batch(paths[i:i + batch], size, transform)))
    return np.concatenate(acts) if acts else np.zeros((0, 2048))


def pair_real_generated(val, view_order, dataset_root, rootb,
                        require_all=False, token_flags=None):
    """Token x sensor pairing: for every val sample and camera, the real
    file is the dataset image and its generated twin is looked up under
    ``rootb`` by token naming (``<CAM>/<token>_<CAM>.png``) or by the
    original nuScenes file name (``gen_naming=original``).  ``token_flags``
    ({token: bool}, ``sample_tokens_by_scene``) keeps the picked tokens
    only.  -> (real_paths, gen_paths) of equal length."""
    reals, gens = [], []
    missing = 0
    for i in range(len(val)):
        s = val[i]
        if token_flags is not None and not token_flags.get(s["token"], False):
            continue
        for cam, fname in zip(view_order, s["filenames"]):
            cands = [
                os.path.join(rootb, cam, f"{s['token']}_{cam}.png"),
                os.path.join(rootb, os.path.splitext(fname)[0] + ".png"),
                os.path.join(rootb, fname),
            ]
            gen = next((c for c in cands if os.path.exists(c)), None)
            if gen is None:
                missing += 1
                if require_all:
                    raise FileNotFoundError(
                        f"no generated image for {s['token']}/{cam} "
                        f"under {rootb} (tried {cands})")
                continue
            real = fname if os.path.isabs(fname) else os.path.join(
                dataset_root, fname)
            reals.append(real)
            gens.append(gen)
    if missing:
        print(f"# WARNING: {missing} token x sensor pairs had no generated "
              "image and were skipped", file=sys.stderr)
    return reals, gens


def _pop_device(argv: List[str]) -> Tuple[Optional[str], List[str]]:
    if "--device" not in argv:
        return None, argv
    i = argv.index("--device")
    return argv[i + 1], argv[:i] + argv[i + 2:]


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    device, argv = _pop_device(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--paths" in argv:
        i = argv.index("--paths")
        dir_a, dir_b = argv[i + 1], argv[i + 2]
        extract, size, label = build_extractor(device=device)
        a = activations_for_paths(_list_images(dir_a), extract, size)
        b = activations_for_paths(_list_images(dir_b), extract, size)
        fid = fid_from_activations(a, b)
        print(f"FID[{label}] ({len(a)} vs {len(b)} images): {fid:.4f}")
        return fid

    from ..data.scenes import sample_tokens_by_scene
    from ..data.wrappers import build_dataset
    from ..utils.config import compose

    cfg, _ = compose(argv)
    fid_cfg = cfg.get("fid") or {}
    rootb = fid_cfg.get("rootb") or cfg.get("fid_rootb")
    assert rootb, "config mode needs fid.rootb=<generated samples dir>"
    rootb = str(rootb)
    val = build_dataset(cfg, "val", load_images=False, load_bev=False)
    flags = sample_tokens_by_scene(
        val, float(fid_cfg.get("ratio", -1)), int(cfg.seed))
    reals, gens = pair_real_generated(
        val, list(cfg.dataset.view_order), str(cfg.dataset.dataset_root),
        rootb, require_all=bool(fid_cfg.get("require_all", False)),
        token_flags=flags)
    assert reals, f"no real/generated pairs found under {rootb}"

    # the same train-matching transform on both sides
    resize_ratio = float(np.mean(np.asarray(
        cfg.dataset.augment2d.resize[0], np.float32)))
    transform = partial(train_matching_transform,
                        resize_ratio=resize_ratio,
                        target_hw=tuple(cfg.dataset.image_size))
    synthetic = str(cfg.dataset.get("dataset_type", "")) \
        == "SyntheticNuScenes"
    extract, size, label = build_extractor(
        require_real=not synthetic
        and not bool(cfg.get("allow_fallback_assets", False)),
        device=device or cfg.get("device"))
    a = activations_for_paths(reals, extract, size, transform=transform)
    b = activations_for_paths(gens, extract, size, transform=transform)
    fid = fid_from_activations(a, b)
    print(f"FID[{label}] ({len(a)} real vs {len(b)} generated, "
          f"token x sensor paired): {fid:.4f}")
    return fid


if __name__ == "__main__":
    main()
