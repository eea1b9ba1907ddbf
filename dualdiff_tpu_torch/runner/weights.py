"""Weights for the port's modules: JAX param trees, and released
diffusers / transformers checkpoints.

JAX param trees -> the port's ``state_dict`` (``from_jax``):

The port's parameter names are the diffusers / transformers names that the
JAX package's exporter (``dualdiff_tpu/runner/weight_import.py``,
``export_params``) emits; this module keeps its own copy of that mapping and
of the layout transposes:

* conv kernels HWIO -> OIHW,
* dense kernels (I, O) -> (O, I),
* norm ``scale`` -> ``weight``, embedding tables unchanged.

One rename departs from the exporter's names: the LoRA adapters of an
attention's output projection, which the exporter names
``to_out.0_lora_a`` / ``to_out.0_lora_b``, are ``to_out_0_lora_a`` /
``to_out_0_lora_b`` here (``to_out`` is a ``ModuleList``; its ``0`` is the
projection itself).  The adapters of ``to_q``, ``to_k`` and ``to_v`` keep
the exporter's ``to_q_lora_a`` etc.  Flat names the exporter emits stay flat
here too: the ControlNet's camera projection of ``use_cam_in_temb`` is
``adm_proj_0`` / ``adm_proj_2`` (``adm_proj`` is no list the exporter
splits), and the box adapter's ``attn2.to_{k,v}_{box,cls}`` and the BEV-map
embedder's ``controlnet_cond_embedding.{conv_in,blocks.N,conv_out}`` are
the exporter's names as they are.

Released checkpoints (the import side of the JAX package's
``runner/weight_import.py`` and ``tools/import_weights.py``): a diffusers
SD v1.5 checkpoint carries the port's names, with two exceptions that
``from_diffusers`` maps: the legacy VAE attention names of pre-0.15
diffusers dumps (the original SD v1.5 VAE on the hub) and the CLIP
``position_ids`` buffer of older transformers dumps, which is dropped.
``read_checkpoint`` reads ``.safetensors`` (with no ``safetensors``
package) and ``.bin`` / ``.pt`` files; ``load_pretrained`` loads one state
dict into a module by the JAX ``merge_imported``'s rules, and
``load_pretrained_dir`` a diffusers-layout directory into a model set.

The port's own weights directory (``save_model_dir``, what the trainer's
``export_model`` and ``tools/import_weights.py`` write and
``tools/export_weights.py`` emits): ``<component>/EXPORT_FILE``, a
``torch.save`` of float32 CPU tensors in the JAX exporter's names
(``export_name``), which ``load_pretrained_dir`` reads.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["from_jax", "NOT_PORTED", "MULTIVIEW_MODULES", "LEGACY_VAE_NAMES",
           "from_diffusers", "read_checkpoint", "load_pretrained",
           "load_pretrained_dir", "weights_file", "export_name",
           "save_model_dir", "EXPORT_FILE"]

# the weights file of each exported model directory (diffusers' name)
EXPORT_FILE = "diffusion_pytorch_model.bin"

_LISTY = (
    "resnets", "attentions", "transformer_blocks", "down_blocks", "up_blocks",
    "downsamplers", "upsamplers", "layers", "blocks",
    "controlnet_down_blocks", "second_linear",
)

# leaves of the JAX trees that the port has no module for yet, by kind;
# from_jax leaves them out
NOT_PORTED = {"vae": ()}


def _torch_name(path: Tuple[str, ...], kind: str) -> str:
    """Flax param path -> diffusers / transformers state-dict name."""
    parts = []
    for p in path:
        m = re.fullmatch(r"(" + "|".join(_LISTY) + r")_(\d+)", p)
        parts.extend([m.group(1), m.group(2)] if m else [p])
    name = ".".join(parts)
    name = name.replace("net_0_proj", "net.0.proj").replace("net_2", "net.2")
    name = name.replace("to_out_0", "to_out.0")
    name = name.replace("to_out.0_lora_", "to_out_0_lora_")  # see above
    name = re.sub(r"\.(kernel|scale|embedding)$", ".weight", name)
    if kind == "vae":
        name = name.replace("mid_attn", "mid_block.attentions.0")
        name = re.sub(r"mid_resnets_(\d+)", r"mid_block.resnets.\1", name)
        name = re.sub(r"(down|up)_blocks_(\d+)_resnets_(\d+)",
                      r"\1_blocks.\2.resnets.\3", name)
        name = re.sub(r"(down|up)_blocks_(\d+)_(down|up)samplers_0",
                      r"\1_blocks.\2.\3samplers.0.conv", name)
    elif kind == "clip":
        name = re.sub(r"^layers\.", "encoder.layers.", name)
        name = name.replace("mlp_fc1", "mlp.fc1").replace("mlp_fc2",
                                                          "mlp.fc2")
        name = name.replace("token_embedding", "embeddings.token_embedding")
        if name.startswith("position_embedding"):
            name = "embeddings.position_embedding.weight"
        name = "text_model." + name
    elif kind == "controlnet":
        name = name.replace("bbox_embedder.class_tokens",
                            "bbox_embedder._class_tokens")
        if name == "uncond_cam":
            name = "uncond_cam.weight"
    return name


def from_jax(flat: Mapping[str, np.ndarray],
             kind: str) -> Dict[str, torch.Tensor]:
    """``flat``: a flax param tree flattened to ``"/"``-joined paths with
    numpy leaves; ``kind`` in {unet, controlnet, vae, clip}.  Returns the
    port's state_dict (float32 CPU tensors), ready for
    ``load_state_dict(..., strict=True)``."""
    if kind not in ("unet", "controlnet", "vae", "clip"):
        raise ValueError(f"unknown kind {kind!r}")
    skip = NOT_PORTED.get(kind, ())
    out = {}
    for key, value in flat.items():
        path = tuple(key.split("/"))
        v = np.asarray(value)
        if path[-1] == "kernel":
            v = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
        name = _torch_name(path, kind)
        if not name.startswith(skip):
            out[name] = torch.from_numpy(np.array(v))
    return out


# the modules DualDiff adds to each transformer block of SD v1.5's UNet
# (the multiview attention, its norm and its connector: a zero-init linear's
# weight and bias, a gated connector's alpha, or no connector): an SD v1.5
# checkpoint holds none of their leaves, which keep the module's init
MULTIVIEW_MODULES = ("attn4", "norm4", "connector")
# legacy -> current names of the VAE's mid-block attention (diffusers
# renamed them in its 0.15 attention refactor; weight_import.py:120-123)
LEGACY_VAE_NAMES = {"query": "to_q", "key": "to_k", "value": "to_v",
                    "proj_attn": "to_out.0"}
_KINDS = ("unet", "controlnet", "vae", "clip")
# safetensors dtype names -> torch dtypes, those SD checkpoints use
_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64}


def from_diffusers(state_dict: Mapping[str, torch.Tensor],
                   kind: str) -> Dict[str, torch.Tensor]:
    """A diffusers / transformers state dict -> the port's names; ``kind``
    in {unet, controlnet, vae, clip}.  The VAE's legacy attention names
    (``LEGACY_VAE_NAMES``) become the current ones; CLIP's
    ``position_ids`` buffer is dropped (``weight_import.py:147``); the
    JAX exporter's ``to_out.0_lora_*`` adapters become ``to_out_0_lora_*``
    (see above); a ControlNet's ``adm_proj.0`` / ``adm_proj.2`` (the
    reference's ``Sequential``, which ``import_controlnet`` takes as the
    exporter's ``adm_proj_0`` / ``adm_proj_2``) become those flat names.
    UNet and ControlNet names are otherwise the port's own: the
    ControlNet's ``bbox_embedder._class_tokens`` and ``uncond_cam.weight``
    are the exporter's names, which the port keeps.  Values become
    tensors, unconverted."""
    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    legacy = re.compile(r"attentions\.0\.(" + "|".join(LEGACY_VAE_NAMES)
                        + r")\.")
    out = {}
    for name, value in state_dict.items():
        if kind == "clip" and name.endswith("position_ids"):
            continue
        if kind == "vae":
            name = legacy.sub(lambda m: f"attentions.0."
                              f"{LEGACY_VAE_NAMES[m.group(1)]}.", name)
        name = name.replace("to_out.0_lora_", "to_out_0_lora_")
        if kind == "controlnet":
            name = re.sub(r"^adm_proj\.(\d+)\.", r"adm_proj_\1.", name)
        out[name] = torch.as_tensor(value)
    return out


def read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a checkpoint file on the CPU: ``.safetensors``
    read here (an 8-byte little-endian header length, a JSON header of
    ``{name: {dtype, shape, data_offsets}}``, then the raw little-endian
    bytes; F32, F16, BF16 and I64), anything else through
    ``torch.load(weights_only=True)``."""
    if not path.endswith(".safetensors"):
        return dict(torch.load(path, map_location="cpu", weights_only=True))
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             f"not one of {sorted(_SAFETENSORS_DTYPES)}")
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        numel = int(np.prod(shape, dtype=np.int64))
        if end - begin != numel * dtype.itemsize or end > len(data):
            raise ValueError(f"{path}: {name}'s bytes {begin}:{end} do not "
                             f"hold {shape} {info['dtype']}")
        out[name] = torch.frombuffer(data, dtype=dtype, count=numel,
                                     offset=begin).reshape(shape) \
            if numel else torch.empty(shape, dtype=dtype)
    return out


def load_pretrained(module: torch.nn.Module,
                    state_dict: Mapping[str, torch.Tensor],
                    kind: str) -> List[str]:
    """Copy a diffusers / transformers state dict (``from_diffusers``'s
    names) into ``module``, onto its own device and dtype, by the JAX
    ``merge_imported``'s rules (``weight_import.py:215-233``): a shape
    mismatch or a key the module lacks raises before anything is copied;
    a module key the state dict lacks keeps the module's value.  ->
    those missing keys (after an SD v1.5 UNet checkpoint, exactly the
    ``MULTIVIEW_MODULES``' leaves)."""
    src = from_diffusers(state_dict, kind)
    own = module.state_dict()
    unexpected = sorted(k for k in src if k not in own)
    if unexpected:
        raise KeyError(f"{len(unexpected)} keys the {kind} lacks: "
                       f"{unexpected[:10]}")
    for k, v in src.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: the {kind} has "
                             f"{tuple(own[k].shape)}, the checkpoint "
                             f"{tuple(v.shape)}")
    with torch.no_grad():
        for k, v in src.items():
            own[k].copy_(v)
    return sorted(k for k in own if k not in src)


def weights_file(sub: str) -> Optional[str]:
    """The first ``*.safetensors``, else ``*.bin``, else ``*.pt`` file of
    directory ``sub`` (``tools/import_weights.py::_find_weights``)."""
    for pattern in ("*.safetensors", "*.bin", "*.pt"):
        hits = sorted(glob.glob(os.path.join(sub, pattern)))
        if hits:
            return hits[0]
    return None


def load_pretrained_dir(models: Dict, src: str) -> Dict[str, Optional[Dict]]:
    """Load a diffusers-layout checkpoint directory into ``build_models``'s
    model set, as ``tools/import_weights.py`` reads it (``:40-130``):
    ``vae/``, ``text_encoder/`` and ``unet/``, and for ControlNet ``i`` the
    first of ``controlnet_<i>/``, ``controlnet/`` and
    ``controlnet_bg_{1,2}/`` (branch 0, 1) that holds a weights file.  ->
    {component: {"file", "missing", "src_keys"}, or None where no weights
    file was found: that component keeps its weights and is reported, not
    guessed}."""
    jobs = [("vae", models["vae"], "vae", ["vae"]),
            ("text_encoder", models["text_encoder"], "clip",
             ["text_encoder"]),
            ("unet", models["unet"], "unet", ["unet"])]
    jobs += [(f"controlnet_{i}", cn, "controlnet",
              [f"controlnet_{i}", "controlnet", f"controlnet_bg_{i + 1}"])
             for i, cn in enumerate(models["controlnets"])]
    report = {}
    for name, module, kind, subdirs in jobs:
        path = next(filter(None, (weights_file(os.path.join(src, d))
                                  for d in subdirs)), None)
        if path is None:
            report[name] = None
            continue
        sd = read_checkpoint(path)
        missing = load_pretrained(module, sd, kind)
        report[name] = {"file": path, "missing": missing,
                        "src_keys": len(sd)}
    return report


def export_name(name: str) -> str:
    """A port state-dict name -> the JAX exporter's (the one rename of
    the module docstring: ``to_out_0_lora_*`` -> ``to_out.0_lora_*``)."""
    return name.replace("to_out_0_lora_", "to_out.0_lora_")


def save_model_dir(state_dicts: Mapping[str, Mapping[str, torch.Tensor]],
                   root: str) -> Dict[str, str]:
    """``{component: state dict}`` -> ``<root>/<component>/EXPORT_FILE``
    each: float32 CPU tensors under ``export_name``s.  -> {component:
    path}."""
    paths = {}
    for name, sd in state_dicts.items():
        path = os.path.join(root, name, EXPORT_FILE)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({export_name(k): v.detach().to("cpu", torch.float32)
                    for k, v in sd.items()}, path)
        paths[name] = path
    return paths
