"""JAX param trees -> the port's ``state_dict``.

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
the exporter's ``to_q_lora_a`` etc.

A diffusers SD v1.5 checkpoint carries the same names, so it loads into the
same modules.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["from_jax", "NOT_PORTED"]

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
