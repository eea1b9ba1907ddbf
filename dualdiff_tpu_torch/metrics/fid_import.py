"""The FID Inception weights, ``pt_inception-2015-12-05`` (pytorch-fid's
port of the TF InceptionV3), into and out of ``metrics.fid.InceptionV3``.

The file's layout is torchvision's ``inception_v3`` (``num_classes=1008``,
no aux head): each of the 94 conv blocks ``<mod>`` carries
``<mod>.conv.weight`` (O, I, kh, kw) and
``<mod>.bn.{weight,bias,running_mean,running_var,num_batches_tracked}``,
and the classifier ``fc.{weight,bias}``, which pool3 does not use.
``PT_INCEPTION_CONV_MODULES`` is the list of blocks (the JAX importer's,
copied).  ``import_pt_inception`` checks that every weight is there and
every key is consumed (``fc.*`` dropped) before the module loads the rest
with ``strict=True``, so a name that drifts on either side fails loudly.
"""

from __future__ import annotations

from typing import Dict, List

import torch

__all__ = ["PT_INCEPTION_CONV_MODULES", "pt_inception_key_list",
           "import_pt_inception", "load_pt_inception", "export_pt_inception"]


def _blocks() -> List[str]:
    stem = ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
            "Conv2d_3b_1x1", "Conv2d_4a_3x3"]
    a = ["branch1x1", "branch5x5_1", "branch5x5_2",
         "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"]
    b = ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"]
    c = ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
         "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3",
         "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"]
    d = ["branch3x3_1", "branch3x3_2",
         "branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"]
    e = ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
         "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a",
         "branch3x3dbl_3b", "branch_pool"]
    mods = list(stem)
    for mixed in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        mods += [f"{mixed}.{m}" for m in a]
    mods += [f"Mixed_6a.{m}" for m in b]
    for mixed in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        mods += [f"{mixed}.{m}" for m in c]
    mods += [f"Mixed_7a.{m}" for m in d]
    for mixed in ("Mixed_7b", "Mixed_7c"):
        mods += [f"{mixed}.{m}" for m in e]
    return mods


PT_INCEPTION_CONV_MODULES: List[str] = _blocks()  # 94 conv blocks
assert len(PT_INCEPTION_CONV_MODULES) == 94

_BN_KEYS = ("weight", "bias", "running_mean", "running_var",
            "num_batches_tracked")


def pt_inception_key_list() -> List[str]:
    """Every key of the canonical pt_inception-2015-12-05 state dict."""
    keys = []
    for mod in PT_INCEPTION_CONV_MODULES:
        keys.append(f"{mod}.conv.weight")
        keys += [f"{mod}.bn.{k}" for k in _BN_KEYS]
    keys += ["fc.weight", "fc.bias"]
    return keys


def import_pt_inception(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """A pytorch-fid state dict -> the module's state dict: every weight
    present (the ``fc`` head and the ``num_batches_tracked`` counters may be
    missing), every key consumed, ``fc`` dropped, missing counters 0."""
    sd = {k: torch.as_tensor(v) for k, v in state_dict.items()}
    required = {k for k in pt_inception_key_list()
                if not k.startswith("fc.")
                and not k.endswith("num_batches_tracked")}
    missing = required - set(sd)
    assert not missing, f"state dict missing keys: {sorted(missing)[:8]}"
    out, consumed = {}, {"fc.weight", "fc.bias"}  # the classifier: unused
    for mod in PT_INCEPTION_CONV_MODULES:
        keys = [f"{mod}.conv.weight"] + [f"{mod}.bn.{k}" for k in _BN_KEYS]
        for k in keys:
            out[k] = sd[k] if k in sd else torch.zeros((), dtype=torch.int64)
        consumed.update(keys)
    leftover = set(sd) - consumed
    assert not leftover, f"unconsumed pt_inception keys: {sorted(leftover)[:8]}"
    return out


def load_pt_inception(model: torch.nn.Module, state_dict: Dict) -> None:
    """``import_pt_inception`` of ``state_dict`` into ``model``,
    ``strict=True``."""
    model.load_state_dict(import_pt_inception(state_dict), strict=True)


def export_pt_inception(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The module's weights under the pytorch-fid names, on the CPU
    (``num_batches_tracked`` 0, no ``fc``)."""
    own = model.state_dict()
    out = {}
    for k in pt_inception_key_list():
        if k.startswith("fc."):
            continue
        out[k] = (torch.zeros((), dtype=torch.int64)
                  if k.endswith("num_batches_tracked")
                  else own[k].detach().cpu().clone())
    return out
