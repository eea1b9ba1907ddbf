"""Dynamic import of the ``pkg.mod.Class`` strings of a config, and a
dtype cast over nested containers of tensors.

Port of ``dualdiff_tpu/utils/common.py``.  The shipped configs
name the JAX package's classes (``model.runner_module:
dualdiff_tpu.runner.trainer.MultiviewTrainer``); ``load_module`` maps that
package prefix to the port's and imports the port's class of the same
path.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Optional

import torch

__all__ = ["load_module", "move_to", "PORTED_PREFIX"]

# the JAX package's prefix -> the port's
PORTED_PREFIX = ("dualdiff_tpu.", "dualdiff_tpu_torch.")


def load_module(name: str) -> Any:
    """The attribute ``name`` (``pkg.mod.Class``) names, with a leading
    ``dualdiff_tpu.`` read as ``dualdiff_tpu_torch.``."""
    old, new = PORTED_PREFIX
    if name.startswith(old):
        name = new + name[len(old):]
    module, _, attr = name.rpartition(".")
    return getattr(importlib.import_module(module), attr)


def move_to(tree, dtype=None, predicate: Optional[Callable] = None):
    """``tree`` with every tensor leaf for which ``predicate`` holds (every
    one when it is None) cast to ``dtype``; dicts, lists and tuples are
    rebuilt, any other leaf is kept as it is (the JAX package's
    ``jax.tree_util.tree_map`` of ``astype``)."""
    if isinstance(tree, dict):
        return type(tree)((k, move_to(v, dtype, predicate))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        out = [move_to(v, dtype, predicate) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    if isinstance(tree, torch.Tensor) and (predicate is None
                                           or predicate(tree)):
        return tree.to(dtype)
    return tree
