"""Dynamic import of the ``pkg.mod.Class`` strings of a config.

Port of ``dualdiff_tpu/utils/common.py::load_module``.  The shipped configs
name the JAX package's classes (``model.runner_module:
dualdiff_tpu.runner.trainer.MultiviewTrainer``); ``load_module`` maps that
package prefix to the port's and imports the port's class of the same
path.
"""

from __future__ import annotations

import importlib
from typing import Any

__all__ = ["load_module", "PORTED_PREFIX"]

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
