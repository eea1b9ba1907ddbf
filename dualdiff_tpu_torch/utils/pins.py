"""Pinned-output numerics check of the bench's generation.

Port of ``dualdiff_tpu/utils/pins.py``: four statistics of the images one
seeded generation gives are held to the values stored for the same
(device, geometry, batch, box cap) key in ``bench_pins.json`` beside this
module, within ``atol + rtol * |pinned|`` (0.005 + 2%).  A kernel regression
(a wrong mask, a scrambled layout, a dropped CFG row) moves them by far
more than a library version's rounding does.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

__all__ = ["output_stats", "check_pin", "save_pin", "PIN_FILE"]

PIN_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bench_pins.json")


def output_stats(t: torch.Tensor) -> Dict[str, float]:
    """Mean, std, min and max of a tensor in float32, as Python floats (the
    reductions run where the tensor lies)."""
    a = t.detach().float()
    return {"mean": float(a.mean()), "std": float(a.std()),
            "min": float(a.min()), "max": float(a.max())}


def _read(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def check_pin(stats: Dict[str, float], key: str,
              pin_file: Optional[str] = None,
              rtol: float = 0.02, atol: float = 0.005) -> Dict:
    """``stats`` against the pin stored for ``key`` -> ``{"status": "ok" |
    "drift" | "unpinned", "key", "stats"[, "drift"]}``; ``unpinned``: no pin
    for ``key`` yet."""
    pin = _read(pin_file or PIN_FILE).get(key)
    out = {"status": "ok", "key": key, "stats": stats}
    if not isinstance(pin, dict):
        out["status"] = "unpinned"
        return out
    drift = {}
    for name, pinned in pin.items():
        got = stats.get(name)
        if got is None:
            continue
        tol = atol + rtol * abs(float(pinned))
        if abs(float(got) - float(pinned)) > tol:
            drift[name] = {"pinned": float(pinned), "got": float(got),
                           "tol": round(tol, 6)}
    if drift:
        out["status"] = "drift"
        out["drift"] = drift
    return out


def save_pin(stats: Dict[str, float], key: str,
             pin_file: Optional[str] = None) -> None:
    """Record ``stats`` as the pin for ``key``."""
    path = pin_file or PIN_FILE
    pins = _read(path)
    pins[key] = {k: round(float(v), 6) for k, v in stats.items()}
    with open(path, "w") as f:
        json.dump(pins, f, indent=1, sort_keys=True)
        f.write("\n")
