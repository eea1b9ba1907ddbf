"""Tracing and profiling: a profiler trace, named ranges, a step timer
with TFLOP/s accounting and a NaN / Inf guard.

Port of ``dualdiff_tpu/utils/profiling.py``, with the same four names:
``trace`` records a ``torch.profiler`` trace of the CPU and, when there is
one, the card, written as a Chrome / Perfetto JSON; ``named_scope`` is
``torch.profiler.record_function`` (a range in that trace);
``StepTimer`` synchronises the card before it reads the clock once the
process uses it, so a step's time holds its kernels;
``check_finite`` sweeps nested tensors and arrays.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)

__all__ = ["trace", "StepTimer", "named_scope", "check_finite",
           "TRACE_FILE"]

named_scope = torch.profiler.record_function

# the file ``trace`` writes under its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Record a profiler trace of the block into ``<logdir>/TRACE_FILE``
    (open it in Perfetto or chrome://tracing); the card's activity is in
    it when CUDA is available.  Yields the profiler, whose
    ``key_averages()`` tabulate the same events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


class StepTimer:
    """Rolling step-time and throughput tracker.

    ``flops_per_step`` (optional) is the analytic cost of one step; when
    set, ``stats()`` reports achieved TFLOP/s (model FLOPs, not hardware
    FLOPs).  Once the process uses the card, ``tick`` waits for its queued
    work first, so a step's time is the card's, not its launch's."""

    def __init__(self, flops_per_step: Optional[float] = None,
                 window: int = 50):
        self.flops = flops_per_step
        self.window = window
        self.times = []
        self._last = None

    def tick(self) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        avg = sum(self.times) / len(self.times)
        out = {"step_time_s": avg, "steps_per_s": 1.0 / avg}
        if self.flops:
            out["tflops_per_s"] = self.flops / avg / 1e12
        return out


def _leaves(tree, path: str = ""):
    """(path, leaf) of nested dicts, lists and tuples, paths as
    ``jax.tree_util.keystr`` writes them (``['a'][0]``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):  # jax flattens dicts in key order
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def check_finite(tree, name: str = "tree") -> None:
    """Host-side NaN / Inf sweep over a state dict or nested tensors and
    arrays: raises ``FloatingPointError`` naming the first 8 floating
    leaves that hold a NaN or an Inf (a debugging aid; the trainer's own
    NaN-loss check stays)."""
    bad = []
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            ok = not leaf.is_floating_point() or bool(
                torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            ok = arr.dtype.kind != "f" or bool(np.isfinite(arr).all())
        if not ok:
            bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad[:8]}")
