"""Collectives that carry gradients, and the split a model call runs under.

The JAX package splits a batch over a ``(data, view)`` mesh and lets XLA
insert the collectives that attn4, ST-Attn and the temporal attention need
across the shards.  Here each rank runs its own rows eagerly, and the
modules that couple rows across ranks call these collectives themselves:

* ``gather(x, group, dim)``: every rank's ``x`` of ``group``, concatenated
  along ``dim`` in the group's rank order.  Its backward sums every rank's
  gradient of the whole (one ``all_reduce``) and keeps this rank's slice:
  rank ``s``'s input gets ``sum_r dL_r / dx_s``.
* ``all_sum(x, group)``: the sum over ``group`` of ``x`` (the RGD reward's
  partial sums); its backward is the same sum of the gradients.
* ``gather_runs(x, group)``: ``gather`` along dim 0 where the ranks' runs
  may differ in length (a reward over a prefix of each clip).

With ``group`` None each returns its input, so one body serves a model
call with and without a mesh.

Both are sums, never means.  Each rank's loss is the mean over its own
rows, the global loss is the mean of the ranks' losses, and the summed
cross-rank gradients add up over the ranks to the gradient of the sum of
the ranks' losses; ``mesh.average_gradients`` then divides by the world
size once, so the split step equals one process's step on the global
batch.  Each collective's backward runs where autograd reaches it, and a
block that ``remat_call`` replays calls its forward collectives again in
the backward: every rank runs the same graph, so every rank meets them in
the same order.

``Split``: where this rank's rows of a model call sit in the global batch
(its cameras of each sample, its frames of each clip) and the groups that
hold the rest; ``mesh.Mesh.split`` builds it, the trainer and the pipeline
pass it to the UNet in the place of its camera count.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist

__all__ = ["gather", "all_sum", "gather_runs", "Split", "as_split",
           "frame_group_size", "GatherStats", "STATS"]


@dataclass
class GatherStats:
    """What ``gather`` moved in this process: calls, bytes received from
    other ranks (forward and backward), and host seconds in the collective
    (a read of ``seconds`` is honest only where the caller synchronises the
    device around the step)."""
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


STATS = GatherStats()


def _group_size(group) -> int:
    return dist.get_world_size(group)


def _timed(fn, nbytes: int):
    t0 = time.perf_counter()
    out = fn()
    STATS.calls += 1
    STATS.bytes += nbytes
    STATS.seconds += time.perf_counter() - t0
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim: int):
        n = _group_size(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        _timed(lambda: dist.all_gather(parts, x, group=group),
               (n - 1) * x.numel() * x.element_size())
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        # a copy: the sum is taken in place, and autograd's buffer may be
        # another node's too
        grad = grad.clone(memory_format=torch.contiguous_format)
        n = _group_size(ctx.group)
        _timed(lambda: dist.all_reduce(grad, group=ctx.group),
               2 * (n - 1) * grad.numel() * grad.element_size() // n)
        own = grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size)
        return own.contiguous(), None, None


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` (see the
    module docstring); ``x`` itself when ``group`` is None."""
    if group is None:
        return x
    return _Gather.apply(x, group, dim)


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable (see the module
    docstring); ``x`` itself when ``group`` is None."""
    if group is None:
        return x
    return _AllSum.apply(x, group)


def gather_runs(x: torch.Tensor, group):
    """Every rank's ``x`` of ``group`` concatenated along dim 0, the ranks'
    lengths free to differ -> (the whole, the index of this rank's first
    row there).  Each run is padded to the longest and gathered
    (``gather``, whose backward this takes); ``(x, 0)`` when ``group`` is
    None."""
    if group is None:
        return x, 0
    n = torch.tensor([x.shape[0]], device=x.device)
    sizes = [torch.empty_like(n) for _ in range(_group_size(group))]
    dist.all_gather(sizes, n, group=group)
    sizes = [int(s) for s in sizes]
    m = max(sizes)
    full = gather(torch.cat([x, x.new_zeros(m - x.shape[0], *x.shape[1:])]),
                  group, 0)
    rows = [r * m + i for r, s in enumerate(sizes) for i in range(s)]
    return full[rows], sum(sizes[:dist.get_rank(group)])


@dataclass(frozen=True)
class Split:
    """This rank's place in the global batch of a model call.

    Rows fold (sample or frame, camera), camera inner.  The rank holds
    ``n_local`` of the ``n_cam`` cameras of each of its samples, global
    cameras ``view0 .. view0 + n_local - 1``; ``view_group`` is the ranks
    that hold the other cameras of the same samples (None: all here).  With
    clips of ``frames`` frames, frame outer, the rank's samples are a run
    of frames, and ``frame_group`` is the ``frame_ranks`` ranks whose runs
    together are whole clips, this one at place ``frame_rank`` (None:
    whole clips here).  Camera and frame identities stay global: attn4's
    neighbours, ST-Attn's first and previous frame and the temporal
    attention's keys are read from the gathered rows."""
    n_cam: int
    n_local: int
    view0: int = 0
    view_group: Any = field(default=None, compare=False)
    frame_group: Any = field(default=None, compare=False)
    frame_ranks: int = 1
    frame_rank: int = 0

    def __post_init__(self):
        if not 0 < self.n_local <= self.n_cam or self.view0 < 0 or \
                self.view0 + self.n_local > self.n_cam:
            raise ValueError(f"cameras {self.view0}.."
                             f"{self.view0 + self.n_local - 1} are not a "
                             f"run of {self.n_cam}")
        if (self.view_group is None) != (self.n_local == self.n_cam):
            raise ValueError("a view group holds the cameras a rank lacks: "
                             "one exactly when n_local < n_cam")
        if (self.frame_group is None) != (self.frame_ranks == 1) or \
                not 0 <= self.frame_rank < self.frame_ranks:
            raise ValueError(f"frame rank {self.frame_rank} of "
                             f"{self.frame_ranks}")

    def clip_rows(self, rows: int, frames: int):
        """-> (the index, in the frame group's gathered rows, of this
        rank's first frame; the number of gathered frames), for ``rows``
        frames here of clips of ``frames``; raises when the group's frames
        are not whole clips."""
        total = rows * self.frame_ranks
        if total % frames:
            raise ValueError(f"{self.frame_ranks} ranks of {rows} frames "
                             f"are not whole clips of {frames}")
        return self.frame_rank * rows, total


def as_split(n_cam) -> Split:
    """A model call's ``Split``: ``n_cam`` itself, or for a camera count
    every camera and every frame here (no groups)."""
    return n_cam if isinstance(n_cam, Split) else Split(int(n_cam),
                                                        int(n_cam))


def frame_group_size(rows: int, frames: int) -> int:
    """The ranks whose runs of ``rows`` frames are together whole clips of
    ``frames``: ``frames / gcd(rows, frames)`` (1 when every rank holds
    whole clips)."""
    return frames // math.gcd(rows, frames)
