"""Process group and the ``(data, view)`` mesh over ``torch.distributed``.

Port of ``dualdiff_tpu/parallel/mesh.py``.  The JAX package lays its
devices on a ``(data, view)`` mesh: the batch is sharded over ``data``, a
camera axis over ``view``, the parameters are replicated, and XLA inserts
the collectives.  Here each process is one rank of a process group and
holds one shard:

* ``create_mesh(data=-1, view=1)`` -> ``Mesh``: ranks laid out as JAX's
  ``reshape(data, view)`` lays devices, rank ``d * view + v`` (``data =
  -1``: the world size over ``view``; ``data * view`` must be the world
  size).  With ``view > 1`` it forms the view groups, one per ``d`` (the
  ranks that hold the cameras of the same samples); ``Mesh.split`` forms
  the frame groups on first use (the data ranks, at one ``v``, whose
  frames are together whole clips).  ``dist.new_group`` is collective:
  every rank makes the same calls in the same order.
* ``init_from_env()``: ``jax.distributed.initialize()``'s counterpart.  It
  reads the launcher's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
  (``python -m torch.distributed.run`` sets them) and joins the group over
  ``nccl`` when every rank of the host has a card of its own, else over
  ``gloo`` (the CPU, or ranks that share a card: NCCL refuses two ranks on
  one device).
* ``batch_shardings`` / ``shard_batch`` / ``put_global``: every rank builds
  the same host batch, as the JAX processes do, and keeps its index of
  each leaf by the JAX rule (``batch_shardings``): a leaf whose first
  dimension divides by ``data`` is split there in contiguous blocks (rank
  ``d`` of ``data`` takes rows ``[d n/data, (d+1) n/data)``, ``P("data")``),
  and, when its dimension 1 is ``n_cam`` and ``view > 1`` divides it, also
  there (``P("data", "view")``); every other leaf is whole (replicated).
  A clip batch's frame-flattened leading dimension ``B * F`` is one such
  first dimension: a rank may hold part of a clip.  ``replicate`` has no
  counterpart: every rank holds every parameter.
* ``average_gradients``: one ``all_reduce`` per flattened float32 bucket,
  divided by the world size; ``all_mean`` for metrics; ``barrier``,
  ``is_main``, ``broadcast_object``, ``destroy``.

Nothing falls back: a rank that cannot reach its card raises in
``resolve_device``, a layout the JAX rule would replicate where the model
couples the rows (cameras that do not divide over ``view``) raises, and a
failed collective raises out of the step.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from .collectives import Split, frame_group_size

__all__ = ["Mesh", "create_mesh", "config_mesh", "init_from_env",
           "rank_device",
           "batch_shardings", "shard_batch", "put_global",
           "average_gradients", "all_mean", "barrier", "is_main",
           "broadcast_object", "destroy", "group_up"]

log = logging.getLogger(__name__)

# float32 elements per all-reduce bucket (64 MiB)
BUCKET_NUMEL = 16 << 20

# the process subgroups formed so far: (kind, data, view, size) -> this
# rank's group; every rank forms every group of a kind at once
_GROUPS: Dict[tuple, Any] = {}


@dataclass(frozen=True)
class Mesh:
    """This process's place on the ``(data, view)`` mesh: ``world`` ranks,
    this one ``rank = data_rank * view + view_rank``; ``view_group``, the
    ranks of its ``data_rank`` (None with ``view`` 1)."""
    world: int
    rank: int
    data: int
    view: int = 1
    view_group: Any = field(default=None, compare=False, repr=False)

    @property
    def data_rank(self) -> int:
        return self.rank // self.view

    @property
    def view_rank(self) -> int:
        return self.rank % self.view

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading dimension of ``n`` (a multiple of
        ``data``)."""
        if n % self.data:
            raise ValueError(f"{n} rows do not divide over data={self.data}")
        per = n // self.data
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def cams(self, n_cam: int) -> slice:
        """This rank's cameras of ``n_cam`` (a multiple of ``view``)."""
        if n_cam % self.view:
            raise ValueError(f"{n_cam} cameras do not divide over "
                             f"view={self.view}: the JAX rule would keep "
                             f"every camera on every rank")
        per = n_cam // self.view
        return slice(self.view_rank * per, (self.view_rank + 1) * per)

    def frame_group(self, size: int):
        """This rank's group of ``size`` consecutive data ranks at its view
        rank (None for 1); forms every such group on first use, so every
        rank must ask at the same point."""
        if size == 1:
            return None
        if self.data % size:
            raise ValueError(f"frame groups of {size} do not divide "
                             f"data={self.data}")
        key = ("frame", self.data, self.view, size)
        if key not in _GROUPS:
            for d0 in range(0, self.data, size):
                for v in range(self.view):
                    g = dist.new_group([(d0 + i) * self.view + v
                                        for i in range(size)])
                    if (self.data_rank // size * size, self.view_rank) == \
                            (d0, v):
                        _GROUPS[key] = g
        return _GROUPS[key]

    def split(self, n_cam: int, rows: int, frames: int = 1
              ) -> Optional[Split]:
        """The ``Split`` of a model call whose rows here are ``rows``
        samples (clips: frames, frame outer, ``frames`` a clip) of this
        rank's ``n_cam // view`` cameras: None when this rank holds whole
        samples and whole clips (nothing to exchange)."""
        cams = self.cams(n_cam)
        size = frame_group_size(rows, frames) if frames > 1 else 1
        if self.view == 1 and size == 1:
            return None
        return Split(n_cam=n_cam, n_local=cams.stop - cams.start,
                     view0=cams.start, view_group=self.view_group,
                     frame_group=self.frame_group(size), frame_ranks=size,
                     frame_rank=self.data_rank % size)


def group_up() -> bool:
    """Whether this process is in an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def create_mesh(data: int = -1, view: int = 1) -> Mesh:
    """The process group's layout (world size 1, rank 0 without a group):
    rank ``d * view + v`` holds data shard ``d`` and camera shard ``v``.
    ``data = -1`` means the world size over ``view``; ``data * view`` must
    equal the world size, since every rank holds one shard.  With ``view >
    1`` the view groups are formed (collective: every rank calls this)."""
    world = dist.get_world_size() if group_up() else 1
    rank = dist.get_rank() if group_up() else 0
    view = int(view)
    if view < 1 or world % view:
        raise ValueError(f"mesh view={view} on {world} processes: the view "
                         f"axis must divide the ranks")
    data = world // view if int(data) == -1 else int(data)
    if data * view != world:
        raise ValueError(f"mesh {data}x{view} on {world} processes: each "
                         f"process is one shard")
    group = None
    if view > 1:
        key = ("view", data, view, view)
        if key not in _GROUPS:
            for d in range(data):
                g = dist.new_group([d * view + v for v in range(view)])
                if d == rank // view:
                    _GROUPS[key] = g
        group = _GROUPS[key]
    return Mesh(world=world, rank=rank, data=data, view=view,
                view_group=group)


def config_mesh(cfg) -> Mesh:
    """``create_mesh`` of ``cfg.accelerator.mesh`` (``data``, ``view``;
    -1 and 1 where absent)."""
    m = (cfg.get("accelerator") or {}).get("mesh") or {}
    return create_mesh(data=int(m.get("data", -1)),
                       view=int(m.get("view", 1)))


def _env_int(name: str, default: Optional[int] = None) -> int:
    v = os.environ.get(name)
    if v is None:
        if default is None:
            raise RuntimeError(f"{name} is not set: start the ranks with "
                               f"python -m torch.distributed.run")
        return default
    return int(v)


def rank_device(device=None) -> torch.device:
    """The device of this rank: the CPU when ``device`` says so, else
    ``cuda:LOCAL_RANK`` when the host has a card per local rank, or the
    card the local ranks share.  Raises without a card."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    resolve_device(device)
    local = _env_int("LOCAL_RANK", 0)
    n = torch.cuda.device_count()
    own = n >= _env_int("LOCAL_WORLD_SIZE", 1)
    return torch.device("cuda", local if own else local % n)


def init_from_env(device=None) -> str:
    """Join the process group the launcher's environment describes (see
    the module docstring); ``device="cpu"`` takes ``gloo``.  -> the
    backend."""
    rank, world = _env_int("RANK"), _env_int("WORLD_SIZE")
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = _env_int("MASTER_PORT")
    dev = rank_device(device)
    own_card = dev.type == "cuda" and torch.cuda.device_count() >= \
        _env_int("LOCAL_WORLD_SIZE", 1)
    backend = "nccl" if own_card else "gloo"
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank, **kw)
    log.info("rank %d of %d on %s over %s (%s)", rank, world, dev, backend,
             "a card per rank" if own_card else
             "the CPU" if dev.type == "cpu" else "ranks share a card")
    return backend


def destroy() -> None:
    """Leave the process group, if this process is in one (its subgroups
    with it)."""
    _GROUPS.clear()
    if group_up():
        dist.destroy_process_group()


def is_main() -> bool:
    """Rank 0, or no group."""
    return not group_up() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank (no-op without a group)."""
    if group_up():
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself without a group)."""
    if not group_up():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def _map2(tree, other, fn):
    if isinstance(tree, dict):
        return {k: _map2(v, other[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(v, o, fn) for v, o in zip(tree, other))
    return fn(tree, other)


def batch_shardings(batch, mesh: Mesh, n_cam: int = 6):
    """Per leaf of a (nested) batch: the index this rank keeps, the JAX
    package's ``batch_shardings`` on the ``(data, view)`` mesh: a slice of
    the first dimension (``P("data")``), a (rows, cameras) pair of slices
    when dimension 1 is ``n_cam`` and ``view > 1`` (``P("data",
    "view")``), or None for the whole leaf (scalars, non-arrays, and first
    dimensions that ``data`` does not divide).  With ``view > 1``,
    ``n_cam`` must divide by it (``Mesh.cams``)."""
    if mesh.view > 1:
        cams = mesh.cams(n_cam)

    def pick(x):
        shape = getattr(x, "shape", None)
        if shape is None or len(shape) < 1 or shape[0] % mesh.data:
            return None
        rows = mesh.rows(int(shape[0]))
        if mesh.view > 1 and len(shape) >= 2 and shape[1] == n_cam:
            return rows, cams
        return rows

    return _map(batch, pick)


def put_global(tree, shardings):
    """Each leaf's index under ``shardings`` (``batch_shardings``' tree):
    every rank holds the same host tree and keeps its own rows and
    cameras, with no collective."""
    return _map2(tree, shardings, lambda x, s: x if s is None else x[s])


def shard_batch(batch, mesh: Mesh, n_cam: int = 6):
    """This rank's rows (and cameras) of a (nested) host or device
    batch."""
    return put_global(batch, batch_shardings(batch, mesh, n_cam))


def _buckets(tensors: Dict[str, torch.Tensor]):
    """The names of ``tensors`` in order, in runs of at most
    ``BUCKET_NUMEL`` elements (a larger tensor is a run of its own)."""
    buckets, cur, size = [], [], 0
    for k, t in tensors.items():
        if cur and size + t.numel() > BUCKET_NUMEL:
            buckets.append(cur)
            cur, size = [], 0
        cur.append(k)
        size += t.numel()
    return buckets + [cur] if cur else buckets


def average_gradients(grads: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of each gradient, in float32: the tensors
    are packed in order into flat float32 buckets of at most
    ``BUCKET_NUMEL`` elements (a larger tensor is a bucket of its own), one
    ``all_reduce`` sums each bucket, and the sum is divided by the world
    size.  -> {name: float32 view into its bucket}.  Without a group the
    gradients come back in float32 unchanged."""
    out = {k: g.float() for k, g in grads.items()}
    if not group_up():
        return out
    world = dist.get_world_size()
    for keys in _buckets(out):
        flat = torch.cat([out[k].reshape(-1) for k in keys])
        dist.all_reduce(flat)
        flat.div_(world)
        offset = 0
        for k in keys:
            n = out[k].numel()
            out[k] = flat[offset:offset + n].view(out[k].shape)
            offset += n
    return out


def all_mean(x):
    """The mean over the ranks of a tensor, or of each tensor or number of
    a dict (one ``all_reduce`` of them stacked in float64 on the first
    tensor's device).  Without a group, ``x`` unchanged."""
    if not group_up():
        return x
    world = dist.get_world_size()
    if isinstance(x, torch.Tensor):
        y = x.detach().clone()
        dist.all_reduce(y)
        return y / world
    keys = list(x)
    dev = next((v.device for v in x.values()
                if isinstance(v, torch.Tensor)), torch.device("cpu"))
    vals = torch.stack([torch.as_tensor(x[k], dtype=torch.float64,
                                        device=dev).detach().reshape(())
                        for k in keys])
    dist.all_reduce(vals)
    vals /= world
    return {k: vals[i] for i, k in enumerate(keys)}
