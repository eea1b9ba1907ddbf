"""Process group and data-axis sharding over ``torch.distributed``.

Port of ``dualdiff_tpu/parallel/mesh.py``.  The JAX package lays its
devices on a ``(data, view)`` mesh: the batch is sharded over ``data``, the
parameters are replicated, and XLA all-reduces the gradients.  Here each
process is one rank of a process group and holds one data shard:

* ``create_mesh(data=-1, view=1)`` -> ``Mesh``: the group's world size, this
  process's rank and ``data`` (``-1``: the world size).  ``view > 1``
  raises ``NotImplementedError`` (``VIEW_NOT_PORTED``).
* ``init_from_env()``: ``jax.distributed.initialize()``'s counterpart.  It
  reads the launcher's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
  (``python -m torch.distributed.run`` sets them) and joins the group over
  ``nccl`` when every rank of the host has a card of its own, else over
  ``gloo`` (the CPU, or ranks that share a card: NCCL refuses two ranks on
  one device).
* ``batch_shardings`` / ``shard_batch`` / ``put_global``: every rank builds
  the same host batch, as the JAX processes do, and keeps its rows of every
  leaf whose first dimension divides by ``data``, in contiguous blocks
  (rank ``r`` of ``d`` takes rows ``[r n/d, (r+1) n/d)``), and the whole
  leaf otherwise: the JAX rule (``batch_shardings``), ``P("data")`` or
  replicated.  ``replicate`` has no counterpart: every rank holds every
  parameter.
* ``average_gradients``: one ``all_reduce`` per flattened float32 bucket,
  divided by the world size; ``all_mean`` for metrics; ``barrier``,
  ``is_main``, ``broadcast_object``, ``destroy``.

Nothing falls back: a rank that cannot reach its card raises in
``resolve_device``, and a failed collective raises out of the step.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist

from .. import resolve_device

__all__ = ["Mesh", "VIEW_NOT_PORTED", "create_mesh", "init_from_env",
           "rank_device", "batch_shardings", "shard_batch", "put_global",
           "average_gradients", "all_mean", "barrier", "is_main",
           "broadcast_object", "destroy", "group_up"]

log = logging.getLogger(__name__)

VIEW_NOT_PORTED = (
    "mesh view > 1 (the camera axis split across cards) is not ported: the "
    "port runs each rank on one card, and attn4's camera ring would need "
    "each view's two neighbours from the ranks that hold them")

# float32 elements per all-reduce bucket (64 MiB)
BUCKET_NUMEL = 16 << 20


@dataclass(frozen=True)
class Mesh:
    """This process's place on the data axis: ``world`` ranks, this one
    ``rank``, ``data`` shards (``data == world``)."""
    world: int
    rank: int
    data: int

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading dimension of ``n`` (a multiple of
        ``data``)."""
        if n % self.data:
            raise ValueError(f"{n} rows do not divide over data={self.data}")
        per = n // self.data
        return slice(self.rank * per, (self.rank + 1) * per)


def group_up() -> bool:
    """Whether this process is in an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def create_mesh(data: int = -1, view: int = 1) -> Mesh:
    """The process group's layout (world size 1, rank 0 without a group).
    ``data = -1`` means the world size; any other ``data`` must equal it,
    since every rank holds one data shard."""
    if int(view) != 1:
        raise NotImplementedError(VIEW_NOT_PORTED)
    world = dist.get_world_size() if group_up() else 1
    rank = dist.get_rank() if group_up() else 0
    data = world if int(data) == -1 else int(data)
    if data != world:
        raise ValueError(f"mesh data={data} on {world} processes: each "
                         f"process is one data shard")
    return Mesh(world=world, rank=rank, data=data)


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
    """Leave the process group, if this process is in one."""
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
    """Per leaf of a (nested) batch: the slice of its first dimension this
    rank keeps, or None for the whole leaf (scalars, non-arrays, and first
    dimensions that ``data`` does not divide): the JAX package's
    ``batch_shardings`` on a ``(data, 1)`` mesh.  ``n_cam`` is the JAX
    signature's; with ``view`` 1 no camera axis is split."""
    del n_cam

    def pick(x):
        shape = getattr(x, "shape", None)
        if shape is None or len(shape) < 1 or shape[0] % mesh.data:
            return None
        return mesh.rows(int(shape[0]))

    return _map(batch, pick)


def put_global(tree, shardings):
    """Each leaf's rows under ``shardings`` (``batch_shardings``' tree):
    every rank holds the same host tree and keeps its own rows, with no
    collective."""
    return _map2(tree, shardings, lambda x, s: x if s is None else x[s])


def shard_batch(batch, mesh: Mesh, n_cam: int = 6):
    """This rank's rows of a (nested) host or device batch."""
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
