"""Whether a full-width generation's rows depend on the batch they share,
and which layer makes them: a one-off read on the card, not a test (pytest
does not collect it):

    python -m tests.torch_batch_probe

The flagship at 224x400 (``chip_smoke._flagship``: seeded weights, bf16,
UniPC-20) generates from the global draw of seed ``SEED`` (the initial
latents of ``chip_smoke``'s phase ``ddp``): each row of its two-sample
batch alone (B = 1, what a rank of phase ``ddp`` generates), both rows
together (``pair``, B = 2), and row 0 twice (``dup``, B = 2 with equal
rows).  Each under three routes of ``tests.torch_bf16_grads._routed``: the
attention on its kernels (``kernels``), on the plain einsum (``einsum``),
and on its kernels with cuBLAS's reduced-precision bf16 reductions off
(``no_rpr``).  One JSON line per route: mean and max ``|B = 2 row - B = 1
row|`` for ``pair`` and ``dup``, and ``dup``'s two rows against each
other.

Then, per route, a one-step generation of ``pair`` in which every call of
a leaf module (``Linear``, ``Conv2d``, ``GroupNorm``, ...) and of every
attention kernel wrapper is run again on each half of its first
dimension (``chip_smoke.halved_calls``): a call whose halves,
concatenated, are not bit-equal to the whole call's output depends on the
other rows of its batch.  One JSON line
per route: for each module type and wrapper, its calls, those that depend
on the batch and the largest difference.
"""

from __future__ import annotations

import json
import sys

import torch

import chip_smoke
from tests.torch_bf16_grads import _routed

ROUTES = ("kernels", "einsum", "no_rpr")


def _tree(tree, fn, shard):
    """``fn(leaf, slice)`` of every leaf that ``shard`` splits."""
    if isinstance(tree, dict):
        return {k: _tree(v, fn, shard[k]) for k, v in tree.items()}
    return tree if shard is None else fn(tree, shard)


def _batches(batch, dev):
    """The two-sample batch, each sample alone, and sample 0 twice, on
    ``dev``."""
    from dualdiff_tpu_torch.parallel import mesh as M
    from dualdiff_tpu_torch.runner.conds import prepare_batch, to_device

    host = prepare_batch(batch, "cpu")
    halves = [M.Mesh(world=2, rank=r, data=2) for r in range(2)]
    shard = M.batch_shardings(host, halves[0])
    alone = [M.shard_batch(host, m) for m in halves]
    dup = _tree(alone[0], lambda x, _: torch.cat([x, x]), shard)
    return [to_device(b, dev) for b in (host, *alone, dup)]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    chip_smoke.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.phase_build()
    cfg, batch, pipe = chip_smoke._flagship("cuda")
    h, w = cfg.dataset.image_size
    dev = pipe.device
    lat = torch.randn((2, 1, h // 8, w // 8, 4), device=dev,
                      generator=torch.Generator(device=dev)
                      .manual_seed(chip_smoke.SEED))
    pair, one0, one1, dup = _batches(batch, dev)
    lat_dup = torch.cat([lat[:1], lat[:1]])
    smi = chip_smoke.card()

    def err(a, b):
        d = (a.float() - b.float()).abs()
        return {"mean": float(d.mean()), "max": float(d.max())}

    for route in ROUTES:
        def generations():
            with torch.no_grad():
                return (pipe(pair, latents=lat).cpu(),
                        pipe(one0, latents=lat[:1]).cpu(),
                        pipe(one1, latents=lat[1:]).cpu(),
                        pipe(dup, latents=lat_dup).cpu())
        whole, b0, b1, twice = _routed(route, generations)
        print(json.dumps({
            "route": route, "card": smi,
            "pair_row0_vs_b1": err(whole[0], b0[0]),
            "pair_row1_vs_b1": err(whole[1], b1[0]),
            "dup_row0_vs_b1": err(twice[0], b0[0]),
            "dup_row1_vs_row0": err(twice[1], twice[0])}), flush=True)
    for route in ROUTES:
        seen = _routed(route, lambda: chip_smoke.halved_calls(
            pipe, pair, lat, modules=True))
        print(json.dumps({"route": route, "card": smi, "halved_calls": {
            k: v for k, v in sorted(seen.items())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
