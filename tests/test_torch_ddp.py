"""Data parallelism over processes (``dualdiff_tpu_torch/parallel/mesh.py``)
on the CPU: the port of ``tests/test_multihost.py``'s checks.

A module fixture starts, all at once, the port's train tool under
``python -m torch.distributed.run --nproc_per_node 2`` (a 3-step run that
saves ``checkpoint-2`` on its way, then a two-rank resume from that
checkpoint), and two ranks of a gloo
group and one lone process of ``tests/torch_ddp_worker.py`` (the same
``from_jax`` weights of ``torch_parity.tiny_setup`` and
``tiny_video_setup`` in each; a tiny generation, one ``MultiviewTrainer``
step and one cached ``VideoTrainer`` step on global batches of 2).  The
clip step runs at 256x128: at 64x32 the mid block is 1x1, and its
GroupNorm turned float32 rounding into leaf gradients up to a quarter
apart between two batch sizes or thread counts.

Tolerances (float32 on both sides; one rank's rows against the whole batch
change only the order of sums): per trainable leaf, the averaged gradient
within ``1e-5 ||g|| + 1e-8`` of the one-process gradient ``g``, the loss
within 1e-6 relative, the generated rows within 1e-5; the ranks' averaged
gradients and updated trainables bit for bit; the resumed step's loss equal
to the uninterrupted run's.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu_torch.parallel import mesh as M
from dualdiff_tpu_torch.runner.train_state import named_roots

ROOT = os.path.join(os.path.dirname(__file__), "..")
RANKS = 2
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-8
LOSS_RTOL = 1e-6
IMAGE_ATOL = 1e-5
TRAIN = ["+exp=224x400", "runner=debug", "device=cpu", "tiny_models=true",
         "dataset.image_size=[32,48]", "dataset.num_samples=4",
         f"runner.train_batch_size={RANKS}", "runner.max_train_steps=3",
         "runner.checkpointing_steps=2"]
TIMEOUT = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _popen(cmd, env=None):
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(procs):
    outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"{p.args} failed:\n{out[-4000:]}"


def _launch(log_root, *words):
    return _popen([sys.executable, "-m", "torch.distributed.run",
                   "--standalone", f"--nproc_per_node={RANKS}", "-m",
                   "dualdiff_tpu_torch.tools.train", *TRAIN,
                   f"log_root={log_root}", *words],
                  env=dict(os.environ, OMP_NUM_THREADS="1"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    whole, resumed = tmp / "whole", tmp / "resumed"
    tools = [_launch(whole)]
    procs = []
    try:
        weights = str(tmp / "weights.pt")
        torch.save({key: {root: m.state_dict() for root, m
                          in named_roots(setup()["pmodels"])}
                    for key, setup in (("image", tp.tiny_setup),
                                       ("video", tp.tiny_video_setup))},
                   weights)
        port = str(_free_port())
        worker = [sys.executable, "-m", "tests.torch_ddp_worker", weights]
        # the lone process does the ranks' work together, on their two
        # threads
        lone = {k: v for k, v in os.environ.items()
                if k not in ("RANK", "WORLD_SIZE")}
        procs = [_popen(worker + [str(tmp / "lone.pt"), "2"], lone)] + [
            _popen(worker + [str(tmp / f"rank{r}.pt"), "1"], dict(
                os.environ, RANK=str(r), WORLD_SIZE=str(RANKS),
                LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(RANKS),
                MASTER_ADDR="localhost", MASTER_PORT=port))
            for r in range(RANKS)]
        _finish(tools[:1])
        tools.append(_launch(resumed, f"resume_from_checkpoint={whole}/"
                                      "checkpoint-2"))
        _finish(procs + tools[1:])
    finally:  # a failed run leaves no rank waiting on another
        for p in procs + tools:
            if p.poll() is None:
                p.terminate()  # the launcher stops its ranks on SIGTERM
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
    load = lambda name: torch.load(tmp / name, weights_only=False)
    return {"lone": load("lone.pt"),
            "ranks": [load(f"rank{r}.pt") for r in range(RANKS)],
            "whole": whole, "resumed": resumed}


def _metrics(run):
    return {x["step"]: x for x in map(json.loads, open(run / "metrics.jsonl"))}


def test_the_group_forms_and_refuses_a_view_axis(runs):
    assert [(r["world"], r["rank"], r["data"], r["backend"])
            for r in runs["ranks"]] == [(2, 0, 2, "gloo"), (2, 1, 2, "gloo")]
    assert (runs["lone"]["world"], runs["lone"]["data"]) == (1, 1)
    for r in runs["ranks"] + [runs["lone"]]:
        assert r["view_refused"] == M.VIEW_NOT_PORTED
    assert "camera ring" in M.VIEW_NOT_PORTED
    with pytest.raises(NotImplementedError, match="view > 1"):
        M.create_mesh(view=2)


@pytest.mark.parametrize("what", ["step", "video"])
def test_two_ranks_step_as_one_process(runs, what):
    """The image step (uncached) and the clip step (cached): the averaged
    gradient and the loss against one process on the global batch; the
    ranks bit for bit; the clip trainer's cache holds its rank's rows."""
    lone = runs["lone"][what]
    ranks = [r[what] for r in runs["ranks"]]
    assert lone["grads"] and set(ranks[0]["grads"]) == set(lone["grads"])
    for k, g in lone["grads"].items():
        got = ranks[0]["grads"][k]
        assert (got - g).norm() <= GRAD_RTOL * g.norm() + GRAD_ATOL, k
    assert abs(ranks[0]["loss"] - lone["loss"]) <= LOSS_RTOL * abs(
        lone["loss"])
    for key in ("grads", "trainables"):
        for k, v in ranks[0][key].items():
            assert torch.equal(v, ranks[1][key][k]), (key, k)
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert ranks[0]["grad_norm"] == ranks[1]["grad_norm"]
    if what == "video":
        # (clip, frame, flipped): one clip of 2 frames a rank, the lone
        # process both
        assert len(lone["cache_keys"]) == 4
        mine = [r["cache_keys"] for r in ranks]
        assert all(len(k) == 2 for k in mine)
        assert sorted(mine[0] + mine[1]) == lone["cache_keys"]


def test_generation_rows_are_disjoint_cover_and_equal_one_process(runs):
    rows = [r["rows"] for r in runs["ranks"]]
    assert rows == [[0], [1]]
    want = runs["lone"]["images"]
    assert want.shape[0] == RANKS
    for r, got in zip(rows, (x["images"] for x in runs["ranks"])):
        assert got.shape == want[r].shape
        assert torch.isfinite(got).all()
        assert float((got - want[r]).abs().max()) <= IMAGE_ATOL


def test_shard_rule_equals_jax_batch_shardings():
    """For every leaf of a tiny flagship batch of 2 samples, the rows
    ``shard_batch`` keeps on each rank equal the index JAX's
    ``batch_shardings`` gives that data shard on a ``(2, 1)`` mesh of
    virtual CPU devices (``devices_indices_map``, no compile), and the
    values equal the JAX batch's at that index."""
    from dualdiff_tpu.data.collate import collate_fn as jax_collate
    from dualdiff_tpu.data.synthetic import SyntheticNuScenes
    from dualdiff_tpu.parallel.mesh import batch_shardings, create_mesh
    from dualdiff_tpu.runner.trainer import prepare_batch as jax_prepare
    from dualdiff_tpu_torch.data.collate import collate_fn
    from dualdiff_tpu_torch.runner.conds import prepare_batch

    setup = tp.tiny_setup()
    jcfg, pcfg, tok = setup["jcfg"], setup["pcfg"], setup["tokenizer"]
    h, w = jcfg.dataset.image_size
    ds = SyntheticNuScenes(num_samples=RANKS, image_size=(h, w), seed=0)
    items = [ds[i] for i in range(RANKS)]
    jt = jax_prepare(jax_collate(items, jcfg, tok, is_train=False,
                                 rng=np.random.default_rng(0)))
    pt = prepare_batch(collate_fn(items, pcfg, tok, is_train=False,
                                  rng=np.random.default_rng(0)), "cpu")
    jmesh = create_mesh(data=RANKS, view=1)
    jsh = batch_shardings(jt, jmesh)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    jleaves, jshard = dict(leaves(jt)), dict(leaves(jsh))
    assert set(dict(leaves(pt))) == set(jleaves)
    split = 0
    for r in range(RANKS):
        mesh = M.Mesh(world=RANKS, rank=r, data=RANKS)
        mine = dict(leaves(M.shard_batch(pt, mesh)))
        rows = dict(leaves(M.batch_shardings(pt, mesh)))
        for k, x in jleaves.items():
            x = np.asarray(x)
            idx = jshard[k].devices_indices_map(x.shape)[
                jmesh.devices[r, 0]]
            lo, hi, _ = idx[0].indices(x.shape[0]) if idx else (0, 1, 1)
            got = rows[k] or slice(0, x.shape[0])
            assert (got.start, got.stop) == (lo, hi), (k, r)
            split += hi - lo < x.shape[0]
            np.testing.assert_array_equal(mine[k].numpy(), x[idx],
                                          err_msg=k)
    assert split >= 2 * 8  # most leaves split, both ranks


def test_launcher_saves_on_rank_0_and_resumes_as_one_run(runs):
    whole, resumed = runs["whole"], runs["resumed"]
    assert "checkpoint-2" in os.listdir(whole)
    logs = {n: open(whole / n).read() for n in ("train.log",
                                                "train_rank1.log")}
    assert "saved checkpoint" in logs["train.log"]
    assert "saved checkpoint" not in logs["train_rank1.log"]
    assert "over gloo" in logs["train_rank1.log"]
    assert sorted(_metrics(resumed)) == [3]
    want = _metrics(whole)
    assert sorted(want) == [1, 2, 3]
    assert _metrics(resumed)[3]["train/loss"] == want[3]["train/loss"]
    assert np.isfinite(want[3]["train/loss"])
    state = torch.load(whole / "checkpoint-2" / "trainer_state.pt",
                       weights_only=True)
    assert state["step"] == 2
