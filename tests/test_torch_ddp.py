"""Parallelism over processes (``dualdiff_tpu_torch/parallel/mesh.py``)
on the CPU: the port of ``tests/test_multihost.py``'s checks and of
``tests/test_multichip.py``'s ``(data, view)`` layouts.

A module fixture starts, all at once, the port's train tool under
``python -m torch.distributed.run --nproc_per_node 2`` (a 3-step run that
saves ``checkpoint-2`` on its way, then a two-rank resume from that
checkpoint), and two ranks of a gloo
group and one lone process of ``tests/torch_ddp_worker.py`` (the same
``from_jax`` weights of ``torch_parity.tiny_setup`` and
``tiny_video_setup`` (and its RGD stage-2 set) in each; a tiny generation,
one ``MultiviewTrainer`` step and one cached ``VideoTrainer`` step on
global batches of 2; then on the ranks the generation and the step again
on a ``(data=1, view=2)`` mesh, 3 cameras a rank, the generation from
initial noise of its own for each camera (the lone process generates
that whole); then one 4-frame clip's step, stage 1, stage 2 with the
temporal reward, and stage 2 with the reward over the clip's first 2
frames, on the ranks 2 frames each).  The clip steps run at 256x128: at
64x32 the mid block is 1x1, and its GroupNorm turned float32 rounding
into leaf gradients up to a quarter apart between two batch sizes or
thread counts.

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
                    for key, setup in (
                        ("image", tp.tiny_setup),
                        ("video", tp.tiny_video_setup),
                        ("rgd", lambda: tp.tiny_video_setup("rgd")))},
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
    """The two ranks form the ``(2, 1)`` group and the ``(1, 2)`` one with
    its view group, rank ``v`` holding cameras ``[3 v, 3 v + 3)`` and a
    ``Split``; a view axis that does not divide the ranks is refused, on
    the ranks and in the lone process (and without a group)."""
    assert [(r["world"], r["rank"], r["data"], r["backend"])
            for r in runs["ranks"]] == [(2, 0, 2, "gloo"), (2, 1, 2, "gloo")]
    assert (runs["lone"]["world"], runs["lone"]["data"]) == (1, 1)
    assert [r["view_group"] for r in runs["ranks"]] == [
        (1, 2, 0, 0, True), (1, 2, 0, 1, True)]
    assert [r["view_cams"] for r in runs["ranks"]] == [[0, 3], [3, 6]]
    assert all(r["view_split"] for r in runs["ranks"])
    for r, view in zip(runs["ranks"] + [runs["lone"]], (3, 3, 2)):
        assert f"mesh view={view} on" in r["view_refused"]
        assert "must divide the ranks" in r["view_refused"]
    with pytest.raises(ValueError, match="must divide the ranks"):
        M.create_mesh(view=2)
    assert M.create_mesh(view=1) == M.Mesh(world=1, rank=0, data=1)


@pytest.mark.parametrize("what", ["step", "video", "view_step",
                                  "frames_stage1", "frames_stage2",
                                  "frames_prefix"])
def test_two_ranks_step_as_one_process(runs, what):
    """The image step (uncached), the clip step (cached), the image step
    with 3 cameras a rank (against the lone process's image step), and the
    4-frame clip's step with 2 frames a rank, stage 1 and stage 2 (the
    temporal reward across the ranks' frames; and over the first 2 frames
    only, rank 1 holding none of them): the averaged gradient and
    the loss against one process on the global batch; the ranks bit for
    bit; the clip trainer's cache holds its rank's rows."""
    lone = runs["lone"]["step" if what == "view_step" else what]
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
    if what.startswith("frames"):  # (cameras, frame ranks, frame rank)
        assert lone["split"] is None
        assert [r["split"] for r in ranks] == [(6, 2, 0), (6, 2, 1)]
    if what in ("frames_stage2", "frames_prefix"):
        assert "reward" in lone and ranks[0]["reward"] == ranks[1]["reward"]
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


def test_view_split_generation_equals_one_process_cameras(runs):
    """On the ``(1, 2)`` mesh each rank generates its 3 cameras of both
    samples from initial noise of its own for each camera: the lone
    process's images of those cameras, within 1e-5."""
    want = runs["lone"]["cam_images"]
    for r in runs["ranks"]:
        got = r["view_images"]
        cams = slice(*r["view_cams"])
        assert got.shape == want[:, cams].shape == (RANKS, 3, 256, 128, 3)
        assert torch.isfinite(got).all()
        assert float((got - want[:, cams]).abs().max()) <= IMAGE_ATOL


# (data, view, batch): the two ranks of the fixture, test_multichip.py's
# {data: 4, view: 2} on an image batch of 4 samples, and on one 4-frame
# clip (B*F = 4 rows over 4 data shards: 1 frame x 3 cameras a rank)
SHARD_LAYOUTS = {"data2": (2, 1, 2), "data4_view2": (4, 2, 4),
                 "data4_view2_clip": (4, 2, "clip")}


@pytest.mark.parametrize("layout", list(SHARD_LAYOUTS))
def test_shard_rule_equals_jax_batch_shardings(layout):
    """For every leaf of a tiny flagship batch, the index ``shard_batch``
    keeps on each rank (rows, and cameras with ``view > 1``) equals the
    index JAX's ``batch_shardings`` gives that device of a ``(data,
    view)`` mesh of virtual CPU devices (``devices_indices_map``, no
    compile), and the values equal the JAX batch's at that index.  The
    clip's frame-flattened rows split below a clip a rank, as the JAX
    rule splits them."""
    import jax

    from dualdiff_tpu.data.collate import collate_fn as jax_collate
    from dualdiff_tpu.data.synthetic import SyntheticNuScenes
    from dualdiff_tpu.data.video import SyntheticNuScenesVideo
    from dualdiff_tpu.data.video import collate_video as jax_collate_video
    from dualdiff_tpu.parallel.mesh import batch_shardings, create_mesh
    from dualdiff_tpu.runner.trainer import prepare_batch as jax_prepare
    from dualdiff_tpu_torch.data.collate import collate_fn
    from dualdiff_tpu_torch.data.video import collate_video
    from dualdiff_tpu_torch.runner.conds import prepare_batch

    data, view, n = SHARD_LAYOUTS[layout]
    if len(jax.devices()) < data * view:
        pytest.skip("needs the 8-device virtual CPU mesh from conftest")
    setup = tp.tiny_setup()
    jcfg, pcfg, tok = setup["jcfg"], setup["pcfg"], setup["tokenizer"]
    h, w = jcfg.dataset.image_size
    rng = lambda: np.random.default_rng(0)
    if n == "clip":
        clip = [SyntheticNuScenesVideo(num_clips=1, num_frames=4,
                                       image_size=(h, w))[0]]
        jt = jax_prepare(jax_collate_video(clip, jcfg, tok, is_train=False,
                                           rng=rng()))
        pt = prepare_batch(collate_video(clip, pcfg, tok, is_train=False,
                                         rng=rng()), "cpu")
    else:
        ds = SyntheticNuScenes(num_samples=n, image_size=(h, w), seed=0)
        items = [ds[i] for i in range(n)]
        jt = jax_prepare(jax_collate(items, jcfg, tok, is_train=False,
                                     rng=rng()))
        pt = prepare_batch(collate_fn(items, pcfg, tok, is_train=False,
                                      rng=rng()), "cpu")
    jmesh = create_mesh(data=data, view=view)
    jsh = batch_shardings(jt, jmesh)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    def bounds(idx, shape):
        """Per dimension (start, stop) of a numpy index over ``shape``."""
        idx = idx if isinstance(idx, tuple) else () if idx is None \
            else (idx,)
        return [i.indices(d)[:2] for i, d in zip(
            idx + (slice(None),) * (len(shape) - len(idx)), shape)]

    jleaves, jshard = dict(leaves(jt)), dict(leaves(jsh))
    assert set(dict(leaves(pt))) == set(jleaves)
    split = {"data": 0, "view": 0}
    for r in range(data * view):
        mesh = M.Mesh(world=data * view, rank=r, data=data, view=view)
        mine = dict(leaves(M.shard_batch(pt, mesh)))
        index = dict(leaves(M.batch_shardings(pt, mesh)))
        for k, x in jleaves.items():
            x = np.asarray(x)
            idx = jshard[k].devices_indices_map(x.shape)[
                jmesh.devices[r // view, r % view]]
            got, want = bounds(index[k], x.shape), bounds(idx, x.shape)
            assert got == want, (k, r, got, want)
            split["data"] += x.ndim > 0 and want[0][1] - want[0][0] < \
                x.shape[0]
            split["view"] += x.ndim > 1 and want[1][1] - want[1][0] < \
                x.shape[1]
            np.testing.assert_array_equal(mine[k].numpy(), x[idx],
                                          err_msg=k)
    # most leaves split over data, on every rank; the camera leaves over
    # view too
    assert split["data"] >= data * view * 8
    assert (split["view"] >= data * view * 4) == (view > 1)
    if n == "clip":
        px = mine["pixel_values"]
        assert px.shape[:2] == (1, 3) and jt["pixel_values"].shape[0] == 4


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
