"""The explore path of the PyTorch port against the JAX package's: attention
probabilities and UNet block features under ``models.layers.capture``
against ``apply(..., mutable=["intermediates"])``, key for key, and the
port's ``move_to`` / ``utils/profiling.py`` against the JAX ones.

Same float32 weights and seeded numpy inputs on both sides (``tp.tiny_setup``,
256x128: the top latent level's 512 tokens reach the port's kernel wrappers
outside the capture).  Tolerances: probabilities ``atol 1e-5`` (float32
softmax on both sides); block features ``2^-7 max|x| + 1e-3`` (about 60
layers deep, sums in different orders).
"""

import math
import os
from collections import Counter

import flax
import jax
import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.models import layers as JL
from dualdiff_tpu.runner import trainer as JT
from dualdiff_tpu.utils import common as JC
from dualdiff_tpu.utils import profiling as JP
from dualdiff_tpu_torch.models import layers as PL
from dualdiff_tpu_torch.runner import conds as PC
from dualdiff_tpu_torch.utils import common as PCM
from dualdiff_tpu_torch.utils import profiling as PP

RING = ((5, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 0))
PROB_ATOL = 1e-5
BLOCKS = [f"down_block_{i}_out" for i in range(4)] + ["mid_block_out"] + \
    [f"up_block_{i}_out" for i in range(4)]


def _rng(seed):
    return np.random.default_rng(seed)


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def _flat_inter(inter):
    """JAX ``intermediates`` -> {"a/b/name": the first sown value}."""
    return {"/".join(k): np.asarray(v[0]) for k, v in
            flax.traverse_util.flatten_dict(inter["intermediates"]).items()}


@pytest.fixture(scope="module")
def ref():
    """ControlNet 0 on the tiny batch, then the UNet on its residuals and
    context, both under JAX's intermediates (one jitted call each) and the
    port's capture, with the port's capture-off outputs before and after
    the capture and the kernel wrappers' calls of each run."""
    tiny = tp.tiny_setup()
    jm, params = tiny["jmodels"], tiny["params"]
    jt = JT.prepare_batch(tiny["batch"])
    pt = PC.prepare_batch(tiny["batch"], "cpu")
    text, = tp.jax_text(tiny, jt, ("input_ids",))
    h, w = tiny["jcfg"].dataset.image_size
    lhw = (h // 8, w // 8)
    jconds = JT.compute_branch_conds(jm, jt, lhw, (896, 1600))
    lat = _rng(40).normal(size=(1, 6, *lhw, 4)).astype(np.float32)
    ts = np.array([500], np.int32)

    def jax_probe(p_cn, p_unet, lat, ts, cam, text, cond, boxes):
        (downs, mid, kv), inter_cn = jm["controlnets"][0].apply(
            {"params": p_cn}, lat, ts, cam, text, cond, bboxes_3d=boxes,
            mutable=["intermediates"])
        eps, inter_unet = jm["unet"].apply(
            {"params": p_unet}, lat.reshape(6, *lhw, 4), ts.repeat(6), kv,
            down_block_additional_residuals=downs,
            mid_block_additional_residual=mid, n_cam=6,
            mutable=["intermediates"])
        return (downs, mid, kv, eps), inter_cn, inter_unet

    (downs, mid, kv, eps), inter_cn, inter_unet = jax.jit(jax_probe)(
        params["controlnet_0"], params["unet"], lat, ts,
        jt["camera_param"], text, jconds[0], jt.get("boxes_0"))

    pm = tiny["pmodels"]
    cn, unet = pm["controlnets"][0], pm["unet"]
    pconds = PC.compute_branch_conds(pm, pt, lhw, (896, 1600))
    plat = tp.t(lat).permute(0, 1, 4, 2, 3)
    calls = []

    def port_probe():
        with torch.no_grad():
            d, m, k = cn(plat, tp.t(ts), pt["camera_param"], tp.t(text),
                         pconds[0], bboxes_3d=pt.get("boxes_0"))
            out = unet(plat.reshape(6, 4, *lhw), tp.t(ts).repeat(6), k,
                       down_block_additional_residuals=d,
                       mid_block_additional_residual=m, n_cam=6)
        return out

    with pytest.MonkeyPatch.context() as mp:
        counts = Counter()
        tp.count_calls(mp, counts)
        before = port_probe()
        calls.append(dict(counts))
        counts.clear()
        with PL.capture(cn) as cap_cn, PL.capture(unet) as cap_unet:
            captured = port_probe()
        calls.append(dict(counts))
        counts.clear()
        after = port_probe()
        calls.append(dict(counts))
    return {"jax": {"controlnet": _flat_inter(inter_cn),
                    "unet": _flat_inter(inter_unet), "eps": eps},
            "port": {"controlnet": cap_cn, "unet": cap_unet},
            "before": before, "captured": captured, "after": after,
            "calls": calls}


@pytest.mark.parametrize("net", ["controlnet", "unet"])
def test_attention_probs_match_jax_key_for_key(ref, net):
    """Every attention of the network records its probabilities under the
    JAX intermediates path (attn1, attn2 and, in the UNet, attn4 in its
    stacked explore form, 2 B' rows), float32, equal within 1e-5."""
    want = {k: v for k, v in ref["jax"][net].items()
            if k.endswith("/attn_probs")}
    got = {k: v for k, v in ref["port"][net].items()
           if k.endswith("/attn_probs")}
    assert want and sorted(got) == sorted(want)
    kinds = {k.split("/")[-2] for k in want}
    assert kinds == {"attn1", "attn2"} | ({"attn4"} if net == "unet"
                                          else set()), kinds
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert tuple(got[k].shape) == v.shape, k
        if k.endswith("attn4/attn_probs"):
            assert v.shape[0] == 12  # [q; q] over [left; right], B' = 6
        tp.assert_close(got[k], v, 0, PROB_ATOL, k)


def test_block_features_match_jax(ref):
    """The nine block outputs of the SD v1.5 layout: only the UNet records
    them, channels-first in the port."""
    want, got = ref["jax"]["unet"], ref["port"]["unet"]
    assert sorted(k for k in got if "/" not in k) == sorted(BLOCKS)
    assert sorted(k for k in want if "/" not in k) == sorted(BLOCKS)
    assert not [k for k in ref["port"]["controlnet"] if "/" not in k]
    for k in BLOCKS:
        x = want[k]
        tol = 2 ** -7 * float(np.abs(x).max()) + 1e-3
        tp.assert_close(got[k], _nchw(x), 0, tol, k)
    tp.assert_close(ref["captured"], _nchw(ref["jax"]["eps"]), 0,
                    2 ** -7 * float(np.abs(ref["jax"]["eps"]).max()) + 1e-3)


def test_probability_rows_sum_to_one(ref):
    for net in ("controlnet", "unet"):
        for k, v in ref["port"][net].items():
            if k.endswith("/attn_probs"):
                assert bool((v >= 0).all()), k
                tp.assert_close(v.sum(-1), np.ones(v.shape[:-1]), 0, 1e-5, k)


def test_capture_off_is_bit_equal_with_the_same_launches(ref):
    """Before and after a capture the forward is bit-equal and calls the
    same kernel wrappers as often (the ring's among them); inside it no
    wrapper of the probed attentions runs."""
    assert torch.equal(ref["before"], ref["after"])
    before, captured, after = ref["calls"]
    assert before == after
    assert before.get("packed_attention_nbr_fwd", 0) > 0, before
    assert not captured, captured


def test_attn4_explore_form_of_a_block_matches_jax():
    """A camera-ring block under the capture takes JAX's explore form (the
    stacked neighbour attention), which differs from its fused ring form;
    out of the capture it is the fused one again, as JAX's plain apply."""
    x = _rng(5).normal(size=(6, 24, 32)).astype(np.float32)
    ctx = _rng(6).normal(size=(6, 20, 96)).astype(np.float32)
    jm = JL.BasicTransformerBlock(dim=32, heads=4, cross_attention_dim=96,
                                  n_cam=6, multiview=True,
                                  neighboring_view_pair=RING)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x,
                                            ctx))["params"]
    params = tp.random_params(shapes, seed=3)
    fused, (explore, inter) = jax.jit(lambda p: (
        jm.apply({"params": p}, x, ctx),
        jm.apply({"params": p}, x, ctx, mutable=["intermediates"])))(params)
    pm = tp.load_port(PL.BasicTransformerBlock(
        32, 4, 96, multiview=True, neighboring_view_pair=RING), params,
        "unet")
    with torch.no_grad():
        plain = pm(tp.t(x), tp.t(ctx), n_cam=6)
        with PL.capture(pm) as store:
            got = pm(tp.t(x), tp.t(ctx), n_cam=6)
    want = _flat_inter(inter)
    assert sorted(store) == sorted(want) == [
        f"{a}/attn_probs" for a in ("attn1", "attn2", "attn4")]
    for k, v in want.items():
        tp.assert_close(store[k], v, 0, PROB_ATOL, k)
    tp.assert_close(got, explore, 2e-5, 2e-5)
    tp.assert_close(plain, fused, 2e-5, 2e-5)
    assert not np.allclose(np.asarray(fused), np.asarray(explore),
                           atol=1e-3)


def _tree():
    rng = _rng(11)
    return {"a": rng.normal(size=(3, 2)).astype(np.float32),
            "b": [rng.integers(0, 9, (4,)).astype(np.int64),
                  (rng.normal(size=(2,)).astype(np.float32), 7)],
            "c": {"d": rng.normal(size=(1,)).astype(np.float32)}}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return tp.t(tree) if isinstance(tree, np.ndarray) else tree


def _leaves(tree):
    return [np.asarray(x) if not isinstance(x, torch.Tensor)
            else x.numpy() for x in jax.tree_util.tree_leaves(
                tree, is_leaf=lambda x: isinstance(x, torch.Tensor))]


@pytest.mark.parametrize("predicate", [None, "float"])
def test_move_to_matches_jax(predicate):
    """The same numpy tree through both: the same structure, dtypes and
    values (float16 casts)."""
    jpred = ppred = None
    if predicate == "float":
        jpred = lambda x: np.issubdtype(x.dtype, np.floating)
        ppred = lambda x: x.is_floating_point()
    tree = _tree()
    want = JC.move_to(tree, np.float16, jpred)
    got = PCM.move_to(_as_torch(tree), torch.float16, ppred)
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(
        got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_step_timer_check_finite_and_trace_match_jax(monkeypatch, tmp_path):
    """StepTimer: the same stats() keys and values on the same clock;
    check_finite: the same FloatingPointError text on the same tree, and
    silence on a finite one; trace writes a trace with the named range."""
    ticks = [0.0, 0.5, 1.25, 2.5, 2.75]
    reads = iter(t for t in ticks for _ in range(2))  # each timer reads once
    monkeypatch.setattr(JP.time, "perf_counter", lambda: next(reads))
    assert PP.time is JP.time
    jt, pt = JP.StepTimer(3e12, window=3), PP.StepTimer(3e12, window=3)
    assert jt.stats() == pt.stats() == {}
    for _ in ticks:
        jt.tick()
        pt.tick()
    assert jt.stats().keys() == pt.stats().keys() == {
        "step_time_s", "steps_per_s", "tflops_per_s"}
    for k, v in jt.stats().items():
        assert math.isclose(pt.stats()[k], v, rel_tol=1e-12), k
    monkeypatch.undo()

    tree = _tree()
    tree["a"][1, 0] = np.nan
    tree["c"]["d"][0] = np.inf
    tree["e"] = [np.ones(2, np.float32), np.array([np.inf, 1.0])]
    msgs = []
    for fn, t in ((JP.check_finite, tree),
                  (PP.check_finite, _as_torch(tree))):
        with pytest.raises(FloatingPointError) as e:
            fn(t, "state")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    PP.check_finite(_as_torch(_tree()))
    JP.check_finite(_tree())

    with PP.trace(str(tmp_path)) as prof:
        with PP.named_scope("probe_range"):
            torch.ones(4).sum()
    assert "probe_range" in {e.key for e in prof.key_averages()}
    assert os.path.getsize(tmp_path / PP.TRACE_FILE) > 0
