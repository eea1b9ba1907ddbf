"""bf16 against float32 training gradients at 224x400, JAX package and port.

A one-off check, not a test (pytest does not collect it):

    JAX_PLATFORMS=cpu python -m tests.torch_bf16_grads [flagship|fusionp]

The tiny model sets of ``torch_parity`` with equal seeded weights, at the
configs' own 224x400 (a 28x50 = 1400-token top latent level, 8400
positions over six views), one seeded training batch and JAX's draws.  Four
loss + gradient evaluations on the CPU: the JAX package's
``jax.value_and_grad(make_loss_fn(...))`` in float32 and in bf16 (frozen
params cast to bf16, trainables float32, as its trainer keeps them), and
the port's ``make_loss_fn`` + ``backward`` in float32 and in bf16 (every
module cast to bf16, as ``chip_smoke.train_reference_readings`` casts them).
Each side's bf16 gradients are read against its own float32 ones with
``chip_smoke.leaf_grad_errors``, the per-leaf measure of the card's
training gate; the port's float32 against JAX's float32 shows that both
compute one function.  ``fusionp``: the ``occ_bg_fusionp`` set, with the
conditioning embedder's ``conv_out`` scaled by ``SFA_COND_SCALE`` as the
gate scales it.  Prints one JSON line per framework.

Two more modes take the port alone to the card, where JAX is not
installed:

    JAX_PLATFORMS=cpu python -m tests.torch_bf16_grads save [flagship|fusionp]
    python -m tests.torch_bf16_grads port cuda [flagship|fusionp]
    python -m tests.torch_bf16_grads gate cuda [flagship|fusionp]

``save`` writes the port's float32 weights (JAX's seeded ones), the batch
and JAX's draws to ``build/bf16_case_<config>.pt``; ``port`` reads them and
holds the port's bf16 gradients on the device against its float32 ones on
the CPU, with the attention on the kernels (``kernels``: on the CPU their
plain versions), on the mma.sync templates alone (``template``: no call in
``sm90_in_scope``, so the backward runs ``attention_train.cu`` where it
would run ``attention_sm90_bwd.cu``) and on ``mha_einsum`` (``einsum``:
``PACKED_MIN_LQ`` and ``FLASH_MIN_LEN`` out of reach).  ``gate`` reads
``chip_smoke.train_reference_readings`` at 224x400 (the gate's own weights
and batch) the same three ways, and with cuBLAS's reduced-precision bf16
reductions off (``no_rpr``); for ``fusionp`` the gate lowers
``FLASH_MIN_LEN`` itself, so ``einsum`` moves only the packed calls there.

    python -m tests.torch_bf16_grads time cuda

times the element-staged split-layout kernels (d % 8 != 0, the
templates' route) at the tiny SFA+ stage-2 training shape and at phase
3's d = 20 shape: one JSON line of graph ms, to compare a change of those
templates with its parent in one call.
"""

from __future__ import annotations

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tests import torch_parity as tp  # noqa: E402

# the leaves that read over LEAF_TOL at 224x400 on the card (ROADMAP)
NAMED = ("down_blocks.0.resnets.0.time_emb_proj.weight", "to_v_txt.weight")
CASE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build", "bf16_case_{}.pt")


def _setup(fusionp: bool):
    from dualdiff_tpu.data.collate import collate_fn
    from dualdiff_tpu.data.synthetic import SyntheticNuScenes
    from dualdiff_tpu.data.tokenizer import HashTokenizer
    from dualdiff_tpu.runner.factory import build_models
    from dualdiff_tpu.runner.trainer import init_full_params, prepare_batch

    jcfg = tp.jax_config(["runner.mixed_precision=fp32"], fusionp=fusionp)
    h, w = jcfg.dataset.image_size
    tok = HashTokenizer()
    ds = SyntheticNuScenes(num_samples=2, image_size=(h, w), seed=0)
    batch = collate_fn([ds[0]], jcfg, tok, is_train=True,
                       rng=np.random.default_rng(0))
    jmodels = build_models(jcfg, tiny=True)
    shapes = init_full_params(
        jcfg, jmodels, prepare_batch(batch), (h // 8, w // 8),
        tuple(jcfg.model.get("ors_frame_hw", (896, 1600))), tok,
        abstract=True)
    params = tp.random_params(shapes, scale={"cam2token": 0.01})
    if fusionp:
        conv = params["controlnet_0"]["controlnet_cond_embedding"]["conv_out"]
        for k in conv:
            conv[k] = conv[k] * np.float32(chip_smoke.SFA_COND_SCALE)
    return jcfg, batch, params


def _jax_grads(fusionp, precision, batch, params, key):
    import jax
    import jax.numpy as jnp

    from dualdiff_tpu.diffusion.schedule import DiffusionSchedule
    from dualdiff_tpu.runner.factory import build_models
    from dualdiff_tpu.runner.train_state import (partition_params,
                                                 trainable_predicate)
    from dualdiff_tpu.runner.trainer import make_loss_fn, prepare_batch

    cfg = tp.jax_config([f"runner.mixed_precision={precision}"],
                        fusionp=fusionp)
    h, w = cfg.dataset.image_size
    models = build_models(cfg, tiny=True)
    trainable, frozen = partition_params(params, trainable_predicate(
        "only_new"))
    frozen = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x).astype(models["dtype"]), frozen)
    loss_fn = make_loss_fn(models, cfg, DiffusionSchedule.create(),
                           (h // 8, w // 8),
                           tuple(cfg.model.get("ors_frame_hw", (896, 1600))))
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        trainable, frozen, prepare_batch(batch), key)
    return float(loss), grads


def _port_grads(fusionp, precision, batch, params, draws):
    from dualdiff_tpu_torch.diffusion.schedule import DiffusionSchedule
    from dualdiff_tpu_torch.runner.conds import prepare_batch
    from dualdiff_tpu_torch.runner.factory import build_models
    from dualdiff_tpu_torch.runner.train_state import (named_roots,
                                                       partition_params,
                                                       trainable_predicate)
    from dualdiff_tpu_torch.runner.trainer import make_loss_fn

    cfg = tp.port_config([f"runner.mixed_precision={precision}"],
                         fusionp=fusionp)
    h, w = cfg.dataset.image_size
    models = build_models(cfg, tiny=True, device="cpu")
    tp._load_port_models(models, params)
    for _, m in named_roots(models):
        m.to("cpu", models["dtype"])
    partition_params(models, trainable_predicate(
        str(cfg.model.unet.trainable_state)))
    loss, _ = make_loss_fn(models, cfg, DiffusionSchedule.create(),
                           (h // 8, w // 8),
                           tuple(cfg.model.get("ors_frame_hw")))(
        prepare_batch(batch, "cpu"), draws)
    loss.backward()
    return loss.item(), chip_smoke._trainable_grads(models)


def _jax_flat(grads, roots) -> dict:
    from dualdiff_tpu_torch.runner.weights import from_jax

    kind = lambda r: "unet" if r == "unet" else "controlnet"
    return {f"{r}/{n}": g.float() for r in roots
            for n, g in from_jax(tp.flat(grads[r]), kind(r)).items()}


def _summary(errs: dict) -> dict:
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    return {"worst": dict(worst),
            "named": {k: v for k, v in errs.items()
                      if any(k.endswith(n) for n in NAMED)
                      and ("time_emb" not in k or k.startswith("controlnet"))}}


def main(which: str) -> None:
    import jax

    fusionp = which == "fusionp"
    torch.set_num_threads(max(1, os.cpu_count() // 2))
    jcfg, batch, params = _setup(fusionp)
    h, w = jcfg.dataset.image_size
    key = jax.random.PRNGKey(2)
    draws = tp.jax_draws(key, jcfg, 1, (h // 8, w // 8), frames=1)
    jax_loss, jax_g = {}, {}
    port_loss, port_g = {}, {}
    jax_error = None
    for precision in ("fp32", "bf16"):
        try:
            jax_loss[precision], g = _jax_grads(fusionp, precision, batch,
                                                params, key)
            roots = [r for r in g if r.startswith(("unet", "controlnet"))]
            jax_g[precision] = _jax_flat(g, roots)
        except jax.errors.JaxRuntimeError as e:
            # XLA's CPU backend runs no bf16 x bf16 -> f32 dot (SFA+)
            jax_error = str(e).splitlines()[0]
        port_loss[precision], port_g[precision] = _port_grads(
            fusionp, precision, batch, params, draws)
    cross = chip_smoke.leaf_grad_errors(
        jax_g["fp32"], {k: port_g["fp32"].get(k) for k in jax_g["fp32"]})
    for name, loss, g in (("jax", jax_loss, jax_g),
                          ("port", port_loss, port_g)):
        if len(g) < 2:
            print(json.dumps({"framework": name, "config": which,
                              "error": jax_error}), flush=True)
            continue
        errs = chip_smoke.leaf_grad_errors(
            g["fp32"], {k: g["bf16"].get(k) for k in g["fp32"]})
        print(json.dumps({
            "framework": name, "config": which, "image_size": [h, w],
            "loss_fp32": loss["fp32"], "loss_bf16": loss["bf16"],
            "leaves": len(errs), **_summary(errs)}), flush=True)
    print(json.dumps({"port_fp32_vs_jax_fp32_worst": max(cross.values())}))


def save(which: str) -> None:
    import jax

    from dualdiff_tpu_torch.runner.factory import build_models
    from dualdiff_tpu_torch.runner.train_state import named_roots

    fusionp = which == "fusionp"
    jcfg, batch, params = _setup(fusionp)
    h, w = jcfg.dataset.image_size
    draws = tp.jax_draws(jax.random.PRNGKey(2), jcfg, 1, (h // 8, w // 8),
                         frames=1)
    models = build_models(tp.port_config(["runner.mixed_precision=fp32"],
                                         fusionp=fusionp),
                          tiny=True, device="cpu")
    tp._load_port_models(models, params)
    os.makedirs(os.path.dirname(CASE), exist_ok=True)
    torch.save({"state": {r: m.state_dict() for r, m in named_roots(models)},
                "batch": batch, "draws": draws}, CASE.format(which))


def _case_grads(which, case, precision, dev):
    from dualdiff_tpu_torch.diffusion.schedule import DiffusionSchedule
    from dualdiff_tpu_torch.ops import attention as A
    from dualdiff_tpu_torch.runner.conds import prepare_batch
    from dualdiff_tpu_torch.runner.factory import build_models
    from dualdiff_tpu_torch.runner.train_state import (named_roots,
                                                       partition_params,
                                                       trainable_predicate)
    from dualdiff_tpu_torch.runner.trainer import make_loss_fn

    cfg = tp.port_config([f"runner.mixed_precision={precision}"],
                         fusionp=which == "fusionp")
    h, w = cfg.dataset.image_size
    models = build_models(cfg, tiny=True, device=dev)
    for root, m in named_roots(models):
        m.load_state_dict(case["state"][root], strict=True)
        m.to(dev, models["dtype"])
    partition_params(models, trainable_predicate(
        str(cfg.model.unet.trainable_state)))
    draws = {k: None if v is None else v.to(dev)
             for k, v in case["draws"].items()}
    A.reset_launch_counts()
    loss, _ = make_loss_fn(models, cfg, DiffusionSchedule.create(),
                           (h // 8, w // 8),
                           tuple(cfg.model.get("ors_frame_hw")))(
        prepare_batch(case["batch"], dev), draws)
    loss.backward()
    return (loss.item(), chip_smoke._trainable_grads(models),
            chip_smoke.launch_counts(A))


def _routed(mode: str, run):
    """``run()`` with the attention on ``mode``'s route."""
    from dualdiff_tpu_torch.ops import attention as A

    routes = A.PACKED_MIN_LQ, A.FLASH_MIN_LEN, A.SM90_MAX_HEAD_DIM
    matmul = torch.backends.cuda.matmul
    rpr = matmul.allow_bf16_reduced_precision_reduction
    if mode == "einsum":
        A.PACKED_MIN_LQ = A.FLASH_MIN_LEN = 10 ** 9
    if mode == "template":
        A.SM90_MAX_HEAD_DIM = 0
    if mode == "no_rpr":
        matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return run()
    finally:
        A.PACKED_MIN_LQ, A.FLASH_MIN_LEN, A.SM90_MAX_HEAD_DIM = routes
        matmul.allow_bf16_reduced_precision_reduction = rpr


def _report(inputs, which, dev, mode, loss_rel_err, errs, launches):
    print(json.dumps({
        "inputs": inputs, "config": which, "device": dev, "mode": mode,
        "loss_rel_err": loss_rel_err, **_summary(errs),
        "launches": {k: v for k, v in launches.items() if v}}), flush=True)


def port(dev: str, which: str) -> None:
    case = torch.load(CASE.format(which), weights_only=False)
    loss32, g32, _ = _case_grads(which, case, "fp32", "cpu")
    for mode in ("kernels", "template", "einsum"):
        loss16, g16, launches = _routed(
            mode, lambda: _case_grads(which, case, "bf16", dev))
        _report("jax seeded", which, dev, mode,
                abs(loss16 - loss32) / abs(loss32),
                chip_smoke.leaf_grad_errors(g32, g16), launches)


def gate(dev: str, which: str) -> None:
    from dualdiff_tpu_torch.utils import config as C

    load = C.load_config
    C.load_config = lambda name=C.FLAGSHIP, overrides=(): load(
        name, [o for o in overrides if "image_size" not in o])
    try:
        for mode in ("kernels", "template", "einsum", "no_rpr"):
            r = _routed(mode, lambda: chip_smoke.train_reference_readings(
                dev, fusionp=which == "fusionp"))
            _report("gate's", which, dev, mode, r["loss_rel_err"],
                    r["leaf_rel_err"], r["launches"])
    finally:
        C.load_config = load


# (label, rows, lq, lk, heads, head_dim): the tiny occ_bg_fusionp's SFA+
# stage 2 under grad at 224x400, and phase 3's d = 20 split-layout case
SPLIT_SHAPES = (("SFA+ stage 2, tiny, d=4", 6, 1400, 1400, 8, 4),
                ("d=20, ragged", 3, 777, 1111, 8, 20))


def time_split(dev: str) -> None:
    """Graph ms (``chip_smoke.graph_ms``) of the four split-layout
    wrappers at ``SPLIT_SHAPES`` on seeded bf16 inputs, with the card's
    name and power limit."""
    from dualdiff_tpu_torch.ops import attention as A

    g = torch.Generator(device=dev).manual_seed(0)
    out = {"device": chip_smoke.phase_device()}
    for label, b, lq, lk, h, d in SPLIT_SHAPES:
        q, do = (torch.randn(b, lq, h, d, generator=g, device=dev)
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(b, lk, h, d, generator=g, device=dev).bfloat16()
                for _ in range(2))
        o, lse = A.flash_attention_lse_fwd(q, k, v)
        delta = A.flash_attention_delta(o, do)
        out[label] = {
            "fwd": chip_smoke.graph_ms(lambda: A.flash_attention_fwd(q, k,
                                                                     v)),
            "lse_fwd": chip_smoke.graph_ms(
                lambda: A.flash_attention_lse_fwd(q, k, v)),
            "bwd_dq": chip_smoke.graph_ms(
                lambda: A.flash_attention_bwd_dq(q, k, v, do, lse, delta)),
            "bwd_dkv": chip_smoke.graph_ms(
                lambda: A.flash_attention_bwd_dkv(q, k, v, do, lse, delta))}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:] or ["flagship"]
    if args[0] == "time":
        time_split(args[1])
    elif args[0] == "save":
        for w in args[1:] or ["flagship", "fusionp"]:
            save(w)
    elif args[0] in ("port", "gate"):
        for w in args[2:] or ["flagship", "fusionp"]:
            (port if args[0] == "port" else gate)(args[1], w)
    else:
        main(args[0])
