"""The port's trainable partition, optimizer and LR schedules against the
JAX package's ``train_state`` (optax).

* The trainable set equals JAX's ``only_new`` partition of the same tiny
  model set, leaf for leaf (names mapped by ``from_jax``'s naming).
* ``AdamW`` against ``optax.chain(clip_by_global_norm, adamw)`` with a bf16
  first moment, over steps that cover the warmup, the cosine decay and both
  sides of the clip: parameters within 1e-6 relative + 1e-9 absolute (both
  sides float32; the global norm's sum runs in another order).
* Schedules: every value at steps 0..N within 1e-7 relative (both compute in
  float32).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.runner.train_state import build_optimizer as jax_optimizer
from dualdiff_tpu.runner.train_state import partition_params as jax_partition
from dualdiff_tpu.runner.train_state import \
    trainable_predicate as jax_predicate
from dualdiff_tpu_torch.runner.factory import build_models
from dualdiff_tpu_torch.runner.train_state import (build_optimizer,
                                                   build_schedule,
                                                   partition_params,
                                                   trainable_predicate)
from dualdiff_tpu_torch.runner.weights import _torch_name

KIND = {"unet": "unet", "controlnet_0": "controlnet",
        "controlnet_1": "controlnet", "vae": "vae", "text_encoder": "clip"}


def test_trainable_set_equals_jax_only_new():
    tiny = tp.tiny_setup()
    jtrain, _ = jax_partition(tiny["params"], jax_predicate("only_new"))
    want = {f"{root}/{_torch_name(tuple(rest), KIND[root])}"
            for root, *rest in (k.split("/") for k in tp.flat(jtrain))}
    models = build_models(tp.port_config(tp.TINY_OVERRIDES), tiny=True,
                          device="cpu")
    trainable, frozen = partition_params(models, trainable_predicate())
    assert set(trainable) == want
    assert all(p.requires_grad for p in trainable.values())
    assert not any(p.requires_grad for p in frozen.values())
    roots = {k.split("/")[0] for k in trainable}
    assert roots == {"unet", "controlnet_0", "controlnet_1"}
    assert "controlnet_0/bbox_embedder._class_tokens" in frozen
    assert all(any(m in k for m in ("attn4", "norm4", "connector"))
               for k in trainable if k.startswith("unet/"))


def _runner(extra):
    return (tp.jax_config(extra).runner, tp.port_config(extra).runner)


@pytest.mark.parametrize("kind", ["cosine", "constant_with_warmup",
                                  "constant"])
def test_schedule_values_match_optax(kind):
    jr, pr = _runner([f"runner.lr_scheduler={kind}",
                      "runner.lr_warmup_steps=3"])
    _, jsched = jax_optimizer(jr, 10)
    sched = build_schedule(pr, 10)
    for step in range(13):
        np.testing.assert_allclose(float(sched(step)),
                                   float(jsched(jnp.int32(step))),
                                   rtol=1e-7, atol=0, err_msg=str(step))
    # flagship: warmup 3000 -> the first step's learning rate is exactly 0
    assert float(build_schedule(tp.port_config().runner, 10 ** 6)(0)) == 0.0


def test_adamw_matches_optax_over_steps():
    """Six steps of the flagship optimizer (warmup shortened to 2 steps,
    cosine to 6) on three tensors; gradients scaled so the clip triggers on
    steps 0, 2 and 4 and not on the others."""
    jr, pr = _runner(["runner.lr_warmup_steps=2", "runner.learning_rate=0.1"])
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 3)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (2.0 if i % 2 == 0 else 0.01))
              .astype(np.float32) for k, s in shapes.items()}
             for i in range(6)]

    tx, _ = jax_optimizer(jr, 6)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    opt = build_optimizer(pr, params, 6)
    assert opt.mu["a"].dtype == torch.bfloat16
    for i, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        norm = opt.step({k: torch.from_numpy(v) for k, v in g.items()})
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            {k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6)
        assert (float(norm) >= 1.0) == (i % 2 == 0)
        for k in shapes:
            np.testing.assert_allclose(params[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{k} step {i}")
    assert float(state[1][0].mu["a"].astype(jnp.float32).sum()) == \
        pytest.approx(float(opt.mu["a"].float().sum()), rel=1e-6)


def test_gradient_accumulation_is_refused():
    """Accumulation is ported (``tests/test_torch_train_run.py``); what is
    refused is an optimizer state taken under another accumulation: a
    k = 2 state into a k = 1 optimizer and back."""
    params = {"a": torch.nn.Parameter(torch.ones(3))}
    opts = [build_optimizer(tp.port_config(
        [f"runner.gradient_accumulation_steps={k}"]).runner, params, 10)
        for k in (1, 2)]
    assert opts[0].acc is None and set(opts[1].acc) == {"a"}
    for src, dst in ((1, 0), (0, 1)):
        with pytest.raises(ValueError, match="accumulation"):
            opts[dst].load_state_dict(opts[src].state_dict())


def test_lora_only_is_refused():
    """``lora_only`` (RGD stage 2) refuses every ControlNet parameter and
    every UNet parameter without ``lora`` in its name; an unknown trainable
    state is refused outright."""
    pred = trainable_predicate("lora_only")
    assert pred("unet", "down_blocks.0.attentions.0.transformer_blocks.0."
                "attn1.to_out_0_lora_b.weight")
    for root, name in (("unet", "down_blocks.0.attentions.0."
                        "transformer_blocks.0.attn4.to_q.weight"),
                       ("controlnet_0", "conv_in.weight"),
                       ("vae", "decoder.conv_in.weight")):
        assert not pred(root, name), (root, name)
    with pytest.raises(ValueError, match="lora"):
        trainable_predicate("lora")
