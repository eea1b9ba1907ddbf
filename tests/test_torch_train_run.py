"""A training run of the port's own: gradient accumulation, checkpoints
(save, latest, resume, reset), export, prefetching, and a step after a
validation.

* Accumulation against ``optax.MultiSteps`` over the JAX package's
  ``build_optimizer`` (``gradient_accumulation_steps`` 1 and 2): the
  parameters after every micro-step within 1e-6 relative + 3e-8 absolute
  (both float32; the global norm sums in another order, which moves an
  update of lr 0.1 by up to a float32 ulp of its size, 7.5e-9 at 0.1),
  the bf16 first moment's sum within 1e-6 relative, ``count`` once per
  update.  optax runs op by op, as in ``test_torch_train_state.py``; at
  k = 2 under ``jax.disable_jit`` too, since ``MultiSteps``' ``lax.cond``
  compiles its branches otherwise, and compiled, XLA fuses ``b1 * mu``
  into the sum without rounding it to bf16 first, which moves the bf16
  moment by an ulp (2.4e-4 at 0.044) and the parameters by 1e-4.
* Resume, prefetch and validation: bit for bit on the CPU (same code, same
  draws, same order of operations).

The trainers are tiny (``tiny_models=true`` at 32x48, ``+exp=224x400``:
one ControlNet).  The trainer's export against the JAX exporter is in
``test_torch_checkpoint.py``.
"""

import contextlib
import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.runner.train_state import build_optimizer as jax_optimizer
from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes
from dualdiff_tpu_torch.data.video import SyntheticNuScenesVideo
from dualdiff_tpu_torch.runner.factory import build_models, randomize_weights
from dualdiff_tpu_torch.runner.train_state import build_optimizer, named_roots
from dualdiff_tpu_torch.runner.trainer import CHECKPOINT_FILE, \
    MultiviewTrainer
from dualdiff_tpu_torch.runner.validator import Validator
from dualdiff_tpu_torch.runner.video_trainer import VideoTrainer
from dualdiff_tpu_torch.runner.weights import load_pretrained_dir
from dualdiff_tpu_torch.utils.config import compose

TINY = ["+exp=224x400", "runner=debug", "dataset.image_size=[32,48]",
        "tiny_models=true", "dataset.num_samples=4", "device=cpu",
        "runner.max_train_steps=6", "runner.checkpointing_steps=0"]


def _cfg(tmp_path, *extra):
    cfg, _ = compose(TINY + [f"log_root={tmp_path}"] + list(extra))
    return cfg


def _trainer(cfg, **kw):
    h, w = cfg.dataset.image_size
    ds = SyntheticNuScenes(num_samples=int(cfg.dataset.num_samples),
                           image_size=(h, w), seed=int(cfg.seed))
    return MultiviewTrainer(cfg, ds, device="cpu", **kw)


def _state(trainer):
    """Everything a step reads or writes, cloned."""
    opt = trainer.optimizer
    out = {"step": trainer.step, "count": opt.count,
           "mini_step": opt.mini_step,
           "generator": trainer.generator.get_state().clone()}
    for key in ("master", "mu", "nu") + (("acc",) if opt.acc else ()):
        out.update({f"{key}/{k}": v.clone()
                    for k, v in getattr(opt, key).items()})
    out.update({f"live/{k}": p.detach().clone()
                for k, p in trainer.trainable.items()})
    return out


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("k", [1, 2])
def test_accumulation_matches_optax_multisteps(k):
    """Four micro-steps of the flagship optimizer (warmup 1 step, cosine
    over 4, lr 0.1, bf16 first moment) on three tensors, gradients scaled
    so that the clip triggers on some updates and not on others."""
    extra = ["runner.lr_warmup_steps=1", "runner.learning_rate=0.1",
             f"runner.gradient_accumulation_steps={k}"]
    jr, pr = tp.jax_config(extra).runner, tp.port_config(extra).runner
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 3)}
    p0 = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (rng.normal(size=s) * (3.0 if i < 2 else 0.02))
              .astype(np.float32) for n, s in shapes.items()}
             for i in range(4)]
    tx, _ = jax_optimizer(jr, 4)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    state = tx.init(jp)
    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for n, v in p0.items()}
    opt = build_optimizer(pr, params, 4)
    assert (opt.acc is None) == (k == 1)
    for i, g in enumerate(grads):
        jg = {n: jnp.asarray(v) for n, v in g.items()}
        with jax.disable_jit() if k > 1 else contextlib.nullcontext():
            updates, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        norm = opt.step({n: torch.from_numpy(v) for n, v in g.items()})
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)),
                                   rtol=1e-6)
        for n in shapes:
            np.testing.assert_allclose(params[n].detach().numpy(),
                                       np.asarray(jp[n]), rtol=1e-6,
                                       atol=3e-8, err_msg=f"{n} step {i}")
        inner = state.inner_opt_state if k > 1 else state
        assert opt.count == int(inner[1][0].count) == (i + 1) // k
        np.testing.assert_allclose(
            float(opt.mu["a"].float().sum()),
            float(inner[1][0].mu["a"].astype(jnp.float32).sum()),
            rtol=1e-6, atol=1e-9)
        assert opt.mu["a"].dtype == torch.bfloat16
        if k > 1:
            assert opt.mini_step == int(state.mini_step) == (i + 1) % k


def test_trainer_accumulates_before_it_updates(tmp_path):
    """At k = 2 the first micro-step leaves the live parameters, masters,
    moments and ``count`` exactly as they were and fills the accumulators;
    the second moves them and empties the accumulators."""
    trainer = _trainer(_cfg(tmp_path, "runner.gradient_accumulation_steps=2",
                            "runner.lr_scheduler=constant"))
    before = _state(trainer)
    trainer.run(1)
    after = _state(trainer)
    for key in before:
        if key.split("/")[0] in ("master", "mu", "nu", "live", "count"):
            assert torch.equal(torch.as_tensor(before[key]),
                               torch.as_tensor(after[key])), key
    assert any(bool(v.any()) for v in trainer.optimizer.acc.values())
    assert trainer.optimizer.mini_step == 1 and trainer.step == 1
    trainer.run(2)
    opt = trainer.optimizer
    assert opt.count == 1 and opt.mini_step == 0 and trainer.step == 2
    assert not any(bool(v.any()) for v in opt.acc.values())
    got_grad = {k for k, v in opt.nu.items() if bool(v.any())}
    moved = {k for k in opt.master
             if not torch.equal(opt.master[k], before[f"master/{k}"])}
    assert got_grad and got_grad <= moved  # zero-init layers block the rest
    assert all(torch.equal(p.detach(), opt.master[k].to(p.dtype))
               for k, p in trainer.trainable.items())


@pytest.mark.parametrize("k,saved", [(1, 2), (2, 1), (3, 2)])
def test_resume_equals_an_uninterrupted_run(tmp_path, k, saved):
    """3 steps in one go against ``saved`` steps, a checkpoint, a fresh
    trainer, ``load_checkpoint("latest")`` and the rest: every optimizer
    tensor, the live parameters, ``count``, ``mini_step``, the generator
    and the batch plan bit for bit (k = 2 at step 1 and k = 3 at step 2
    checkpoint mid-accumulation)."""
    cfg = _cfg(tmp_path / "whole", f"runner.gradient_accumulation_steps={k}")
    whole = _trainer(cfg)
    plans = []
    build = whole._build_batch
    whole._build_batch = lambda plan: (plans.append(plan), build(plan))[1]
    whole.run(3)
    want = _state(whole)

    cfg = _cfg(tmp_path / "resumed", f"runner.gradient_accumulation_steps={k}",
               f"runner.checkpointing_steps={saved}")
    first = _trainer(cfg)
    first.run(saved)
    assert first.saved_step == saved
    resumed = _trainer(cfg)
    seen = []
    build = resumed._build_batch
    resumed._build_batch = lambda plan: (seen.append(plan), build(plan))[1]
    assert resumed.load_checkpoint("latest") == first.checkpoint_dir(saved)
    assert resumed.step == saved
    resumed.run(3)
    _assert_same(_state(resumed), want)
    assert seen == plans[saved:]  # the epoch's plan from its cursor


def test_checkpoint_reads_with_weights_only(tmp_path):
    trainer = _trainer(_cfg(tmp_path, "runner.gradient_accumulation_steps=2"))
    trainer.run(1)
    path = trainer.save_checkpoint()
    state = torch.load(f"{path}/{CHECKPOINT_FILE}", weights_only=True)
    assert state["step"] == 1 and state["optimizer"]["mini_step"] == 1
    assert set(state["optimizer"]) == {"master", "mu", "nu", "count",
                                       "accumulate", "acc", "mini_step"}
    assert state["generator"].dtype == torch.uint8


def test_reset_scheduler_keeps_parameters_and_step(tmp_path):
    cfg = _cfg(tmp_path, "runner.gradient_accumulation_steps=2",
               "runner.checkpointing_steps=3")
    trainer = _trainer(cfg)
    trainer.run(3)
    fresh = _trainer(cfg)
    fresh.load_checkpoint("latest", reset_scheduler=True)
    opt = fresh.optimizer
    assert fresh.step == 3 and opt.count == 0 and opt.mini_step == 0
    for key in ("mu", "nu", "acc"):
        assert not any(bool(v.any()) for v in getattr(opt, key).values())
    for k, v in trainer.optimizer.master.items():
        assert torch.equal(opt.master[k], v)
        assert torch.equal(fresh.trainable[k].detach(), v.to(torch.bfloat16))


def test_latest_without_a_checkpoint_starts_fresh(tmp_path, caplog):
    trainer = _trainer(_cfg(tmp_path))
    before = _state(trainer)
    with caplog.at_level(logging.WARNING):
        assert trainer.load_checkpoint("latest") is None
    assert "no checkpoint found" in caplog.text
    _assert_same(_state(trainer), before)


def test_refuses_a_state_of_other_accumulation(tmp_path):
    cfg = _cfg(tmp_path, "runner.gradient_accumulation_steps=2",
               "runner.checkpointing_steps=1")
    _trainer(cfg).run(1)
    other = _trainer(_cfg(tmp_path))
    with pytest.raises(ValueError, match="accumulation"):
        other.load_checkpoint("latest")


def test_workers_change_no_draw(tmp_path):
    """``runner.num_workers=2`` (batches built on threads, 3 ahead) and 0
    give the same run bit for bit."""
    states = []
    for workers in (0, 2):
        trainer = _trainer(_cfg(tmp_path / str(workers),
                                f"runner.num_workers={workers}",
                                "runner.prefetch_factor=3"))
        trainer.run(3)
        states.append(_state(trainer))
    _assert_same(*states)


def test_a_step_after_a_validation_equals_one_without(tmp_path):
    """Mid-accumulation (k = 2): step, validate, step against step, step.
    The modules are back in training mode after the validation."""
    states = []
    for validate in (False, True):
        cfg = _cfg(tmp_path, "runner.gradient_accumulation_steps=2")
        trainer = _trainer(cfg)
        trainer.run(1)
        if validate:
            val = SyntheticNuScenes(num_samples=1, image_size=(32, 48),
                                    seed=1)
            grids = Validator(cfg, val, trainer.tokenizer).validate(trainer)
            assert len(grids) == 1 and grids[0].shape == (64, 144, 3)
            assert all(m.training for _, net in named_roots(trainer.models)
                       for m in net.modules())
        trainer.run(2)
        states.append(_state(trainer))
    _assert_same(*states)


def test_stage2_lora_checkpoint_resume_and_export(tmp_path):
    """RGD stage 2 (``rgd_stage2``, 2-frame clips): only the LoRA leaves
    train; they save, resume bit for bit and export under the JAX
    exporter's names (``to_out.0_lora_*``), which load back."""
    cfg = tp.port_config(tp.TINY_VIDEO_OVERRIDES + [
        "dataset.image_size=[64, 32]", f"log_root={tmp_path}",
        "runner.checkpointing_steps=1"], video="rgd")
    models = build_models(cfg, tiny=True, device="cpu")
    for _, m in named_roots(models):
        randomize_weights(m, 0)
    clips = SyntheticNuScenesVideo(num_clips=2, num_frames=2,
                                   image_size=(64, 32))

    def trainer():
        return VideoTrainer(cfg, clips, device="cpu",
                            models=copy.deepcopy(models))

    whole = trainer()
    assert whole.trainable and all("lora" in k for k in whole.trainable)
    whole.run(2)
    first = trainer()
    first.run(1)
    resumed = trainer()
    resumed.load_checkpoint("latest")
    resumed.run(2)
    _assert_same(_state(resumed), _state(whole))
    sd = resumed.export_state_dicts()["unet"]
    lora = [k for k in sd if "lora" in k]
    assert lora and any("to_out.0_lora_a" in k for k in lora)
    assert not any("to_out_0_lora" in k for k in sd)
    root = resumed.export_model()
    fresh = build_models(cfg, tiny=True, device="cpu")
    report = load_pretrained_dir(fresh, root)
    assert report["unet"]["missing"] == []
    for name, p in resumed.trainable.items():
        root_, sub = name.split("/", 1)
        assert torch.equal(fresh[root_].state_dict()[sub],
                           resumed.optimizer.master[name]), name


def test_the_conditioning_cache_keeps_its_count_under_threads(tmp_path):
    """``_cache_rows`` from 16 threads at once (prefetch workers fill the
    cache concurrently), the switch interval shortened: every entry is
    there and the byte count is their sum."""
    import sys
    import threading

    trainer = _trainer(_cfg(tmp_path, "runner.cache_conditioning=true"))
    row = {"latent_moments": torch.ones(2, 8, 4, 6),
           "ors_rays": torch.ones(2, 3, 3, 5, dtype=torch.int8)}

    def fill(t):
        for i in range(50):
            trainer._cache_rows([(t, i, False), (t, i, True)], row)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=fill, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    cache = trainer._cond_cache
    assert len(cache) == 16 * 50 * 2
    assert trainer._cond_cache_bytes == sum(
        v.numel() * v.element_size() for e in cache.values()
        for v in e.values())
