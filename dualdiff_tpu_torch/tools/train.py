"""Training launcher: the JAX package's ``tools/train.py`` for the port.

    python -m dualdiff_tpu_torch.tools.train +exp=dual_branch_augloss_fusion \
        runner=debug seed=7
    python -m dualdiff_tpu_torch.tools.train +exp=224x400 runner=debug \
        device=cpu tiny_models=true dataset.image_size=[32,48]

Words as ``utils.config.compose`` takes them; ``device=cpu`` runs the plain
path (the card by default).  Writes under ``log_root`` (default
``<log_root_prefix>/<projname>_<date>_<task_id>``): ``train.log``,
``hydra/config.json`` and ``hydra/overrides.json`` (the words, which
``tools.test`` reads back), ``metrics.jsonl`` (a line per step: its
metrics and, as ``launches``, the attention kernels it launched per
wrapper and sm90 kernel), validation grids every
``runner.validation_steps`` under ``val/step-<n>/`` (one item, with the
validation's kernel launches in ``launches.json``; a failed validation is
logged and training goes on), ``checkpoint-<n>/`` every ``runner.checkpointing_steps`` and at
the end, and the exported weights.  ``resume_from_checkpoint=<dir>|latest``
(with ``resume_reset_scheduler``), ``validation_only``,
``save_model_only`` and ``try_run`` (2 steps) as in the JAX tool.

Data-parallel over processes (the JAX tool's ``jax.distributed``
entry), two ranks on one host::

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m dualdiff_tpu_torch.tools.train +exp=224x400 runner=debug \
        device=cpu tiny_models=true dataset.image_size=[32,48]

With ``WORLD_SIZE`` > 1 the tool composes the config, joins the
launcher's process group (``parallel.mesh.init_from_env``, over gloo when
the config's ``device`` is the CPU), runs on
``cuda:LOCAL_RANK`` (the shared card when the ranks share one; the CPU
with ``device=cpu``) and leaves the group at exit.
``runner.train_batch_size`` is the global batch.  ``accelerator.mesh.view``
(``data`` x ``view`` ranks) also splits each sample's cameras over
``view`` ranks, and a clip's frames split over the data ranks where the
clips are fewer (``accelerator.mesh.view=2`` over 2 ranks: each rank
generates and trains 3 of the 6 cameras).  Rank 0 writes the
config, ``metrics.jsonl``, the checkpoints, the export and the
validations, and logs to ``train.log``; rank ``r`` > 0 logs to
``train_rank<r>.log``.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

from ..data.wrappers import build_dataset
from ..ops.attention import reset_launch_counts, take_launch_counts
from ..parallel.mesh import barrier, broadcast_object, config_mesh, \
    destroy, init_from_env, rank_device
from ..runner.validator import RunWriter, Validator
from ..utils.common import load_module
from ..utils.config import compose, save_config


def main(argv=None):
    cfg, overrides = compose(argv if argv is not None else sys.argv[1:])
    if int(os.environ.get("WORLD_SIZE", "1")) == 1:
        return _main(cfg, overrides, None)
    # the composed device picks the backend and the rank's device alike
    backend = init_from_env(cfg.get("device"))
    try:
        _main(cfg, overrides, backend)
    finally:
        destroy()


def _main(cfg, overrides, backend):
    mesh = config_mesh(cfg)
    if not cfg.log_root:  # rank 0's clock names the run
        cfg["log_root"] = broadcast_object(os.path.join(
            str(cfg.log_root_prefix),
            f"{cfg.projname}_{time.strftime('%Y-%m-%d_%H-%M')}_{cfg.task_id}"))
    device = rank_device(cfg.get("device")) if backend else cfg.get("device")
    os.makedirs(cfg.log_root, exist_ok=True)
    logging.basicConfig(
        level=logging.DEBUG if cfg.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=[logging.StreamHandler(), logging.FileHandler(
            os.path.join(cfg.log_root, f"train_rank{mesh.rank}.log"
                         if mesh.rank else "train.log"))],
        force=True)
    log = logging.getLogger("train")
    if backend:
        log.info("rank %d of %d on %s over %s", mesh.rank, mesh.world,
                 device, backend)
    main_rank = mesh.rank == 0
    if main_rank:
        save_config(cfg, os.path.join(cfg.log_root, "hydra", "config.json"))
        with open(os.path.join(cfg.log_root, "hydra", "overrides.json"),
                  "w") as f:
            json.dump(overrides, f, indent=1)

    train_set = build_dataset(cfg, "train")
    val_set = build_dataset(cfg, "val")
    log.info("train samples: %d, val: %d", len(train_set), len(val_set))

    runner_cls = load_module(str(cfg.model.runner_module))
    trainer = runner_cls(cfg, train_set, device=device)
    if cfg.resume_from_checkpoint:
        trainer.load_checkpoint(
            str(cfg.resume_from_checkpoint),
            reset_scheduler=bool(cfg.resume_reset_scheduler))

    writer = RunWriter(cfg.log_root) if main_rank else None
    validator = Validator(cfg, val_set, trainer.tokenizer)
    val_every = int(cfg.runner.validation_steps)
    t_last = [time.time()]

    def on_metrics(step, metrics):
        now = time.time()
        metrics = dict(metrics, step_time=now - t_last[0])
        t_last[0] = now
        launches = take_launch_counts()
        if writer:
            writer.add_scalars(step, {f"train/{k}": v
                                      for k, v in metrics.items()},
                               launches=launches)
        if step % 10 == 0 or step < 5:
            log.info("step %d: %s", step,
                     {k: round(v, 5) for k, v in metrics.items()})
        if val_every and step % val_every == 0 and not cfg.validation_only:
            if writer:
                try:
                    validator.validate(trainer, writer, step, max_items=1)
                except Exception as e:  # validation must not stop training
                    log.exception("validation failed: %s", e)
                writer.add_json(step, "launches", take_launch_counts())
            barrier()

    if cfg.validation_only:
        if writer:
            validator.validate(trainer, writer, 0)
        return
    if cfg.save_model_only:
        trainer.export_model()
        return

    max_steps = 2 if cfg.try_run else None
    reset_launch_counts()
    trainer.run(max_steps=max_steps, on_metrics=on_metrics)
    if trainer.saved_step != trainer.step:  # run() saved none at this step
        trainer.save_checkpoint()
    trainer.export_model()
    log.info("done; artifacts in %s", cfg.log_root)


if __name__ == "__main__":
    main()
