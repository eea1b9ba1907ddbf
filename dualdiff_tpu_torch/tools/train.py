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
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

from ..data.wrappers import build_dataset
from ..ops.attention import reset_launch_counts, take_launch_counts
from ..runner.validator import RunWriter, Validator
from ..utils.common import load_module
from ..utils.config import compose, save_config


def main(argv=None):
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg, overrides = compose(overrides)
    if not cfg.log_root:
        cfg["log_root"] = os.path.join(
            str(cfg.log_root_prefix),
            f"{cfg.projname}_{time.strftime('%Y-%m-%d_%H-%M')}_{cfg.task_id}")
    os.makedirs(cfg.log_root, exist_ok=True)
    logging.basicConfig(
        level=logging.DEBUG if cfg.debug else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=[logging.StreamHandler(),
                  logging.FileHandler(os.path.join(cfg.log_root,
                                                   "train.log"))],
        force=True)
    log = logging.getLogger("train")
    save_config(cfg, os.path.join(cfg.log_root, "hydra", "config.json"))
    with open(os.path.join(cfg.log_root, "hydra", "overrides.json"),
              "w") as f:
        json.dump(overrides, f, indent=1)

    train_set = build_dataset(cfg, "train")
    val_set = build_dataset(cfg, "val")
    log.info("train samples: %d, val: %d", len(train_set), len(val_set))

    runner_cls = load_module(str(cfg.model.runner_module))
    trainer = runner_cls(cfg, train_set, device=cfg.get("device"))
    if cfg.resume_from_checkpoint:
        trainer.load_checkpoint(
            str(cfg.resume_from_checkpoint),
            reset_scheduler=bool(cfg.resume_reset_scheduler))

    writer = RunWriter(cfg.log_root)
    validator = Validator(cfg, val_set, trainer.tokenizer)
    val_every = int(cfg.runner.validation_steps)
    t_last = [time.time()]

    def on_metrics(step, metrics):
        now = time.time()
        metrics = dict(metrics, step_time=now - t_last[0])
        t_last[0] = now
        writer.add_scalars(step, {f"train/{k}": v
                                  for k, v in metrics.items()},
                           launches=take_launch_counts())
        if step % 10 == 0 or step < 5:
            log.info("step %d: %s", step,
                     {k: round(v, 5) for k, v in metrics.items()})
        if val_every and step % val_every == 0 and not cfg.validation_only:
            try:
                validator.validate(trainer, writer, step, max_items=1)
            except Exception as e:  # validation must not stop training
                log.exception("validation failed: %s", e)
            writer.add_json(step, "launches", take_launch_counts())

    if cfg.validation_only:
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
