"""Trainable partition and optimizer of the training step.

Port of ``dualdiff_tpu/runner/train_state.py``.  The JAX package keeps the
trainables in float32, casts them to the compute dtype at each use, and
steps them with ``optax.chain(clip_by_global_norm, adamw)``, wrapped in
``optax.MultiSteps`` when ``gradient_accumulation_steps`` is above 1.  Here
every module stays in the compute dtype (bf16); ``AdamW`` keeps a float32
master copy of each trainable, upcasts the gradients, steps the master copy
exactly as optax does and copies it back rounded.  ``torch.optim.AdamW`` is not
used: it has no low-precision first moment, and ``clip_grad_norm_`` adds
1e-6 to the norm.

Parameters are named ``"<root>/<state_dict name>"`` with roots ``unet``,
``controlnet_<i>``, ``vae`` and ``text_encoder``, as the JAX param tree's
top level.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models.unet import is_new_multiview_param

__all__ = ["trainable_predicate", "named_roots", "partition_params",
           "BOX_ADAPTER_BASE", "init_box_adapter_from_base",
           "build_schedule", "AdamW",
           "build_optimizer"]

Predicate = Callable[[str, str], bool]


def trainable_predicate(unet_trainable_state: str = "only_new",
                        trainable_class_token: bool = False) -> Predicate:
    """pred(root, name) -> trainable?  ``only_new``: every ControlNet
    parameter except the CLIP-initialised class tokens, plus the UNet's
    multiview (attn4 / norm4 / connector) parameters; VAE and text encoder
    frozen.  ``all`` trains the whole UNet too.  ``lora_only`` (RGD stage
    2) freezes every ControlNet and trains only the UNet parameters with
    ``lora`` in a part of their name."""
    if unet_trainable_state not in ("only_new", "all", "lora_only"):
        raise ValueError(
            f"unknown unet trainable_state {unet_trainable_state!r}")
    lora_only = unet_trainable_state == "lora_only"

    def pred(root: str, name: str) -> bool:
        if lora_only:
            return root == "unet" and any("lora" in part
                                          for part in name.split("."))
        if root.startswith("controlnet"):
            if name.split(".")[-1].strip("_") == "class_tokens":
                return trainable_class_token
            return True
        if root == "unet":
            return unet_trainable_state == "all" or is_new_multiview_param(
                name)
        return False

    return pred


def named_roots(models: Dict) -> Iterator[Tuple[str, torch.nn.Module]]:
    """(root, module) of every network in a ``build_models`` dict."""
    yield "unet", models["unet"]
    for i, cn in enumerate(models["controlnets"]):
        yield f"controlnet_{i}", cn
    yield "vae", models["vae"]
    yield "text_encoder", models["text_encoder"]


def partition_params(models: Dict, pred: Predicate):
    """Set ``requires_grad`` by ``pred``; -> (trainable, frozen) dicts of
    ``"<root>/<name>" -> Parameter``."""
    trainable, frozen = {}, {}
    for root, module in named_roots(models):
        for name, p in module.named_parameters():
            keep = pred(root, name)
            p.requires_grad_(keep)
            (trainable if keep else frozen)[f"{root}/{name}"] = p
    return trainable, frozen


# each box-adapter projection -> the base projection it starts from
BOX_ADAPTER_BASE = {"to_k_box": "to_k", "to_k_cls": "to_k",
                    "to_v_box": "to_v", "to_v_cls": "to_v"}


@torch.no_grad()
def init_box_adapter_from_base(models: Dict) -> int:
    """The box adapter's projections start as copies of their attention's
    base projections (``BOX_ADAPTER_BASE``; the JAX package's
    ``init_box_adapter_from_base``, reference box_adapter.py:433-440),
    where the shapes match.  -> the number of tensors copied."""
    src_of = BOX_ADAPTER_BASE
    copied = 0
    for _, module in named_roots(models):
        params = dict(module.named_parameters())
        for name, p in params.items():
            parts = name.split(".")
            if len(parts) < 2 or parts[-2] not in src_of:
                continue
            src = params.get(".".join(parts[:-2] + [src_of[parts[-2]],
                                                    parts[-1]]))
            if src is not None and src.shape == p.shape:
                p.copy_(src)
                copied += 1
    return copied


# ------------------------------------------------------------ schedules --
# float32 arithmetic, as optax's schedules compute

def _f32(x) -> np.float32:
    return np.float32(x)


def _linear(init: float, end: float, steps: int):
    if steps <= 0:
        return lambda count: _f32(init)

    def sched(count: int) -> np.float32:
        frac = _f32(1) - _f32(min(max(count, 0), steps)) / _f32(steps)
        return _f32(init - end) * frac + _f32(end)
    return sched


def _cosine(init: float, decay_steps: int, alpha: float = 0.0):
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got "
                         f"{decay_steps}")

    def sched(count: int) -> np.float32:
        c = _f32(min(count, decay_steps))
        cos = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * c
                                           / _f32(decay_steps)))
        return _f32(init) * (_f32(1 - alpha) * cos + _f32(alpha))
    return sched


def _join(first, second, boundary: int):
    return lambda count: first(count) if count < boundary \
        else second(count - boundary)


def build_schedule(cfg_runner, max_train_steps: int):
    """step -> learning rate: optax's ``warmup_cosine_decay_schedule(0,
    peak, warmup, max(steps, warmup + 1), 0)`` for ``cosine``, linear warmup
    then constant for ``constant_with_warmup``, else constant."""
    warmup = int(cfg_runner.lr_warmup_steps)
    peak = float(cfg_runner.learning_rate)
    kind = str(cfg_runner.lr_scheduler)
    if kind == "cosine":
        decay = max(max_train_steps, warmup + 1)
        return _join(_linear(0.0, peak, warmup), _cosine(peak, decay - warmup),
                     warmup)
    if kind == "constant_with_warmup":
        return _join(_linear(0.0, peak, warmup), lambda c: _f32(peak), warmup)
    return lambda count: _f32(peak)


# ------------------------------------------------------------ optimizer --

class AdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, weight_decay, mu_dtype))`` over float32 master copies of
    ``params``; with ``accumulate = k > 1``, wrapped as by
    ``optax.MultiSteps(..., every_k_schedule=k)``.

    Per update: g = the upcast gradients; norm = their global norm;
    g <- (g / norm) * max_norm when norm >= max_norm; mu, nu updated as
    optax does (the first moment stored in ``mu_dtype``, and ``b1 * mu``
    taken in that dtype with ``b1`` itself rounded to it, as JAX's weak
    typing does: 0.8984375 in bf16); u = mu_hat / (sqrt(nu_hat) + eps)
    + wd * p;
    p <- p - lr(count) * u; then each live parameter gets its master copy
    rounded to its own dtype.  ``master``: the float32 starting values,
    when the live parameters were already rounded.

    Gradient accumulation (``MultiSteps``' ``update``): each micro-step
    folds its upcast gradients into float32 accumulators by Welford's mean,
    ``acc += (g - acc) / (mini_step + 1)``; the k-th runs the update above
    on ``acc`` (so ``count``, and with it the schedule, advances once per k
    micro-steps) and zeroes ``acc`` and ``mini_step``.  The other
    micro-steps leave the masters, the moments, ``count`` and the live
    parameters as they are.  The accumulators exist only when k > 1."""

    def __init__(self, params: Dict[str, torch.nn.Parameter], schedule,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-2, max_grad_norm: float = 1.0,
                 mu_dtype: torch.dtype = torch.float32,
                 master: Optional[Dict[str, torch.Tensor]] = None,
                 accumulate: int = 1):
        self.params = params
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.mu_dtype = mu_dtype
        self.accumulate = max(int(accumulate), 1)
        self._b1_mu = float(torch.tensor(b1, dtype=mu_dtype))
        self.master = {k: (master[k] if master is not None
                           else p.detach()).float().clone().to(p.device)
                       for k, p in params.items()}
        self.mu = {k: torch.zeros_like(m, dtype=mu_dtype)
                   for k, m in self.master.items()}
        self.nu = {k: torch.zeros_like(m) for k, m in self.master.items()}
        self.count = 0
        self.acc = {k: torch.zeros_like(m) for k, m in self.master.items()} \
            if self.accumulate > 1 else None
        self.mini_step = 0

    def grads(self) -> Dict[str, torch.Tensor]:
        """The live parameters' gradients (zero where none reached)."""
        return {k: p.grad if p.grad is not None else torch.zeros_like(p)
                for k, p in self.params.items()}

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    @torch.no_grad()
    def step(self, grads: Optional[Dict[str, torch.Tensor]] = None
             ) -> torch.Tensor:
        """One micro-step from ``grads`` (default: the parameters'
        ``.grad``): an update, or with accumulation a fold into the
        accumulators and an update every ``accumulate``-th call.  Returns
        the global norm of the given gradients before clipping."""
        g = {k: v.float() for k, v in (grads or self.grads()).items()}
        norm = global_norm(list(g.values()))
        if self.acc is None:
            self._update(g, norm)
            return norm
        n = self.mini_step
        for k, gk in g.items():
            self.acc[k].add_((gk - self.acc[k]).div_(n + 1))
        del g
        if n + 1 < self.accumulate:
            self.mini_step = n + 1
            return norm
        self._update(self.acc, global_norm(list(self.acc.values())))
        for a in self.acc.values():
            a.zero_()
        self.mini_step = 0
        return norm

    def _update(self, g: Dict[str, torch.Tensor], norm: torch.Tensor
                ) -> None:
        if not bool(norm < self.max_grad_norm):
            g = {k: (v / norm) * self.max_grad_norm for k, v in g.items()}
        lr = float(self.schedule(self.count))
        c = _f32(self.count + 1)
        bc1 = float(_f32(1) - _f32(self.b1) ** c)
        bc2 = float(_f32(1) - _f32(self.b2) ** c)
        for k, gk in g.items():
            decayed = (self._b1_mu * self.mu[k].float()).to(self.mu_dtype)
            mu = (1 - self.b1) * gk + decayed
            nu = (1 - self.b2) * gk * gk + self.b2 * self.nu[k]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * self.master[k]
            self.master[k] += -lr * u
            self.mu[k] = mu.to(self.mu_dtype)
            self.nu[k] = nu
            self.params[k].copy_(self.master[k])
        self.count += 1

    def state_dict(self) -> Dict:
        """``master``, ``mu`` (in ``mu_dtype``), ``nu`` and ``count``; with
        accumulation also ``acc`` and ``mini_step``.  The tensors are the
        optimizer's own, on its device."""
        out = {"master": dict(self.master), "mu": dict(self.mu),
               "nu": dict(self.nu), "count": self.count,
               "accumulate": self.accumulate}
        if self.acc is not None:
            out.update(acc=dict(self.acc), mini_step=self.mini_step)
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Dict) -> None:
        """Copy a ``state_dict()`` into this optimizer's tensors (on its own
        device and dtypes), then set the live parameters from the masters,
        rounded to their dtype.  The trainable names and the accumulation
        must be this optimizer's."""
        if int(state.get("accumulate", 1)) != self.accumulate:
            raise ValueError(
                f"the state was taken with gradient accumulation over "
                f"{state.get('accumulate', 1)} micro-steps, this optimizer "
                f"accumulates {self.accumulate}")
        for key in ("master", "mu", "nu") + (("acc",) if self.acc is not None else ()):
            own, src = getattr(self, key), state[key]
            if set(src) != set(own):
                raise KeyError(f"{key}: the state's trainables differ: "
                               f"{sorted(set(src) ^ set(own))[:5]}")
            for k, v in src.items():
                own[k].copy_(v)
        self.count = int(state["count"])
        self.mini_step = int(state.get("mini_step", 0))
        for k, p in self.params.items():
            p.copy_(self.master[k])

    @torch.no_grad()
    def reset_state(self) -> None:
        """The moments, ``count`` and the accumulators back to zero, as
        ``tx.init(params)`` starts them; the masters stay."""
        for d in (self.mu, self.nu) + ((self.acc,) if self.acc is not None else ()):
            for v in d.values():
                v.zero_()
        self.count = 0
        self.mini_step = 0


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, float32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def build_optimizer(cfg_runner, params: Dict[str, torch.nn.Parameter],
                    max_train_steps: int,
                    master: Optional[Dict[str, torch.Tensor]] = None
                    ) -> AdamW:
    """The JAX package's ``build_optimizer`` for the port: AdamW with a
    global-norm clip, the configured schedule and a bf16 first moment when
    ``adam_mu_dtype`` is ``bf16``, accumulating the gradients of
    ``gradient_accumulation_steps`` micro-steps per update when above 1."""
    mu_dtype = {"bf16": torch.bfloat16}.get(
        str(cfg_runner.get("adam_mu_dtype", "bf16")), torch.float32)
    return AdamW(params, build_schedule(cfg_runner, max_train_steps),
                 b1=float(cfg_runner.adam_beta1),
                 b2=float(cfg_runner.adam_beta2),
                 eps=float(cfg_runner.adam_epsilon),
                 weight_decay=float(cfg_runner.adam_weight_decay),
                 max_grad_norm=float(cfg_runner.max_grad_norm),
                 mu_dtype=mu_dtype, master=master,
                 accumulate=int(cfg_runner.gradient_accumulation_steps))
