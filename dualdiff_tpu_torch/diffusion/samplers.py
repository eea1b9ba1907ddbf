"""Samplers: DDIM ("leading" spacing) and UniPC (bh2, data prediction,
corrector on, lower-order final).

Port of ``dualdiff_tpu/diffusion/samplers.py``.  The JAX versions are one
``lax.scan`` each; here each is a Python loop with one model evaluation per
step.  Every coefficient depends only on the static timestep grid, so it is
computed on the host (UniPC's B(h) systems in float64) and rounded to
float32 once, as in the JAX package; the loop does only tensor
multiply-adds.

``model_fn(x, t) -> eps`` with ``t`` a Python int timestep; conditioning and
CFG live inside ``model_fn``.  Stateful form, as in the JAX package: with
``model_state0`` given, ``model_fn(x, t, i, state) -> (eps, state)``, where
``i`` is the 0-based step index and the state is threaded from step to step
(the pipeline's model function, whose state holds the ControlNet residuals
between refreshes).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .schedule import DiffusionSchedule

__all__ = ["ddim_timesteps", "ddim_sample", "unipc_timesteps",
           "unipc_tables", "unipc_sample"]


def _evaluate(model_fn, x, t: int, i: int, stateful: bool, state):
    """One model evaluation -> (eps in float32, the next state)."""
    if stateful:
        eps, state = model_fn(x, t, i, state)
    else:
        eps = model_fn(x, t)
    return eps.float(), state


def ddim_timesteps(num_inference_steps: int, num_train_timesteps: int = 1000,
                   steps_offset: int = 1) -> np.ndarray:
    """'leading' spacing used by the SD v1.5 DDIM config."""
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(num_inference_steps) * step_ratio).round()[::-1] \
        .astype(np.int64) + steps_offset
    return np.clip(ts, 0, num_train_timesteps - 1)


def ddim_sample(schedule: DiffusionSchedule, model_fn: Callable,
                latents: torch.Tensor, num_inference_steps: int = 20,
                eta: float = 0.0, generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[torch.Tensor]] = None,
                model_state0: Any = None) -> torch.Tensor:
    """Deterministic (``eta=0``) or stochastic DDIM.  Below step 0 the
    previous cumulative alpha is 1.  With ``eta > 0`` step ``i`` adds
    ``sigma_i * noise[i]`` when ``noise`` (one tensor per step, the
    latents' shape) is given, else a draw from ``generator``."""
    ts = ddim_timesteps(num_inference_steps, schedule.num_train_timesteps)
    step_ratio = schedule.num_train_timesteps // num_inference_steps
    ac = np.asarray(schedule.alphas_cumprod, np.float32)
    prev = ts - step_ratio
    a_t = ac[ts]
    a_prev = np.where(prev >= 0, ac[np.maximum(prev, 0)],
                      np.float32(1.0)).astype(np.float32)
    one = np.float32(1.0)
    # float32 coefficients, computed as the JAX scan body computes them
    sq_1mat, sq_at = np.sqrt(one - a_t), np.sqrt(a_t)
    sq_aprev, sq_1maprev = np.sqrt(a_prev), np.sqrt(one - a_prev)
    sigma = (np.float32(eta) * np.sqrt((one - a_prev) / (one - a_t))
             * np.sqrt(one - a_t / a_prev)).astype(np.float32)
    sq_dir = np.sqrt(one - a_prev - sigma ** 2)
    stateful = model_state0 is not None
    state = model_state0
    x = latents.float()
    for i in range(num_inference_steps):
        eps, state = _evaluate(model_fn, x, int(ts[i]), i, stateful, state)
        x0 = (x - float(sq_1mat[i]) * eps) / float(sq_at[i])
        if eta > 0.0:
            z = noise[i].to(x.device, torch.float32) if noise is not None \
                else torch.randn(x.shape, generator=generator,
                                 device=x.device)
            x = float(sq_aprev[i]) * x0 + float(sq_dir[i]) * eps \
                + float(sigma[i]) * z
        else:
            x = float(sq_aprev[i]) * x0 + float(sq_1maprev[i]) * eps
    return x


def unipc_timesteps(num_inference_steps: int,
                    num_train_timesteps: int = 1000) -> np.ndarray:
    """'linspace' spacing (diffusers UniPCMultistepScheduler default)."""
    return (np.linspace(0, num_train_timesteps - 1, num_inference_steps + 1)
            .round()[::-1][:-1].astype(np.int64))


def _bh2_system(lam_t, lam_s0, rks_hist, p_ord):
    """(h_phi_1, B_h, rhos_p, rhos_c) of one bh2 update of order ``p_ord``
    with history ratios ``rks_hist`` (predict_x0, so hh = -h)."""
    hh = -(lam_t - lam_s0)
    h_phi_1 = np.expm1(hh)
    B_h = h_phi_1
    rks = np.asarray(list(rks_hist) + [1.0], np.float64)
    R = np.stack([rks ** k for k in range(p_ord)])
    b = np.zeros(p_ord, np.float64)
    h_phi_k = h_phi_1 / hh - 1.0
    fact = 1.0
    for k in range(1, p_ord + 1):
        b[k - 1] = h_phi_k * fact / B_h
        fact *= k + 1
        h_phi_k = h_phi_k / hh - 1.0 / fact
    if p_ord == 1:
        rhos_p, rhos_c = np.zeros(0), np.array([0.5])
    else:
        # the reference special-cases the order-2 predictor to [0.5]
        rhos_p = (np.array([0.5]) if p_ord == 2
                  else np.linalg.solve(R[:-1, :-1], b[:-1]))
        rhos_c = np.linalg.solve(R, b)
    return h_phi_1, B_h, rhos_p, rhos_c


def unipc_tables(schedule: DiffusionSchedule, n: int, order: int,
                 final_sigma: str) -> Dict[str, np.ndarray]:
    """Per-step float32 coefficients: ``c_*`` for the corrector of step i
    (s0 = ts[i-1] -> t = ts[i]), ``p_*`` for the predictor of step i
    (s0 = ts[i] -> ts[i+1], or the final boundary)."""
    if order not in (1, 2, 3):
        raise ValueError(f"solver_order={order} is not supported: UniPC "
                         "here covers orders 1-3")
    if final_sigma not in ("zero", "default", "sigma_min"):
        raise ValueError(f"unknown final_sigma {final_sigma!r}")
    ts = unipc_timesteps(n, schedule.num_train_timesteps)
    ac = np.asarray(schedule.alphas_cumprod, np.float64)
    lam = lambda t: 0.5 * (np.log(ac[t]) - np.log1p(-ac[t]))
    alpha = lambda t: np.sqrt(ac[t])
    sigma = lambda t: np.sqrt(1.0 - ac[t])

    this_order = np.zeros(n, np.int64)
    lower = 0
    for i in range(n):
        this_order[i] = min(order, n - i, lower + 1)
        lower = min(lower + 1, order)

    names = ("sig_ratio", "alpha_t", "h_phi_1", "B_h", "rho1", "rho2",
             "rk1_inv", "rk2_inv")
    c = {k: np.zeros(n) for k in names + ("rho_t",)}
    p = {k: np.zeros(n) for k in names}
    for i in range(1, n):
        s0, t = ts[i - 1], ts[i]
        oc = int(this_order[i - 1])
        h = lam(t) - lam(s0)
        rks = [(lam(ts[i - 1 - k]) - lam(s0)) / h for k in range(1, oc)]
        h_phi_1, B_h, _, rhos_c = _bh2_system(lam(t), lam(s0), rks, oc)
        c["sig_ratio"][i] = sigma(t) / sigma(s0)
        c["alpha_t"][i] = alpha(t)
        c["h_phi_1"][i] = h_phi_1
        c["B_h"][i] = B_h
        c["rho_t"][i] = rhos_c[-1]
        for k, r in enumerate(rks):
            c[f"rho{k + 1}"][i] = rhos_c[k]
            c[f"rk{k + 1}_inv"][i] = 1.0 / r
    for i in range(n):
        s0 = ts[i]
        if i + 1 < n:
            t = ts[i + 1]
            op = int(this_order[i])
            h = lam(t) - lam(s0)
            rks = [(lam(ts[i - k]) - lam(s0)) / h for k in range(1, op)]
            h_phi_1, B_h, rhos_p, _ = _bh2_system(lam(t), lam(s0), rks, op)
            p["sig_ratio"][i] = sigma(t) / sigma(s0)
            p["alpha_t"][i] = alpha(t)
            p["h_phi_1"][i] = h_phi_1
            p["B_h"][i] = B_h
            for k, r in enumerate(rks):
                p[f"rho{k + 1}"][i] = rhos_p[k]
                p[f"rk{k + 1}_inv"][i] = 1.0 / r
        elif final_sigma == "zero":
            # diffusers final_sigmas_type="zero": the last predictor lands
            # on x0 exactly (h -> inf)
            p["sig_ratio"][i], p["alpha_t"][i] = 0.0, 1.0
            p["h_phi_1"][i], p["B_h"][i] = -1.0, -1.0
        else:  # old diffusers: the last predictor steps to timestep 0
            h_phi_1, B_h, _, _ = _bh2_system(lam(0), lam(s0), [], 1)
            p["sig_ratio"][i] = sigma(0) / sigma(s0)
            p["alpha_t"][i] = alpha(0)
            p["h_phi_1"][i] = h_phi_1
            p["B_h"][i] = B_h

    tables = {"t": ts,
              "sqrt_ac": np.sqrt(ac[ts]), "sqrt_1mac": np.sqrt(1.0 - ac[ts])}
    tables.update({f"c_{k}": v for k, v in c.items()})
    tables.update({f"p_{k}": v for k, v in p.items()})
    return {k: (v if k == "t" else v.astype(np.float32))
            for k, v in tables.items()}


def unipc_sample(schedule: DiffusionSchedule, model_fn: Callable,
                 latents: torch.Tensor, num_inference_steps: int = 20,
                 order: int = 2, final_sigma: str = "zero",
                 model_state0: Any = None) -> torch.Tensor:
    """UniPC orders 1-3.  ``final_sigma="zero"``: the last step lands on
    the predicted x0 (modern diffusers); ``"default"``/``"sigma_min"``: it
    steps to train timestep 0, as the reference's older diffusers does."""
    tb = unipc_tables(schedule, num_inference_steps, order, final_sigma)
    f = lambda name, i: float(tb[name][i])  # float32 values, exact in float
    stateful = model_state0 is not None
    state = model_state0
    x = latents.float()
    last_sample = m0 = m1 = m2 = torch.zeros_like(x)
    for i in range(num_inference_steps):
        eps, state = _evaluate(model_fn, x, int(tb["t"][i]), i, stateful,
                               state)
        x0 = (x - f("sqrt_1mac", i) * eps) / f("sqrt_ac", i)
        if i > 0:  # corrector: refine x with the fresh evaluation
            d1_c = (m1 - m0) * f("c_rk1_inv", i)
            d2_c = (m2 - m0) * f("c_rk2_inv", i)
            d1_t = x0 - m0
            x_corr = (f("c_sig_ratio", i) * last_sample
                      - f("c_alpha_t", i) * f("c_h_phi_1", i) * m0)
            x = x_corr - f("c_alpha_t", i) * f("c_B_h", i) * (
                f("c_rho1", i) * d1_c + f("c_rho2", i) * d2_c
                + f("c_rho_t", i) * d1_t)
        d1_p = (m0 - x0) * f("p_rk1_inv", i)
        d2_p = (m1 - x0) * f("p_rk2_inv", i)
        x_pred = f("p_sig_ratio", i) * x - f("p_alpha_t", i) * \
            f("p_h_phi_1", i) * x0
        x_pred = x_pred - f("p_alpha_t", i) * f("p_B_h", i) * (
            f("p_rho1", i) * d1_p + f("p_rho2", i) * d2_p)
        x, last_sample, m0, m1, m2 = x_pred, x, x0, m0, m1
    return x
