"""The port's UniPC and DDIM samplers against the JAX package's, step by
step.

A fixed nonlinear toy ``model_fn`` on both sides; the JAX side records the
sample it is evaluated at in every step (``jax.debug.callback``), the port's
side likewise, and every step's input and the final output are compared.
UniPC: tolerance 1e-5: float32 arithmetic in the same order on both sides,
with coefficients rounded from the same float64 host tables; only tanh's
last bit may differ.

DDIM: tolerance 1e-6 absolute, with the analytic eps model of a point mass
(``eps = (x - sqrt(abar_t) x0) / sqrt(1 - abar_t)``) on samples of unit
size, at eta 0 and at eta 0.5 with JAX's per-step noise passed in.  Both
sides read the JAX schedule's cumulative alphas (the port's own differ in
the last bits, ``test_schedule_matches``), so only the samplers' float32
arithmetic differs.  The stateful form (``model_state0``, as the pipeline's
ControlNet cache uses it) of both samplers refreshes its state at the same
steps as JAX's, ``i % k == 0``, within the same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.diffusion.samplers import ddim_sample as jax_ddim
from dualdiff_tpu.diffusion.samplers import ddim_timesteps as jax_ddim_ts
from dualdiff_tpu.diffusion.samplers import unipc_sample as jax_unipc
from dualdiff_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from dualdiff_tpu_torch.diffusion.samplers import (ddim_sample,
                                                   ddim_timesteps,
                                                   unipc_sample,
                                                   unipc_timesteps)
from dualdiff_tpu_torch.diffusion.schedule import DiffusionSchedule


def test_schedule_matches():
    """rtol 1e-5: XLA's float32 cumprod is an associative scan, numpy's is
    sequential; after 1000 products they differ in the last bits (2.3e-6)."""
    j, p = JSchedule.create(), DiffusionSchedule.create()
    np.testing.assert_allclose(p.alphas_cumprod, np.asarray(j.alphas_cumprod),
                               rtol=1e-5)
    np.testing.assert_allclose(p.betas, np.asarray(j.betas), rtol=1e-6)


@pytest.mark.parametrize("final_sigma", ["zero", "default"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_unipc_step_by_step(order, final_sigma):
    steps = 6
    x0 = np.random.default_rng(order).normal(
        size=(2, 3, 4, 5, 4)).astype(np.float32)
    seen_j = []

    def jax_fn(x, t):
        jax.debug.callback(lambda a: seen_j.append(np.asarray(a)), x,
                           ordered=True)
        return jnp.tanh(0.5 * x + t.astype(jnp.float32) / 1000.0) * 0.8

    want = jax_unipc(JSchedule.create(), jax_fn, jnp.asarray(x0),
                     num_inference_steps=steps, order=order,
                     final_sigma=final_sigma)
    want = np.asarray(jax.block_until_ready(want))
    seen_p = []

    def port_fn(x, t):
        seen_p.append(x.clone())
        return torch.tanh(0.5 * x + t / 1000.0) * 0.8

    got = unipc_sample(DiffusionSchedule.create(), port_fn, tp.t(x0),
                       num_inference_steps=steps, order=order,
                       final_sigma=final_sigma)
    assert len(seen_p) == len(seen_j) == steps
    for i, (a, b) in enumerate(zip(seen_p, seen_j)):
        tp.assert_close(a, b, 1e-5, 1e-5, what=f"step {i}")
    tp.assert_close(got, want, 1e-5, 1e-5)


def test_unipc_timesteps_and_order_check():
    from dualdiff_tpu.diffusion.samplers import unipc_timesteps as jts

    np.testing.assert_array_equal(unipc_timesteps(20), jts(20))
    with pytest.raises(ValueError):
        unipc_sample(DiffusionSchedule.create(), lambda x, t: x,
                     torch.zeros(1), num_inference_steps=3, order=4)


def _shared_schedules():
    """The JAX schedule and a port schedule holding its very arrays."""
    j = JSchedule.create()
    return j, DiffusionSchedule(
        betas=np.asarray(j.betas, np.float32),
        alphas_cumprod=np.asarray(j.alphas_cumprod, np.float32))


@pytest.mark.parametrize("steps", [1, 7, 20, 50])
def test_ddim_timesteps_match(steps):
    np.testing.assert_array_equal(ddim_timesteps(steps), jax_ddim_ts(steps))
    np.testing.assert_array_equal(ddim_timesteps(steps, 1000, 0),
                                  jax_ddim_ts(steps, 1000, 0))


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_step_by_step(eta):
    steps = 6
    rng = np.random.default_rng(11)
    target = rng.normal(size=(2, 3, 4, 5, 4)).astype(np.float32)
    x_t = rng.normal(size=target.shape).astype(np.float32)
    jsched, psched = _shared_schedules()
    ac = np.asarray(jsched.alphas_cumprod)
    seen_j = []

    def jax_fn(x, t):
        jax.debug.callback(lambda a: seen_j.append(np.asarray(a)), x,
                           ordered=True)
        at = jnp.asarray(ac)[t]
        return (x - jnp.sqrt(at) * target) / jnp.sqrt(1.0 - at)

    key = jax.random.PRNGKey(5) if eta else None
    want = np.asarray(jax.block_until_ready(jax_ddim(
        jsched, jax_fn, jnp.asarray(x_t), num_inference_steps=steps,
        eta=eta, rng=key)))
    # the JAX scan's per-step draws (ddim_sample: split(rng, steps))
    noise = [tp.t(jax.random.normal(k, target.shape, jnp.float32))
             for k in jax.random.split(key, steps)] if eta else None
    seen_p = []

    def port_fn(x, t):
        seen_p.append(x.clone())
        at = float(ac[t])
        return (x - at ** 0.5 * tp.t(target)) / (1.0 - at) ** 0.5

    got = ddim_sample(psched, port_fn, tp.t(x_t), num_inference_steps=steps,
                      eta=eta, noise=noise)
    assert len(seen_p) == len(seen_j) == steps
    for i, (a, b) in enumerate(zip(seen_p, seen_j)):
        tp.assert_close(a, b, 0, 1e-6, what=f"step {i}")
    tp.assert_close(got, want, 0, 1e-6)
    if not eta:  # the point mass: deterministic DDIM lands on it
        tp.assert_close(got, target, 0, 1e-4)


def test_ddim_draws_from_the_generator_with_eta():
    """Without per-step noise, eta > 0 draws from the generator: the same
    seed gives the same sample, another seed another."""
    sched = DiffusionSchedule.create()
    x = torch.zeros(1, 2, 3, 4)
    run = lambda seed: ddim_sample(
        sched, lambda a, t: torch.tanh(a), x, num_inference_steps=4,
        eta=1.0, generator=torch.Generator().manual_seed(seed))
    torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
    assert not torch.equal(run(1), run(2))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("sampler", ["ddim", "unipc"])
def test_stateful_form_refreshes_where_jax_does(sampler, k):
    """``model_fn(x, t, i, state) -> (eps, state)``: the state is refreshed
    from the sample at the steps ``i % k == 0`` and kept in between, as
    the pipeline's ControlNet cache is; eps depends on it, so a refresh at
    another step would move the result."""
    steps = 7
    x0 = np.random.default_rng(k).normal(size=(2, 3, 4, 5, 4)).astype(
        np.float32)
    jsched, psched = _shared_schedules()

    def jax_fn(x, t, i, state):
        state = jax.lax.cond(i % k == 0, lambda _: 0.3 * jnp.tanh(x),
                             lambda s: s, state)
        return jnp.tanh(0.5 * x + t.astype(jnp.float32) / 1000.0) * 0.8 \
            + state, state

    refreshed = []

    def port_fn(x, t, i, state):
        if i % k == 0:
            refreshed.append(i)
            state = 0.3 * torch.tanh(x)
        return torch.tanh(0.5 * x + t / 1000.0) * 0.8 + state, state

    j_run = jax_ddim if sampler == "ddim" else jax_unipc
    p_run = ddim_sample if sampler == "ddim" else unipc_sample
    want = np.asarray(jax.block_until_ready(j_run(
        jsched, jax_fn, jnp.asarray(x0), num_inference_steps=steps,
        model_state0=jnp.zeros(x0.shape, jnp.float32))))
    got = p_run(psched, port_fn, tp.t(x0), num_inference_steps=steps,
                model_state0=torch.zeros(x0.shape))
    assert refreshed == list(range(0, steps, k))
    tol = 1e-6 if sampler == "ddim" else 1e-5
    tp.assert_close(got, want, tol, tol)
