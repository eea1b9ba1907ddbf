"""The port's UniPC sampler against the JAX package's, step by step.

A fixed nonlinear toy ``model_fn`` on both sides; the JAX side records the
sample it is evaluated at in every step (``jax.debug.callback``), the port's
side likewise, and every step's input and the final output are compared.
Tolerance 1e-5: float32 arithmetic in the same order on both sides, with
coefficients rounded from the same float64 host tables; only tanh's last
bit may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.diffusion.samplers import unipc_sample as jax_unipc
from dualdiff_tpu.diffusion.schedule import DiffusionSchedule as JSchedule
from dualdiff_tpu_torch.diffusion.samplers import unipc_sample, unipc_timesteps
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
