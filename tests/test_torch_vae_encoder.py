"""The port's VAE encoder (``encode_moments``, ``encode``, ``encode_mode``)
and decoder against the JAX package's, with the tiny weights of
``tiny_setup``.

The image is 64 x 36 so that the stride-2 downsamplers see odd sizes
(36 -> 18 -> 9 -> 4): a symmetric pad would shift every later pixel, the
(0, 1) bottom-right pad of diffusers and the JAX package does not.  The
posterior noise is JAX's own draw, handed to the port.  Tolerance 1e-4
absolute on values of magnitude ~1: both sides float32, only the order of
the convolution sums differs.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests import torch_parity as tp

ATOL = 1e-4


def _nchw(x):
    return tp.t(x).permute(0, 3, 1, 2)


def test_encode_matches_jax():
    tiny = tp.tiny_setup()
    jvae, pvae = tiny["jmodels"]["vae"], tiny["pmodels"]["vae"]
    p = {"params": tiny["params"]["vae"]}
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.0, 1.0, size=(2, 64, 36, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    want_m = jvae.apply(p, jnp.asarray(x), method=jvae.encode_moments)
    want_z = jvae.apply(p, jnp.asarray(x), key, method=jvae.encode)
    want_mode = jvae.apply(p, jnp.asarray(x), method=jvae.encode_mode)
    noise = jax.random.normal(key, want_mode.shape, jnp.float32)

    with torch.no_grad():
        got_m = pvae.encode_moments(_nchw(x))
        got_z = pvae.encode(_nchw(x), _nchw(noise))
        got_mode = pvae.encode_mode(_nchw(x))
    assert tuple(got_m.shape) == (2, 8, 8, 4)
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    tp.assert_close(nhwc(got_m), want_m, rtol=0, atol=ATOL, what="moments")
    tp.assert_close(nhwc(got_z), want_z, rtol=0, atol=ATOL, what="encode")
    tp.assert_close(nhwc(got_mode), want_mode, rtol=0, atol=ATOL,
                    what="encode_mode")


def test_encode_scales_the_noise_by_the_posterior_std():
    """``encode(x, noise)`` is ``(mean + exp(logvar / 2) * noise) * scale``:
    zero noise gives the mode, and the step from zero to unit noise is the
    scaled standard deviation.  Exact: the same float32 ops on both sides."""
    pvae = tp.tiny_setup()["pmodels"]["vae"]
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (1, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        mean, logvar = pvae.encode_moments(x).chunk(2, dim=1)
        z0 = pvae.encode(x, torch.zeros_like(mean))
        z1 = pvae.encode(x, torch.ones_like(mean))
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    torch.testing.assert_close(z0, pvae.encode_mode(x), rtol=0, atol=0)
    torch.testing.assert_close(z1, (mean + std) * pvae.scaling_factor,
                               rtol=0, atol=0)


def test_vae_decode():
    tiny = tp.tiny_setup()
    jm, pm = tiny["jmodels"]["vae"], tiny["pmodels"]["vae"]
    z = np.random.default_rng(70).normal(size=(2, 32, 16, 4)).astype(
        np.float32)
    want = jax.jit(lambda p, z: jm.apply({"params": p}, z, method=jm.decode))(
        tiny["params"]["vae"], z)
    with torch.no_grad():
        got = pm.decode(tp.nhwc_to_nchw(z))
    tp.assert_close(got, np.transpose(np.asarray(want), (0, 3, 1, 2)), 1e-4,
                    1e-4)
    assert math.isfinite(float(got.abs().max()))
