"""``from_jax`` against the JAX package's exporter, and strict loads.

For the same param tree, every name and value ``from_jax`` produces equals
what ``dualdiff_tpu.runner.weight_import.export_params`` produces (so a
diffusers checkpoint, which carries those names, loads the same way), and
each of the port's modules loads it with ``strict=True``.  No leaf is left
out: the VAE carries its encoder and ``quant_conv`` too.
"""

import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.runner.weight_import import export_params
from dualdiff_tpu_torch.runner.weights import NOT_PORTED, from_jax

KINDS = [("unet", "unet"), ("controlnet_0", "controlnet"),
         ("controlnet_1", "controlnet"), ("vae", "vae"),
         ("text_encoder", "clip")]


@pytest.fixture(scope="module")
def tiny():
    return tp.tiny_setup()


@pytest.mark.parametrize("key, kind", KINDS)
def test_from_jax_equals_export_params(tiny, key, kind):
    params = tiny["params"][key]
    want = export_params(params, kind)
    got = from_jax(tp.flat(params), kind)
    skipped = {k for k in want if k.startswith(NOT_PORTED.get(kind, ()))}
    assert set(got) == set(want) - skipped
    assert not skipped
    if kind == "vae":
        assert any(k.startswith("encoder.") for k in got)
        assert "quant_conv.weight" in got
    for name, value in got.items():
        np.testing.assert_array_equal(value.numpy(), want[name],
                                      err_msg=name)


@pytest.mark.parametrize("key, kind", KINDS)
def test_strict_load_into_port_modules(tiny, key, kind):
    models = tiny["pmodels"]
    module = {"unet": models["unet"], "vae": models["vae"],
              "text_encoder": models["text_encoder"],
              "controlnet_0": models["controlnets"][0],
              "controlnet_1": models["controlnets"][1]}[key]
    sd = from_jax(tp.flat(tiny["params"][key]), kind)
    result = module.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    for name, p in module.state_dict().items():
        torch.testing.assert_close(p, sd[name], rtol=0, atol=0)
