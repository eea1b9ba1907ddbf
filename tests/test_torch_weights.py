"""``from_jax`` against the JAX package's exporter, and strict loads.

For the same param tree, every name and value ``from_jax`` produces equals
what ``dualdiff_tpu.runner.weight_import.export_params`` produces (so a
diffusers checkpoint, which carries those names, loads the same way), and
each of the port's modules loads it with ``strict=True``.  No leaf is left
out: the VAE carries its encoder and ``quant_conv`` too, and the video UNet
its ``norm_temporal``, ``attn_temporal`` and ``temporal_connector`` leaves.
The RGD stage-2 UNet carries its LoRA leaves, with the one rename
``from_jax`` states: the exporter's ``to_out.0_lora_a`` / ``_b`` are
``to_out_0_lora_a`` / ``_b`` in the port.  The ``occ_bg_fusionp``
ControlNet carries SFA+'s leaves (``txt_con_fusionp``: five bias-free
projections and ``to_out.0``).
"""

import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.runner.weight_import import export_params
from dualdiff_tpu_torch.runner.weights import NOT_PORTED, from_jax

KINDS = [("unet", "unet"), ("controlnet_0", "controlnet"),
         ("controlnet_1", "controlnet"), ("vae", "vae"),
         ("text_encoder", "clip"), ("video_unet", "unet"),
         ("rgd_unet", "unet"), ("fusionp_controlnet", "controlnet")]
TEMPORAL = ("norm_temporal.", "attn_temporal.", "temporal_connector.")
VIDEO = {"video_unet": True, "rgd_unet": "rgd"}


def _renamed(name: str) -> str:
    """The exporter's name -> the port's (the only rename)."""
    return name.replace("to_out.0_lora_", "to_out_0_lora_")


@pytest.fixture(scope="module")
def tiny():
    return tp.tiny_setup()


def _params(tiny, key):
    if key in VIDEO:
        return tp.tiny_video_unet_params(VIDEO[key])
    if key == "fusionp_controlnet":
        return tp.tiny_setup(fusionp=True)["params"]["controlnet_0"]
    return tiny["params"][key]


def _module(tiny, key):
    if key in VIDEO:
        from dualdiff_tpu_torch.runner.factory import build_models

        return build_models(tp.port_config(tp.TINY_VIDEO_OVERRIDES,
                                           video=VIDEO[key]),
                            tiny=True, device="cpu")["unet"]
    if key == "fusionp_controlnet":
        return tp.tiny_setup(fusionp=True)["pmodels"]["controlnets"][0]
    models = tiny["pmodels"]
    return {"unet": models["unet"], "vae": models["vae"],
            "text_encoder": models["text_encoder"],
            "controlnet_0": models["controlnets"][0],
            "controlnet_1": models["controlnets"][1]}[key]


@pytest.mark.parametrize("key, kind", KINDS)
def test_from_jax_equals_export_params(tiny, key, kind):
    params = _params(tiny, key)
    exported = export_params(params, kind)
    want = {_renamed(k): v for k, v in exported.items()}
    got = from_jax(tp.flat(params), kind)
    skipped = {k for k in want if k.startswith(NOT_PORTED.get(kind, ()))}
    assert set(got) == set(want) - skipped
    assert not skipped
    if kind == "vae":
        assert any(k.startswith("encoder.") for k in got)
        assert "quant_conv.weight" in got
    temporal = {k for k in got if any(p in k for p in TEMPORAL)}
    # 10 transformer blocks in the tiny UNet, each with norm_temporal (2
    # leaves), attn_temporal (q, k, v, out weight and bias) and the connector
    assert len(temporal) == (10 * (2 + 5 + 2) if key in VIDEO else 0)
    # 10 blocks x attn1 / attn2 x 4 projections x A / B; the output
    # projection's 40 are the renamed ones
    lora = {k for k in got if "_lora_" in k}
    assert len(lora) == (10 * 2 * 4 * 2 if key == "rgd_unet" else 0)
    assert len(set(exported) - set(got)) == len(lora) // 4
    assert all(k.endswith(("_lora_a.weight", "_lora_b.weight"))
               for k in lora)
    sfa_plus = {k for k in got if k.startswith("txt_con_fusionp.")}
    assert sfa_plus == ({f"txt_con_fusionp.to_{p}.weight" for p in (
        "q_occ", "k_occ", "v_occ", "k_txt", "v_txt")} | {
        "txt_con_fusionp.to_out.0.weight", "txt_con_fusionp.to_out.0.bias"}
        if key == "fusionp_controlnet" else set())
    for name, value in got.items():
        np.testing.assert_array_equal(value.numpy(), want[name],
                                      err_msg=name)


@pytest.mark.parametrize("key, kind", KINDS)
def test_strict_load_into_port_modules(tiny, key, kind):
    module = _module(tiny, key)
    sd = from_jax(tp.flat(_params(tiny, key)), kind)
    result = module.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    for name, p in module.state_dict().items():
        torch.testing.assert_close(p, sd[name], rtol=0, atol=0)
