"""Loading released SD v1.5 / DualDiff checkpoints by their diffusers /
transformers names (``dualdiff_tpu_torch/runner/weights.py``).

* Full-width key coverage on the ``meta`` device: every key of the repo's
  SD v1.5 key lists (``runner/sd15_keys.py``: UNet, VAE in current and
  legacy attention names, CLIP with and without ``position_ids``) loads
  into the port's full-width module at its own shape, and what the module
  keeps of its own init is exactly the multiview leaves of the UNet.
* A tiny round trip: the JAX exporter's state dicts (the VAE renamed to
  the legacy names, CLIP with ``position_ids``) through
  ``load_pretrained`` equal the ``from_jax`` load bit for bit.
* ``read_checkpoint`` against files written by the ``safetensors``
  package and by ``torch.save``; ``load_pretrained_dir`` on a
  diffusers-layout directory.
* A shape mismatch and an unexpected key raise.
* The trainer's export (the flagship's tiny weights, both ControlNets):
  names and values equal the JAX exporter's (``export_params``) for the
  same weights, exactly (float32 both sides), and the export loads back
  through ``load_pretrained_dir`` bit for bit.
"""

import copy
import os

import numpy as np
import pytest
import torch

from tests import torch_parity as tp
from dualdiff_tpu.runner.weight_import import export_params
from dualdiff_tpu_torch.data.synthetic import SyntheticNuScenes
from dualdiff_tpu_torch.runner.factory import build_models
from dualdiff_tpu_torch.runner.sd15_keys import (sd15_clip_keys,
                                                 sd15_unet_keys,
                                                 sd15_vae_keys)
from dualdiff_tpu_torch.runner.trainer import MultiviewTrainer
from dualdiff_tpu_torch.runner.weights import (LEGACY_VAE_NAMES,
                                               MULTIVIEW_MODULES,
                                               from_diffusers,
                                               load_pretrained,
                                               load_pretrained_dir,
                                               read_checkpoint)
from dualdiff_tpu_torch.utils.config import load_config

# (kind, the module's key in build_models' dict, the SD v1.5 key list)
FULL_WIDTH = [
    ("unet", "unet", sd15_unet_keys()),
    ("vae", "vae", sd15_vae_keys(legacy_attn=False)),
    ("vae", "vae", sd15_vae_keys(legacy_attn=True)),
    ("clip", "text_encoder", sd15_clip_keys(with_position_ids=False)),
    ("clip", "text_encoder", sd15_clip_keys(with_position_ids=True)),
]
FULL_WIDTH_IDS = ["unet", "vae", "vae-legacy", "clip", "clip-position_ids"]


def _multiview(name: str) -> bool:
    return any(f".{m}." in name for m in MULTIVIEW_MODULES)


def _legacy_vae(sd: dict) -> dict:
    """Current VAE attention names -> the legacy ones of pre-0.15 diffusers
    dumps."""
    out = {}
    for k, v in sd.items():
        for old, new in LEGACY_VAE_NAMES.items():
            k = k.replace(f"attentions.0.{new}.", f"attentions.0.{old}.")
        out[k] = v
    return out


@pytest.fixture(scope="module")
def full_width():
    """The flagship's full-width model set on the meta device (no
    memory, no init)."""
    return build_models(load_config(), device="meta")


@pytest.mark.parametrize("kind, key, keys", FULL_WIDTH, ids=FULL_WIDTH_IDS)
def test_sd15_keys_load_into_the_full_width_modules(full_width, kind, key,
                                                    keys):
    """Every SD v1.5 key maps to a port key of the same shape (a mismatch
    or an unmapped key would raise), and the module keys the checkpoint
    does not hold are exactly the UNet's multiview leaves: 16 transformer
    blocks x (attn4's 5, norm4's 2, the connector's 2)."""
    module = full_width[key]
    sd = {k: torch.empty(shape, device="meta") for k, shape in keys.items()}
    missing = load_pretrained(module, sd, kind)
    own = module.state_dict()
    assert missing == sorted(k for k in own if _multiview(k))
    assert len(missing) == (16 * 9 if kind == "unet" else 0)
    mapped = from_diffusers(sd, kind)
    assert len(mapped) == len(own) - len(missing)
    assert all(tuple(own[k].shape) == tuple(v.shape)
               for k, v in mapped.items())


def test_sd15_vae_legacy_names_are_the_16_renamed():
    """The legacy and the current VAE key lists differ in the 16
    attention names ``from_diffusers`` maps."""
    legacy, current = sd15_vae_keys(legacy_attn=True), sd15_vae_keys()
    differ = sorted(set(legacy) - set(current))
    assert len(differ) == 16
    assert sorted(from_diffusers(dict.fromkeys(differ, 0), "vae")) == \
        sorted(set(current) - set(legacy))


@pytest.fixture(scope="module")
def tiny():
    return tp.tiny_setup()


# (JAX params key, port module key, kind)
TINY = [("unet", "unet", "unet"), ("controlnet_0", "controlnet_0",
                                   "controlnet"),
        ("controlnet_1", "controlnet_1", "controlnet"), ("vae", "vae", "vae"),
        ("text_encoder", "text_encoder", "clip")]


def _port_module(models, key):
    if key.startswith("controlnet_"):
        return models["controlnets"][int(key[-1])]
    return models[key]


def _exported(params, kind: str) -> dict:
    """The JAX exporter's state dict as a released checkpoint names it:
    the VAE in the legacy attention names, CLIP with ``position_ids``."""
    sd = export_params(params, kind)
    if kind == "vae":
        sd = _legacy_vae(sd)
    if kind == "clip":
        sd["text_model.embeddings.position_ids"] = np.arange(
            77, dtype=np.int64)[None]
    return sd


@pytest.mark.parametrize("jkey, key, kind", TINY)
def test_exported_checkpoint_loads_as_from_jax_does(tiny, jkey, key, kind):
    """JAX ``export_params`` -> (legacy VAE names, ``position_ids``) ->
    ``load_pretrained`` into a freshly built tiny module: every tensor
    equals the ``from_jax`` load of the same params, bit for bit, and
    nothing is missing."""
    fresh = build_models(tiny["pcfg"], tiny=True, device="cpu")
    module = _port_module(fresh, key)
    assert load_pretrained(module, _exported(tiny["params"][jkey], kind),
                           kind) == []
    want = _port_module(tiny["pmodels"], key).state_dict()
    got = module.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_load_pretrained_refuses_a_shape_mismatch_and_an_unknown_key(tiny):
    vae = build_models(tiny["pcfg"], tiny=True, device="cpu")["vae"]
    sd = {k: v.clone() for k, v in vae.state_dict().items()}
    before = {k: v.clone() for k, v in sd.items()}
    bad = dict(sd, **{"decoder.conv_out.bias": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pretrained(vae, bad, "vae")
    extra = dict(sd, **{"decoder.extra.weight": torch.zeros(3)})
    with pytest.raises(KeyError, match="decoder.extra.weight"):
        load_pretrained(vae, extra, "vae")
    # nothing was copied by a refused load
    assert all(torch.equal(v, before[k]) for k, v in
               vae.state_dict().items())
    with pytest.raises(ValueError, match="kind"):
        load_pretrained(vae, sd, "vae_v2")


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"a.weight": torch.randn(3, 5, generator=g),
            "a.bias": torch.randn(5, generator=g).half(),
            "b.weight": torch.randn(2, 2, 3, 3, generator=g).bfloat16(),
            "c.ids": torch.arange(77, dtype=torch.int64)[None],
            "d.empty": torch.zeros(0, 4)}


@pytest.mark.parametrize("suffix", [".safetensors", ".bin", ".pt"])
def test_read_checkpoint_reads_safetensors_and_torch_files(tmp_path, suffix):
    """F32, F16, BF16 and I64 tensors (one of them empty), bit for bit
    and in their own dtypes, from a file the ``safetensors`` package or
    ``torch.save`` wrote."""
    path = str(tmp_path / f"model{suffix}")
    want = _tensors()
    if suffix == ".safetensors":
        from safetensors.torch import save_file

        save_file(want, path, metadata={"format": "pt"})
    else:
        torch.save(want, path)
    got = read_checkpoint(path)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k


def test_read_checkpoint_refuses_a_dtype_it_does_not_read(tmp_path):
    from safetensors.torch import save_file

    path = str(tmp_path / "f64.safetensors")
    save_file({"x": torch.zeros(2, dtype=torch.float64)}, path)
    with pytest.raises(ValueError, match="F64"):
        read_checkpoint(path)


def test_load_pretrained_dir_reads_the_diffusers_layout(tiny, tmp_path):
    """``tools/import_weights.py``'s layout: ``vae/`` (safetensors, legacy
    names), ``text_encoder/`` (``.bin``, with ``position_ids``), ``unet/``
    (safetensors) and ``controlnet_bg_1/`` for branch 0; branch 1 has no
    directory and is reported, keeping its weights."""
    from safetensors.torch import save_file

    files = {"vae": ("vae", "vae/diffusion_pytorch_model.safetensors"),
             "text_encoder": ("clip", "text_encoder/pytorch_model.bin"),
             "unet": ("unet", "unet/diffusion_pytorch_model.safetensors"),
             "controlnet_0": ("controlnet",
                              "controlnet_bg_1/model.safetensors")}
    for jkey, (kind, name) in files.items():
        sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
              _exported(tiny["params"][jkey], kind).items()}
        path = os.path.join(tmp_path, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if name.endswith(".bin"):
            torch.save(sd, path)
        else:
            save_file(sd, path)
    fresh = build_models(tiny["pcfg"], tiny=True, device="cpu")
    cn1 = {k: v.clone() for k, v in
           fresh["controlnets"][1].state_dict().items()}
    report = load_pretrained_dir(fresh, str(tmp_path))
    assert report["controlnet_1"] is None
    assert report["controlnet_0"]["file"].endswith(
        os.path.join("controlnet_bg_1", "model.safetensors"))
    for key in ("vae", "text_encoder", "unet", "controlnet_0"):
        assert report[key]["missing"] == [], key
        want = _port_module(tiny["pmodels"], key).state_dict()
        got = _port_module(fresh, key).state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), key
    assert all(torch.equal(v, cn1[k]) for k, v in
               fresh["controlnets"][1].state_dict().items())


def test_export_equals_the_jax_exporter_and_loads_back(tmp_path):
    """The flagship's tiny weights (both ControlNets): ``export_state_dicts``
    equals ``export_params`` of the same JAX params name for name and value;
    ``export_model`` writes ``controlnet_bg_1``, ``controlnet_bg_2`` and
    ``unet``, which ``load_pretrained_dir`` loads into a fresh model set
    with no unknown key, every tensor equal."""
    tiny = tp.tiny_setup()
    cfg = tp.port_config(tp.TINY_OVERRIDES + [f"log_root={tmp_path}"])
    h, w = cfg.dataset.image_size
    ds = SyntheticNuScenes(num_samples=1, image_size=(h, w), seed=0)
    trainer = MultiviewTrainer(cfg, ds, device="cpu",
                               models=copy.deepcopy(tiny["pmodels"]))
    got = trainer.export_state_dicts()
    assert set(got) == {"unet", "controlnet_0", "controlnet_1"}
    for key, sd in got.items():
        want = export_params(tiny["params"][key],
                             "unet" if key == "unet" else "controlnet")
        assert set(sd) == set(want), key
        for name, v in sd.items():
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), want[name],
                                          err_msg=name)
    root = trainer.export_model()
    fresh = build_models(cfg, tiny=True, device="cpu")
    report = load_pretrained_dir(fresh, root)
    assert report["controlnet_0"]["file"].endswith(
        "controlnet_bg_1/diffusion_pytorch_model.bin")
    assert report["controlnet_1"]["file"].endswith(
        "controlnet_bg_2/diffusion_pytorch_model.bin")
    for key in ("unet", "controlnet_0", "controlnet_1"):
        assert report[key]["missing"] == []
    nets = {"unet": fresh["unet"], "controlnet_0": fresh["controlnets"][0],
            "controlnet_1": fresh["controlnets"][1]}
    for key, module in nets.items():
        for name, v in module.state_dict().items():
            assert torch.equal(v, got[key][name]), (key, name)
