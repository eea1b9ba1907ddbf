"""Key / shape lists of the SD v1.5 checkpoint family.

The port's own copy of ``dualdiff_tpu/runner/sd15_keys.py`` (a test keeps
the two equal).  Every key a released ``runwayml/stable-diffusion-v1-5``
diffusers checkpoint holds, with its torch shape, enumerated from the
diffusers model definitions at the v1.5 configuration
(``UNet2DConditionModel`` with block_out=(320,640,1280,1280),
layers_per_block=2, cross_attention_dim=768, use_linear_projection=False;
``AutoencoderKL`` with block_out=(128,256,512,512), layers_per_block=2,
latent=4; transformers ``CLIPTextModel``, the ViT-L/14 text tower).  The
port's loader (``runner/weights.py``) is tested against them, so a name
that a released checkpoint holds and the port would drop or misplace fails
on the CPU, with no download.
"""

from __future__ import annotations

from typing import Dict, Tuple

Shape = Tuple[int, ...]

__all__ = ["sd15_unet_keys", "sd15_vae_keys", "sd15_clip_keys"]


def _conv(name: str, o: int, i: int, k: int = 3) -> Dict[str, Shape]:
    return {f"{name}.weight": (o, i, k, k), f"{name}.bias": (o,)}


def _lin(name: str, o: int, i: int) -> Dict[str, Shape]:
    return {f"{name}.weight": (o, i), f"{name}.bias": (o,)}


def _norm(name: str, c: int) -> Dict[str, Shape]:
    return {f"{name}.weight": (c,), f"{name}.bias": (c,)}


def _resnet(p: str, i: int, o: int, time_dim: int = 0) -> Dict[str, Shape]:
    d = _norm(f"{p}.norm1", i)
    d.update(_conv(f"{p}.conv1", o, i))
    if time_dim:
        d.update(_lin(f"{p}.time_emb_proj", o, time_dim))
    d.update(_norm(f"{p}.norm2", o))
    d.update(_conv(f"{p}.conv2", o, o))
    if i != o:
        d.update(_conv(f"{p}.conv_shortcut", o, i, 1))
    return d


def _transformer(p: str, c: int, cross: int = 768) -> Dict[str, Shape]:
    d = _norm(f"{p}.norm", c)  # spatial group norm
    d.update(_conv(f"{p}.proj_in", c, c, 1))  # SD1.5: conv projection
    t = f"{p}.transformer_blocks.0"
    for n in ("norm1", "norm2", "norm3"):
        d.update(_norm(f"{t}.{n}", c))
    for a, kdim in (("attn1", c), ("attn2", cross)):
        d[f"{t}.{a}.to_q.weight"] = (c, c)
        d[f"{t}.{a}.to_k.weight"] = (c, kdim)
        d[f"{t}.{a}.to_v.weight"] = (c, kdim)
        d.update(_lin(f"{t}.{a}.to_out.0", c, c))
    d.update(_lin(f"{t}.ff.net.0.proj", 8 * c, c))  # GEGLU: 2 x 4c
    d.update(_lin(f"{t}.ff.net.2", c, 4 * c))
    d.update(_conv(f"{p}.proj_out", c, c, 1))
    return d


def sd15_unet_keys() -> Dict[str, Shape]:
    C = [320, 640, 1280, 1280]
    t_dim = 1280
    d = _conv("conv_in", 320, 4)
    d.update(_lin("time_embedding.linear_1", t_dim, 320))
    d.update(_lin("time_embedding.linear_2", t_dim, t_dim))

    skips = [320]  # conv_in output enters the skip stack
    prev = 320
    for bi, c in enumerate(C):
        for j in range(2):
            d.update(_resnet(f"down_blocks.{bi}.resnets.{j}",
                             prev if j == 0 else c, c, t_dim))
            if bi < 3:  # block 3 is DownBlock2D (no attention)
                d.update(_transformer(f"down_blocks.{bi}.attentions.{j}", c))
            skips.append(c)
        if bi < 3:
            d.update(_conv(f"down_blocks.{bi}.downsamplers.0.conv", c, c))
            skips.append(c)
        prev = c

    d.update(_resnet("mid_block.resnets.0", 1280, 1280, t_dim))
    d.update(_transformer("mid_block.attentions.0", 1280))
    d.update(_resnet("mid_block.resnets.1", 1280, 1280, t_dim))

    prev = 1280
    for bi, c in enumerate(C[::-1]):
        for j in range(3):
            skip = skips.pop()
            d.update(_resnet(f"up_blocks.{bi}.resnets.{j}",
                             (prev if j == 0 else c) + skip, c, t_dim))
            if bi > 0:  # block 0 is UpBlock2D (no attention)
                d.update(_transformer(f"up_blocks.{bi}.attentions.{j}", c))
        if bi < 3:
            d.update(_conv(f"up_blocks.{bi}.upsamplers.0.conv", c, c))
        prev = c
    assert not skips

    d.update(_norm("conv_norm_out", 320))
    d.update(_conv("conv_out", 4, 320))
    return d


def _vae_attn(p: str, c: int, legacy: bool) -> Dict[str, Shape]:
    """diffusers renamed the VAE attention params (query/key/value/proj_attn
    -> to_q/to_k/to_v/to_out.0) in the 0.15 attention refactor; original
    SD v1.5 dumps on the hub carry the legacy names."""
    d = _norm(f"{p}.group_norm", c)
    if legacy:
        for n in ("query", "key", "value"):
            d.update(_lin(f"{p}.{n}", c, c))
        d.update(_lin(f"{p}.proj_attn", c, c))
    else:
        for n in ("to_q", "to_k", "to_v"):
            d.update(_lin(f"{p}.{n}", c, c))
        d.update(_lin(f"{p}.to_out.0", c, c))
    return d


def sd15_vae_keys(legacy_attn: bool = False) -> Dict[str, Shape]:
    C = [128, 256, 512, 512]
    d = _conv("encoder.conv_in", 128, 3)
    prev = 128
    for bi, c in enumerate(C):
        for j in range(2):
            d.update(_resnet(f"encoder.down_blocks.{bi}.resnets.{j}",
                             prev if j == 0 else c, c))
        if bi < 3:
            d.update(_conv(f"encoder.down_blocks.{bi}.downsamplers.0.conv",
                           c, c))
        prev = c
    d.update(_resnet("encoder.mid_block.resnets.0", 512, 512))
    d.update(_vae_attn("encoder.mid_block.attentions.0", 512, legacy_attn))
    d.update(_resnet("encoder.mid_block.resnets.1", 512, 512))
    d.update(_norm("encoder.conv_norm_out", 512))
    d.update(_conv("encoder.conv_out", 8, 512))  # 2 x latent (mean, logvar)

    d.update(_conv("decoder.conv_in", 512, 4))
    d.update(_resnet("decoder.mid_block.resnets.0", 512, 512))
    d.update(_vae_attn("decoder.mid_block.attentions.0", 512, legacy_attn))
    d.update(_resnet("decoder.mid_block.resnets.1", 512, 512))
    prev = 512
    for bi, c in enumerate(C[::-1]):
        for j in range(3):
            d.update(_resnet(f"decoder.up_blocks.{bi}.resnets.{j}",
                             prev if j == 0 else c, c))
        if bi < 3:
            d.update(_conv(f"decoder.up_blocks.{bi}.upsamplers.0.conv", c, c))
        prev = c
    d.update(_norm("decoder.conv_norm_out", 128))
    d.update(_conv("decoder.conv_out", 3, 128))

    d.update(_conv("quant_conv", 8, 8, 1))
    d.update(_conv("post_quant_conv", 4, 4, 1))
    return d


def sd15_clip_keys(with_position_ids: bool = False) -> Dict[str, Shape]:
    d: Dict[str, Shape] = {
        "text_model.embeddings.token_embedding.weight": (49408, 768),
        "text_model.embeddings.position_embedding.weight": (77, 768),
    }
    if with_position_ids:  # buffer in older transformers dumps; ignored
        d["text_model.embeddings.position_ids"] = (1, 77)
    for i in range(12):
        p = f"text_model.encoder.layers.{i}"
        for n in ("k_proj", "v_proj", "q_proj", "out_proj"):
            d.update(_lin(f"{p}.self_attn.{n}", 768, 768))
        d.update(_norm(f"{p}.layer_norm1", 768))
        d.update(_lin(f"{p}.mlp.fc1", 3072, 768))
        d.update(_lin(f"{p}.mlp.fc2", 768, 3072))
        d.update(_norm(f"{p}.layer_norm2", 768))
    d.update(_norm("text_model.final_layer_norm", 768))
    return d
