"""Building blocks of the SD v1.5 UNet / ControlNet family, in PyTorch.

Port of ``dualdiff_tpu/models/layers.py`` (inference parts).  Parameter
names follow the diffusers names that the JAX package's weight exporter
emits, so ``runner/weights.py`` output loads with ``strict=True``.

* Convolutions run NCHW; transformer blocks take ``(B', L, C)`` tokens.
* The compute dtype is the parameters' dtype.  ``Linear`` and ``Conv2d``
  cast their input to it, as flax's ``Dense``/``Conv`` with ``dtype`` do.
* Heads default to 8 with head_dim = channels // 8 (diffusers SD v1.5:
  ``attention_head_dim=8`` is the head count).
* ``capture(model)`` is the explore mode (the JAX package's
  ``apply(..., mutable=["intermediates"])``): inside it every
  ``Attention`` of ``model`` takes the explicit float32 softmax and records
  its probabilities, attn4 leaves the camera-ring kernel for the stacked
  neighbour form, and the UNet records its block outputs.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import (attention_packed, attention_packed_neighbors,
                             multi_head_attention)
from ..ops.fourier import timestep_embedding
from ..parallel.collectives import Split, as_split, gather
from .norms import GroupNorm, LayerNorm

__all__ = ["Linear", "Conv2d", "zero_module", "TimestepEmbedding",
           "ResnetBlock2D", "Downsample2D", "Upsample2D", "Attention",
           "GEGLUFeedForward", "GatedConnector", "BasicTransformerBlock",
           "Transformer2DModel", "get_timestep_embedding", "is_camera_ring",
           "remat_call", "capture", "jax_path", "ATTN4_TYPES",
           "CONNECTOR_TYPES"]

# attn4 forms and connector types of the JAX package's BasicTransformerBlock
ATTN4_TYPES = ("add", "concat", "self")
CONNECTOR_TYPES = ("zero_linear", "gated", "none")


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


def zero_module(m: nn.Module) -> nn.Module:
    """Zero-initialise every parameter (the JAX package's zero-init leaves:
    attn4 connector, ControlNet zero convs, conditioning ``conv_out``)."""
    for p in m.parameters():
        nn.init.zeros_(p)
    return m


class TimestepEmbedding(nn.Module):
    """linear -> silu -> linear (diffusers ``TimestepEmbedding``)."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(min(groups, in_channels), in_channels, eps)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = Linear(temb_dim, out_channels)
        self.norm2 = GroupNorm(min(groups, out_channels), out_channels, eps)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        dtype = self.conv1.weight.dtype
        h = self.conv1(F.silu(self.norm1(x)).to(dtype))
        t = self.time_emb_proj(F.silu(temb.to(dtype)))
        h = self.norm2(h + t[:, :, None, None])
        h = self.conv2(F.silu(h).to(dtype))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor,
                target_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Nearest 2x, or to ``target_hw`` when the encoder produced odd
        sizes.  ``nearest-exact`` (half-pixel centres) is what
        ``jax.image.resize(..., "nearest")`` computes; torch's ``nearest``
        differs at the 4->7 and 7->14 resizes of the 224x400 UNet."""
        h, w = x.shape[2:]
        size = tuple(target_hw) if target_hw is not None else (2 * h, 2 * w)
        return self.conv(F.interpolate(x, size=size, mode="nearest-exact"))


def jax_path(name: str) -> str:
    """A submodule's ``named_modules`` name -> its path in the JAX
    package's trees: ``down_blocks.0.attentions.1`` ->
    ``down_blocks_0/attentions_1`` (a list index joins its list's
    name)."""
    out = []
    for part in name.split(".") if name else []:
        if part.isdigit() and out:
            out[-1] += f"_{part}"
        else:
            out.append(part)
    return "/".join(out)


@contextlib.contextmanager
def capture(model: nn.Module) -> Iterator[Dict[str, torch.Tensor]]:
    """Explore mode on ``model`` for the block: yields the dict its
    forwards record into, keyed as the JAX package's flattened
    ``intermediates`` collection (``jax_path`` of the module, then the
    ``sow`` name): every ``Attention``'s ``.../attn_probs``, float32
    (B', H, Lq, Lk), and a UNet's ``down_block_<i>_out``,
    ``mid_block_out`` and ``up_block_<i>_out`` in its NCHW layout.
    Outside the block the modules run as before: the same kernels, the
    same launches."""
    store: Dict[str, torch.Tensor] = {}
    subs = [(name, m) for name, m in model.named_modules()
            if hasattr(m, "_capture")]
    for name, m in subs:
        m._capture = (store, jax_path(name))
    try:
        yield store
    finally:
        for _, m in subs:
            m._capture = None


def record(module: nn.Module, name: str, value: torch.Tensor) -> None:
    """Into the dict of ``capture``, under the module's path and
    ``name``."""
    store, path = module._capture
    store[f"{path}/{name}" if path else name] = value


class Attention(nn.Module):
    """Multi-head attention with separate q / kv dims (diffusers
    ``Attention``), channel-packed.

    ``lora_rank > 0`` (DualDiff+ RGD stage 2) adds a LoRA adapter to each
    projection, as the JAX package's ``Attention._proj``: ``W x + B(A x)``
    with bias-free ``<proj>_lora_a`` (rank x in) and ``<proj>_lora_b``
    (out x rank, zero at init), no rank scale.  The output projection's
    adapters are ``to_out_0_lora_a`` / ``to_out_0_lora_b`` (the JAX
    exporter's ``to_out.0_lora_a`` is no path inside ``to_out``, a
    ``ModuleList``).

    ``box_adapter`` (the decoupled box cross-attention of
    ``+exp=occ_bg_adapter``, ControlNets only): a call with
    ``num_box_tokens = M > 0`` splits its K/V tokens into ``[text | box
    (M) | cls (M)]``.  The text tokens go through the packed attention as
    usual; ``to_k_box`` / ``to_v_box`` project the box tokens and
    ``to_k_cls`` / ``to_v_cls`` the class tokens; the box K and V each add
    their attention over the class K/V, and the queries' attention over the
    box K/V is added to the text attention's output before ``to_out`` (the
    JAX package's ``box_scale``, 1.0 in every config).  Padded boxes are
    null-feature tokens and take part in every softmax, as in the JAX
    package.

    Under ``capture`` a call that is not the camera ring computes its
    text (or self) attention as the JAX explore path does
    (``layers.py:177-187``): float32 logits scaled by ``head_dim**-0.5``,
    softmax, recorded as ``attn_probs`` (B', H, Lq, Lk), and
    ``probs.to(v.dtype) @ v``."""

    def __init__(self, query_dim: int, heads: int = 8,
                 kv_dim: Optional[int] = None, lora_rank: int = 0,
                 box_adapter: bool = False):
        super().__init__()
        self._capture = None
        self.heads = heads
        self.lora_rank = lora_rank
        kv_dim = kv_dim or query_dim
        self.to_q = Linear(query_dim, query_dim, bias=False)
        self.to_k = Linear(kv_dim, query_dim, bias=False)
        self.to_v = Linear(kv_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([Linear(query_dim, query_dim)])
        self.box_adapter = box_adapter
        if box_adapter:
            for proj in ("to_k_box", "to_v_box", "to_k_cls", "to_v_cls"):
                setattr(self, proj, Linear(kv_dim, query_dim, bias=False))
        if lora_rank:
            for proj, d_in in (("to_q", query_dim), ("to_k", kv_dim),
                               ("to_v", kv_dim), ("to_out_0", query_dim)):
                setattr(self, f"{proj}_lora_a",
                        Linear(d_in, lora_rank, bias=False))
                setattr(self, f"{proj}_lora_b", zero_module(
                    Linear(lora_rank, query_dim, bias=False)))

    def _proj(self, proj: str, layer: nn.Module,
              x: torch.Tensor) -> torch.Tensor:
        out = layer(x)
        if self.lora_rank:
            a = getattr(self, f"{proj}_lora_a")(x)
            out = out + getattr(self, f"{proj}_lora_b")(a)
        return out

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                ring_views: int = 0, num_box_tokens: int = 0,
                ring_view0: int = 0) -> torch.Tensor:
        """``ring_views=N``: attn4 camera-ring mode.  The leading dim folds
        (batch, view); each view attends to its left and right neighbors
        with neighbor selection inside the kernel, so K/V projections run
        once per view.  Under a view split ``hidden_states`` holds a rank's
        views ``ring_view0 ..`` of each sample and
        ``encoder_hidden_states`` all N views (gathered), whose K/V the
        ring reads.  ``num_box_tokens``: the box adapter's split (see the
        class)."""
        kv = hidden_states if encoder_hidden_states is None \
            else encoder_hidden_states
        adapter = self.box_adapter and num_box_tokens > 0 \
            and encoder_hidden_states is not None
        if adapter:
            n_txt = kv.shape[1] - 2 * num_box_tokens
            box_tok = kv[:, n_txt:n_txt + num_box_tokens]
            cls_tok = kv[:, n_txt + num_box_tokens:]
            kv = kv[:, :n_txt]
        q = self._proj("to_q", self.to_q, hidden_states)
        k = self._proj("to_k", self.to_k, kv)
        v = self._proj("to_v", self.to_v, kv)
        if ring_views:
            out = attention_packed_neighbors(q, k, v, self.heads, ring_views,
                                             view0=ring_view0)
        elif self._capture is not None:
            out = self._explore(q, k, v)
        else:
            out = attention_packed(q, k, v, self.heads)
        if adapter:
            out = out + self._box_attention(q, box_tok, cls_tok)
        return self._proj("to_out_0", self.to_out[0], out)

    def _explore(self, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
        """The capture path's attention, recording its probabilities."""
        b, lq, c = q.shape
        d = c // self.heads
        split = lambda t: t.reshape(t.shape[0], t.shape[1], self.heads, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", split(q).float(),
                              split(k).float()) * (d ** -0.5)
        probs = torch.softmax(logits, dim=-1)
        record(self, "attn_probs", probs)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype),
                            split(v)).reshape(b, lq, c)

    def _box_attention(self, q: torch.Tensor, box_tok: torch.Tensor,
                       cls_tok: torch.Tensor) -> torch.Tensor:
        """The queries' attention over the box K/V enriched by the class
        K/V, (B, Lq, C).  Every length here is ``bbox_max_length`` or the
        queries', so ``multi_head_attention`` takes einsum."""
        b, lq, c = q.shape
        split = lambda t: t.reshape(t.shape[0], t.shape[1], self.heads,
                                    c // self.heads)
        bk, bv = split(self.to_k_box(box_tok)), split(self.to_v_box(box_tok))
        ck, cv = split(self.to_k_cls(cls_tok)), split(self.to_v_cls(cls_tok))
        bk = bk + multi_head_attention(bk, ck, cv)
        bv = bv + multi_head_attention(bv, ck, cv)
        return multi_head_attention(split(q), bk, bv).reshape(b, lq, c)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        # flax nn.gelu defaults to the tanh approximation
        return h * F.gelu(gate.float(), approximate="tanh").to(h.dtype)


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # diffusers layout: net.0 = GEGLU, net.1 = dropout, net.2 = out
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class GatedConnector(nn.Module):
    """``tanh(alpha) * x`` with ``alpha`` of shape ``(dim,)``, zero at init
    (the JAX package's ``GatedConnector``, attn4's ``gated`` connector)."""

    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.alpha).to(x.dtype) * x


def is_camera_ring(pairs: Optional[Sequence[Sequence[int]]],
                   n_cam: int) -> bool:
    return pairs is not None and len(pairs) == n_cam and all(
        tuple(pairs[i]) == ((i - 1) % n_cam, (i + 1) % n_cam)
        for i in range(n_cam))


def _connector(kind: str, dim: int) -> Optional[nn.Module]:
    if kind == "zero_linear":
        return zero_module(Linear(dim, dim))
    if kind == "gated":
        return GatedConnector(dim)
    if kind == "none":
        return None
    raise ValueError(f"zero_module_type {kind!r}: one of {CONNECTOR_TYPES}")


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> (multiview attn4 + connector) ->
    (temporal attn + connector) -> FF.

    attn4 (the JAX package's ``_multiview_attn``), by
    ``neighboring_attn_type``:

    * ``add``: each view attends to its two neighbours
      (``neighboring_view_pair``) and the two outputs are summed.  On the
      camera ring, outside ``capture``, that is the ring kernel
      (``attention_packed_neighbors``); over other pairs, and on the ring
      under ``capture`` (the JAX explore path), the left and right
      neighbours' tokens are gathered and one attention runs the stacked
      ``[q; q]`` over ``[kv_left; kv_right]``, its halves summed;
    * ``concat``: each view attends to ``[kv_left | kv_right]`` (2L keys);
    * ``self``: one attention over all ``n_cam * L`` tokens of a sample.

    Its output goes through the connector ``zero_module_type``: a zero-init
    linear (``zero_linear``), ``tanh(alpha) * x`` (``gated``) or nothing
    (``none``).

    Video hooks (DualDiff+), active when ``num_frames > 1``; the leading dim
    then folds (clip, frame, camera), frame outer, camera inner:

    * ``st_attn``: attn1's K/V are ``[first frame; previous frame]`` of
      ``norm1``'s output, from the same view (frame 0 takes itself twice);
    * ``temporal``: ``norm_temporal`` -> ``attn_temporal`` over the frame
      axis, per (view, pixel) -> the zero-init ``temporal_connector`` ->
      residual, after attn4 and before the feed-forward.

    ``lora_rank``: LoRA adapters on attn1 and attn2 only (RGD stage 2).
    ``box_adapter``: attn2 carries the decoupled box cross-attention
    (``Attention``), split by the forward's ``num_box_tokens``."""

    def __init__(self, dim: int, heads: int = 8,
                 cross_attention_dim: int = 768, multiview: bool = False,
                 st_attn: bool = False, temporal: bool = False,
                 num_frames: int = 1, lora_rank: int = 0,
                 box_adapter: bool = False,
                 neighboring_view_pair: Optional[
                     Sequence[Sequence[int]]] = None,
                 neighboring_attn_type: str = "add",
                 zero_module_type: str = "zero_linear"):
        super().__init__()
        if neighboring_attn_type not in ATTN4_TYPES:
            raise ValueError(f"neighboring_attn_type "
                             f"{neighboring_attn_type!r}: one of "
                             f"{ATTN4_TYPES}")
        if multiview and neighboring_attn_type != "self" and \
                neighboring_view_pair is None:
            raise ValueError(f"attn4 {neighboring_attn_type!r} attends over "
                             "neighboring_view_pair, which is None")
        self.multiview = multiview
        self.neighboring_view_pair = neighboring_view_pair
        self.neighboring_attn_type = neighboring_attn_type
        self.st_attn = st_attn and num_frames > 1
        self.temporal = temporal and num_frames > 1
        self.num_frames = num_frames
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, lora_rank=lora_rank)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, kv_dim=cross_attention_dim,
                               lora_rank=lora_rank, box_adapter=box_adapter)
        if multiview:
            self.norm4 = LayerNorm(dim)
            self.attn4 = Attention(dim, heads)
            self.connector = _connector(zero_module_type, dim)
        if self.temporal:
            self.norm_temporal = LayerNorm(dim)
            self.attn_temporal = Attention(dim, heads)
            self.temporal_connector = zero_module(Linear(dim, dim))
        self.norm3 = LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                n_cam=1, num_box_tokens: int = 0) -> torch.Tensor:
        """``n_cam``: the cameras of a sample, or this rank's ``Split``
        under a mesh (``parallel/collectives.py``): its rows are then its
        cameras of its samples, and attn4, ST-Attn and the temporal
        attention gather the rows they read from the ranks that hold
        them."""
        split = as_split(n_cam)
        h = hidden_states
        norm_h = self.norm1(h)
        kv = self._st_attn_kv(norm_h, split) if self.st_attn else None
        h = h + self.attn1(norm_h, kv)
        h = h + self.attn2(self.norm2(h), encoder_hidden_states,
                           num_box_tokens=num_box_tokens)
        if self.multiview:
            out = self._multiview_attn(self.norm4(h), split)
            h = h + (out if self.connector is None else self.connector(out))
        if self.temporal:
            h = h + self.temporal_connector(
                self._temporal_attn(self.norm_temporal(h), split))
        return h + self.ff(self.norm3(h))

    def _multiview_attn(self, norm_h: torch.Tensor,
                        split: Split) -> torch.Tensor:
        """attn4 on (B*n, L, C) tokens, by ``neighboring_attn_type``, ``n``
        the cameras here.  K/V read every view of each sample: under a
        view split the other ranks' views come from a ``gather`` over the
        view group (the normed states; each rank projects K/V of every
        view), and every camera index (``neighboring_view_pair``, the
        ring) is global."""
        n, n_all, view0 = split.n_local, split.n_cam, split.view0
        bn, l, c = norm_h.shape
        b = bn // n
        full = gather(norm_h.reshape(b, n, l, c), split.view_group, 1)
        if self.neighboring_attn_type == "self":
            return self.attn4(norm_h.reshape(b, n * l, c),
                              full.reshape(b, n_all * l, c)).reshape(bn, l, c)
        pairs = self.neighboring_view_pair
        if self.neighboring_attn_type == "add" and self.attn4._capture is \
                None and is_camera_ring(pairs, n_all):
            return self.attn4(norm_h, full.reshape(b * n_all, l, c),
                              ring_views=n_all, ring_view0=view0)
        take = lambda side: full[:, [pairs[view0 + i][side]
                                     for i in range(n)]].reshape(bn, l, c)
        kv_left, kv_right = take(0), take(1)
        if self.neighboring_attn_type == "add":
            out2 = self.attn4(torch.cat([norm_h, norm_h]),
                              torch.cat([kv_left, kv_right]))
            return out2[:bn] + out2[bn:]
        return self.attn4(norm_h, torch.cat([kv_left, kv_right], dim=1))

    def _frames(self, norm_h: torch.Tensor, split: Split):
        """-> (this rank's frames (rows, n, L, C), every frame of the clips
        they belong to (total, n, L, C): under a frame split gathered from
        the frame group, the index of this rank's first frame there)."""
        x = norm_h.reshape(-1, split.n_local, *norm_h.shape[1:])
        j0, _ = split.clip_rows(x.shape[0], self.num_frames)
        return x, gather(x, split.frame_group, 0), j0

    def _st_attn_kv(self, norm_h: torch.Tensor, split: Split) -> torch.Tensor:
        """(B', L, C) -> (B', 2L, C): per row, the first frame's tokens then
        the previous frame's, of the same view, read from the clip's
        frames (``_frames``: under a frame split the first local frame's
        previous frame lives on the rank to the left)."""
        bfn, l, c = norm_h.shape
        f = self.num_frames
        x, full, j0 = self._frames(norm_h, split)
        rows = range(j0, j0 + x.shape[0])
        first = full[[j - j % f for j in rows]]
        prev = full[[j - (j % f > 0) for j in rows]]
        return torch.cat([first, prev], dim=2).reshape(bfn, 2 * l, c)

    def _temporal_attn(self, norm_h: torch.Tensor,
                       split: Split) -> torch.Tensor:
        """Self-attention over the frame axis, per (clip, view, token).
        The whole clips here run as one call; under a frame split a part
        of a clip at either end of this rank's frames runs its queries
        over all the clip's frames, gathered from the frame group."""
        bfn, l, c = norm_h.shape
        f = self.num_frames
        x, full, j0 = self._frames(norm_h, split)
        n, end = x.shape[1], j0 + x.shape[0]
        a = min(end, -(-j0 // f) * f)  # the whole clips here: [a, e)
        e = max(a, end - end % f)
        per_view = lambda t: t.permute(1, 2, 0, 3).reshape(n * l, -1, c)

        def part(s, t):  # frames [s, t) of one clip
            o = self.attn_temporal(per_view(x[s - j0:t - j0]),
                                   per_view(full[s - s % f:s - s % f + f]))
            return o.reshape(n, l, t - s, c).permute(2, 0, 1, 3)

        outs = [part(j0, a)] if j0 < a else []
        if a < e:
            k = (e - a) // f
            t = x[a - j0:e - j0].reshape(k, f, n, l, c).permute(0, 2, 3, 1, 4)
            o = self.attn_temporal(t.reshape(-1, f, c))
            outs.append(o.reshape(k, n, l, f, c).permute(0, 3, 1, 2, 4)
                        .reshape(k * f, n, l, c))
        if e < end:
            outs.append(part(e, end))
        return torch.cat(outs).reshape(bfn, l, c)


class Transformer2DModel(nn.Module):
    """GroupNorm -> 1x1 conv in -> transformer block(s) -> 1x1 conv out,
    plus the residual.  NCHW in and out."""

    def __init__(self, channels: int, heads: int = 8,
                 cross_attention_dim: int = 768, num_layers: int = 1,
                 multiview: bool = False, st_attn: bool = False,
                 temporal: bool = False, num_frames: int = 1,
                 lora_rank: int = 0, box_adapter: bool = False,
                 **attn4):
        """``attn4``: ``BasicTransformerBlock``'s ``neighboring_view_pair``,
        ``neighboring_attn_type`` and ``zero_module_type``."""
        super().__init__()
        self.norm = GroupNorm(min(32, channels), channels, eps=1e-6)
        self.proj_in = Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, cross_attention_dim,
                                  multiview, st_attn, temporal, num_frames,
                                  lora_rank, box_adapter, **attn4)
            for _ in range(num_layers)])
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, encoder_hidden_states: torch.Tensor,
                n_cam=1, num_box_tokens: int = 0) -> torch.Tensor:
        b, c, h, w = x.shape
        hs = self.proj_in(self.norm(x))
        hs = hs.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            hs = block(hs, encoder_hidden_states, n_cam, num_box_tokens)
        hs = hs.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(hs) + x


def remat_call(enabled: bool, min_tokens: int, block: nn.Module,
               x: torch.Tensor, *args):
    """``block(x, *args)``, rematerialised in the backward (gradient
    checkpointing, the JAX package's per-block ``nn.remat``) when
    ``enabled``, grad is on and the block's input has at least
    ``min_tokens`` spatial tokens."""
    if enabled and torch.is_grad_enabled() \
            and x.shape[-2] * x.shape[-1] >= min_tokens:
        return checkpoint(block, x, *args, use_reentrant=False)
    return block(x, *args)


def get_timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """SD v1.5 sinusoidal projection (flip_sin_to_cos=True, shift=0)."""
    return timestep_embedding(timesteps, dim, flip_sin_to_cos=True)
