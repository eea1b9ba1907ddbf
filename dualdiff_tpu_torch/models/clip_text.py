"""CLIP ViT-L/14 text encoder (SD v1.5's frozen text tower), PyTorch.

Port of ``dualdiff_tpu/models/clip_text.py``, written in the package so the
port needs no ``transformers``.  quick-GELU, causal mask, final LayerNorm;
pooled output = hidden state at argmax(input_ids) (the EOT token).
Parameter names are those of ``transformers.CLIPTextModel``.  LayerNorm
outputs are float32, as in the JAX module, so the returned states are
float32 whatever the weights' dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import Linear
from .norms import LayerNorm

__all__ = ["CLIPTextModel"]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(hidden_size, hidden_size)
        self.k_proj = Linear(hidden_size, hidden_size)
        self.v_proj = Linear(hidden_size, hidden_size)
        self.out_proj = Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        h = self.num_heads
        d = c // h
        q = self.q_proj(x).reshape(b, l, h, d)
        k = self.k_proj(x).reshape(b, l, h, d)
        v = self.v_proj(x).reshape(b, l, h, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        logits = torch.where(mask, logits * d ** -0.5,
                             torch.full_like(logits, -1e9))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, l, c)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int):
        super().__init__()
        self.fc1 = Linear(hidden_size, intermediate_size)
        self.fc2 = Linear(intermediate_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden_size, out_dtype=torch.float32)
        self.self_attn = CLIPAttention(hidden_size, num_heads)
        self.layer_norm2 = LayerNorm(hidden_size, out_dtype=torch.float32)
        self.mlp = CLIPMLP(hidden_size, intermediate_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int,
                 max_position_embeddings: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, hidden_size)
        self.position_embedding = nn.Embedding(max_position_embeddings,
                                               hidden_size)


class CLIPEncoder(nn.Module):
    def __init__(self, num_layers: int, hidden_size: int, num_heads: int,
                 intermediate_size: int):
        super().__init__()
        self.layers = nn.ModuleList([
            CLIPLayer(hidden_size, num_heads, intermediate_size)
            for _ in range(num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, vocab_size, hidden_size, num_layers, num_heads,
                 max_position_embeddings, intermediate_size):
        super().__init__()
        self.embeddings = CLIPEmbeddings(vocab_size, hidden_size,
                                         max_position_embeddings)
        self.encoder = CLIPEncoder(num_layers, hidden_size, num_heads,
                                   intermediate_size)
        self.final_layer_norm = LayerNorm(hidden_size,
                                          out_dtype=torch.float32)


class CLIPTextModel(nn.Module):
    def __init__(self, vocab_size: int = 49408, hidden_size: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 max_position_embeddings: int = 77,
                 intermediate_size: int = 3072):
        super().__init__()
        self.text_model = CLIPTextTransformer(
            vocab_size, hidden_size, num_layers, num_heads,
            max_position_embeddings, intermediate_size)

    def forward(self, input_ids: torch.Tensor):
        """input_ids (B, L) -> (last_hidden_state (B, L, D) float32,
        pooled (B, D) float32)."""
        tm = self.text_model
        b, l = input_ids.shape
        ids = input_ids.long()
        x = tm.embeddings.token_embedding(ids)
        x = x + tm.embeddings.position_embedding.weight[None, :l].to(x.dtype)
        causal = torch.ones(l, l, dtype=torch.bool,
                            device=ids.device).tril()
        for layer in tm.encoder.layers:
            x = layer(x, causal)
        x = tm.final_layer_norm(x)
        pooled = x[torch.arange(b, device=ids.device), ids.argmax(dim=-1)]
        return x, pooled
