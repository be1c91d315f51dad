"""Inference-time projection fusion, as the JAX package's
`models/optimized.py` does it:

  - self-attention q/k/v -> one (d -> 3d) `qkv_proj`,
  - cross-attention k/v -> one (d -> 2d) `kv_proj` (run once per utterance
    when the cache is built).

The model functions in models/whisper.py take the fused entries wherever
they are present. The transform is lossless (pure concatenation). It
rewrites the model in place (the fused weights replace the separate ones,
so a large-v3 model never holds both) and returns it.
"""
from __future__ import annotations

import torch
from torch import nn


def _fuse(attn: nn.Module, names: tuple[str, ...], out_name: str) -> None:
    parts = [getattr(attn, n) for n in names]
    w = torch.cat([p.weight for p in parts], dim=0)
    # k_proj has no bias in Whisper: its slot in the fused bias is zero, so
    # the fused projection keeps one bias add
    b = torch.cat([
        p.bias if p.bias is not None else torch.zeros(
            p.out_features, dtype=w.dtype, device=w.device)
        for p in parts
    ])
    fused = nn.Linear(w.shape[1], w.shape[0], device="meta")
    fused.weight = nn.Parameter(w, requires_grad=False)
    fused.bias = nn.Parameter(b, requires_grad=False)
    for n in names:
        delattr(attn, n)
    setattr(attn, out_name, fused)


def fuse_attention(attn: nn.Module, *, cross: bool) -> None:
    if cross:
        _fuse(attn, ("k_proj", "v_proj"), "kv_proj")
    else:
        _fuse(attn, ("q_proj", "k_proj", "v_proj"), "qkv_proj")


@torch.no_grad()
def fuse_for_inference(model):
    """Fuse every layer's projections in place; returns the model."""
    for layer in model.model.encoder.layers:
        fuse_attention(layer.self_attn, cross=False)
    for layer in model.model.decoder.layers:
        fuse_attention(layer.self_attn, cross=False)
        fuse_attention(layer.encoder_attn, cross=True)
    return model
