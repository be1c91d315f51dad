"""Plain multi-head attention (the XLA path of the JAX package).

Inputs are (B, T, H, D) per-head tensors; the 1/sqrt(D) scale is applied
to q in the input dtype, scores and softmax are fp32, and the
probabilities are cast back to the input dtype before the PV product.
Products run on fp32 copies of the operands: a product of two bf16 values
is exact in fp32, so this matches bf16 operands with fp32 accumulation.
Used for the decoder's full-sequence mode and its prompt prefill; the
encoder's unmasked self-attention goes through ops/flash_attention.py.
"""
from __future__ import annotations

import torch


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = False,
) -> torch.Tensor:
    """(B, Tq, H, D), (B, Tk, H, D) -> (B, Tq, H, D).

    mask: optional boolean broadcastable to (B, H, Tq, Tk); True = attend.
    """
    in_dtype = q.dtype
    d = q.shape[-1]
    scale = torch.tensor(1.0 / (d**0.5), dtype=in_dtype)
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", (q * scale).float(), k.float()
    )
    if causal:
        tq, tk = scores.shape[-2], scores.shape[-1]
        causal_mask = (
            torch.arange(tk, device=q.device)[None, :]
            <= torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        )
        scores = scores.masked_fill(~causal_mask, float("-inf"))
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(in_dtype).float(), v.float())
    return out.to(in_dtype)
