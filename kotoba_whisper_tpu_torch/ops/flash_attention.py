"""Encoder self-attention forward: kernel K1 (csrc/flash_attention.cu) and
its plain twin, both returning (O, LSE).

Non-causal softmax(q k^T / sqrt(D)) v over the whole key range, with O in
the input dtype and the fp32 natural-log logsumexp of each query row (the
residual a backward pass needs). Layout is the model's: q (B, Tq, H, D),
k/v (B, Tk, H, D), O (B, Tq, H, D), LSE (B, H, Tq).
"""
from __future__ import annotations

import torch

from kotoba_whisper_tpu_torch.ops import _build


def flash_attention_reference(q, k, v):
    """Plain twin: fp32 scores and softmax, LSE from torch.logsumexp."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / d**0.5), k.float())
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def flash_attention_fwd(q, k, v):
    """K1 wrapper: the kernel for CUDA tensors, the plain twin for CPU
    tensors. -> (O (B, Tq, H, D) in q.dtype, LSE (B, H, Tq) fp32)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention (K1) takes bfloat16, {name} is {t.dtype}")
        if t.ndim != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention takes contiguous (B, T, H, D) {name}")
    b, tq, h, d = q.shape
    if d != 64:
        raise ValueError(f"K1 is built for head dim 64, got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention shapes differ: q {q.shape}, k {k.shape}, v {v.shape}")
    tk = k.shape[1]
    if tq == 0 or tk == 0:
        raise ValueError("flash_attention needs at least one query and one key")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    rc = _build.library("flash_attention").kwt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, tq, tk, h, _build.stream_handle(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"K1 flash attention launch failed: cudaError {rc}")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v):
    """(B, Tq, H, D) x (B, Tk, H, D) -> (B, Tq, H, D); softmax(QK^T/sqrt(D))V."""
    return flash_attention_fwd(q, k, v)[0]
