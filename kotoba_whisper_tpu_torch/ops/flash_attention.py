"""Flash attention: the forward kernels K1 (non-causal) and K4 (causal) in
csrc/flash_attention.cu, the backward kernel pair K5 in
csrc/flash_attention_bwd.cu, their plain twins, and the
`FlashAttention` autograd function that ties them together.

softmax(q k^T / sqrt(D)) v with O in the input dtype and the fp32
natural-log logsumexp of each query row (the residual the backward pass
needs). Causal attention is end-aligned: query row i sees keys
j <= i + (Tk - Tq); the public `flash_attention` takes it only with
Tq == Tk, as the JAX package does. Layout is the model's: q (B, Tq, H, D),
k/v (B, Tk, H, D), O (B, Tq, H, D), LSE (B, H, Tq).

Each wrapper launches its kernel for CUDA tensors (bf16, D = 64) and
takes its plain twin only for CPU tensors.
"""
from __future__ import annotations

import torch

from kotoba_whisper_tpu_torch.ops import _build


def _scores(q, k, causal):
    """fp32 scores of q pre-scaled by 1/sqrt(D) in its own dtype (the JAX
    package's `_scale_exact` fold: 1/8 is exact in bf16 and fp32), with
    the end-aligned causal mask applied as -inf."""
    d = q.shape[-1]
    qs = q * torch.tensor(1.0 / d**0.5, dtype=q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        above = (torch.arange(tk, device=q.device)[None, :]
                 > torch.arange(tq, device=q.device)[:, None] + (tk - tq))
        s = s.masked_fill(above, float("-inf"))
    return qs, s


def flash_attention_reference(q, k, v, causal=False):
    """Plain twin of K1/K4: fp32 scores and softmax, LSE from
    torch.logsumexp. -> (O in q.dtype, LSE (B, H, Tq) fp32)."""
    _, s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype), lse


def _check_bf16(**tensors):
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention kernels take bfloat16, {name} is {t.dtype}")
        if t.ndim != 4 or not t.is_contiguous():
            raise ValueError(f"flash attention takes contiguous (B, T, H, D) {name}")


def _check_shapes(q, k, v):
    b, tq, h, d = q.shape
    if d != 64:
        raise ValueError(f"the flash attention kernels are built for head dim 64, got {d}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention shapes differ: q {q.shape}, k {k.shape}, v {v.shape}")
    if tq == 0 or k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one query and one key")
    return b, tq, k.shape[1], h


def flash_attention_fwd(q, k, v, *, causal=False):
    """K1 (causal=False) / K4 (causal=True) wrapper: the kernel for CUDA
    tensors, the plain twin for CPU tensors.
    -> (O (B, Tq, H, D) in q.dtype, LSE (B, H, Tq) fp32)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal)
    _check_bf16(q=q, k=k, v=v)
    b, tq, tk, h = _check_shapes(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    rc = _build.library("flash_attention").kwt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, tq, tk, h, int(causal), _build.stream_handle(q.device),
    )
    name = "K4" if causal else "K1"
    if rc != 0:
        raise RuntimeError(f"{name} flash attention launch failed: cudaError {rc}")
    if causal:
        flash_attention_fwd.causal_launches += 1
    else:
        flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0          # K1
flash_attention_fwd.causal_launches = 0   # K4


def attention_delta(o, do):
    """D = rowsum(dO * O) in fp32, (B, H, Tq): computed outside the
    kernels, as the JAX package computes it in XLA."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, causal):
    """Plain twin of K5, step by step in fp32 in the order of the JAX
    package's `_bwd_dq_kernel` and `_bwd_dkv_kernel` (not autograd): P from
    the saved LSE, dP = dO V^T, dS = P (dP - D); P and dS are cast to the
    input dtype before their products, and dQ is multiplied by the scale
    at the end. -> (dQ, dK, dV) in q's, k's and v's dtypes."""
    in_dtype = q.dtype
    scale = 1.0 / q.shape[-1] ** 0.5
    qs, s = _scores(q, k, causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - attention_delta(o, do)[..., None])).to(in_dtype).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(in_dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal):
    """K5 wrapper (dQ kernel, then dK/dV kernel): the kernels for CUDA
    tensors, the plain twin for CPU tensors. -> (dQ, dK, dV)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
    _check_bf16(q=q, k=k, v=v, o=o, do=do)
    b, tq, tk, h = _check_shapes(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"K5: o {o.shape} and do {do.shape} must match q {q.shape}")
    if lse.shape != (b, h, tq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"K5 takes a contiguous fp32 (B, H, Tq) lse, got {lse.dtype} {lse.shape}")
    delta = attention_delta(o, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = _build.library("flash_attention_bwd").kwt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, tq, tk, h, int(causal), _build.stream_handle(q.device),
    )
    if rc != 0:
        raise RuntimeError(f"K5 flash attention backward launch failed: cudaError {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0  # K5 (calls; each launches two kernels)


class FlashAttention(torch.autograd.Function):
    """Forward through K1/K4, backward through K5; saves (q, k, v, O, LSE)
    as the JAX package's custom_vjp does."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(), causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal=False):
    """(B, Tq, H, D) x (B, Tk, H, D) -> (B, Tq, H, D); softmax(QK^T/sqrt(D))V,
    differentiable. causal requires Tq == Tk (the model's only causal use,
    decoder self-attention over a full block)."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError("causal flash attention requires Tq == Tk")
    return FlashAttention.apply(q, k, v, causal)
