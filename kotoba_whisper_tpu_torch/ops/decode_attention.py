"""Decode-step attention over flat KV caches: kernel K2
(csrc/decode_attention.cu) and its plain twin.

One query per batch row against a flat (B, T, H*64) K/V block: the cache
layout of models/whisper.py. Int8 caches carry fp32 per-row scales
(B, T, 1) that fold into the scores (k_scale) and into the softmax weights
before the V reduction (v_scale): exact algebra, the only loss is the
quantization itself. `valid_len` is a lockstep scalar or per-row (B,)
counts; rows at or past it are masked.

The kernel is one launch per call: `split_plan` cuts the rows a call
reads into at most MAX_CLUSTER slices, one CTA each, and the CTAs of a
batch row form a thread-block cluster that combines its slices on chip.
"""
from __future__ import annotations

import torch

from kotoba_whisper_tpu_torch.ops import _build

NEG_INF = -1.0e30
MAX_CLUSTER = 8     # CTAs per batch row: the portable cluster size
MIN_CTA_ROWS = 64   # a cache of up to this many rows is one CTA per row


def split_plan(span: int) -> tuple[int, int]:
    """(CTAs per batch row, rows per CTA) for a call over cache rows
    [0, span): CTA r reads rows [r * rows, min((r + 1) * rows, valid)).
    The CTAs of a row are one cluster, so their count is the grid's x."""
    if span < 1:
        raise ValueError(f"K2 needs at least one cache row, got {span}")
    n_ctas = min(MAX_CLUSTER, -(-span // MIN_CTA_ROWS))
    return n_ctas, -(-span // n_ctas)


def decode_attention_reference(
    q, k_flat, v_flat, valid_len, *, n_heads, k_scale=None, v_scale=None,
):
    """(B, H, hd) x (B, T, H*hd) -> (B, H, hd) in q.dtype; fp32 inside."""
    b, t, dh = k_flat.shape
    hd = dh // n_heads
    qf = q.float().reshape(b, n_heads, hd) * (1.0 / hd**0.5)
    kf = k_flat.float().reshape(b, t, n_heads, hd)
    scores = torch.einsum("bthd,bhd->bth", kf, qf)
    if k_scale is not None:
        scores = scores * k_scale.float()
    valid = torch.as_tensor(valid_len, device=q.device)
    if valid.ndim == 1:
        valid = valid[:, None, None]
    pos = torch.arange(t, device=q.device)[None, :, None]
    scores = torch.where(pos < valid, scores, NEG_INF)
    w = torch.softmax(scores, dim=1)
    if v_scale is not None:
        w = w * v_scale.float()
    out = torch.einsum("bth,bthd->bhd", w, v_flat.float().reshape(b, t, n_heads, hd))
    return out.to(q.dtype)


def decode_attention(
    q, k_flat, v_flat, valid_len, *, n_heads, k_scale=None, v_scale=None,
):
    """K2 wrapper: the kernel for CUDA tensors, the plain twin for CPU
    tensors. valid_len: int (every row) or a (B,) int32 tensor. Allocates
    only the output; safe to capture in a CUDA graph."""
    if q.is_cpu:
        return decode_attention_reference(
            q, k_flat, v_flat, valid_len, n_heads=n_heads,
            k_scale=k_scale, v_scale=v_scale,
        )
    # the checks that guard the kernel, in as few tensor calls as will do:
    # this wrapper runs 64 times a decode step, and the step is host-bound
    b, t, dh = k_flat.shape
    kv_int8 = k_flat.dtype == torch.int8
    card, q_stride, q_ptr = q.get_device(), q.stride(), q.data_ptr()
    if (not q.is_cuda or q.dtype != torch.bfloat16 or q.shape != (b, n_heads, 64)
            or q_stride[1:] != (64, 1) or q_stride[0] % 8 or q_ptr % 16):
        raise ValueError(f"K2 takes bfloat16 q (B, H, 64), each row's heads contiguous and "
                         f"16-byte aligned, got {q.dtype} {tuple(q.shape)} {q_stride}")
    if dh != n_heads * 64 or dh * k_flat.element_size() > 5120:
        raise ValueError(f"K2 takes H*64 columns of at most 5120 bytes, got {dh} x {n_heads}")
    if (v_flat.shape != k_flat.shape or v_flat.dtype != k_flat.dtype
            or not (kv_int8 or k_flat.dtype == torch.bfloat16)):
        raise ValueError(f"K2 takes bfloat16 or int8 K and V of one shape, got "
                         f"{k_flat.dtype} {tuple(k_flat.shape)}, {v_flat.dtype} "
                         f"{tuple(v_flat.shape)}")
    k_ptr, v_ptr = k_flat.data_ptr(), v_flat.data_ptr()
    if (not (k_flat.is_contiguous() and v_flat.is_contiguous()) or (k_ptr | v_ptr) % 16
            or k_flat.get_device() != card or v_flat.get_device() != card):
        raise ValueError("K2 takes contiguous, 16-byte aligned K/V on q's card")
    ks_ptr = vs_ptr = None
    if kv_int8:
        if k_scale is None or v_scale is None or any(
                s.dtype != torch.float32 or s.shape != (b, t, 1) or not s.is_contiguous()
                or s.get_device() != card for s in (k_scale, v_scale)):
            raise ValueError("K2's int8 K/V take contiguous fp32 (B, T, 1) k_scale and v_scale")
        ks_ptr, vs_ptr = k_scale.data_ptr(), v_scale.data_ptr()
    elif k_scale is not None or v_scale is not None:
        raise ValueError("K2's bfloat16 K/V take no scales")
    if isinstance(valid_len, torch.Tensor):
        if (valid_len.shape != (b,) or valid_len.dtype != torch.int32
                or valid_len.get_device() != card):
            raise ValueError("K2's per-row valid_len is a (B,) int32 tensor on q's card")
        valid_rows, valid_all, span = valid_len.data_ptr(), 0, t
    else:
        valid_all = span = int(valid_len)
        if not 1 <= valid_all <= t:
            raise ValueError(f"K2 valid_len {valid_all} outside [1, {t}]")
        valid_rows = None
    n_ctas, rows = split_plan(span)
    out = torch.empty((b, n_heads, 64), dtype=torch.bfloat16, device=q.device)
    rc = _build.function("decode_attention", "kwt_decode_attention")(
        q_ptr, q_stride[0], k_ptr, v_ptr, ks_ptr, vs_ptr, valid_rows, valid_all,
        out.data_ptr(), b, t, n_heads, n_ctas, rows, int(kv_int8),
        _build.stream_handle(card),
    )
    if rc != 0:
        raise RuntimeError(f"K2 decode attention launch failed: cudaError {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
