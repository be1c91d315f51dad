"""Decode-step attention over flat KV caches: kernel K2
(csrc/decode_attention.cu) and its plain twin.

One query per batch row against a flat (B, T, H*64) K/V block: the cache
layout of models/whisper.py. Int8 caches carry fp32 per-row scales
(B, T, 1) that fold into the scores (k_scale) and into the softmax weights
before the V reduction (v_scale): exact algebra, the only loss is the
quantization itself. `valid_len` is a lockstep scalar or per-row (B,)
counts; rows at or past it are masked.
"""
from __future__ import annotations

import torch

from kotoba_whisper_tpu_torch.ops import _build

NEG_INF = -1.0e30
_CHUNK_ROWS = 64  # cache rows per block: csrc/decode_attention.cu kChunk


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
    tensors. valid_len: int (every row) or a (B,) int32 tensor."""
    if q.device.type == "cpu":
        return decode_attention_reference(
            q, k_flat, v_flat, valid_len, n_heads=n_heads,
            k_scale=k_scale, v_scale=v_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, t, dh = k_flat.shape
    if q.dtype != torch.bfloat16 or q.shape != (b, n_heads, dh // n_heads):
        raise TypeError(f"K2 takes bfloat16 q (B, H, 64), got {q.dtype} {tuple(q.shape)}")
    if dh != n_heads * 64:
        raise ValueError(f"K2 is built for head dim 64, got {dh // n_heads}")
    if v_flat.shape != k_flat.shape or v_flat.dtype != k_flat.dtype:
        raise ValueError("K2: k and v differ in shape or dtype")
    kv_int8 = k_flat.dtype == torch.int8
    if not kv_int8 and k_flat.dtype != torch.bfloat16:
        raise TypeError(f"K2 takes bfloat16 or int8 K/V, got {k_flat.dtype}")
    if kv_int8 != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("K2: int8 K/V need both scales; bf16 K/V take none")
    tensors = [k_flat, v_flat]
    if kv_int8:
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or s.shape != (b, t, 1):
                raise ValueError(f"K2 scales are fp32 (B, T, 1), got {s.dtype} {tuple(s.shape)}")
        tensors += [k_scale, v_scale]
    for x in tensors:
        if x.device != q.device or not x.is_contiguous():
            raise ValueError("K2 takes contiguous tensors on one device")
    # q's rows may lie apart (a row of a fused qkv projection); its heads
    # must be contiguous within a row
    if q.stride(2) != 1 or q.stride(1) != dh // n_heads:
        raise ValueError("K2 takes q (B, H, 64) with each row's heads contiguous")
    if k_flat.data_ptr() % 16 or v_flat.data_ptr() % 16:
        raise ValueError("K2 needs 16-byte aligned K/V")

    if isinstance(valid_len, torch.Tensor):
        if valid_len.shape != (b,) or valid_len.device != q.device:
            raise ValueError("K2 per-row valid_len is a (B,) tensor on q's device")
        valid_rows, valid_all, span = valid_len.to(torch.int32).contiguous(), 0, t
    else:
        valid_all = int(valid_len)
        if not 1 <= valid_all <= t:
            raise ValueError(f"K2 valid_len {valid_all} outside [1, {t}]")
        valid_rows, span = None, valid_all
    n_splits = -(-span // _CHUNK_ROWS)
    dev = q.device
    out = torch.empty((b, dh), dtype=torch.bfloat16, device=dev)
    part_o = part_m = part_l = None  # split partials; one chunk needs none
    if n_splits > 1:
        part_o = torch.empty((b, n_splits, dh), dtype=torch.float32, device=dev)
        part_m, part_l = torch.empty(
            (2, b, n_splits, n_heads), dtype=torch.float32, device=dev
        )
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = _build.library("decode_attention").kwt_decode_attention(
        q.data_ptr(), k_flat.data_ptr(), v_flat.data_ptr(), ptr(k_scale),
        ptr(v_scale), ptr(valid_rows), valid_all, q.stride(0), out.data_ptr(), ptr(part_o),
        ptr(part_m), ptr(part_l), b, t, n_heads, n_splits, int(kv_int8),
        _build.stream_handle(dev),
    )
    if rc != 0:
        raise RuntimeError(f"K2 decode attention launch failed: cudaError {rc}")
    decode_attention.launches += 1
    return out.reshape(b, n_heads, dh // n_heads)


decode_attention.launches = 0
