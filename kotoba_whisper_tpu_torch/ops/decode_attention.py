"""Decode-step attention over flat KV caches: kernel K2
(csrc/decode_attention.cu) and its plain twins.

One query per batch row against a flat (B, T, H*64) K/V block: the cache
layout of models/whisper.py. Int8 caches carry fp32 per-row scales
(B, T, 1) that fold into the scores (k_scale) and into the softmax weights
before the V reduction (v_scale): exact algebra, the only loss is the
quantization itself. `valid_len` is a lockstep scalar or per-row (B,)
counts. Without `ring_pos` a row's keys are its slots [0, valid); with it
(decode/streaming.py's shared-slot ring) they are its `valid` most recent
slots, ending at slot ring_pos: slot s is a key when
(ring_pos - s) mod T < valid.

`decode_attention_beam` is the beam form: K beam queries of a group
against the group's one shared (cross-attention) K/V row, every slot a
key; the rows are read once for all K queries.

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
STAGES, STAGE_BYTES = 4, 20480  # the kernel's copy ring
SMEM_LIMIT = 232448  # bytes of shared memory a CTA may take on the card
MAX_BEAMS = 6        # beam forms the kernel is built for: the most whose
# scores fit a CTA's shared memory at large-v3's cross cache (T=1500, H=20)


def split_plan(span: int) -> tuple[int, int]:
    """(CTAs per batch row, rows per CTA) for a call over cache rows
    [0, span): CTA r reads rows [r * rows, min((r + 1) * rows, valid)).
    The CTAs of a row are one cluster, so their count is the grid's x.
    Rows are logical: in the ring form, logical row j is `ring_slot`."""
    if span < 1:
        raise ValueError(f"K2 needs at least one cache row, got {span}")
    n_ctas = min(MAX_CLUSTER, -(-span // MIN_CTA_ROWS))
    return n_ctas, -(-span // n_ctas)


def stage_rows(row_bytes: int) -> int:
    """Cache rows one stage of the kernel's copy ring holds."""
    return STAGE_BYTES // row_bytes


def ring_slot(ring_pos: int, valid: int, t: int, j: int) -> int:
    """Physical slot of logical row j in [0, valid) of a ring row whose
    `valid` most recent keys end at slot ring_pos: the kernel's map."""
    return (ring_pos + 1 - valid + j) % t


def ring_copies(ring_pos: int, valid: int, t: int, r0: int, n: int) -> list[tuple[int, int, int]]:
    """The kernel's bulk copies of logical rows [r0, r0 + n) of a ring row,
    as (first slot, rows, row offset in the stage): one copy, or two where
    the run wraps past slot t - 1."""
    s = ring_slot(ring_pos, valid, t, r0)
    n1 = min(n, t - s)
    return [(s, n1, 0)] + ([(0, n - n1, n1)] if n > n1 else [])


def smem_bytes(rows: int, n_heads: int, beams: int = 1) -> int:
    """Dynamic shared memory of one CTA over `rows` cache rows (the
    kernel's `Layout.total`)."""
    kh = beams * n_heads
    end = (STAGES * STAGE_BYTES + 4 * rows * kh + 8 * rows + 8 * kh
           + 4 * (beams * n_heads * 64 + MAX_CLUSTER) + 8 * MAX_CLUSTER * kh)
    return ((end + 7) & ~7) + 16 * STAGES


def decode_attention_reference(
    q, k_flat, v_flat, valid_len, *, n_heads, k_scale=None, v_scale=None, ring_pos=None,
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
    if ring_pos is not None:
        pos = torch.remainder(torch.as_tensor(ring_pos, device=q.device) - pos, t)  # age
    scores = torch.where(pos < valid, scores, NEG_INF)
    w = torch.softmax(scores, dim=1)
    if v_scale is not None:
        w = w * v_scale.float()
    out = torch.einsum("bth,bthd->bhd", w, v_flat.float().reshape(b, t, n_heads, hd))
    return out.to(q.dtype)


def decode_attention_reference_beam(q, k_flat, v_flat, *, n_heads, k_scale=None, v_scale=None):
    """(G, K, H, hd) x (G, T, H*hd) -> (G, K, H, hd) in q.dtype: each
    group's K queries against its one K/V row, every slot a key; fp32
    inside."""
    g, _, _, hd = q.shape
    t = k_flat.shape[1]
    qf = q.float() * (1.0 / hd**0.5)
    scores = torch.einsum("gthd,gkhd->gtkh", k_flat.float().reshape(g, t, n_heads, hd), qf)
    if k_scale is not None:
        scores = scores * k_scale.float()[:, :, :, None]
    w = torch.softmax(scores, dim=1)
    if v_scale is not None:
        w = w * v_scale.float()[:, :, :, None]
    out = torch.einsum("gtkh,gthd->gkhd", w, v_flat.float().reshape(g, t, n_heads, hd))
    return out.to(q.dtype)


def _kv_args(card, k_flat, v_flat, k_scale, v_scale, n_heads):
    """K2's checks of the K/V cache and its scales (kept to few tensor
    calls: the self and cross calls run 64 times a decode step, and the
    step is host-bound) -> (int8?, K, V, k_scale, v_scale pointers)."""
    b, t, dh = k_flat.shape
    kv_int8 = k_flat.dtype == torch.int8
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
    return kv_int8, k_ptr, v_ptr, ks_ptr, vs_ptr


def _launch(q_ptr, q_stride, kv, valid_rows, valid_all, ring_ptr, out, b, t, n_heads, beams,
            n_ctas, rows, card):
    kv_int8, k_ptr, v_ptr, ks_ptr, vs_ptr = kv
    rc = _build.function("decode_attention", "kwt_decode_attention")(
        q_ptr, q_stride, k_ptr, v_ptr, ks_ptr, vs_ptr, valid_rows, valid_all, ring_ptr,
        out.data_ptr(), b, t, n_heads, beams, n_ctas, rows, int(kv_int8),
        _build.stream_handle(card),
    )
    if rc != 0:
        raise RuntimeError(f"K2 decode attention launch failed: cudaError {rc}")


def decode_attention(
    q, k_flat, v_flat, valid_len, *, n_heads, k_scale=None, v_scale=None, ring_pos=None,
):
    """K2 wrapper: the kernel for CUDA tensors, the plain twin for CPU
    tensors. valid_len: int (every row) or a (B,) int32 tensor; ring_pos:
    None (prefix form) or, on the card, a 0-d int32 tensor on q's card,
    read by the kernel from device memory. Allocates only the output; safe
    to capture in a CUDA graph."""
    if q.is_cpu:
        return decode_attention_reference(
            q, k_flat, v_flat, valid_len, n_heads=n_heads,
            k_scale=k_scale, v_scale=v_scale, ring_pos=ring_pos,
        )
    b, t, _ = k_flat.shape
    card, q_stride, q_ptr = q.get_device(), q.stride(), q.data_ptr()
    if (not q.is_cuda or q.dtype != torch.bfloat16 or q.shape != (b, n_heads, 64)
            or q_stride[1:] != (64, 1) or q_stride[0] % 8 or q_ptr % 16):
        raise ValueError(f"K2 takes bfloat16 q (B, H, 64), each row's heads contiguous and "
                         f"16-byte aligned, got {q.dtype} {tuple(q.shape)} {q_stride}")
    kv = _kv_args(card, k_flat, v_flat, k_scale, v_scale, n_heads)
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
    ring_ptr = None
    if ring_pos is not None:
        if (not isinstance(ring_pos, torch.Tensor) or ring_pos.shape != ()
                or ring_pos.dtype != torch.int32 or ring_pos.get_device() != card):
            raise ValueError("K2's ring_pos is a 0-d int32 tensor on q's card")
        ring_ptr = ring_pos.data_ptr()
    n_ctas, rows = split_plan(span)
    out = torch.empty((b, n_heads, 64), dtype=torch.bfloat16, device=q.device)
    _launch(q_ptr, q_stride[0], kv, valid_rows, valid_all, ring_ptr, out, b, t, n_heads, 1,
            n_ctas, rows, card)
    if ring_pos is None:
        decode_attention.launches += 1
    else:
        decode_attention.ring_launches += 1
    return out


decode_attention.launches = 0       # K2, prefix form
decode_attention.ring_launches = 0  # K2, ring form


def decode_attention_beam(q, k_flat, v_flat, *, n_heads, k_scale=None, v_scale=None):
    """K2's beam form: q (G, K, H, 64) against one flat K/V row per group
    (G, T, H*64), every slot a key -> (G, K, H, 64). The kernel for CUDA
    tensors (K <= MAX_BEAMS, and a CTA's scores within the card's shared
    memory), the plain twin for CPU tensors. Allocates only the output; safe to capture in a CUDA graph."""
    if q.is_cpu:
        return decode_attention_reference_beam(
            q, k_flat, v_flat, n_heads=n_heads, k_scale=k_scale, v_scale=v_scale)
    g, t, _ = k_flat.shape
    beams = q.shape[1] if q.ndim == 4 else 0
    n_ctas, rows = split_plan(t)
    if not 1 <= beams <= MAX_BEAMS or smem_bytes(rows, n_heads, beams) > SMEM_LIMIT:
        raise ValueError(f"K2's beam form takes 1 to {MAX_BEAMS} beams whose scores fit in "
                         f"shared memory: {beams} beams over {rows} rows a CTA need "
                         f"{smem_bytes(rows, n_heads, beams)} of {SMEM_LIMIT} bytes")
    card, q_stride, q_ptr = q.get_device(), q.stride(), q.data_ptr()
    if (not q.is_cuda or q.dtype != torch.bfloat16 or q.shape != (g, beams, n_heads, 64)
            or q_stride[1:] != (q_stride[1], 64, 1) or q_stride[0] != beams * q_stride[1]
            or q_stride[1] % 8 or q_ptr % 16):
        raise ValueError(f"K2's beam form takes bfloat16 q (G, K, H, 64), its G*K rows evenly "
                         f"strided, each row's heads contiguous and 16-byte aligned, got "
                         f"{q.dtype} {tuple(q.shape)} {q_stride}")
    kv = _kv_args(card, k_flat, v_flat, k_scale, v_scale, n_heads)
    out = torch.empty((g, beams, n_heads, 64), dtype=torch.bfloat16, device=q.device)
    _launch(q_ptr, q_stride[1], kv, None, t, None, out, g, t, n_heads, beams, n_ctas, rows,
            card)
    decode_attention_beam.launches += 1
    return out


decode_attention_beam.launches = 0  # K2, beam form
