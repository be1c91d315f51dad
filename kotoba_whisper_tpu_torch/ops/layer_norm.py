"""Fused LayerNorm and residual-add + LayerNorm: kernel K6
(csrc/layer_norm.cu) and its plain twin.

Numerics of the JAX package's `ops/layer_norm.py`: fp32 statistics, the
mean first and then the variance of the centred values (not E[x^2] -
mean^2), one rounding to the storage dtype. `add_layer_norm` rounds x + y
to the storage dtype BEFORE it normalises, so it returns exactly the sum
and LayerNorm the unfused `x = x + y; layer_norm(x)` sequence gives.

As in the JAX package, the model does not call these: they run in the
`fused_ln` variant of tools/enc_exp.py. Each wrapper launches K6 for CUDA
tensors (bf16 or fp32 rows of a width that is a multiple of 8, at most
2048; fp32 rows come back fp32) and takes its plain twin only for CPU
tensors.
"""
from __future__ import annotations

import torch

from kotoba_whisper_tpu_torch.ops import _build

_MAX_WIDTH = 2048  # csrc/layer_norm.cu kMaxChunks x 8 x 32 lanes
WARPS_PER_BLOCK = 4  # csrc/layer_norm.cu kWarps: one row per warp at a time
_WEIGHT_DTYPES = _ROW_DTYPES = (torch.bfloat16, torch.float32)


def row_schedule(rows, grid):
    """The rows each warp of K6's persistent grid normalises, in order:
    warp j of block i starts at row i * WARPS_PER_BLOCK + j and strides by
    grid * WARPS_PER_BLOCK (csrc/layer_norm.cu `layer_norm_kernel`). ->
    {(block, warp): list of rows}."""
    step = grid * WARPS_PER_BLOCK
    return {(blk, wp): list(range(blk * WARPS_PER_BLOCK + wp, rows, step))
            for blk in range(grid) for wp in range(WARPS_PER_BLOCK)}


def _ln_rows(x32, weight, bias, eps):
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * weight.float() + bias.float()


def layer_norm_reference(x, weight, bias, eps=1e-5):
    """Plain twin of K6's LayerNorm: any leading shape, x's dtype out."""
    return _ln_rows(x.float(), weight, bias, eps).to(x.dtype)


def add_layer_norm_reference(x, y, weight, bias, eps=1e-5):
    """Plain twin of K6's fused add: (x + y rounded, LayerNorm of it)."""
    summed = (x.float() + y.float()).to(x.dtype)
    return summed, _ln_rows(summed.float(), weight, bias, eps).to(x.dtype)


def _check(x, weight, bias, *others):
    """Raises on what K6 does not take; -> (rows, d, weight is fp32, x is
    fp32). The rows are bf16 or fp32, all of x's dtype; the weight and bias
    go to the kernel as they are stored (bf16 or fp32)."""
    d = x.shape[-1]
    for name, t in (("x", x), *others):
        if (t.device.type != "cuda" or t.dtype not in _ROW_DTYPES or t.dtype != x.dtype
                or not t.is_contiguous()):
            raise ValueError(f"K6 takes contiguous bfloat16 or fp32 rows on the card, all of "
                             f"one dtype; {name} is {t.dtype} on {t.device}")
        if t.shape != x.shape:
            raise ValueError(f"K6: {name} {tuple(t.shape)} differs from x {tuple(x.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"K6 reads 16-byte chunks: {name} is not 16-byte aligned")
    if d % 8 or d > _MAX_WIDTH or x.numel() == 0:
        raise ValueError(f"K6 takes a width that is a multiple of 8 up to {_MAX_WIDTH} and "
                         f"at least one row, got {tuple(x.shape)}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.shape != (d,) or t.dtype != weight.dtype or t.dtype not in _WEIGHT_DTYPES:
            raise ValueError(f"K6: weight and bias must be ({d},) of one dtype, bf16 or "
                             f"fp32; {name} is {tuple(t.shape)} {t.dtype}")
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"K6 reads {name} contiguous, 16-byte aligned, on x's card")
    return x.numel() // d, d, int(weight.dtype == torch.float32), int(x.dtype == torch.float32)


def layer_norm(x, weight, bias, eps=1e-5):
    """K6 LayerNorm over the last axis: the kernel for CUDA tensors, the
    plain twin for CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, eps)
    rows, d, w_fp32, x_fp32 = _check(x, weight, bias)
    out = torch.empty_like(x)
    card = x.get_device()
    rc = _build.function("layer_norm", "kwt_layer_norm")(
        card, x.data_ptr(), None, weight.data_ptr(), bias.data_ptr(), w_fp32, x_fp32, None,
        out.data_ptr(), rows, d, float(eps), _build.stream_handle(card),
    )
    if rc != 0:
        raise RuntimeError(f"K6 layer_norm launch failed: cudaError {rc}")
    layer_norm.launches += 1
    return out


def add_layer_norm(x, y, weight, bias, eps=1e-5):
    """K6 fused residual add + LayerNorm -> (x + y, LayerNorm(x + y))."""
    if x.device.type == "cpu":
        return add_layer_norm_reference(x, y, weight, bias, eps)
    rows, d, w_fp32, x_fp32 = _check(x, weight, bias, ("y", y))
    summed, out = torch.empty_like(x), torch.empty_like(x)
    card = x.get_device()
    rc = _build.function("layer_norm", "kwt_layer_norm")(
        card, x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(), w_fp32, x_fp32,
        summed.data_ptr(), out.data_ptr(), rows, d, float(eps), _build.stream_handle(card),
    )
    if rc != 0:
        raise RuntimeError(f"K6 add_layer_norm launch failed: cudaError {rc}")
    add_layer_norm.launches += 1
    return summed, out


layer_norm.launches = 0
add_layer_norm.launches = 0
