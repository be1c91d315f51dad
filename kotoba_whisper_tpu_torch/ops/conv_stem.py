"""The audio stem conv1(k3, s1, pad 1) + GELU -> conv2(k3, s2, pad 1) +
GELU: kernel K7 (csrc/conv_stem.cu) and its plain twin.

It computes what the JAX package's Pallas stem (`ops/conv_stem.py`
`conv_stem_pallas`) computes, which is not exactly the default stem of
models/whisper.py: each conv accumulates in fp32 and adds its bias (rounded
to the activation dtype) in fp32 BEFORE rounding, and the exact-erf GELU
runs in fp32 on the rounded value; conv2's zero padding applies to the
post-GELU conv1 output. The encoder takes it with `stem_impl="pallas"`
(the JAX package's name for the opt-in stem).

Layout: x (B, n_mels, T) -> (B, T // 2, d), T even. The wrapper launches K7
for CUDA tensors (bf16: csrc/conv_stem.cu; fp32: the 3xTF32 tensor-core
form in csrc/conv_stem_f32.cu) and takes the twin only for CPU tensors. K7
reads its weights in a tap-major copy, in x's dtype, made once per weight
version (`tap_major_weights`; the fp32 form's split into TF32 high parts
and residuals by `split_tf32`); `stem_plan` packs the shapes, the tile
counts and each tap's TMA coordinates (`tap_coords`) that both forms read
(the fp32 form with F32_TILE_N-column tiles), and `stem_tile` mirrors the
order they walk their output tiles.
"""
from __future__ import annotations

import ctypes
import weakref
from functools import lru_cache

import torch
import torch.nn.functional as F

from kotoba_whisper_tpu_torch.ops import _build


def _gelu_exact(y32):
    return 0.5 * y32 * (1.0 + torch.erf(y32 * 2.0**-0.5))


def conv_stem_reference(w1, b1, w2, b2, x):
    """Plain twin of K7, step by step as the TPU kernel: conv weights
    (C_out, C_in, 3) and biases are cast to x's dtype, products summed in
    fp32 (exact products of the upcast operands), bias added in fp32,
    rounded, GELU in fp32, rounded."""
    dt = x.dtype

    def conv_gelu(h, w, b, stride):
        acc = F.conv1d(h.float(), w.to(dt).float(), stride=stride, padding=1)
        y = (acc + b.to(dt).float()[:, None]).to(dt)
        return _gelu_exact(y.float()).to(dt)

    y1 = conv_gelu(x, w1, b1, 1)
    return conv_gelu(y1, w2, b2, 2).transpose(1, 2)


# K7's tiles (csrc/conv_stem.cu): 128 output rows of one batch element x
# 256 output channels, K in steps of 64 input channels of one tap
TILE_M, TILE_N, TILE_K = 128, 256, 64


def tap_coords(stride, tap):
    """Where K7 reads tap `tap` (0, 1, 2) of output row i, as (parity, row
    offset) TMA coordinates. stride 1: x row i + tap - 1 (parity 0). stride
    2: y1 row 2i + tap - 1 read through the (B, T/2, 2, d) view as (pair i +
    offset, parity), so tap 0 = (i - 1, 1), tap 1 = (i, 0), tap 2 = (i, 1).
    Rows outside [0, T) fall outside the maps and read as zero."""
    if stride == 1:
        return 0, tap - 1
    return (tap - 1) % 2, (tap - 1) // 2


def stem_tiles(t_out, d, tile_n=TILE_N):
    """(row tiles per batch element, column tiles) of one conv's output."""
    return -(-t_out // TILE_M), -(-d // tile_n)


def stem_tile(w, n_mtiles, n_ntiles, tile_n=TILE_N):
    """K7's work item w -> (batch element, first row, first channel); the
    column tile runs fastest (csrc/conv_stem.cu and conv_stem_f32.cu
    `tile_of`)."""
    rest, nt = divmod(w, n_ntiles)
    b, mt = divmod(rest, n_mtiles)
    return b, mt * TILE_M, nt * tile_n


@lru_cache(maxsize=64)
def stem_plan(batch, t, c_in, d, tile_n=TILE_N):
    """The int64 array K7's C entries read: batch, T, C, d, the row tiles of
    conv1 and conv2, the column tiles (of `tile_n` channels: TILE_N for the
    bf16 form, F32_TILE_N for the fp32 one), then conv1's and conv2's tap
    parities and offsets (`tap_coords`)."""
    n_m1, n_n = stem_tiles(t, d, tile_n)
    n_m2, _ = stem_tiles(t // 2, d, tile_n)
    taps = [[tap_coords(stride, tap)[i] for tap in range(3)] for stride in (1, 2)
            for i in (0, 1)]
    return (ctypes.c_longlong * 19)(batch, t, c_in, d, n_m1, n_m2, n_n,
                                    *(v for row in taps for v in row))


# the fp32 form's tiles (csrc/conv_stem_f32.cu): 128 output rows of one
# batch element (TILE_M) x 128 channels, K steps of 32 channels of one tap,
# each step's 3xTF32 products summed in an accumulator of their own and
# added to the tile's fp32 sum
F32_TILE_N, F32_TILE_K = 128, 32


def split_tf32(x):
    """fp32 x as its TF32 high part, rounded to nearest with ties away from
    zero (csrc/sm90_common.cuh `split_tf32`: an integer add and mask), and
    its residual x - hi, exact in fp32: hi + lo == x."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -8192).view(torch.float32)
    return hi, x - hi


_tap_major_cache: dict = {}


@torch.no_grad()
def _tap_major(w1, b1, w2, b2, dtype):
    w1p, w2p = (w.detach().to(dtype).permute(0, 2, 1).contiguous() for w in (w1, w2))
    b1p, b2p = (b.detach().to(dtype).contiguous() for b in (b1, b2))
    if dtype == torch.float32:
        return (*split_tf32(w1p), b1p, *split_tf32(w2p), b2p)
    return w1p, b1p, w2p, b2p


def tap_major_weights(w1, b1, w2, b2, dtype=torch.bfloat16):
    """(C_out, 3, C_in) tap-major copies of the conv weights and the biases
    in `dtype`, as the TPU wrapper lays the weights out before its
    pallas_call: bf16 (w1, b1, w2, b2) for the bf16 kernel; for the fp32
    form each weight as its TF32 high part and residual (`split_tf32`),
    (w1_hi, w1_lo, b1, w2_hi, w2_lo, b2), what its tensor cores read. Made
    once and cached by each tensor's identity, storage address and
    `_version` (and the dtype), so an in-place update of a weight (which
    bumps its version) rebuilds them. Inference tensors carry no version
    counter, so an in-place update of one could not be seen: their copies
    are made on every call."""
    src = (w1, b1, w2, b2)
    if any(t.is_inference() for t in src):
        return _tap_major(*src, dtype)
    key = (*(id(t) for t in src), dtype)
    state = tuple((t.data_ptr(), t._version) for t in src)
    hit = _tap_major_cache.get(key)
    if hit is not None and hit[0] == state and all(r() is t for r, t in zip(hit[1], src)):
        return hit[2]
    packed = _tap_major(*src, dtype)
    for dead in [k for k, v in _tap_major_cache.items() if any(r() is None for r in v[1])]:
        del _tap_major_cache[dead]  # copies of weights that no longer exist
    if len(_tap_major_cache) >= 8:
        _tap_major_cache.pop(next(iter(_tap_major_cache)))
    _tap_major_cache[key] = (state, tuple(weakref.ref(t) for t in src), packed)
    return packed


def _conv_stem_f32(w1, b1, w2, b2, x):
    """K7's fp32 form on the card: a split transpose of x, then conv1 and
    conv2 on 3xTF32 wgmma through y1's high parts and residuals."""
    b, c_in, t = x.shape
    d = w1.shape[0]
    if c_in % 4 or d % 4 or w2.shape != (d, d, 3) or w1.shape != (d, c_in, 3):
        raise ValueError(f"K7's fp32 form needs n_mels % 4 == 0 and d % 4 == 0 (16-byte "
                         f"rows for its tensor maps) and 3-tap convs; got x {tuple(x.shape)}, "
                         f"conv1 {tuple(w1.shape)}, conv2 {tuple(w2.shape)}")
    if any(wt.device != x.device for wt in (w1, b1, w2, b2)):
        raise ValueError("K7: the conv weights must be on x's card")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("K7 reads x in 16-byte aligned rows")
    w1h, w1l, b1p, w2h, w2l, b2p = tap_major_weights(w1, b1, w2, b2, torch.float32)
    # scratch: x as (B, T, C) rows and conv1's output y1, each as TF32 high
    # parts, then residuals
    xt = x.new_empty((2, b, t, c_in))
    y1 = x.new_empty((2, b, t, d))
    out = x.new_empty((b, t // 2, d))
    card = x.get_device()
    rc = _build.function("conv_stem_f32", "kwt_conv_stem_f32")(
        card, x.data_ptr(), w1h.data_ptr(), w1l.data_ptr(), b1p.data_ptr(), w2h.data_ptr(),
        w2l.data_ptr(), b2p.data_ptr(), xt.data_ptr(), y1.data_ptr(), out.data_ptr(),
        stem_plan(b, t, c_in, d, F32_TILE_N), _build.stream_handle(card),
    )
    if rc != 0:
        raise RuntimeError(f"K7 conv stem (fp32) launch failed: cudaError {rc}")
    conv_stem.launches += 1
    return out


def conv_stem(conv1, conv2, x):
    """K7 wrapper: conv1/conv2 are the encoder's nn.Conv1d modules (their
    weights are cast to x's dtype); x (B, n_mels, T) -> (B, T // 2, d),
    bf16 or fp32."""
    if x.ndim != 3 or x.shape[2] % 2:
        raise ValueError(f"conv stem takes (B, n_mels, T) with T even, got {tuple(x.shape)}")
    w1, b1, w2, b2 = conv1.weight, conv1.bias, conv2.weight, conv2.bias
    if x.device.type == "cpu":
        return conv_stem_reference(w1, b1, w2, b2, x)
    if x.device.type != "cuda" or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"K7 takes bfloat16 or fp32 on the card, got {x.dtype} on {x.device}")
    if x.dtype == torch.float32:
        return _conv_stem_f32(w1, b1, w2, b2, x)
    b, c_in, t = x.shape
    d = w1.shape[0]
    if c_in % 8 or d % 8 or w2.shape != (d, d, 3) or w1.shape != (d, c_in, 3):
        raise ValueError(f"K7 needs n_mels % 8 == 0 and d % 8 == 0 (16-byte rows), 3-tap "
                         f"convs; got x {tuple(x.shape)}, conv1 {tuple(w1.shape)}, "
                         f"conv2 {tuple(w2.shape)}")
    if any(wt.device != x.device for wt in (w1, b1, w2, b2)):
        raise ValueError("K7: the conv weights must be on x's card")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("K7 reads x in 16-byte aligned rows")
    w1p, b1b, w2p, b2b = tap_major_weights(w1, b1, w2, b2)
    # scratch: x as (B, T, C) rows (K7 transposes it: TMA cannot shift a box
    # by one frame along x's own T-contiguous rows) and conv1's output y1
    xt = x.new_empty((b, t, c_in))
    y1 = x.new_empty((b, t, d))
    out = x.new_empty((b, t // 2, d))
    card = x.get_device()
    rc = _build.function("conv_stem", "kwt_conv_stem")(
        card, x.data_ptr(), w1p.data_ptr(), b1b.data_ptr(), w2p.data_ptr(), b2b.data_ptr(),
        xt.data_ptr(), y1.data_ptr(), out.data_ptr(), stem_plan(b, t, c_in, d),
        _build.stream_handle(card),
    )
    if rc != 0:
        raise RuntimeError(f"K7 conv stem launch failed: cudaError {rc}")
    conv_stem.launches += 1
    return out


conv_stem.launches = 0
