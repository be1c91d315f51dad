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
for CUDA tensors (bf16) and takes the twin only for CPU tensors.
"""
from __future__ import annotations

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


def conv_stem(conv1, conv2, x):
    """K7 wrapper: conv1/conv2 are the encoder's nn.Conv1d modules (their
    weights are cast to x's dtype); x (B, n_mels, T) -> (B, T // 2, d)."""
    if x.ndim != 3 or x.shape[2] % 2:
        raise ValueError(f"conv stem takes (B, n_mels, T) with T even, got {tuple(x.shape)}")
    w1, b1, w2, b2 = conv1.weight, conv1.bias, conv2.weight, conv2.bias
    if x.device.type == "cpu":
        return conv_stem_reference(w1, b1, w2, b2, x)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise TypeError(f"K7 takes bfloat16 on the card, got {x.dtype} on {x.device}")
    b, c_in, t = x.shape
    d = w1.shape[0]
    if c_in % 32 or d % 128 or w2.shape != (d, d, 3) or w1.shape != (d, c_in, 3):
        raise ValueError(f"K7 needs n_mels % 32 == 0 and d % 128 == 0, 3-tap convs; got "
                         f"x {tuple(x.shape)}, conv1 {tuple(w1.shape)}, conv2 {tuple(w2.shape)}")
    bf = torch.bfloat16
    # (B, T, C) rows and (C_out, 3 * C_in) tap-major weights, as the TPU
    # wrapper lays them out before its pallas_call
    xt = x.transpose(1, 2).contiguous()
    w1p = w1.to(bf).permute(0, 2, 1).reshape(d, 3 * c_in).contiguous()
    w2p = w2.to(bf).permute(0, 2, 1).reshape(d, 3 * d).contiguous()
    b1b, b2b = b1.to(bf).contiguous(), b2.to(bf).contiguous()
    y1 = torch.empty((b, t, d), dtype=bf, device=x.device)
    out = torch.empty((b, t // 2, d), dtype=bf, device=x.device)
    rc = _build.function("conv_stem", "kwt_conv_stem")(
        xt.data_ptr(), w1p.data_ptr(), b1b.data_ptr(), w2p.data_ptr(), b2b.data_ptr(),
        y1.data_ptr(), out.data_ptr(), b, t, c_in, d, _build.stream_handle(x.device),
    )
    if rc != 0:
        raise RuntimeError(f"K7 conv stem launch failed: cudaError {rc}")
    conv_stem.launches += 1
    return out


conv_stem.launches = 0
