"""w8a8 int8 projections for inference, as the JAX package's
`models/quantized.py` computes them (per dense projection y = x W^T + b):

  - weights: static per-out-channel absmax int8, `weight_q` (out, in) with
    an fp32 scale per output channel `weight_scale` (out,);
  - activations: dynamic per-row absmax int8, computed at run time;
  - product: s8 x s8 -> s32 (`torch._int_mm`, a stock GEMM as the JAX
    package left it to XLA), dequantized as ((y * s_x) * s_w) + b in fp32,
    then cast back to the activation dtype.

Each step copies the JAX package's operations as written (absmax in the
input dtype, `* (1/127)` for activations and `/ 127` for weights), so fp32
results are identical to the JAX package's. Only the per-layer dense
projections (q/k/v or the fused qkv/kv, out, fc1, fc2) are quantized;
LayerNorms, attention, the conv stem, embeddings and logits stay in the
compute dtype. Quantize after the model's dtype cast and after
`fuse_for_inference` (the JAX package's order), so the fused projections
quantize as one; the transform rewrites the model in place and returns it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# dense modules eligible for quantization (names inside each layer)
_DENSE_KEYS = (
    "q_proj", "k_proj", "v_proj", "qkv_proj", "kv_proj", "out_proj", "fc1", "fc2",
)
# torch._int_mm on the card takes more than 16 rows (the decode step's
# GEMMs have B rows); smaller products are padded with zero rows
_INT_MM_MIN_ROWS = 17


class QuantizedLinear(nn.Module):
    """A w8a8 projection's state: int8 weight (out, in) and fp32
    per-out-channel scale (out,) as buffers, the bias (None for k_proj)
    kept from the quantized nn.Linear."""

    def __init__(self, weight_q: torch.Tensor, weight_scale: torch.Tensor,
                 bias: torch.Tensor | None):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("weight_scale", weight_scale)
        self.bias = None if bias is None else nn.Parameter(bias.detach(), requires_grad=False)


@torch.no_grad()
def quantize_dense_int8(lin: nn.Linear) -> QuantizedLinear:
    """Per-out-channel absmax over the contraction axis."""
    k = lin.weight.float()                      # (out, in)
    amax = k.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    return QuantizedLinear(q, scale[:, 0], lin.bias)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32, exact."""
    m = xq.shape[0]
    if xq.is_cuda and m < _INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, _INT_MM_MIN_ROWS - m))
        return torch._int_mm(xq, wq.t())[:m]
    return torch._int_mm(xq, wq.t())


def dense_int8(q: QuantizedLinear, x: torch.Tensor) -> torch.Tensor:
    """w8a8 dense: dynamic per-row activation quantization, s32 product.

    Row-parallel (`reduce_group` set: x holds the rank's columns of each
    row), in this order, bit-exact with the whole projection: the row
    absmax is the max over the model group, the rank's columns quantize
    with it, the s32 partial products sum over the group (exact in int32),
    then the one dequantize with the whole per-output scale and the bias."""
    group = getattr(q, "reduce_group", None)
    a = x.abs().amax(dim=-1, keepdim=True).float()
    if group is not None:
        dist.all_reduce(a, op=dist.ReduceOp.MAX, group=group)
    s_x = torch.clamp(a, min=1e-8) * (1.0 / 127.0)
    inv = 1.0 / s_x
    xq = torch.clamp(torch.round(x.float() * inv), -127, 127).to(torch.int8)
    lead = x.shape[:-1]
    y = int8_matmul(xq.reshape(-1, x.shape[-1]), q.weight_q).reshape(*lead, -1)
    if group is not None:
        dist.all_reduce(y, group=group)
    y = y.float() * s_x * q.weight_scale.float()
    if q.bias is not None:
        y = y + q.bias.float()
    return y.to(x.dtype)


def _quantize_children(module: nn.Module) -> None:
    for name, child in list(module.named_children()):
        if isinstance(child, nn.Linear) and name in _DENSE_KEYS:
            setattr(module, name, quantize_dense_int8(child))
        else:
            _quantize_children(child)


@torch.no_grad()
def quantize_for_inference(model, parts: tuple[str, ...] = ("encoder", "decoder")):
    """Quantize the dense projections of the named parts' layers to w8a8,
    in place (fused or unfused layout); returns the model."""
    for part in parts:
        for layer in getattr(model.model, part).layers:
            _quantize_children(layer)
    return model
