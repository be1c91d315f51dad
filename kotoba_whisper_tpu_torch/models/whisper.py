"""Whisper encoder-decoder in PyTorch, with the JAX package's numerics.

The module tree carries HF's parameter names (model.encoder.layers.N.
self_attn.q_proj.weight, ...), so an HF-layout state dict loads with
`load_state_dict`. The computation is written as functions over the
modules rather than in `forward`, to keep the JAX package's numerics:

  - LayerNorm in fp32, cast back to the activation dtype;
  - projections in the activation dtype, bias added after the product;
  - conv stem with exact-erf GELU, fixed sinusoidal encoder positions;
  - logits in fp32 against the tied token embedding.

The activation (compute) dtype is the dtype of the model's weights unless
a function is given `compute_dtype`: serving casts the model
(`model.to(torch.bfloat16)`); training keeps fp32 master weights and casts
each weight to the compute dtype at its use, as the JAX package's `dense`
does, so gradients reach the fp32 weights.

On the card the encoder's self-attention runs through kernel K1 (K8
under KWT_FA_INT8), the full-sequence decoder's causal self-attention
through K4 and its cross-attention through K1 (with K5 for the backward
pass of both), every single-token decode step's self- and cross-attention
through K2 (its ring form for continuous batching's shared-slot cache,
its beam form for beam search's shared cross-K/V), and the opt-in conv
stem (`stem_impl="pallas"`) through K7; on the CPU the same calls take
their plain twins.

The functions take the inference transforms wherever the JAX package
does: fused qkv/kv projections (models/optimized.py) and w8a8 projections
(models/quantized.py).

An fp32 model computes in fp32 on the card too: its attention runs through
the kernels' fp32 forms, and its convolutions and projections run with
TF32 off for the call (`exact_fp32`), whatever torch's flags say outside
it (cuDNN takes fp32 convolutions in TF32 by default).

`encoder_forward`, `decoder_forward` and `forward` build autograd graphs
(training); `encode`, `decode` and `init_cache` run under inference mode.

Tensor parallelism (parallel/sharded.place_params): a sharded model holds
its rank's H / M heads of every attention and 1 / M of every ffn, and
records its model group (`tp_size`, `tp_group`). The functions take the
rank's heads and cache width from the model (`rank_heads`, `rank_width`),
a row-parallel projection sums its partial products over the group before
its bias (`dense`), and the int8 KV rows take their absmax over the whole
row, across the group (`quantize_kv_rows`); the int4 cache's per-head
scales are the rank's own heads' and need no collective. The group's ranks
then hold the same residual stream, LayerNorms and logits.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from kotoba_whisper_tpu_torch.core.config import WhisperConfig
from kotoba_whisper_tpu_torch.core.device import check_model_device, resolve_device
from kotoba_whisper_tpu_torch.models.quantized import QuantizedLinear, dense_int8
from kotoba_whisper_tpu_torch.ops.attention import attention
from kotoba_whisper_tpu_torch.ops.conv_stem import conv_stem
from kotoba_whisper_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_beam,
    unpack_int4,
)
from kotoba_whisper_tpu_torch.ops.flash_attention import flash_attention


def sinusoidal_positions(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed encoder position table (log-spaced sinusoids)."""
    assert channels % 2 == 0
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(
        np.float32
    )


# ---------------------------------------------------------------------------
# Module tree (HF names)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d, bias=False)  # Whisper: no k bias
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = Attention(d)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(d, cfg.encoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn = Attention(d)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.encoder_attn = Attention(d)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.fc1 = nn.Linear(d, cfg.decoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.decoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)


class Encoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.conv1 = nn.Conv1d(cfg.num_mel_bins, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.embed_positions = nn.Embedding(cfg.max_source_positions, d)
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)


class Decoder(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        d = cfg.d_model
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
        self.embed_positions = nn.Embedding(cfg.max_target_positions, d)
        self.layers = nn.ModuleList(DecoderLayer(cfg) for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)


class WhisperModel(nn.Module):
    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)


class WhisperForConditionalGeneration(nn.Module):
    """Parameter container. The output projection is tied to
    model.decoder.embed_tokens and is not a separate parameter, so HF
    state dicts load after dropping `proj_out.weight`."""

    def __init__(self, cfg: WhisperConfig):
        super().__init__()
        self.cfg = cfg
        self.model = WhisperModel(cfg)

    @property
    def dtype(self) -> torch.dtype:
        return self.model.decoder.embed_tokens.weight.dtype


def init_params(
    cfg: WhisperConfig,
    generator: torch.Generator,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> WhisperForConditionalGeneration:
    """Random model as the JAX `init_params` draws it: dense, conv and
    embedding weights N(0, 0.02), biases 0, LayerNorm 1/0, sinusoidal
    encoder positions. `generator` must live on `device`."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = WhisperForConditionalGeneration(cfg)
    model = model.to_empty(device=dev).to(dtype)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("layer_norm.weight"):
                p.fill_(1.0)
            elif name.endswith(".bias"):
                p.zero_()
            elif name == "model.encoder.embed_positions.weight":
                p.copy_(torch.from_numpy(
                    sinusoidal_positions(cfg.max_source_positions, cfg.d_model)
                ))
            else:
                p.normal_(0.0, 0.02, generator=generator)
    return model.eval()


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------

def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """The JAX package's LayerNorm: fp32 statistics and affine, one rounding
    to x's dtype. PyTorch's fused LayerNorm computes in fp32 for bf16 input
    with weights of the same dtype; fp32 weights on bf16 activations (fp32
    master weights in training) take the explicit fp32 path."""
    if ln.weight.dtype == x.dtype:
        return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, ln.eps)
    return F.layer_norm(
        x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps
    ).to(x.dtype)


def tp_group(model: nn.Module):
    """The model group of a tensor-parallel model (None when whole)."""
    return getattr(model, "tp_group", None)


def rank_heads(model: nn.Module, n_heads: int) -> int:
    """The heads of an attention that this rank holds."""
    return n_heads // getattr(model, "tp_size", 1)


def rank_width(model: nn.Module) -> int:
    """The K/V cache width this rank holds (its heads x 64)."""
    return model.cfg.d_model // getattr(model, "tp_size", 1)


def dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Product in x's dtype (the weight cast to it), bias added after; a
    w8a8 projection takes the int8 product. A row-parallel projection
    (`reduce_group` set) sums its rank's partial product over the model
    group first; every rank gets the same sum."""
    if isinstance(lin, QuantizedLinear):
        return dense_int8(lin, x)
    y = F.linear(x, lin.weight.to(x.dtype))
    group = getattr(lin, "reduce_group", None)
    if group is not None:
        dist.all_reduce(y, group=group)
    if lin.bias is not None:
        y = y + lin.bias.to(x.dtype)
    return y


def conv1d(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """x (B, C_in, T); K=3, padding 1; product in x's dtype, bias after."""
    y = F.conv1d(x, conv.weight.to(x.dtype), None, stride=conv.stride, padding=conv.padding)
    return y + conv.bias.to(x.dtype)[None, :, None]


@contextlib.contextmanager
def exact_fp32(dtype: torch.dtype):
    """For fp32 compute, the block's convolutions and matmuls stay fp32 on
    the card: cuDNN (torch.backends.cudnn.allow_tf32, True by default) and
    cuBLAS (torch.backends.cuda.matmul.allow_tf32, where a caller set it)
    would otherwise round their operands to TF32's 10-bit mantissa. Both
    flags are off inside the block and the caller's are back after it.
    Other dtypes leave the flags alone."""
    if dtype != torch.float32:
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = saved


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, hd = x.shape
    return x.reshape(b, t, h * hd)


def qkv_projections(attn: nn.Module, x: torch.Tensor, kv_x: torch.Tensor, n_heads: int):
    """(q, k, v) head-split projections; takes the fused qkv (self) or kv
    (cross) entries when present. The fused outputs' column blocks stay
    views: the attention kernels read them with their token stride."""
    if hasattr(attn, "qkv_proj"):  # self-attention, x is kv_x
        q, k, v = dense(attn.qkv_proj, x).chunk(3, dim=-1)
    elif hasattr(attn, "kv_proj"):
        q = dense(attn.q_proj, x)
        k, v = dense(attn.kv_proj, kv_x).chunk(2, dim=-1)
    else:
        q, k, v = dense(attn.q_proj, x), dense(attn.k_proj, kv_x), dense(attn.v_proj, kv_x)
    return split_heads(q, n_heads), split_heads(k, n_heads), split_heads(v, n_heads)


def logits_from(emb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits against the tied embedding, cast to x's dtype first (as
    the JAX package does): the product of two bf16 values is exact in fp32,
    so fp32 operands give bf16-in/fp32-out."""
    return F.linear(x.float(), emb.to(x.dtype).float())


def _maybe_remat(fn, remat: bool, *args):
    """fn(*args), recomputed in the backward pass when `remat` (the JAX
    package's jax.checkpoint of each scanned layer)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _encoder_layer(layer: EncoderLayer, n_heads: int, x: torch.Tensor) -> torch.Tensor:
    h = layer_norm(layer.self_attn_layer_norm, x)
    sa = layer.self_attn
    x = x + dense(sa.out_proj, merge_heads(flash_attention(*qkv_projections(sa, h, h, n_heads))))
    h = layer_norm(layer.final_layer_norm, x)
    return x + dense(layer.fc2, F.gelu(dense(layer.fc1, h)))


def embed_audio(model: WhisperForConditionalGeneration, feats: torch.Tensor,
                dtype: torch.dtype, stem_impl: str = "xla") -> torch.Tensor:
    """The encoder's input: conv stem, then the fixed positions.
    (B, n_mels, 3000) -> (B, 1500, d) in `dtype`. stem_impl: "xla" (the
    default stem: stock convs, as the JAX package leaves it to XLA) or
    "pallas" (the JAX package's opt-in fused stem: K7 on the card)."""
    enc = model.model.encoder
    x = feats.to(dtype)
    if stem_impl == "pallas":
        x = conv_stem(enc.conv1, enc.conv2, x)
    elif stem_impl == "xla":
        with exact_fp32(dtype):
            x = F.gelu(conv1d(enc.conv1, x))
            # (B, d, T) -> (B, T, d) rows: left as a transposed view, the
            # residual stream would keep that layout through every layer and
            # each LayerNorm and projection would copy it
            x = F.gelu(conv1d(enc.conv2, x)).transpose(1, 2).contiguous()
    else:
        raise ValueError(f"stem_impl is 'xla' or 'pallas', got {stem_impl!r}")
    return x + enc.embed_positions.weight.to(dtype)[None]


def encoder_forward(
    model: WhisperForConditionalGeneration,
    feats: torch.Tensor,
    *,
    compute_dtype: torch.dtype | None = None,
    remat: bool = False,
    stem_impl: str = "xla",
) -> torch.Tensor:
    """(B, n_mels, 3000) log-mel on the model's device -> (B, 1500, d)
    encoder states in the compute dtype (default: the weights' dtype).
    Differentiable with the default stem; run it under torch.no_grad() for
    a frozen encoder."""
    cfg, enc = model.cfg, model.model.encoder
    dtype = compute_dtype or model.dtype
    with exact_fp32(dtype):
        x = embed_audio(model, feats, dtype, stem_impl)
        n_heads = rank_heads(model, cfg.encoder_attention_heads)
        for layer in enc.layers:
            x = _maybe_remat(_encoder_layer, remat, layer, n_heads, x)
        return layer_norm(enc.layer_norm, x)


@torch.inference_mode()
def encode(
    model: WhisperForConditionalGeneration, input_features, *, device="cuda",
    stem_impl: str = "xla",
) -> torch.Tensor:
    """(B, n_mels, 3000) log-mel -> (B, 1500, d) encoder states."""
    dev = resolve_device(device)
    check_model_device(model, dev)
    return encoder_forward(model, torch.as_tensor(input_features).to(dev), stem_impl=stem_impl)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclass
class KVCache:
    """Fixed-capacity decoder cache, layers stacked on axis 0, K/V FLAT:
    self_k/self_v (L, B, capacity, D); cross_k/cross_v (L, B, 1500, D),
    projected once per utterance. `length` is the lockstep fill (an int),
    or each row's own token count, a (B,) int32 tensor (continuous
    batching, decode/streaming.py).

    Beam mode (init_cache(beam_size=K)): cross_k/cross_v hold one row per
    beam group, (L, G, 1500, D), and the self buffers G*K rows.

    int8 mode: K/V stored int8 with per-row absmax scales (L, B, T, 1) fp32.

    int4 mode: the cross K/V stored as int4 codes packed two a byte
    (`pack_int4`: (L, B, 1500, D / 2) uint8) with per-(row, head) absmax
    scales (L, B, 1500, H) bf16; the self K/V int8 with scales of the same
    per-head form (L, B, capacity, H) bf16. A head's scale folds exactly
    into the block-diagonal attention (`quantize_kv_heads`).

    The buffers are updated in place by `decode`."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    length: int | torch.Tensor
    self_k_scale: torch.Tensor | None = None
    self_v_scale: torch.Tensor | None = None
    cross_k_scale: torch.Tensor | None = None
    cross_v_scale: torch.Tensor | None = None

    @property
    def is_quantized(self) -> bool:
        return self.cross_k_scale is not None

    @property
    def per_head_scales(self) -> bool:
        """int4 mode. Per-head scales are bf16 and per-row ones fp32: the
        dtype tells them apart, where the last dim would take a 1-head
        decoder's per-head cache for a per-row one."""
        return self.is_quantized and self.cross_k_scale.dtype == torch.bfloat16

    @property
    def kv_dtype(self) -> str:
        """The `kv_dtype` the cache was made with."""
        if not self.is_quantized:
            return "compute"
        return "int4" if self.per_head_scales else "int8"


def quantize_kv_rows(x: torch.Tensor, group=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., T, D) -> (int8 values, fp32 per-row scale (..., T, 1)). With a
    model group, x is the rank's heads of each row and the absmax is the
    whole row's, so the codes are the unsharded cache's."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_kv_heads(x: torch.Tensor, n_heads: int,
                      bits: int = 4) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., T, D) -> (int8 codes (..., T, D), bf16 scales (..., T, H)).

    Absmax per (row, head): each scale covers one head's 64 columns, which
    the block-diagonal decode attention folds exactly. The JAX package's
    op order: fp32 absmax, max(amax, 1e-8) / qmax (7 for 4 bits, 127 for
    8), the scale rounded through bf16 first so that the stored scale is
    the one quantized against, then round half to even and clamp. 4-bit
    codes lie in [-7, 7]; `pack_int4` stores them."""
    qmax = {4: 7.0, 8: 127.0}[bits]
    *lead, t, d = x.shape
    xs = x.float().reshape(*lead, t, n_heads, d // n_heads)
    amax = xs.abs().amax(dim=-1, keepdim=True)
    scale = (torch.clamp(amax, min=1e-8) / qmax).to(torch.bfloat16).float()
    q = torch.clamp(torch.round(xs / scale), -qmax, qmax)
    return q.to(torch.int8).reshape(*lead, t, d), scale[..., 0].to(torch.bfloat16)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7] (..., D) -> the int4 cache's storage, (...,
    D / 2) uint8: flat column 2j in the low nibble of byte j, column 2j + 1
    in its high nibble, each as a 4-bit two's complement. The kernels
    (csrc/decode_attention*.cu) and `unpack_int4` read this layout."""
    nib = codes.to(torch.int16) & 0xF
    return (nib[..., 0::2] | (nib[..., 1::2] << 4)).to(torch.uint8)


def _init_cache(model, encoder_out, capacity, kv_dtype, beam_size=1):
    cfg, dec = model.cfg, model.model.decoder
    n_layers, d = cfg.decoder_layers, rank_width(model)
    n_heads = rank_heads(model, cfg.decoder_attention_heads)
    group = tp_group(model)
    b, t_enc = encoder_out.shape[:2]
    rows = b * beam_size  # self-K/V rows: one per hypothesis
    dev = encoder_out.device
    if kv_dtype not in ("compute", "int8", "int4"):
        raise ValueError(f"kv_dtype is 'compute', 'int8' or 'int4', got {kv_dtype!r}")
    store = model.dtype if kv_dtype == "compute" else torch.int8
    cross_store, cross_d = (torch.uint8, d // 2) if kv_dtype == "int4" else (store, d)
    cross_k = torch.empty((n_layers, b, t_enc, cross_d), dtype=cross_store, device=dev)
    cross_v = torch.empty_like(cross_k)
    scales = {}
    if kv_dtype != "compute":
        s_w, s_dt = (n_heads, torch.bfloat16) if kv_dtype == "int4" else (1, torch.float32)
        ck_s = torch.empty((n_layers, b, t_enc, s_w), dtype=s_dt, device=dev)
        cv_s = torch.empty_like(ck_s)
        ones = torch.ones((n_layers, rows, capacity, s_w), dtype=s_dt, device=dev)
        scales = dict(self_k_scale=ones, self_v_scale=ones.clone(),
                      cross_k_scale=ck_s, cross_v_scale=cv_s)
    # one layer at a time: only one layer's full-precision projection is
    # ever live, whatever the depth and batch
    for i, layer in enumerate(dec.layers):
        ea = layer.encoder_attn
        with exact_fp32(model.dtype):
            if hasattr(ea, "kv_proj"):
                k, v = dense(ea.kv_proj, encoder_out).chunk(2, dim=-1)
            else:
                k, v = dense(ea.k_proj, encoder_out), dense(ea.v_proj, encoder_out)
        if kv_dtype == "int4":
            for buf, s_buf, x in ((cross_k, ck_s, k), (cross_v, cv_s, v)):
                codes, s_buf[i] = quantize_kv_heads(x, n_heads, 4)
                buf[i] = pack_int4(codes)
        elif kv_dtype == "int8":
            cross_k[i], ck_s[i] = quantize_kv_rows(k, group)
            cross_v[i], cv_s[i] = quantize_kv_rows(v, group)
        else:
            cross_k[i], cross_v[i] = k, v
    self_k = torch.zeros((n_layers, rows, capacity, d), dtype=store, device=dev)
    return KVCache(self_k, torch.zeros_like(self_k), cross_k, cross_v, 0, **scales)


@torch.inference_mode()
def init_cache(
    model: WhisperForConditionalGeneration,
    encoder_out: torch.Tensor,
    capacity: int,
    *,
    kv_dtype: str = "compute",
    beam_size: int = 1,
    device="cuda",
) -> KVCache:
    """kv_dtype: "compute" (the model's dtype), "int8" or "int4" (see
    KVCache). beam_size > 1:
    encoder_out holds one row per beam group; the cross K/V, the same for
    every hypothesis of a group, is projected and stored once per group,
    and the self buffers get group * beam_size rows (decode(beam_size=)
    fans each group's beam queries over its shared cross row)."""
    dev = resolve_device(device)
    check_model_device(model, dev)
    return _init_cache(model, encoder_out.to(dev), capacity, kv_dtype, beam_size)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _decoder_layer(layer: DecoderLayer, n_heads: int, x: torch.Tensor,
                   enc: torch.Tensor) -> torch.Tensor:
    h = layer_norm(layer.self_attn_layer_norm, x)
    sa = layer.self_attn
    o = flash_attention(*qkv_projections(sa, h, h, n_heads), causal=True)
    x = x + dense(sa.out_proj, merge_heads(o))
    h = layer_norm(layer.encoder_attn_layer_norm, x)
    ea = layer.encoder_attn
    o = flash_attention(*qkv_projections(ea, h, enc, n_heads))
    x = x + dense(ea.out_proj, merge_heads(o))
    h = layer_norm(layer.final_layer_norm, x)
    return x + dense(layer.fc2, F.gelu(dense(layer.fc1, h)))


def decoder_forward(
    model: WhisperForConditionalGeneration,
    input_ids: torch.Tensor,
    encoder_out: torch.Tensor,
    *,
    compute_dtype: torch.dtype | None = None,
    remat: bool = False,
) -> torch.Tensor:
    """Full-sequence decoder (training, teacher forcing): causal
    self-attention over input_ids (B, T) against encoder_out, both on the
    model's device -> fp32 logits (B, T, vocab). Differentiable; `remat`
    recomputes each layer in the backward pass."""
    cfg, dec = model.cfg, model.model.decoder
    dtype = compute_dtype or model.dtype
    t = input_ids.shape[1]
    emb = dec.embed_tokens.weight.to(dtype)
    x = emb[input_ids] + dec.embed_positions.weight[:t].to(dtype)[None]
    enc = encoder_out.to(dtype)
    n_heads = rank_heads(model, cfg.decoder_attention_heads)
    with exact_fp32(dtype):
        for layer in dec.layers:
            x = _maybe_remat(_decoder_layer, remat, layer, n_heads, x, enc)
        return logits_from(emb, layer_norm(dec.layer_norm, x))


def _dequant(vals, scale, dtype):
    """A quantized K/V block (packed int4 or int8 codes) times its per-row
    (..., T, 1) or per-head (..., T, H) scales, in `dtype`: the prompt
    prefill's keys (one pass; the decode steps fold the scales instead)."""
    if scale is None:
        return vals
    v = (unpack_int4(vals) if vals.dtype == torch.uint8 else vals).float()
    if scale.shape[-1] > 1:
        *lead, t, d = v.shape
        v = v.reshape(*lead, t, scale.shape[-1], -1) * scale.float()[..., None]
        return v.reshape(*lead, t, d).to(dtype)
    return (v * scale).to(dtype)


def _decode_step(model, input_ids, cache: KVCache, ring_pos=None, beam_size=1):
    """Incremental decode of a (B, t) token block against the cache (see
    `_decode_step_body`), its products in fp32 for an fp32 model."""
    with exact_fp32(model.dtype):
        return _decode_step_body(model, input_ids, cache, ring_pos, beam_size)


def _decode_step_body(model, input_ids, cache: KVCache, ring_pos, beam_size):
    """Incremental decode of a (B, t) token block against the cache.

    With per-row lengths (cache.length a (B,) int32 tensor; t == 1 only)
    each row's position is its own count. With `ring_pos` (a 0-d int32
    tensor) every row writes its new K/V at that shared ring slot and its
    keys are its count + 1 most recent slots (K2's ring form); without it
    each row writes at its own count and its keys are slots 0..count (the
    lockstep slot order, K2's prefix form with per-row lengths). Beam mode
    (beam_size > 1, a cache from init_cache(beam_size=)): rows are
    beam-major groups of beam_size, and the cross-attention fans each
    group's queries over its one cross row. The two combine: a beam
    stream's step (decode/streaming_beam.py) has per-row lengths, a ring
    slot and beam groups."""
    cfg, dec = model.cfg, model.model.decoder
    n_heads = rank_heads(model, cfg.decoder_attention_heads)
    group = tp_group(model)
    b, t = input_ids.shape
    capacity = cache.self_k.shape[2]
    per_row = isinstance(cache.length, torch.Tensor)
    if per_row:
        if t != 1:
            raise ValueError(f"per-row lengths take one token a step, got {t}")
        x = (dec.embed_tokens.weight[input_ids]
             + dec.embed_positions.weight[cache.length][:, None])
        new_length = cache.length + 1
        if ring_pos is None:
            own_rows = torch.arange(b, device=input_ids.device)
            own_slots = cache.length.long()
        else:
            slot = ring_pos.reshape(1).long()
    else:
        if ring_pos is not None:
            raise ValueError("ring_pos needs per-row lengths")
        pos0 = cache.length
        if pos0 + t > capacity:
            raise ValueError(f"cache capacity {capacity} exceeded at {pos0 + t}")
        x = (dec.embed_tokens.weight[input_ids]
             + dec.embed_positions.weight[pos0 : pos0 + t][None])
        new_length = pos0 + t
    int8_kv = cache.is_quantized
    per_head = cache.per_head_scales
    if t > 1:
        # prefill: token i (global pos length+i) attends to slots
        # 0..length+i: causal within the block, full over history
        dev = input_ids.device
        kv_mask = (
            torch.arange(capacity, device=dev)[None, :]
            <= pos0 + torch.arange(t, device=dev)[:, None]
        )[None, None]

    def write(buf, new):
        """new (B, t, *) into buf (B, capacity, *): at the lockstep fill,
        every row at the shared ring slot, or each row at its own count."""
        if per_row and ring_pos is None:
            buf[own_rows, own_slots] = new[:, 0]
        elif per_row:
            buf.index_copy_(1, slot, new)
        else:
            buf[:, pos0 : pos0 + t] = new

    def one_query(q_flat, k_flat, v_flat, valid, k_s, v_s, ring=None):
        o = decode_attention(
            q_flat.reshape(b, n_heads, -1), k_flat, v_flat, valid,
            n_heads=n_heads, k_scale=k_s, v_scale=v_s, ring_pos=ring,
        )
        return o.reshape(b, 1, -1)

    def many_queries(q_flat, k_flat, v_flat, k_s, v_s, mask=None):
        o = attention(
            split_heads(q_flat, n_heads),
            split_heads(_dequant(k_flat, k_s, model.dtype), n_heads),
            split_heads(_dequant(v_flat, v_s, model.dtype), n_heads),
            mask,
        )
        return merge_heads(o)

    for i, layer in enumerate(dec.layers):
        sk, sv = cache.self_k[i], cache.self_v[i]
        sk_s = cache.self_k_scale[i] if int8_kv else None
        sv_s = cache.self_v_scale[i] if int8_kv else None
        h = layer_norm(layer.self_attn_layer_norm, x)
        sa = layer.self_attn
        q_flat, k_new, v_new = (merge_heads(t) for t in qkv_projections(sa, h, h, n_heads))
        if int8_kv:
            # int4 mode keeps the self K/V in int8, with per-head scales
            k_new, k_new_s = (quantize_kv_heads(k_new, n_heads, 8) if per_head
                              else quantize_kv_rows(k_new, group))
            v_new, v_new_s = (quantize_kv_heads(v_new, n_heads, 8) if per_head
                              else quantize_kv_rows(v_new, group))
            write(sk_s, k_new_s)
            write(sv_s, v_new_s)
        write(sk, k_new)
        write(sv, v_new)
        if t == 1:
            o_flat = one_query(q_flat, sk, sv, new_length, sk_s, sv_s, ring_pos)
        else:
            o_flat = many_queries(q_flat, sk, sv, sk_s, sv_s, kv_mask)
        x = x + dense(sa.out_proj, o_flat)

        h = layer_norm(layer.encoder_attn_layer_norm, x)
        ea = layer.encoder_attn
        q_flat = dense(ea.q_proj, h)
        ck, cv = cache.cross_k[i], cache.cross_v[i]
        ck_s = cache.cross_k_scale[i] if int8_kv else None
        cv_s = cache.cross_v_scale[i] if int8_kv else None
        if beam_size > 1 and t == 1:
            # the group's beam queries against its one cross row, read once
            o = decode_attention_beam(
                q_flat.reshape(b // beam_size, beam_size, n_heads, -1), ck, cv,
                n_heads=n_heads, k_scale=ck_s, v_scale=cv_s,
            )
            o_flat = o.reshape(b, 1, -1)
        elif beam_size > 1:
            # prompt prefill: cross-attention has no mask, so the group's
            # beams and positions fan into one query axis (G, K*t, D)
            qg = q_flat.reshape(b // beam_size, beam_size * t, -1)
            o_flat = many_queries(qg, ck, cv, ck_s, cv_s).reshape(b, t, -1)
        elif t == 1:
            o_flat = one_query(q_flat, ck, cv, ck.shape[1], ck_s, cv_s)
        else:
            o_flat = many_queries(q_flat, ck, cv, ck_s, cv_s)
        x = x + dense(ea.out_proj, o_flat)

        h = layer_norm(layer.final_layer_norm, x)
        x = x + dense(layer.fc2, F.gelu(dense(layer.fc1, h)))
    logits = logits_from(dec.embed_tokens.weight, layer_norm(dec.layer_norm, x))
    return logits, dataclasses.replace(cache, length=new_length)


@torch.inference_mode()
def decode(
    model: WhisperForConditionalGeneration,
    input_ids,
    encoder_out: torch.Tensor | None = None,
    cache: KVCache | None = None,
    *,
    ring_pos: torch.Tensor | None = None,
    beam_size: int = 1,
    device="cuda",
):
    """Decoder forward.

    Full-sequence mode (cache=None): causal self-attention over input_ids
    (B, T) against encoder_out; returns fp32 logits (B, T, vocab).

    Incremental mode (cache given): input_ids is the next token block
    (B, t); returns (logits, cache advanced by t). The cache's buffers are
    written in place; the returned cache shares them. Single-token steps
    run their self- and cross-attention through K2 on the card; a prompt
    prefill (t > 1) dequantizes and uses plain masked attention.

    cache.length may also be a (B,) int32 tensor of per-row counts
    (continuous batching; single-token steps only), with `ring_pos` the
    shared ring slot every row writes, or without it each row writing at
    its own count (see _decode_step). beam_size > 1 takes a cache from
    init_cache(beam_size=) and beam-major input rows.
    """
    dev = resolve_device(device)
    check_model_device(model, dev)
    input_ids = torch.as_tensor(input_ids).to(dev)
    if cache is None:
        if encoder_out is None:
            raise ValueError("full-sequence decode needs encoder_out")
        return decoder_forward(model, input_ids, encoder_out.to(dev))
    return _decode_step(model, input_ids, cache, ring_pos=ring_pos, beam_size=beam_size)


# ---------------------------------------------------------------------------
# Full forward + CE loss (HF forward(labels=...) with the -100 mask)
# ---------------------------------------------------------------------------

def forward(
    model: WhisperForConditionalGeneration,
    input_features,
    decoder_input_ids,
    *,
    encoder_out: torch.Tensor | None = None,
    compute_dtype: torch.dtype | None = None,
    remat: bool = False,
    device="cuda",
):
    """-> (fp32 logits (B, T, vocab), encoder_out). Differentiable."""
    dev = resolve_device(device)
    check_model_device(model, dev)
    if encoder_out is None:
        encoder_out = encoder_forward(
            model, torch.as_tensor(input_features).to(dev),
            compute_dtype=compute_dtype, remat=remat,
        )
    logits = decoder_forward(
        model, torch.as_tensor(decoder_input_ids).to(dev), encoder_out.to(dev),
        compute_dtype=compute_dtype, remat=remat,
    )
    return logits, encoder_out


def ce_loss(logits: torch.Tensor, labels: torch.Tensor,
            count: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross-entropy with the -100 ignore mask (HF semantics).
    `count`, the valid tokens of the whole data-parallel batch, replaces
    this rank's own count as the divisor: the rank's share of the mean."""
    mask = labels != -100
    safe = torch.where(mask, labels, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    return (nll * mask).sum() / (mask.sum() if count is None else count).clamp(min=1)


def shift_labels_right(
    labels: torch.Tensor, decoder_start: int, pad_id: int = 50256
) -> torch.Tensor:
    """labels (with -100 pads) -> decoder_input_ids (collator semantics):
    prepend the start token, drop the last, replace -100 with pad so the
    embeddings are valid (those positions are loss-masked)."""
    start = torch.full((labels.shape[0], 1), decoder_start, dtype=labels.dtype,
                       device=labels.device)
    shifted = torch.cat([start, labels[:, :-1]], dim=1)
    return torch.where(shifted == -100, pad_id, shifted)
