"""M2M100/NLLB-architecture text seq2seq model in PyTorch, with the JAX
package's numerics.

The translator of the cascaded speech-to-text pipeline (eval/cascaded_s2t.py):
the reference binds an NLLB-200 model through HF transformers
(misc/cascaded_s2t_translation/ja_cascaded_s2t_translation.py:45-48); the
JAX package carries the model family natively (models/text_seq2seq.py), and
this is its port. A pre-LN transformer encoder-decoder with sinusoidal
positions (fairseq offset 2, padding-aware), a scaled shared embedding,
relu MLPs, a final LayerNorm on each side and an lm_head tied to the
shared embedding.

The module tree carries HF's parameter names (model.shared.weight,
model.encoder.layers.N.self_attn.q_proj.weight, ...), so an HF state dict
loads by name (`params_from_hf_state_dict`). As in models/whisper.py the
computation is written as functions over the modules:

  - positions as create_position_ids_from_input_ids computes them:
    (cumsum(mask) + past) * mask + pad_id, into a [sin | cos] table of
    num_positions + 2 rows whose row pad_id is zero;
  - LayerNorm in fp32, projections in the compute dtype with the bias
    after the product, logits in fp32 against the shared embedding;
  - attention as the JAX package's `attention_xla` computes it
    (ops/attention.attention: plain matmuls, fp32 softmax), with the
    boolean source-padding mask on encoder self-attention and on
    cross-attention.

The JAX package computes this model in XLA, outside its Pallas kernels, so
the port runs it on stock torch ops on the card too. An fp32 model runs
with TF32 off (models/whisper.exact_fp32), as the Whisper path does.

Greedy decode (`generate_greedy_text`) keeps the JAX package's fixed-
capacity per-layer self cache and a cross K/V computed once, and runs an
eager loop on the device where the JAX package runs lax.while_loop: the
same tokens and the same (B, max_length) output.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from kotoba_whisper_tpu_torch.core.device import check_model_device, resolve_device
from kotoba_whisper_tpu_torch.models.whisper import (
    dense,
    exact_fp32,
    layer_norm,
    logits_from,
    merge_heads,
    split_heads,
)
from kotoba_whisper_tpu_torch.ops.attention import attention


@dataclass(frozen=True)
class TextSeq2SeqConfig:
    vocab_size: int = 128112
    d_model: int = 1024
    encoder_layers: int = 12
    decoder_layers: int = 12
    encoder_attention_heads: int = 16
    decoder_attention_heads: int = 16
    encoder_ffn_dim: int = 4096
    decoder_ffn_dim: int = 4096
    max_position_embeddings: int = 1024
    pad_token_id: int = 1
    eos_token_id: int = 2
    decoder_start_token_id: int = 2
    scale_embedding: bool = True
    layer_norm_eps: float = 1e-5

    @property
    def embed_scale(self) -> float:
        return math.sqrt(self.d_model) if self.scale_embedding else 1.0


def config_from_hf_dict(d) -> TextSeq2SeqConfig:
    """From an M2M100/NLLB config.json dict."""
    return TextSeq2SeqConfig(
        vocab_size=d["vocab_size"],
        d_model=d["d_model"],
        encoder_layers=d["encoder_layers"],
        decoder_layers=d["decoder_layers"],
        encoder_attention_heads=d["encoder_attention_heads"],
        decoder_attention_heads=d["decoder_attention_heads"],
        encoder_ffn_dim=d["encoder_ffn_dim"],
        decoder_ffn_dim=d["decoder_ffn_dim"],
        max_position_embeddings=d.get("max_position_embeddings", 1024),
        pad_token_id=d.get("pad_token_id", 1),
        eos_token_id=d.get("eos_token_id", 2),
        decoder_start_token_id=d.get("decoder_start_token_id", 2),
        scale_embedding=d.get("scale_embedding", True),
    )


# ---------------------------------------------------------------------------
# sinusoidal positions (fairseq/tensor2tensor layout, offset 2)
# ---------------------------------------------------------------------------

def sinusoidal_table(
    num_positions: int, d: int, padding_idx: int | None = 1
) -> np.ndarray:
    """M2M100SinusoidalPositionalEmbedding.get_embedding: [sin | cos]
    concatenated (NOT interleaved), row padding_idx zeroed, offset rows
    included (table covers positions 0..num_positions+1)."""
    n = num_positions + 2  # offset
    half = d // 2
    freq = np.exp(np.arange(half, dtype=np.float64) * -(math.log(10000) / (half - 1)))
    ang = np.arange(n, dtype=np.float64)[:, None] * freq[None, :]
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if d % 2 == 1:
        emb = np.concatenate([emb, np.zeros((n, 1))], axis=1)
    if padding_idx is not None:
        emb[padding_idx] = 0.0
    return emb.astype(np.float32)


def position_ids(input_ids: torch.Tensor, pad_id: int, past: int = 0) -> torch.Tensor:
    """create_position_ids_from_input_ids semantics."""
    mask = (input_ids != pad_id).long()
    return (torch.cumsum(mask, dim=1) + past) * mask + pad_id


# ---------------------------------------------------------------------------
# Module tree (HF names)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class TextLayer(nn.Module):
    """An encoder layer, or with `cross` a decoder layer."""

    def __init__(self, d: int, ffn: int, eps: float, cross: bool):
        super().__init__()
        self.self_attn = Attention(d)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        if cross:
            self.encoder_attn = Attention(d)
            self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)


class TextStack(nn.Module):
    def __init__(self, cfg: TextSeq2SeqConfig, n_layers: int, ffn: int, cross: bool):
        super().__init__()
        self.layers = nn.ModuleList(
            TextLayer(cfg.d_model, ffn, cfg.layer_norm_eps, cross) for _ in range(n_layers))
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=cfg.layer_norm_eps)


class M2M100Model(nn.Module):
    def __init__(self, cfg: TextSeq2SeqConfig):
        super().__init__()
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = TextStack(cfg, cfg.encoder_layers, cfg.encoder_ffn_dim, False)
        self.decoder = TextStack(cfg, cfg.decoder_layers, cfg.decoder_ffn_dim, True)


class TextSeq2SeqModel(nn.Module):
    """M2M100ForConditionalGeneration's tree; lm_head is the shared
    embedding. The position table is a buffer outside the state dict."""

    def __init__(self, cfg: TextSeq2SeqConfig):
        super().__init__()
        self.cfg = cfg
        self.model = M2M100Model(cfg)
        self.register_buffer("pos_table", torch.from_numpy(sinusoidal_table(
            cfg.max_position_embeddings, cfg.d_model, cfg.pad_token_id)), persistent=False)


def init_params(
    cfg: TextSeq2SeqConfig, generator: torch.Generator, *, device="cpu",
    dtype: torch.dtype = torch.float32,
) -> TextSeq2SeqModel:
    """Random weights, the JAX package's init: normal kernels of std 0.02
    (0.1 where the input width is at most 4), zero biases, unit
    LayerNorms, a normal(0.02) shared embedding."""
    dev = torch.device(device)
    model = TextSeq2SeqModel(cfg).to(dev)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("layer_norm.weight"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                std = 0.1 if p.ndim == 2 and p.shape[1] <= 4 and "shared" not in name else 0.02
                p.copy_(torch.randn(p.shape, generator=generator, device=dev) * std)
    return model.to(dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _mha(attn: Attention, x, kv_x, n_heads: int, *, mask=None, causal=False):
    q, k, v = (dense(attn.q_proj, x), dense(attn.k_proj, kv_x), dense(attn.v_proj, kv_x))
    o = attention(split_heads(q, n_heads), split_heads(k, n_heads), split_heads(v, n_heads),
                  mask, causal=causal)
    return dense(attn.out_proj, merge_heads(o))


def _mlp(layer: TextLayer, x):
    h = layer_norm(layer.final_layer_norm, x)
    return x + dense(layer.fc2, torch.relu(dense(layer.fc1, h)))


def _embed(model: TextSeq2SeqModel, ids, past=0, compute_dtype=torch.float32):
    cfg = model.cfg
    tok = model.model.shared.weight.to(compute_dtype)[ids]
    tok = tok * torch.tensor(cfg.embed_scale, dtype=compute_dtype)
    pos = position_ids(ids, cfg.pad_token_id, past)
    return tok + model.pos_table.to(compute_dtype)[pos]


def _key_mask(model: TextSeq2SeqModel, ids):
    """(B, 1, 1, S) True where the source token is not padding."""
    return (ids != model.cfg.pad_token_id)[:, None, None, :]


def _encode(model: TextSeq2SeqModel, input_ids, compute_dtype):
    x = _embed(model, input_ids, compute_dtype=compute_dtype)
    key_mask = _key_mask(model, input_ids)
    n_heads = model.cfg.encoder_attention_heads
    for layer in model.model.encoder.layers:
        h = layer_norm(layer.self_attn_layer_norm, x)
        x = x + _mha(layer.self_attn, h, h, n_heads, mask=key_mask)
        x = _mlp(layer, x)
    return layer_norm(model.model.encoder.layer_norm, x)


def _check_positions(model, width: int) -> None:
    """Raise where a sequence of `width` tokens would index past the
    position table (the JAX package reads NaN rows there, HF raises; on
    the card an index past the table would fault the context)."""
    limit = model.cfg.max_position_embeddings
    if width > limit:
        raise ValueError(f"{width} positions exceed max_position_embeddings={limit}")


def _prepare(model, device, *tensors):
    dev = resolve_device(device)
    check_model_device(model, dev)
    return dev, [torch.as_tensor(t).to(dev) for t in tensors]


@torch.inference_mode()
def encode(
    model: TextSeq2SeqModel, input_ids, *, compute_dtype: torch.dtype = torch.float32,
    device="cuda",
) -> torch.Tensor:
    """(B, T) right-padded with pad_token_id -> (B, T, d). Key padding is
    handled inside; padded positions' outputs are garbage and must stay
    masked by the caller (HF behavior)."""
    _, (ids,) = _prepare(model, device, input_ids)
    _check_positions(model, ids.shape[1])
    with exact_fp32(compute_dtype):
        return _encode(model, ids.long(), compute_dtype)


@torch.inference_mode()
def decode(
    model: TextSeq2SeqModel, decoder_input_ids, encoder_out, encoder_ids, *,
    compute_dtype: torch.dtype = torch.float32, device="cuda",
) -> torch.Tensor:
    """Full (training/parity) decoder pass -> fp32 logits (B, T, vocab)."""
    _, (ids, enc, enc_ids) = _prepare(model, device, decoder_input_ids, encoder_out,
                                      encoder_ids)
    _check_positions(model, ids.shape[1])
    with exact_fp32(compute_dtype):
        x = _embed(model, ids.long(), compute_dtype=compute_dtype)
        cross_mask = _key_mask(model, enc_ids)
        enc = enc.to(compute_dtype)
        n_heads = model.cfg.decoder_attention_heads
        for layer in model.model.decoder.layers:
            h = layer_norm(layer.self_attn_layer_norm, x)
            x = x + _mha(layer.self_attn, h, h, n_heads, causal=True)
            h = layer_norm(layer.encoder_attn_layer_norm, x)
            x = x + _mha(layer.encoder_attn, h, enc, n_heads, mask=cross_mask)
            x = _mlp(layer, x)
        x = layer_norm(model.model.decoder.layer_norm, x)
        return logits_from(model.model.shared.weight, x)


# ---------------------------------------------------------------------------
# incremental greedy decode
# ---------------------------------------------------------------------------

@dataclass
class TextKVCache:
    self_k: list[torch.Tensor]   # per layer (B, cap, d)
    self_v: list[torch.Tensor]
    cross_k: list[torch.Tensor]  # per layer (B, S, d)
    cross_v: list[torch.Tensor]
    length: int = 0


def _init_cache(model, encoder_out, capacity, compute_dtype) -> TextKVCache:
    enc = encoder_out.to(compute_dtype)
    layers = model.model.decoder.layers
    b, d = enc.shape[0], model.cfg.d_model

    def zeros():
        return torch.zeros(b, capacity, d, dtype=compute_dtype, device=enc.device)

    return TextKVCache(
        [zeros() for _ in layers], [zeros() for _ in layers],
        [dense(lp.encoder_attn.k_proj, enc) for lp in layers],
        [dense(lp.encoder_attn.v_proj, enc) for lp in layers],
    )


def _decode_step(model, token, cache: TextKVCache, cross_mask, compute_dtype):
    """One token (B, 1) -> fp32 logits (B, vocab); the cache is written in
    place at slot cache.length, which then moves on by one."""
    n_heads = model.cfg.decoder_attention_heads
    pos = cache.length
    cap = cache.self_k[0].shape[1]
    x = _embed(model, token, past=pos, compute_dtype=compute_dtype)
    # slots 0..length inclusive (the one just written)
    self_mask = (torch.arange(cap, device=x.device) <= pos)[None, None, None, :]
    for i, layer in enumerate(model.model.decoder.layers):
        h = layer_norm(layer.self_attn_layer_norm, x)
        sa = layer.self_attn
        cache.self_k[i][:, pos] = dense(sa.k_proj, h)[:, 0]
        cache.self_v[i][:, pos] = dense(sa.v_proj, h)[:, 0]
        o = attention(split_heads(dense(sa.q_proj, h), n_heads),
                      split_heads(cache.self_k[i], n_heads),
                      split_heads(cache.self_v[i], n_heads), self_mask)
        x = x + dense(sa.out_proj, merge_heads(o))
        h = layer_norm(layer.encoder_attn_layer_norm, x)
        ea = layer.encoder_attn
        o = attention(split_heads(dense(ea.q_proj, h), n_heads),
                      split_heads(cache.cross_k[i], n_heads),
                      split_heads(cache.cross_v[i], n_heads), cross_mask)
        x = x + dense(ea.out_proj, merge_heads(o))
        x = _mlp(layer, x)
    x = layer_norm(model.model.decoder.layer_norm, x)
    cache.length += 1
    return logits_from(model.model.shared.weight, x)[:, 0]


@torch.inference_mode()
def generate_greedy_text(
    model: TextSeq2SeqModel,
    input_ids,                       # (B, S) right-padded source
    *,
    forced_bos: int,                 # target language code token
    max_length: int = 64,
    compute_dtype: torch.dtype = torch.float32,
    device="cuda",
) -> torch.Tensor:
    """HF generate() semantics for M2M100: sequence starts
    [decoder_start(=eos), forced_bos, ...], greedy argmax, stop at eos,
    pad after. Returns (B, max_length) int32 on `device`."""
    dev, (ids,) = _prepare(model, device, input_ids)
    _check_positions(model, max(ids.shape[1], max_length - 1))
    cfg = model.cfg
    ids = ids.long()
    b = ids.shape[0]
    with exact_fp32(compute_dtype):
        enc = _encode(model, ids, compute_dtype)
        cross_mask = _key_mask(model, ids)
        cache = _init_cache(model, enc, max_length, compute_dtype)
        tokens = torch.full((b, max_length), cfg.pad_token_id, dtype=torch.long, device=dev)
        tokens[:, 0] = cfg.decoder_start_token_id
        if max_length > 1:
            tokens[:, 1] = forced_bos
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        i = 0
        while i < max_length - 1 and not bool(finished.all()):
            logits = _decode_step(model, tokens[:, i : i + 1], cache, cross_mask, compute_dtype)
            nxt = torch.argmax(logits, dim=-1)
            if i == 0:
                nxt = torch.full_like(nxt, forced_bos)
            nxt = torch.where(finished, cfg.pad_token_id, nxt)
            tokens[:, i + 1] = nxt
            finished = finished | (nxt == cfg.eos_token_id)
            i += 1
    return tokens.to(torch.int32)


# ---------------------------------------------------------------------------
# weights: HF state dicts and checkpoints, the JAX package's parameter tree
# ---------------------------------------------------------------------------

def _load_named(model: TextSeq2SeqModel, get) -> TextSeq2SeqModel:
    """Fill every parameter of `model` from get(state-dict name without
    the leading 'model.') -> array or tensor."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            t = torch.from_numpy(np.array(get(name.removeprefix("model.")), np.float32))
            if t.shape != p.shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(p.shape)}")
            p.copy_(t)
    return model


def params_from_hf_state_dict(sd, cfg: TextSeq2SeqConfig) -> TextSeq2SeqModel:
    """M2M100ForConditionalGeneration state dict -> fp32 model on the CPU.
    Accepts keys with or without the leading 'model.'; lm_head is tied to
    the shared embedding and ignored."""

    def g(name):
        if name in sd:
            t = sd[name]
        elif f"model.{name}" in sd:
            t = sd[f"model.{name}"]
        else:
            raise KeyError(name)
        if hasattr(t, "detach"):
            t = t.detach().cpu().float().numpy()
        return t

    return _load_named(TextSeq2SeqModel(cfg), g)


def load_hf_checkpoint(path: str) -> tuple[TextSeq2SeqModel, TextSeq2SeqConfig]:
    """HF dir (config.json + model.safetensors / pytorch_model.bin) ->
    (fp32 model on the CPU, cfg)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf_dict(json.load(f))
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(st_path):
        from safetensors.numpy import load_file

        sd = load_file(st_path)
    else:
        sd = torch.load(
            os.path.join(path, "pytorch_model.bin"), map_location="cpu",
            weights_only=True,
        )
    return params_from_hf_state_dict(sd, cfg), cfg


def params_from_jax(params, cfg: TextSeq2SeqConfig) -> TextSeq2SeqModel:
    """The JAX package's parameter tree (numpy arrays; layers stacked on
    axis 0, dense kernels (in, out)) -> fp32 model on the CPU."""

    def g(name):
        parts = name.split(".")
        if parts[0] == "shared":
            return params["shared"]["embedding"]
        side = params[parts[0]]
        if parts[1] == "layer_norm":
            return side["layer_norm"]["scale" if parts[2] == "weight" else "bias"]
        i, rest = int(parts[2]), parts[3:]
        node = side["layers"]
        for key in rest[:-1]:
            node = node[key]
        if rest[-1] == "bias":
            return np.asarray(node["bias"])[i]
        if "layer_norm" in rest[-2]:
            return np.asarray(node["scale"])[i]
        return np.asarray(node["kernel"])[i].T

    return _load_named(TextSeq2SeqModel(cfg), g)
