"""Weight bridge into the port's module tree (HF parameter names).

  - `params_from_jax(tree, cfg)`: the JAX package's param pytree, as numpy
    arrays, -> model. Scan-stacked (L, ...) leaves become per-layer
    tensors, dense (in, out) kernels become (out, in) weights, conv
    (K, C_in, C_out) kernels become (C_out, C_in, K), LayerNorm `scale`
    becomes `weight`; the output projection stays tied to the embedding.
    Trees that went through the JAX package's `fuse_for_inference` and/or
    `quantize_for_inference` (`qkv_proj`, `kv_proj`, `kernel_q`,
    `kernel_scale`) give the port's model in the same state: fused
    (models/optimized.py) and/or w8a8 (models/quantized.py).
  - `load_checkpoint(dir)`: an HF-layout directory (config.json plus
    model.safetensors or model.npz) -> (model, cfg), fp32 on the CPU.
"""
from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.config import WhisperConfig
from kotoba_whisper_tpu_torch.models.optimized import fuse_for_inference
from kotoba_whisper_tpu_torch.models.quantized import quantize_for_inference
from kotoba_whisper_tpu_torch.models.whisper import WhisperForConditionalGeneration


def model_from_state_dict(
    sd: Mapping[str, Any], cfg: WhisperConfig
) -> WhisperForConditionalGeneration:
    """HF-named flat state dict -> fp32 model on the CPU (strict: every
    parameter present, nothing extra but the tied `proj_out.weight`).
    Fused (`qkv_proj`) and w8a8 (`weight_q`, int8) entries give a model
    transformed the same way."""
    tensors = {
        k: torch.from_numpy(np.array(v, dtype=np.int8 if k.endswith(".weight_q") else np.float32))
        for k, v in sd.items() if k != "proj_out.weight"
    }
    with torch.device("meta"):
        model = WhisperForConditionalGeneration(cfg)
    if any(".qkv_proj." in k for k in tensors):
        fuse_for_inference(model)
    parts = tuple(part for part in ("encoder", "decoder") if any(
        k.startswith(f"model.{part}.layers.") and k.endswith(".weight_q") for k in tensors))
    if parts:
        quantize_for_inference(model, parts=parts)
    model.load_state_dict(tensors, strict=True, assign=True)
    return model.eval()


def params_from_jax(tree: Mapping[str, Any], cfg: WhisperConfig) -> WhisperForConditionalGeneration:
    sd: dict[str, np.ndarray] = {}

    def leaf(x, i=None, dtype=np.float32):
        a = np.asarray(x, dtype)
        return a if i is None else a[i]

    def put_dense(prefix, p, i=None):
        if "kernel_q" in p:  # w8a8: int8 (in, out) -> (out, in), per-out scales
            sd[f"{prefix}.weight_q"] = leaf(p["kernel_q"], i, np.int8).T
            sd[f"{prefix}.weight_scale"] = leaf(p["kernel_scale"], i)
        else:
            sd[f"{prefix}.weight"] = leaf(p["kernel"], i).T
        if "bias" in p:
            sd[f"{prefix}.bias"] = leaf(p["bias"], i)

    def put_ln(prefix, p, i=None):
        sd[f"{prefix}.weight"] = leaf(p["scale"], i)
        sd[f"{prefix}.bias"] = leaf(p["bias"], i)

    enc, dec = tree["encoder"], tree["decoder"]
    for conv in ("conv1", "conv2"):
        sd[f"model.encoder.{conv}.weight"] = leaf(enc[conv]["kernel"]).transpose(2, 1, 0)
        sd[f"model.encoder.{conv}.bias"] = leaf(enc[conv]["bias"])
    sd["model.encoder.embed_positions.weight"] = leaf(enc["pos_embedding"])
    sd["model.decoder.embed_tokens.weight"] = leaf(dec["embed_tokens"]["embedding"])
    sd["model.decoder.embed_positions.weight"] = leaf(dec["pos_embedding"])
    for side, n_layers, attns in (
        ("encoder", cfg.encoder_layers, ("self_attn",)),
        ("decoder", cfg.decoder_layers, ("self_attn", "encoder_attn")),
    ):
        layers = tree[side]["layers"]
        for i in range(n_layers):
            p = f"model.{side}.layers.{i}"
            for a in attns:
                for proj, sub in layers[a].items():  # q/k/v/out, or fused qkv/kv
                    put_dense(f"{p}.{a}.{proj}", sub, i)
                put_ln(f"{p}.{a}_layer_norm", layers[f"{a}_layer_norm"], i)
            put_dense(f"{p}.fc1", layers["fc1"], i)
            put_dense(f"{p}.fc2", layers["fc2"], i)
            put_ln(f"{p}.final_layer_norm", layers["final_layer_norm"], i)
        put_ln(f"model.{side}.layer_norm", tree[side]["layer_norm"])
    return model_from_state_dict(sd, cfg)


def config_from_hf_dict(d: Mapping[str, Any]) -> WhisperConfig:
    return WhisperConfig(
        vocab_size=d["vocab_size"],
        num_mel_bins=d["num_mel_bins"],
        d_model=d["d_model"],
        encoder_layers=d["encoder_layers"],
        encoder_attention_heads=d["encoder_attention_heads"],
        decoder_layers=d["decoder_layers"],
        decoder_attention_heads=d["decoder_attention_heads"],
        encoder_ffn_dim=d["encoder_ffn_dim"],
        decoder_ffn_dim=d["decoder_ffn_dim"],
        max_source_positions=d["max_source_positions"],
        max_target_positions=d["max_target_positions"],
        pad_token_id=d.get("pad_token_id", 50256),
        bos_token_id=d.get("bos_token_id", 50257),
        eos_token_id=d.get("eos_token_id", 50257),
        decoder_start_token_id=d.get("decoder_start_token_id", 50258),
    )


def load_checkpoint(path: str) -> tuple[WhisperForConditionalGeneration, WhisperConfig]:
    """HF-layout checkpoint dir -> (fp32 CPU model, cfg)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_hf_dict(json.load(f))
    st_path = os.path.join(path, "model.safetensors")
    if os.path.exists(st_path):
        from safetensors.numpy import load_file

        sd = load_file(st_path)
    else:
        with np.load(os.path.join(path, "model.npz")) as z:
            sd = dict(z)
    return model_from_state_dict(sd, cfg), cfg
