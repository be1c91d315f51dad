"""Encoder variant timing on the card, the counterpart of the JAX
package's tools/enc_exp.py. Every name of the JAX tool's VARIANTS runs:

  baseline      models/whisper.encode (cuBLAS projections, K1 attention)
  fused_ln      baseline with the LayerNorms through K6: `layer_norm` before
                each self-attention and for the final norm (33 launches),
                the residual add + LayerNorm before each MLP fused (32)
  int8          baseline with the encoder's projections quantized to w8a8
                (models/quantized.py, parts=("encoder",))
  bf16out       baseline with every projection as the JAX tool's
                `dense_b16`: the product rounded to the compute dtype, the
                bias added after in that dtype (the port's `dense` already
                rounds there, so this is the baseline's arithmetic through
                a separate code path)
  ab_nosoftmax  ablation (timing only, as `encode_ablate`): the attention
                output is v + 0*q + 0*k, so the projections stay live and
                no K1 runs
  ab_nogelu     ablation: the MLP without its GELU
  ab_noln       ablation: no LayerNorm inside the layers (the final norm
                stays)
  ab_gemmonly   all three ablations at once: the stem, the projections and
                the final norm
  tbd           the activations carried as (T, B, D) with the JAX tool's
                `encode_tbd` einsum attention on stock ops (JAX computes
                that attention outside Pallas, so no K1 here)

The other JAX names are aliases (ALIASES): `pallas`, `fused_ln_pallas` and
`int8_pallas` run baseline, fused_ln and int8, because the port's encoder
always takes K1 on the card; `tbd_pallas` runs tbd, whose JAX function
ignores its attn_impl; `flat2d` and `unroll8` run baseline, because they
change only the layout of lax.scan's carry and its unrolling, which an
eager torch encoder does not have. As in the JAX tool the model is seeded
random large-v3 (or --preset) in bf16 (or --dtype float32: K1's, K6's and
K8's fp32 forms, TF32 off) with fused projections; KWT_FA_INT8=qk|qkpv
moves every K1 variant's attention to K8. Prints one JSON line:
{variant, batch, ms_mean, ms_min, compile_s, device} (compile_s: the first
call, kernel builds and library plans included), or with --check
{variant, max_abs_diff, rel_l2} against baseline.

Usage: python -m kotoba_whisper_tpu_torch.tools.enc_exp --variant fused_ln
       [--batch 32] [--trials 5] [--preset large-v3] [--check]
       [--device cuda] [--dtype bfloat16]
"""
from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from kotoba_whisper_tpu_torch.core.config import PRESETS
from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.models import whisper
from kotoba_whisper_tpu_torch.models.optimized import fuse_for_inference
from kotoba_whisper_tpu_torch.models.quantized import quantize_for_inference
from kotoba_whisper_tpu_torch.ops import layer_norm as ln_ops
from kotoba_whisper_tpu_torch.ops.flash_attention import flash_attention
from kotoba_whisper_tpu_torch.tools.step_time import device_name, sync


@torch.inference_mode()
def encode_fused_ln(model, feats):
    """Baseline encoder with K6: LayerNorm, and the residual add fused into
    the LayerNorm that follows it."""
    cfg, enc = model.cfg, model.model.encoder
    eps, n_heads = cfg.layer_norm_eps, cfg.encoder_attention_heads
    with whisper.exact_fp32(model.dtype):  # an fp32 model's projections stay fp32 (no TF32)
        x = whisper.embed_audio(model, feats, model.dtype)  # contiguous rows, as K6 takes them
        for layer in enc.layers:
            ln1, ln2, sa = layer.self_attn_layer_norm, layer.final_layer_norm, layer.self_attn
            h = ln_ops.layer_norm(x, ln1.weight, ln1.bias, eps)
            o = flash_attention(*whisper.qkv_projections(sa, h, h, n_heads))
            attn_out = whisper.dense(sa.out_proj, whisper.merge_heads(o))
            x, h = ln_ops.add_layer_norm(x, attn_out, ln2.weight, ln2.bias, eps)
            x = x + whisper.dense(layer.fc2, F.gelu(whisper.dense(layer.fc1, h)))
        return ln_ops.layer_norm(x, enc.layer_norm.weight, enc.layer_norm.bias, eps)


@torch.inference_mode()
def encode_bf16out(model, feats):
    """The baseline encoder with each projection as the JAX tool's
    `dense_b16`: the product in the compute dtype, the bias added after
    it in that dtype."""
    cfg, enc = model.cfg, model.model.encoder
    n_heads = cfg.encoder_attention_heads

    def dense_b16(lin, x):
        y = F.linear(x, lin.weight.to(x.dtype))
        return y if lin.bias is None else y + lin.bias.to(x.dtype)

    def attn(sa, h):
        if hasattr(sa, "qkv_proj"):
            q, k, v = dense_b16(sa.qkv_proj, h).chunk(3, dim=-1)
        else:
            q, k, v = (dense_b16(getattr(sa, n), h) for n in ("q_proj", "k_proj", "v_proj"))
        o = flash_attention(*(whisper.split_heads(y, n_heads) for y in (q, k, v)))
        return dense_b16(sa.out_proj, whisper.merge_heads(o))

    with whisper.exact_fp32(model.dtype):
        x = whisper.embed_audio(model, feats, model.dtype)
        for layer in enc.layers:
            x = x + attn(layer.self_attn, whisper.layer_norm(layer.self_attn_layer_norm, x))
            h = whisper.layer_norm(layer.final_layer_norm, x)
            x = x + dense_b16(layer.fc2, F.gelu(dense_b16(layer.fc1, h)))
        return whisper.layer_norm(enc.layer_norm, x)


@torch.inference_mode()
def encode_ablate(model, feats, *, no_softmax=False, no_gelu=False, no_ln=False):
    """The JAX tool's `encode_ablate`: the encoder with one non-GEMM part
    stripped (or several), to split its time by part. Not numerically
    valid, timing only. no_softmax: the attention output is v + 0*q + 0*k
    (no K1); no_gelu: the MLP without its GELU; no_ln: no LayerNorm inside
    the layers (the final one stays)."""
    cfg, enc = model.cfg, model.model.encoder
    n_heads = cfg.encoder_attention_heads

    def ln(norm, h):
        return h if no_ln else whisper.layer_norm(norm, h)

    def attn(sa, h):
        q, k, v = whisper.qkv_projections(sa, h, h, n_heads)
        o = v + 0.0 * q + 0.0 * k if no_softmax else flash_attention(q, k, v)
        return whisper.dense(sa.out_proj, whisper.merge_heads(o))

    with whisper.exact_fp32(model.dtype):
        x = whisper.embed_audio(model, feats, model.dtype)
        for layer in enc.layers:
            x = x + attn(layer.self_attn, ln(layer.self_attn_layer_norm, x))
            h = whisper.dense(layer.fc1, ln(layer.final_layer_norm, x))
            x = x + whisper.dense(layer.fc2, h if no_gelu else F.gelu(h))
        return whisper.layer_norm(enc.layer_norm, x)


@torch.inference_mode()
def encode_tbd(model, feats):
    """The JAX tool's `encode_tbd`: the activations carried as (T, B, D),
    self-attention as its two einsums on stock ops (fp32 scores and
    softmax, probabilities rounded to the compute dtype for P V)."""
    cfg, enc = model.cfg, model.model.encoder
    n_heads = cfg.encoder_attention_heads

    def attn_tbd(sa, h):
        t, b, d = h.shape
        if hasattr(sa, "qkv_proj"):
            q, k, v = whisper.dense(sa.qkv_proj, h).chunk(3, dim=-1)
        else:
            q, k, v = (whisper.dense(getattr(sa, n), h) for n in ("q_proj", "k_proj", "v_proj"))
        hd = d // n_heads
        q, k, v = (y.reshape(t, b, n_heads, hd) for y in (q, k, v))
        scale = torch.tensor(1.0 / hd**0.5, dtype=h.dtype)
        scores = torch.einsum("qbhd,kbhd->bhqk", (q * scale).float(), k.float())
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqk,kbhd->qbhd", probs.to(h.dtype).float(), v.float()).to(h.dtype)
        return whisper.dense(sa.out_proj, o.reshape(t, b, d))

    with whisper.exact_fp32(model.dtype):
        x = whisper.embed_audio(model, feats, model.dtype).transpose(0, 1).contiguous()
        for layer in enc.layers:
            x = x + attn_tbd(layer.self_attn, whisper.layer_norm(layer.self_attn_layer_norm, x))
            h = whisper.layer_norm(layer.final_layer_norm, x)
            x = x + whisper.dense(layer.fc2, F.gelu(whisper.dense(layer.fc1, h)))
        return whisper.layer_norm(enc.layer_norm, x).transpose(0, 1)


ABLATIONS = {"ab_nosoftmax": dict(no_softmax=True), "ab_nogelu": dict(no_gelu=True),
             "ab_noln": dict(no_ln=True),
             "ab_gemmonly": dict(no_softmax=True, no_gelu=True, no_ln=True)}


def make_variants(model):
    """name -> fn(feats) for `model` (the int8 variant quantizes a copy of
    its encoder once, on first use)."""
    quantized = {}

    def int8(feats):
        if "m" not in quantized:
            quantized["m"] = quantize_for_inference(copy.deepcopy(model), parts=("encoder",))
        return whisper.encode(quantized["m"], feats, device=feats.device)

    def baseline(feats):
        return whisper.encode(model, feats, device=feats.device)

    def fused_ln(feats):
        return encode_fused_ln(model, feats)

    variants = {"baseline": baseline, "fused_ln": fused_ln, "int8": int8,
                "bf16out": lambda feats: encode_bf16out(model, feats),
                "tbd": lambda feats: encode_tbd(model, feats)}
    for name, flags in ABLATIONS.items():
        variants[name] = lambda feats, flags=flags: encode_ablate(model, feats, **flags)
    return variants


# the JAX tool's names for the same runs: its attention choice is no choice
# here (the port's encoder always takes K1, or K8, on the card; encode_tbd
# ignores attn_impl in JAX too), and flat2d / unroll8 change only the
# layout and unrolling of lax.scan's carry, which an eager encoder lacks
ALIASES = {"pallas": "baseline", "fused_ln_pallas": "fused_ln", "int8_pallas": "int8",
           "tbd_pallas": "tbd", "flat2d": "baseline", "unroll8": "baseline"}
VARIANT_NAMES = ("baseline", "fused_ln", "int8", "bf16out", "tbd", *ABLATIONS, *ALIASES)


def time_variant(fn, feats, trials: int, variant: str) -> dict:
    """The timing record of fn(feats): its first call (compile_s), then
    `trials` calls, each ended by a device synchronise."""
    dev = feats.device
    t0 = time.perf_counter()
    fn(feats)
    sync(dev)
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        fn(feats)
        sync(dev)
        times.append(time.perf_counter() - t0)
    return {"variant": variant, "batch": feats.shape[0], "ms_mean": float(np.mean(times)) * 1e3,
            "ms_min": float(np.min(times)) * 1e3, "compile_s": compile_s,
            "device": device_name(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", required=True, choices=VARIANT_NAMES)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--preset", default="large-v3")
    ap.add_argument("--check", action="store_true",
                    help="compare outputs with baseline (small preset, CPU ok)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = PRESETS[args.preset]
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    model = fuse_for_inference(whisper.init_params(cfg, gen, device=dev, dtype=dtype))
    feats = torch.from_numpy(
        (np.random.default_rng(0).standard_normal(
            (args.batch, cfg.num_mel_bins, cfg.max_source_positions * 2)) * 0.1
         ).astype(np.float32)).to(dev)
    variants = make_variants(model)
    fn = variants[ALIASES.get(args.variant, args.variant)]

    if args.check:
        base = variants["baseline"](feats).float()
        got = fn(feats).float()
        rec = {"variant": args.variant, "max_abs_diff": float((got - base).abs().max()),
               "rel_l2": float((got - base).norm() / base.norm())}
    else:
        rec = time_variant(fn, feats, args.trials, args.variant)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
