"""Encoder variant timing on the card, the counterpart of the JAX
package's tools/enc_exp.py for the variants that run a kernel or an
inference transform:

  baseline  models/whisper.encode (cuBLAS projections, K1 attention)
  fused_ln  baseline with the LayerNorms through K6: `layer_norm` before
            each self-attention and for the final norm (33 launches), the
            residual add + LayerNorm before each MLP fused (32 launches)
  int8      baseline with the encoder's projections quantized to w8a8
            (models/quantized.py, parts=("encoder",))

The JAX names `pallas`, `fused_ln_pallas` and `int8_pallas` map to the same
runs, because the port's encoder always takes K1 on the card. As in the
JAX tool the model is seeded random large-v3 (or --preset) in bf16 (or
--dtype float32: K1's, K6's and K8's fp32 forms) with fused projections;
KWT_FA_INT8=qk|qkpv moves every variant's attention to K8. Prints one JSON line: {variant, batch, ms_mean, ms_min, compile_s}
(compile_s: the first call, kernel builds and library plans included), or
with --check {variant, max_abs_diff, rel_l2} against baseline.

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

    return {"baseline": baseline, "fused_ln": fused_ln, "int8": int8}


# the JAX tool's names for the same runs: its attention choice is no choice
# here, the port's encoder always takes K1 (or K8) on the card
ALIASES = {"pallas": "baseline", "fused_ln_pallas": "fused_ln", "int8_pallas": "int8"}
VARIANT_NAMES = ("baseline", "fused_ln", "int8", *ALIASES)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
        t0 = time.perf_counter()
        fn(feats)
        _sync(dev)
        compile_s = time.perf_counter() - t0
        times = []
        for _ in range(args.trials):
            t0 = time.perf_counter()
            fn(feats)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        rec = {"variant": args.variant, "batch": args.batch,
               "ms_mean": float(np.mean(times)) * 1e3, "ms_min": float(np.min(times)) * 1e3,
               "compile_s": compile_s, "device": str(dev) if dev.type == "cpu"
               else torch.cuda.get_device_name(dev)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
