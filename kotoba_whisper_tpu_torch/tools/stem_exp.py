"""Conv-stem A/B timing on the card, the counterpart of the JAX package's
tools/stem_exp.py: the audio stem's share of the encoder and the stem
formulations at production shapes.

  stem_conv           the production stem (models/whisper.py conv1d: stock
                      convs on (B, C, T), bias after, exact GELU)
  stem_mm             im2col: 3 shifted views concatenated -> one
                      (3*C_in, C_out) product per conv
  stem_mm3            three shifted products per conv, summed in fp32
                      (each product is rounded to the dtype first: torch
                      has no fp32-out bf16 product to mirror the JAX one)
  stem_ncw            the stock convs fed (B, C, T) directly; in PyTorch
                      that is the production layout, so it repeats
                      stem_conv
  stem_pallas         the fused stem, kernel K7 (ops/conv_stem.py)
  stem_conv_nogelu    stem_conv without the GELUs
  stem_conv_tanhgelu  stem_conv with the tanh GELU
  conv2_only          conv2 alone on zeros
  encoder             the whole encoder (the stem share's denominator)

Checks stem_mm against stem_conv (max |diff| < 0.05) first. Prints one
JSON line per variant {name, ms, tflops (stem variants)} and a share line
{stem_share_of_encoder_pct, stem_mm_vs_conv, mismatch_max, batch}.

--dtype float32 runs every variant on an fp32 model with TF32 off
(models/whisper.exact_fp32), stem_pallas through K7's fp32 form.

Usage: python -m kotoba_whisper_tpu_torch.tools.stem_exp [--batch 48]
       [--trials 5] [--preset large-v3] [--device cuda] [--dtype bfloat16]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from kotoba_whisper_tpu_torch.core.config import PRESETS
from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.models import whisper
from kotoba_whisper_tpu_torch.ops.conv_stem import conv_stem


def stem_conv(enc, x, dtype, approximate="none", gelu=True):
    """The production stem, (B, C, T) -> (B, T/2, d)."""
    act = (lambda h: F.gelu(h, approximate=approximate)) if gelu else (lambda h: h)
    h = act(whisper.conv1d(enc.conv1, x.to(dtype)))
    return act(whisper.conv1d(enc.conv2, h)).transpose(1, 2)


def _taps(x, stride):
    """The three shifted (pad 1) views of (B, T, C) x for a k=3 conv."""
    xp = F.pad(x, (0, 0, 1, 1))
    t_out = x.shape[1] // stride
    return [xp[:, d : d + x.shape[1] : stride][:, :t_out] for d in range(3)]


def _tap_weights(conv, dtype):
    """(C_out, C_in, 3) -> (3, C_in, C_out)."""
    return conv.weight.to(dtype).permute(2, 1, 0)


def _mm_conv(conv, x, stride, dtype):
    k = _tap_weights(conv, dtype)
    y = torch.cat(_taps(x, stride), dim=-1) @ k.reshape(-1, k.shape[-1])
    return y + conv.bias.to(dtype)


def _mm3_conv(conv, x, stride, dtype):
    k = _tap_weights(conv, dtype)
    acc = sum((w @ k[d]).float() for d, w in enumerate(_taps(x, stride)))
    return (acc + conv.bias.float()).to(dtype)


def stem_mm(enc, x, dtype, conv=_mm_conv):
    h = x.transpose(1, 2).to(dtype)
    h = F.gelu(conv(enc.conv1, h, 1, dtype))
    return F.gelu(conv(enc.conv2, h, 2, dtype))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.inference_mode()
def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--preset", default="large-v3")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    with whisper.exact_fp32(dtype):
        return _run(args, dtype)


def _run(args, dtype) -> list[dict]:
    dev = resolve_device(args.device)
    cfg = PRESETS[args.preset]
    model = whisper.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                device=dev, dtype=dtype)
    enc = model.model.encoder
    b, t, d = args.batch, 3000, cfg.d_model
    x = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (b, cfg.num_mel_bins, t)) * 0.3).astype(np.float32)).to(dev).to(dtype)
    # tensor-core work: conv1 B*T*(3*mels)*d MACs, conv2 B*(T/2)*(3*d)*d MACs
    stem_flops = 2 * b * t * 3 * cfg.num_mel_bins * d + 2 * b * (t // 2) * 3 * d * d

    variants = {
        "stem_conv": lambda v: stem_conv(enc, v, dtype),
        "stem_mm": lambda v: stem_mm(enc, v, dtype),
        "stem_mm3": lambda v: stem_mm(enc, v, dtype, conv=_mm3_conv),
        "stem_ncw": lambda v: stem_conv(enc, v, dtype),
        "stem_pallas": lambda v: conv_stem(enc.conv1, enc.conv2, v),
        "stem_conv_nogelu": lambda v: stem_conv(enc, v, dtype, gelu=False),
        "stem_conv_tanhgelu": lambda v: stem_conv(enc, v, dtype, approximate="tanh"),
        "conv2_only": lambda v: whisper.conv1d(
            enc.conv2, torch.zeros((v.shape[0], d, t), dtype=dtype, device=dev)),
        "encoder": lambda v: whisper.encoder_forward(model, v),
    }

    # parity check between the two stem formulations
    a = variants["stem_conv"](x[:2]).float()
    m = variants["stem_mm"](x[:2]).float()
    err = float((a - m).abs().max())
    assert err < 0.05, f"stem_mm mismatch: {err}"

    results, lines = {}, []
    for name, fn in variants.items():
        fn(x)
        _sync(dev)
        times = []
        for _ in range(args.trials):
            t0 = time.perf_counter()
            fn(x)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        ms = float(np.min(times)) * 1e3
        rec = {"name": name, "ms": ms}
        if name.startswith("stem"):
            rec["tflops"] = stem_flops / (ms / 1e3) / 1e12
        results[name] = rec
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    share = {
        "stem_share_of_encoder_pct": 100 * results["stem_conv"]["ms"] / results["encoder"]["ms"],
        "stem_mm_vs_conv": results["stem_conv"]["ms"] / results["stem_mm"]["ms"],
        "mismatch_max": err,
        "batch": b,
        "dtype": args.dtype,
        "device": str(dev) if dev.type == "cpu" else torch.cuda.get_device_name(dev),
    }
    lines.append(share)
    print(json.dumps(share), flush=True)
    return lines


if __name__ == "__main__":
    main()
