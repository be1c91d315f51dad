"""GEMM rate calibration on the card at the encoder's shapes, the
counterpart of the JAX package's tools/matmul_cal.py: a chain of
(N, d) x (d, 4d) and (N, 4d) x (4d, d) products, N = batch x 1500 tokens,
each product's output rounded to the input dtype before the next, --steps
pairs back to back. The achievable rate of the library products that the
encoder and the train step spend most of their time in.

  bfloat16  torch.matmul in bf16 (cuBLAS, fp32 accumulation)
  int8      torch._int_mm, s8 x s8 -> s32, the s32 result wrapped to s8
            for the next product as the JAX tool's astype(int8) wraps it
            (timing only)
  float32   torch.matmul in fp32 inside models/whisper.exact_fp32 (TF32
            off): the rate fp32 models get on the card

Prints one JSON line {shape, dtype, ms, tflops, device}: ms the best of
--trials chains (host clock, each ended by a device synchronise), tflops
2 x 2 x N x d x 4d x steps over it. The JAX flag value `bf16` is accepted
for bfloat16.

Usage: python -m kotoba_whisper_tpu_torch.tools.matmul_cal [--batch 32]
       [--d_model 1280] [--steps 32] [--trials 5]
       [--dtype bf16|int8|float32] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.models import whisper
from kotoba_whisper_tpu_torch.models.quantized import int8_matmul
from kotoba_whisper_tpu_torch.tools.step_time import device_name, sync

DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "int8": torch.int8,
          "float32": torch.float32}


def make_operands(n: int, d: int, dtype: torch.dtype, dev) -> tuple:
    """x (n, d), w1 (d, 4d), w2 (4d, d), seeded: N(0, 1) activations and
    N(0, 0.02) weights, or for int8 integers in [-127, 127) with the
    weights stored (out, in) as models/quantized.int8_matmul takes them."""
    g = torch.Generator(device=dev).manual_seed(0)
    f = 4 * d
    if dtype == torch.int8:
        return tuple(torch.randint(-127, 127, shape, generator=g, device=dev, dtype=torch.int8)
                     for shape in ((n, d), (f, d), (d, f)))
    return (torch.randn(n, d, generator=g, device=dev).to(dtype),
            (torch.randn(d, f, generator=g, device=dev) * 0.02).to(dtype),
            (torch.randn(f, d, generator=g, device=dev) * 0.02).to(dtype))


def chain(x, w1, w2, steps: int):
    """`steps` pairs of products, each output in x's dtype."""
    with whisper.exact_fp32(x.dtype):
        for _ in range(steps):
            if x.dtype == torch.int8:
                x = int8_matmul(int8_matmul(x, w1).to(torch.int8), w2).to(torch.int8)
            else:
                x = torch.matmul(torch.matmul(x, w1), w2)
    return x


def measure(x, w1, w2, steps: int, trials: int) -> float:
    """Best of `trials` chains, in seconds, after one warm-up chain."""
    dev = x.device
    chain(x, w1, w2, steps)
    sync(dev)
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        chain(x, w1, w2, steps)
        sync(dev)
        times.append(time.perf_counter() - t0)
    return float(np.min(times))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--d_model", type=int, default=1280)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    n, d = args.batch * 1500, args.d_model
    f = 4 * d
    x, w1, w2 = make_operands(n, d, DTYPES[args.dtype], dev)
    dt = measure(x, w1, w2, args.steps, args.trials)
    rec = {"shape": f"({n},{d})x({d},{f}) chain x{args.steps}", "dtype": args.dtype,
           "ms": dt * 1e3, "tflops": 2 * 2 * n * d * f * args.steps / dt / 1e12,
           "device": device_name(dev)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
