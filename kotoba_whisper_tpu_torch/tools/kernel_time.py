"""Device time of K2's self-attention calls and K5's fp32 backward at the
shapes of the path that runs them, alone on the card, so two trees of the
repository can be timed in turns (one process each, alternating which
runs first) on one card: run it from two `git archive` checkouts, copying
this file into one that lacks it. It calls only the wrappers' public entry
points, whichever form they pick; the library call beside each (PyTorch's
fused attention) is chip_smoke.py's phase 3, which the port does not call.

Rows (chip_smoke.py's phase 3 shapes; large-v3's 20 heads of 64):
- K2 self: phase 4's self call, B=16 rows over a T=51 cache (prompt + 48
  tokens), every slot valid, in int8 with fp32 row scales, int8 with bf16
  per-head scales (the int4 cache's self K/V), bf16, fp32 (fp32 q), and
  int8 at a TP=2 rank's 10 heads (D=640).
- K5 fp32: the training decoder's causal self-attention (B=8, T=128) and
  cross-attention (Tq=128, Tk=1500) backward on the fp32 forward's O and
  LSE: dQ, dK and dV.

Each time is the device ms of one call: the call captured 20 times in a
CUDA graph, the graph replayed 5 times (CUDA events). host_us is the
host's time per call, 200 calls back to back. One JSON line with the
card's name and power limit.

--k5-sweep adds K5's fp32 causal form at T=128 over batch x heads of 1 x
1 (one cluster: its latency), 1 x 20, 4 x 20 and 8 x 20 (the path's), and
at T=64 (one key tile, no cluster partner) and 256, 8 x 20: how its time
splits between one cluster's latency and the card's throughput.

Usage: python -m kotoba_whisper_tpu_torch.tools.kernel_time [--reps 3] [--k5-sweep]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.models import whisper
from kotoba_whisper_tpu_torch.ops import decode_attention as da
from kotoba_whisper_tpu_torch.ops import flash_attention as fa

HEADS, SELF_ROWS, SELF_T = 20, 16, 51  # phase 4: B=16, prompt 3 + 48 tokens
TRAIN_B, LABELS, T_ENC = 8, 128, 1500   # phase 4b


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device ms of one fn(): fn captured `iters` times into a CUDA graph,
    the graph replayed `replays` times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def host_us(fn, calls: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _randn(*shape, seed, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)


def _self_rows():
    """K2's self call in each mode -> {name: call}."""
    rows = {}
    for name, mode, heads in (("self_int8", "int8", HEADS), ("self_int8h", "int8h", HEADS),
                              ("self_bf16", "bf16", HEADS), ("self_fp32", "fp32", HEADS),
                              ("self_int8_d640", "int8", HEADS // 2)):
        dtype = torch.float32 if mode == "fp32" else torch.bfloat16
        q = _randn(SELF_ROWS, heads, 64, seed=4, dtype=dtype)
        kv = []
        for seed in (5, 6):
            x = _randn(SELF_ROWS, SELF_T, heads * 64, seed=seed, dtype=dtype)
            if mode == "int8":
                kv.append(whisper.quantize_kv_rows(x))
            elif mode == "int8h":
                kv.append(whisper.quantize_kv_heads(x, heads, 8))
            else:
                kv.append((x, None))
        (k, ks), (v, vs) = kv

        def call(q=q, k=k, v=v, ks=ks, vs=vs, heads=heads):
            return da.decode_attention(q, k, v, SELF_T, n_heads=heads, k_scale=ks, v_scale=vs)

        rows[name] = call
    return rows


def _k5_rows():
    """K5's fp32 backward, causal and cross -> {name: call}."""
    rows = {}
    f32 = torch.float32
    for name, tk, causal in (("k5_f32_causal", LABELS, True), ("k5_f32_cross", T_ENC, False)):
        q = _randn(TRAIN_B, LABELS, HEADS, 64, seed=55, dtype=f32)
        k, v = (_randn(TRAIN_B, tk, HEADS, 64, seed=s, dtype=f32) for s in (56, 57))
        do = _randn(TRAIN_B, LABELS, HEADS, 64, seed=58, dtype=f32)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)

        def call(q=q, k=k, v=v, o=o, lse=lse, do=do, causal=causal):
            return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)

        rows[name] = call
    return rows


def k5_sweep() -> dict:
    """Device ms of K5's fp32 causal call at (B, H, T) -> {"BxHxT": ms}."""
    f32 = torch.float32
    out = {}
    for b, h, t in ((1, 1, 128), (1, HEADS, 128), (4, HEADS, 128), (TRAIN_B, HEADS, 128),
                    (TRAIN_B, HEADS, 64), (TRAIN_B, HEADS, 256)):
        q, k, v, do = (_randn(b, t, h, 64, seed=s, dtype=f32) for s in (60, 61, 62, 63))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        out[f"{b}x{h}x{t}"] = graph_ms(
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True))
    return out


def measure(reps: int) -> dict:
    rows = {**_self_rows(), **_k5_rows()}
    return {name: {"device_ms": [graph_ms(call) for _ in range(reps)], "host_us": host_us(call)}
            for name, call in rows.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=3, help="timings of each row")
    ap.add_argument("--k5-sweep", action="store_true",
                    help="also time K5's fp32 causal form over batch, heads and T")
    args = ap.parse_args(argv)
    resolve_device("cuda")
    rec = {"rows": measure(args.reps), "device": torch.cuda.get_device_name(0)}
    if args.k5_sweep:
        rec["k5_f32_causal_sweep"] = k5_sweep()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    rec["nvidia_smi"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
