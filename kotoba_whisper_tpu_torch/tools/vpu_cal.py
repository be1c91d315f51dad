"""Exponential / softmax throughput calibration of the card: kernel K9
(csrc/vpu_cal.cu), the counterpart of the JAX package's tools/vpu_cal.py.

A kernel runs only the attention softmax's per-score body (the serialising
add, row max, subtract, exp, row sum; or a bare exp) over a (rows, cols)
fp32 block that stays in registers, `iters` times: the SM's exponential
throughput with no memory traffic in the loop. The exponential is the
attention kernels' exp2f on log2(e)-scaled scores.

Prints one JSON line with the JAX tool's keys (op, block, ms, gelem_per_s,
ns_per_elem, projected_encoder_softmax_ms_b32) plus the projection at
B=16, the exponentials per second for the card and per SM, and the data
sheet's special-function-unit peak (16 ex2 a clock per SM at the card's
maximum SM clock) with the measured share of it.

Usage: python -m kotoba_whisper_tpu_torch.tools.vpu_cal [--rows 512]
       [--cols 1536] [--iters 64] [--op softmax|exp] [--trials 5]
       [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.ops import _build

SFU_EX2_PER_CLOCK_PER_SM = 16  # Hopper data sheet


def encoder_score_elements(batch: int, layers: int = 32, heads: int = 20,
                           frames: int = 1500) -> int:
    """Scores of large-v3's encoder self-attention for one batch."""
    return layers * batch * heads * frames * frames


def vpu_cal_reference(x, iters: int, op: str):
    """Plain twin of K9: the JAX tool's `_kernel` loop in fp32 -> (rows, 1)."""
    acc = torch.zeros((x.shape[0], 1), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        s = x + acc * 1e-9
        if op == "softmax":
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(dim=-1, keepdim=True)
            acc = acc + p.sum(dim=-1, keepdim=True) / l
        else:
            acc = acc + torch.exp(s).sum(dim=-1, keepdim=True)
    return acc


def vpu_cal(x, iters: int, op: str):
    """K9 wrapper: the kernel for CUDA tensors, the twin for CPU tensors."""
    if op not in ("softmax", "exp"):
        raise ValueError(f"op is 'softmax' or 'exp', got {op!r}")
    if x.device.type == "cpu":
        return vpu_cal_reference(x, iters, op)
    rows, cols = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous() or cols > 2048:
        raise ValueError("K9 takes a contiguous fp32 (rows, cols <= 2048) block")
    out = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    card = x.get_device()
    rc = _build.function("vpu_cal", "kwt_vpu_cal")(
        card, x.data_ptr(), out.data_ptr(), rows, cols, iters, int(op == "softmax"),
        _build.stream_handle(card),
    )
    if rc != 0:
        raise RuntimeError(f"K9 calibration launch failed: cudaError {rc}")
    vpu_cal.launches += 1
    return out


vpu_cal.launches = 0


def _max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.split()[0]
    return float(out) * 1e6


def _time_s(fn, trials: int, reps: int = 20) -> float:
    """Least mean seconds of one call over `trials` runs of `reps` calls
    (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / reps)
    return best


def measure(rows=512, cols=1536, iters=64, op="softmax", trials=5, device="cuda") -> dict:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("vpu_cal measures the card; it needs device cuda")
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((rows, cols)).astype(np.float32)).to(dev)
    dt = _time_s(lambda: vpu_cal(x, iters, op), trials)
    # the per-iteration cost alone: the same block at twice the iterations
    dt2 = _time_s(lambda: vpu_cal(x, 2 * iters, op), trials)
    elems = rows * cols * iters
    ns_per_elem = dt / elems * 1e9
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    peak = SFU_EX2_PER_CLOCK_PER_SM * n_sm * _max_sm_clock_hz()
    rate = elems / dt
    return {
        "op": op,
        "block": f"{rows}x{cols}x{iters}",
        "ms": dt * 1e3,
        "gelem_per_s": elems / dt / 1e9,
        "ns_per_elem": ns_per_elem,
        "projected_encoder_softmax_ms_b32": encoder_score_elements(32) * ns_per_elem / 1e6,
        "projected_encoder_softmax_ms_b16": encoder_score_elements(16) * ns_per_elem / 1e6,
        "exp_per_s": rate,
        "exp_per_s_per_sm": rate / n_sm,
        "exp_per_s_marginal": elems / max(dt2 - dt, 1e-12),
        "exp_per_s_peak": peak,
        "sfu_share": rate / peak,
        "device": torch.cuda.get_device_name(dev),
        "sms": n_sm,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--cols", type=int, default=1536)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--op", default="softmax", choices=["softmax", "exp"])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    rec = measure(a.rows, a.cols, a.iters, a.op, a.trials, a.device)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
