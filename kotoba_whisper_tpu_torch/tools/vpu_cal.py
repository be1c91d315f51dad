"""Exponential / softmax throughput calibration of the card: kernel K9
(csrc/vpu_cal.cu), the counterpart of the JAX package's tools/vpu_cal.py.

A kernel runs only the attention softmax's per-score body (the serialising
add, row max, subtract, exp, row sum; or a bare exp) over a (rows, cols)
fp32 block that stays in registers, `iters` times: the SM's exponential
throughput with no memory traffic in the loop. The exponential is the
attention kernels' ex2 on log2(e)-scaled scores. A row lies over
ROW_WARPS[op] warps, ROWS_PER_CTA rows to a CTA, each lane summing (and
taking the max of) its scores in SUMS independent running sums;
`--sweep` builds the kernel at SWEEP's other shapes and in PATCHES'
variants (csrc/vpu_cal.cu patched) and times both ops at each.

Prints one JSON line with the JAX tool's keys (op, block, ms, gelem_per_s,
ns_per_elem, projected_encoder_softmax_ms_b32) plus the projection at
B=16, the exponentials per second for the card and per SM, and the data
sheet's special-function-unit peak (16 ex2 a clock per SM at the card's
maximum SM clock) with the measured share of it.

Usage: python -m kotoba_whisper_tpu_torch.tools.vpu_cal [--rows 512]
       [--cols 1536] [--iters 64] [--op softmax|exp] [--trials 5]
       [--device cuda] [--sweep]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.ops import _build

SFU_EX2_PER_CLOCK_PER_SM = 16  # Hopper data sheet
# csrc/vpu_cal.cu's shape: by op, the warps that hold a row (column c of a
# row in lane c % 32 of warp c // 32 % w, its register c // (32 w), w =
# ROW_WARPS[op]); a lane's independent running sums and maxes (register j
# into sum j % SUMS); the rows a CTA, the widest row
ROW_WARPS, SUMS = {"softmax": 1, "exp": 4}, 4
ROWS_PER_CTA, MAX_COLS = 4, 2048
# the sweep's shapes (softmax warps a row, exp warps a row, sums), the
# shipped one first
SWEEP = ((1, 4, 4), (4, 1, 4), (2, 2, 4), (8, 8, 4), (1, 4, 1), (1, 4, 2), (1, 4, 8))


def shape_lines(softmax_warps: int, exp_warps: int, sums: int) -> str:
    """The kernel source's shape lines."""
    return (f"constexpr int kSoftmaxWarps = {softmax_warps}, kExpWarps = {exp_warps};\n"
            f"constexpr int kSums = {sums};\n")


# textual patches of the shipped source, each found once; "fast_div" (the
# softmax form's sum / l by an approximate reciprocal) is checked like the
# shapes, the knockouts (KNOCKED) compute wrong values: "no_reduce" (each
# lane its own row: no shuffles, no barrier), "no_exp" (every exponential
# an FMUL or FFMA), "no_rebase" (the softmax form's lane sums, each against
# its lane's own max, added without rebasing to the warp's max)
PATCHES = {
    "fast_div": (("acc += kSoftmax ? l / l : l;", "acc += kSoftmax ? __fdividef(l, l) : l;"),),
    "no_reduce": (("m = xor_max<32>(mt) * kLog2e;", "m = mt * kLog2e;"),
                  ("l = xor_sum<32>(rebased(bt, lane_reduce<false>(s), m));",
                   "l = rebased(bt, lane_reduce<false>(s), m);"),
                  ("l = xor_sum<32>(lane_reduce<false>(s));", "l = lane_reduce<false>(s);"),
                  ("if constexpr (kRowWarps > 1) {", "if constexpr (false) {")),
    "no_exp": (("s[j] = ex2(fmaf(s[j], kLog2e, -shift));", "s[j] = fmaf(s[j], kLog2e, -shift);"),
               ("s[j] = ex2(s[j] * kLog2e);", "s[j] = s[j] * kLog2e;")),
    "no_rebase": (("l = xor_sum<32>(rebased(bt, lane_reduce<false>(s), m));",
                   "l = xor_sum<32>(lane_reduce<false>(s));"),),
}
# each knockout's ops, in which the twin check must see it
KNOCKED = {"no_reduce": ("softmax", "exp"), "no_exp": ("softmax", "exp"),
           "no_rebase": ("softmax",)}


def encoder_score_elements(batch: int, layers: int = 32, heads: int = 20,
                           frames: int = 1500) -> int:
    """Scores of large-v3's encoder self-attention for one batch."""
    return layers * batch * heads * frames * frames


def vpu_cal_reference(x, iters: int, op: str):
    """Plain twin of K9: the JAX tool's `_kernel` loop in fp32 -> (rows, 2),
    each row's acc (the JAX kernel's output) and lsum, the sum over the
    iterations of its row sum l (softmax: of exp(s - max s); exp: of
    exp(s)), which sees an exponential that acc's sum / l does not."""
    acc = torch.zeros((x.shape[0], 1), dtype=torch.float32, device=x.device)
    lsum = torch.zeros_like(acc)
    for _ in range(iters):
        s = x + acc * 1e-9
        if op == "softmax":
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            l = p.sum(dim=-1, keepdim=True)
            acc = acc + p.sum(dim=-1, keepdim=True) / l
        else:
            l = torch.exp(s).sum(dim=-1, keepdim=True)
            acc = acc + l
        lsum = lsum + l
    return torch.cat([acc, lsum], dim=1)


def vpu_cal(x, iters: int, op: str):
    """K9 wrapper: the kernel for CUDA tensors, the twin for CPU tensors."""
    if op not in ("softmax", "exp"):
        raise ValueError(f"op is 'softmax' or 'exp', got {op!r}")
    if x.device.type == "cpu":
        return vpu_cal_reference(x, iters, op)
    out = _launch(_build.function("vpu_cal", "kwt_vpu_cal"), x, iters, op)
    vpu_cal.launches += 1
    return out


def _launch(fn, x, iters, op):
    """One launch of a K9 C entry (the built library's, or a sweep
    variant's) on x -> (rows, 2): acc, lsum."""
    rows, cols = x.shape
    if (x.dtype != torch.float32 or not x.is_contiguous() or rows < 1
            or not 1 <= cols <= MAX_COLS):
        raise ValueError(f"K9 takes a contiguous fp32 (rows, 1 <= cols <= {MAX_COLS}) block")
    out = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    card = x.get_device()
    rc = fn(
        card, x.data_ptr(), out.data_ptr(), rows, cols, iters, int(op == "softmax"),
        _build.stream_handle(card),
    )
    if rc != 0:
        raise RuntimeError(f"K9 calibration launch failed: cudaError {rc}")
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
    # the per-iteration cost alone: the same block at twice the iterations.
    # The two are timed in turns, the best of each kept, so that a card
    # still raising its clocks slows the first turn of both alike (timed
    # one after the other, a slow first block read 7x the data sheet's
    # marginal rate on an H100 80GB HBM3 at 700 W).
    dt = dt2 = float("inf")
    for _ in range(trials):
        dt = min(dt, _time_s(lambda: vpu_cal(x, iters, op), 1))
        dt2 = min(dt2, _time_s(lambda: vpu_cal(x, 2 * iters, op), 1))
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


def sweep_sources(src: str) -> dict:
    """{variant: source}: the K9 source at each of SWEEP's shapes
    ("w1_4_s4": softmax on 1 warp a row, exp on 4, 4 sums), then PATCHES'
    variants of the shipped shape; each patched text must be found once."""
    from kotoba_whisper_tpu_torch.tools.beam_probe import replace_once

    shipped = shape_lines(ROW_WARPS["softmax"], ROW_WARPS["exp"], SUMS)
    sources = {f"w{ws}_{we}_s{n}": replace_once(src, shipped, shape_lines(ws, we, n), "vpu_cal")
               for ws, we, n in SWEEP}
    for name, patches in PATCHES.items():
        text = src
        for old, new in patches:
            text = replace_once(text, old, new, "vpu_cal")
        sources[name] = text
    return sources


def sweep(rows=512, cols=1536, iters=64) -> dict:
    """Device ms of both ops at each of `sweep_sources`' variants, one nvcc
    a variant, all started together, into build/vpu_cal_sweep/; each
    variant first held to the twin (rtol 1e-4), which it must hold but in
    its KNOCKED ops, where it must not (the check sees the knockout) ->
    {"w1_4_s4": {"softmax": ms, "exp": ms}, ...}."""
    from kotoba_whisper_tpu_torch.tools.beam_probe import build_variants
    from kotoba_whisper_tpu_torch.tools.kernel_time import graph_ms

    sources = sweep_sources(open(_build.source_path("vpu_cal")).read())
    libs = build_variants(os.path.join(os.path.dirname(_build.BUILD_DIR), "vpu_cal_sweep"),
                          sources, "vpu_cal", "kwt_vpu_cal", "vpu_cal")
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((rows, cols)).astype(np.float32)).cuda()
    out = {}
    for variant, (lib, _) in libs.items():
        out[variant] = {}
        for op in ("softmax", "exp"):
            def call(op=op):
                return _launch(lib.kwt_vpu_cal, x, iters, op)

            held = torch.allclose(call(), vpu_cal_reference(x, iters, op), rtol=1e-4, atol=0)
            if held == (op in KNOCKED.get(variant, ())):
                raise RuntimeError(f"vpu_cal sweep: {variant} {op} "
                                   f"{'holds' if held else 'is off'} the twin")
            out[variant][op] = graph_ms(call)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rows", type=int, default=512)
    ap.add_argument("--cols", type=int, default=1536)
    ap.add_argument("--iters", type=int, default=64)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--op", default="softmax", choices=["softmax", "exp"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sweep", action="store_true",
                    help="also time both ops at each of SWEEP's kernel shapes")
    a = ap.parse_args(argv)
    rec = measure(a.rows, a.cols, a.iters, a.op, a.trials, a.device)
    if a.sweep:
        rec["warps_sweep_device_ms"] = sweep(a.rows, a.cols, a.iters)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
