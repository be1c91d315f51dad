"""Device time of K2's self-attention, cross and beam calls, K1/K4's fp32
forms, K5's fp32 backward, K7's fp32 form, K8 and K9 at the shapes of the
path that runs them, alone on the card, so two trees of the repository can be
timed in turns (one process each, alternating which
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
- K1 fp32: K1's fp32 form, the fp32 encoder's self-attention (B=16,
  T=1500), its no-max form (KWT_FA_NOMAX), the fp32 training decoder's
  cross-attention (Tq=128, Tk=1500, B=8), and K4's fp32 form (causal, B=8,
  T=128).
- K7 fp32: the fp32 conv stem at phase 4k(f)'s shape, (16, 128, 3000) ->
  (16, 1500, 1280), large-v3's convs.
- K2 cross: K2's cross call (B=16 rows over T=1500, every slot valid)
  on the int4 cache (packed int4, bf16 per-head scales) at 20 heads and a
  TP=2 rank's 10, with fp32 q (an fp32 model's int4 cache); the int8 cache
  (fp32 row scales) under fp32 q (an fp32 model's int8 cache: the head
  kernel), and under bf16 q at B=16 and at the stream's 48 rows (phase
  4e), and the bf16 cache, which take the row kernel; and the head kernel
  over int8 under bf16 q at B=16 and 48 through its C entry (a probe: no
  path routes bf16 q there).

Each time is the device ms of one call: the call captured 20 times in a
CUDA graph, the graph replayed 5 times (CUDA events). host_us is the
host's time per call, 200 calls back to back. One JSON line with the
card's name and power limit.

--sweep adds the grids of the head kernel over int8 K/V under fp32 q
(B=16, T=1500, 20 and 10 heads) by heads a CTA x key shares, through its
C entry (`head_plan` sizes them on the card; tools/beam_probe.py sweeps
the int4 beam form's shapes and shares, tools/ring_probe.py the ring
kernel's heads and threads a CTA).

--k5-sweep adds K5's fp32 causal form at T=128 over batch x heads of 1 x
1 (one cluster: its latency), 1 x 20, 4 x 20 and 8 x 20 (the path's), and
at T=64 (one key tile, no cluster partner) and 256, 8 x 20: how its time
splits between one cluster's latency and the card's throughput.

--k4-sweep adds K4's fp32 form (the causal forward) at the shapes at which
tests/test_torch_kernels_cuda.py runs it, (B, Tq, Tk, H), and beside each
its probe: the non-causal 3xTF32 kernel with the causal mask on its
128-row items, built from a patch of csrc/flash_attention_f32.cu
(K4_PROBE_PATCHES) into build/k4_probe/ and held to the twin first.

- K8: the int8 attention core at the encoder's shape (B=16, T=1500), its
  fp32-q form (phase 4k(f): qk, qkpv and both no-max forms) and the bf16
  form's qk and qkpv (phase 4d).
- K2 beam: the beam form at beam search's shape (12 groups x 5 beams over
  T=1500): fp32 q over fp32, int8 (fp32 row scales) and packed int4 K/V
  (phase 4k(b)), and bf16 q over bf16, int8 and int4 K/V.
- K2 ring: the stream's self call at phase 3's and 4j(c)'s shape (W=48
  rows over a T=176 ring, ring_pos 40, per-row valid lengths over [1, 176]
  that wrap) over int8 with fp32 row scales, int8 with bf16 per-head
  scales (the int4 cache's self K/V) and bf16, and int8 at 4g's W=60; and
  the per-row int8 form on a CTA a (row, head) through the C entry, at
  W=48 and 60 (a probe: no path routes it there).
- K9: the calibration loop at the JAX tool's block (512 x 1536 x 64 fp32),
  softmax and exp (tools.vpu_cal's runs, chip_smoke.py's phase 3).

A row whose call launches more than one kernel (K5 fp32 cross and K7
fp32, for instance) also records kernels_ms: the device ms a call spends
in each of its kernels (torch.profiler's CUDA kernel times over 20 calls;
a CUDA graph hides them).

Usage: python -m kotoba_whisper_tpu_torch.tools.kernel_time [--reps 3] [--sweep] [--k5-sweep]
       [--k4-sweep]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.models import whisper
from kotoba_whisper_tpu_torch.ops import _build
from kotoba_whisper_tpu_torch.ops import conv_stem as cs
from kotoba_whisper_tpu_torch.ops import decode_attention as da
from kotoba_whisper_tpu_torch.ops import flash_attention as fa
from kotoba_whisper_tpu_torch.tools import vpu_cal

HEADS, SELF_ROWS, SELF_T = 20, 16, 51  # phase 4: B=16, prompt 3 + 48 tokens
TRAIN_B, LABELS, T_ENC = 8, 128, 1500   # phase 4b
ENC_B = 16                              # phase 4k(a)'s fp32 encoder batch
STREAM_B = 48                           # phase 4e's window: the stream's cross call
RING_T, RING_POS, BEAM_STREAM_W = 176, 40, 60  # the stream's ring; 4g's window
N_MELS, D_MODEL = 128, 1280             # large-v3's stem
K9_BLOCK = (512, 1536, 64)              # the JAX calibration tool's (rows, cols, iters)
# the shapes (B, Tq, Tk, H) at which tests/test_torch_kernels_cuda.py runs
# K4's fp32 form (its forward tests, and the fp32 backward tests' forward
# calls), the path's first
K4_SWEEP = ((TRAIN_B, LABELS, LABELS, HEADS), (2, 130, 130, 3), (1, 1, 1, 1), (2, 65, 65, 2),
            (2, 63, 63, 2), (2, 64, 64, 2), (2, 127, 127, 2), (2, 129, 129, 3),
            (2, 300, 300, 3), (1, 37, 200, 2), (2, 128, 300, 2), (1, 1, 300, 1),
            (2, 200, 200, 4), (2, 130, 130, 4), (2, 600, 600, 4), (2, 1, 1, 3), (2, 63, 63, 3),
            (2, 65, 65, 3), (2, 127, 127, 3), (2, 1, 128, 3), (2, 65, 300, 2),
            (1, 100, 448, 4), (1, 448, 448, 2), (1, 64, 64, 2))


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


def short_kernel_name(name: str) -> str:
    """A profiler's kernel name without its return type, namespaces and
    parameter list: "void (anonymous namespace)::f<true>(float*, int)" ->
    "f<true>"."""
    s = name.replace("(anonymous namespace)::", "")
    depth, head = 0, s
    for i, ch in enumerate(s):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            head = s[:i]
            break
    head = head.strip()
    depth, start = 0, 0
    for i, ch in enumerate(head):
        depth += (ch == "<") - (ch == ">")
        if depth == 0 and ch in " :":
            start = i + 1
    return head[start:]


def kernel_split(fn, iters: int = 20) -> dict:
    """Device ms of one fn() in each kernel it launches, from
    torch.profiler's CUDA kernel times over `iters` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            key = short_kernel_name(e.key)
            out[key] = out.get(key, 0.0) + us / iters / 1e3
    return out


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


def _k1_f32_rows():
    """K1/K4's fp32 forward at the fp32 paths' shapes -> {name: call}."""
    rows = {}
    f32 = torch.float32
    for name, b, tq, tk, causal, no_max in (
            ("k1_f32", ENC_B, T_ENC, T_ENC, False, False),
            ("k1_f32_nomax", ENC_B, T_ENC, T_ENC, False, True),
            ("k1_f32_cross", TRAIN_B, LABELS, T_ENC, False, False),
            ("k4_f32", TRAIN_B, LABELS, LABELS, True, False)):
        q = _randn(b, tq, HEADS, 64, seed=70, dtype=f32)
        k, v = (_randn(b, tk, HEADS, 64, seed=s, dtype=f32) for s in (71, 72))

        def call(q=q, k=k, v=v, causal=causal, no_max=no_max):
            return fa.flash_attention_fwd(q, k, v, causal=causal, int8_mode="", no_max=no_max,
                                          exp2=False)

        rows[name] = call
    return rows


def _k7_f32_rows():
    """K7's fp32 form at phase 4k(f)'s shape -> {name: call}."""
    f32 = torch.float32
    conv1 = torch.nn.Conv1d(N_MELS, D_MODEL, 3, padding=1, device="cuda")
    conv2 = torch.nn.Conv1d(D_MODEL, D_MODEL, 3, stride=2, padding=1, device="cuda")
    x = _randn(ENC_B, N_MELS, 2 * T_ENC, seed=90, dtype=f32)

    def call():
        with torch.no_grad():
            return cs.conv_stem(conv1, conv2, x)

    return {"k7_f32": call}


def _k2_cross_rows():
    """K2's cross call on each cache -> {name: call}."""
    rows = {}
    for name, mode, heads, q_dtype, b in (
            ("k2_int4", "int4", HEADS, torch.bfloat16, ENC_B),
            ("k2_int4_d640", "int4", HEADS // 2, torch.bfloat16, ENC_B),
            ("k2_int4_f32q", "int4", HEADS, torch.float32, ENC_B),
            ("k2_int8", "int8", HEADS, torch.bfloat16, ENC_B),
            ("k2_int8_f32q", "int8", HEADS, torch.float32, ENC_B),
            ("k2_int8_b48", "int8", HEADS, torch.bfloat16, STREAM_B),
            ("k2_bf16", "bf16", HEADS, torch.bfloat16, ENC_B)):
        q = _randn(b, heads, 64, seed=80, dtype=q_dtype)
        kv = []
        for seed in (81, 82):
            x = _randn(b, T_ENC, heads * 64, seed=seed)
            if mode == "int4":
                codes, scale = whisper.quantize_kv_heads(x, heads, 4)
                kv.append((whisper.pack_int4(codes), scale))
            elif mode == "int8":
                kv.append(whisper.quantize_kv_rows(x))
            else:
                kv.append((x, None))
        (k, ks), (v, vs) = kv

        def call(q=q, k=k, v=v, ks=ks, vs=vs, heads=heads):
            return da.decode_attention(q, k, v, T_ENC, n_heads=heads, k_scale=ks, v_scale=vs)

        rows[name] = call
    return rows


def _int8_cache(b, heads, seed):
    """(k, v, k_scale, v_scale): an int8 cross cache with fp32 row scales."""
    (k, ks), (v, vs) = (whisper.quantize_kv_rows(_randn(b, T_ENC, heads * 64, seed=s))
                        for s in (seed, seed + 1))
    return k, v, ks, vs


def _head_entry(q, k, v, ks, vs, heads, shares):
    """A call of the head kernel's C entry over an int8 cache, every row
    valid, at a chosen grid (heads a CTA, key shares)."""
    b, t, _ = k.shape
    n_heads = q.shape[1]
    out = torch.empty_like(q)
    fn = _build.function("decode_attention", "kwt_decode_attention_heads")

    def call():
        rc = fn(0, q.data_ptr(), q.stride(0), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
                vs.data_ptr(), None, t, out.data_ptr(), b, t, n_heads, heads, shares,
                -(-t // shares), da.KV_INT8, int(q.dtype == torch.float32),
                _build.stream_handle(0))
        if rc != 0:
            raise RuntimeError(f"head kernel launch failed: cudaError {rc}")
        return out

    return call


def _head_probe_rows():
    """The head kernel over int8 under bf16 q at B=16 and 48, on the plan
    fp32 q takes -> {name: call}; none in a tree whose head kernel takes
    no int8."""
    if not hasattr(da, "head_plan"):
        return {}
    rows = {}
    for name, b in (("k2_int8_heads_bf16q", ENC_B), ("k2_int8_heads_bf16q_b48", STREAM_B)):
        q = _randn(b, HEADS, 64, seed=80)
        plan = da.head_plan(b, T_ENC, HEADS, da._n_sms(0), kv_dtype=torch.int8)
        rows[name] = _head_entry(q, *_int8_cache(b, HEADS, 81), plan.heads, plan.shares)
    return rows


def _ring_inputs(w, mode, seed=90, t=RING_T, ring_pos=RING_POS):
    """(q, k, v, k_scale, v_scale, valid, ring_pos) of a stream's ring call
    at phase 3's shape: W rows over T=176 slots, valid lengths over [1, 176],
    ring_pos 40 (most rows wrap); with ring_pos None, a self call as phase
    4's: valid the int T (every slot of every row), ring_pos None."""
    q = _randn(w, HEADS, 64, seed=seed)
    kv = []
    for s in (seed + 1, seed + 2):
        x = _randn(w, t, HEADS * 64, seed=s)
        if mode == "int8":
            kv.append(whisper.quantize_kv_rows(x))
        elif mode == "int8h":
            kv.append(whisper.quantize_kv_heads(x, HEADS, 8))
        else:
            kv.append((x, None))
    (k, ks), (v, vs) = kv
    if ring_pos is None:
        return q, k, v, ks, vs, t, None
    valid = torch.linspace(1, t, w, device=q.device).round().to(torch.int32)
    return q, k, v, ks, vs, valid, torch.tensor(ring_pos, dtype=torch.int32, device=q.device)


def _ring_rows():
    """K2's ring call in each self-cache mode -> {name: call}."""
    rows = {}
    for name, w, mode in (("ring_int8", STREAM_B, "int8"), ("ring_int8h", STREAM_B, "int8h"),
                          ("ring_bf16", STREAM_B, "bf16"),
                          ("ring_int8_w60", BEAM_STREAM_W, "int8")):
        q, k, v, ks, vs, valid, ring = _ring_inputs(w, mode)

        def call(q=q, k=k, v=v, ks=ks, vs=vs, valid=valid, ring=ring):
            return da.decode_attention(q, k, v, valid, n_heads=HEADS, k_scale=ks, v_scale=vs,
                                       ring_pos=ring)

        rows[name] = call
    return rows


def _ring_entry(inputs, heads, fn=None):
    """A call of the ring kernel's C entry (`fn`, else the built one's) at
    a chosen grid: heads a CTA."""
    q, k, v, ks, vs, valid, ring = inputs
    mode = (da.KV_BF16 if ks is None else
            da.KV_INT8_HEADS if ks.dtype == torch.bfloat16 else da.KV_INT8)
    out = torch.empty_like(q)
    fn = fn or _build.function("decode_attention_ring", "kwt_decode_attention_ring")

    def call():
        rc = fn(0, q.data_ptr(), q.stride(0), k.data_ptr(), v.data_ptr(),
                None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(),
                *((None, valid) if isinstance(valid, int) else (valid.data_ptr(), 0)),
                None if ring is None else ring.data_ptr(), out.data_ptr(),
                q.shape[0], k.shape[1], HEADS, heads, mode, _build.stream_handle(0))
        if rc != 0:
            raise RuntimeError(f"ring kernel launch failed: cudaError {rc}")
        return out

    return call


def _ring_probe_rows():
    """The per-row int8 ring form on a CTA a (row, head) at W=48 and 60 ->
    {name: call}."""
    return {name: _ring_entry(_ring_inputs(w, "int8"), 1)
            for name, w in (("ring_int8_heads1", STREAM_B),
                            ("ring_int8_w60_heads1", BEAM_STREAM_W))}


def _k8_rows():
    """K8 at the encoder's shape, fp32-q and bf16 forms -> {name: call}."""
    rows = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q, k, v = (_randn(ENC_B, T_ENC, HEADS, 64, seed=s, dtype=dtype) for s in (59, 60, 61))
        for mode in ("qk", "qkpv"):
            for no_max in ((False, True) if dtype == torch.float32 else (False,)):
                def call(q=q, k=k, v=v, mode=mode, no_max=no_max):
                    return fa.flash_attention_int8(q, k, v, mode=mode, no_max=no_max)

                rows[f"k8_{tag}_{mode}{'_nomax' if no_max else ''}"] = call
    return rows


def _beam_rows():
    """K2's beam form at beam search's shape -> {name: call}."""
    rows = {}
    g, beams = 12, 5
    for name, mode, q_dtype in (("beam_f32", "fp32", torch.float32),
                                ("beam_f32_int8", "int8", torch.float32),
                                ("beam_f32_int4", "int4", torch.float32),
                                ("beam_bf16", "bf16", torch.bfloat16),
                                ("beam_bf16_int8", "int8", torch.bfloat16),
                                ("beam_bf16_int4", "int4", torch.bfloat16)):
        q = _randn(g, beams, HEADS, 64, seed=52, dtype=q_dtype)
        kv = []
        for seed in (53, 54):
            x = _randn(g, T_ENC, HEADS * 64, seed=seed, dtype=torch.float32)
            if mode == "int4":
                codes, scale = whisper.quantize_kv_heads(x, HEADS, 4)
                kv.append((whisper.pack_int4(codes), scale))
            elif mode == "int8":
                kv.append(whisper.quantize_kv_rows(x))
            else:
                kv.append((x.to(q_dtype), None))
        (k, ks), (v, vs) = kv

        def call(q=q, k=k, v=v, ks=ks, vs=vs):
            return da.decode_attention_beam(q, k, v, n_heads=HEADS, k_scale=ks, v_scale=vs)

        rows[name] = call
    return rows


def _k9_rows():
    """K9's calibration loop, softmax and exp -> {name: call}."""
    rows, cols, iters = K9_BLOCK
    x = _randn(rows, cols, seed=95, dtype=torch.float32)
    return {f"k9_{op}": (lambda op=op: vpu_cal.vpu_cal(x, iters, op)) for op in ("softmax", "exp")}


def head_sweep() -> dict:
    """Device ms of the int8 head kernel under fp32 q at the cross call
    (B=16, T=1500) by heads a CTA x key shares, at 20 and 10 heads ->
    {"H20 h4 s4": ms}."""
    out = {}
    for n_heads in (HEADS, HEADS // 2):
        q = _randn(ENC_B, n_heads, 64, seed=83, dtype=torch.float32)
        cache = _int8_cache(ENC_B, n_heads, 84)
        for heads in (h for h in da.HEAD_HEADS if n_heads % h == 0):
            for shares in (2, 3, 4, 5, 6, 8):
                if da.head_smem_bytes(-(-T_ENC // shares), heads, torch.int8) > da.SMEM_LIMIT:
                    continue
                out[f"H{n_heads} h{heads} s{shares}"] = graph_ms(
                    _head_entry(q, *cache, heads, shares))
    return out


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


# csrc/flash_attention_f32.cu patched into K4 fp32's probe, which --k4-sweep
# times beside the shipped kernel (ROADMAP tier B item 10): the end-aligned
# causal mask on the non-causal kernel's 128-row work items. The producer
# fills the key tiles at or below an item's last row's bound, each consumer
# computes those at or below its own rows' and releases the rest unread (so
# that the ring's phases stay in step), and a causal call takes that kernel
# in place of the causal one. Each text is found once in the source.
K4_PROBE_PATCHES = (
    ("      for (int j = 0; j < n_kt; ++j, ++it) {\n        const int st",
     "      const int n_j = causal_tiles(tq, tk, (w - bh * n_qtiles) * kTcBM, kTcBM);\n"
     "      for (int j = 0; j < n_j; ++j, ++it) {\n        const int st"),
    ("    for (int j = 0; j < n_kt; ++j, ++it) {\n      const int st",
     "    const int n_item = causal_tiles(tq, tk, qrow0 - c * kTcRows, kTcBM);\n"
     "    const int n_mine = causal_tiles(tq, tk, qrow0, kTcRows);\n"
     "    const int n_free = min(n_mine, (qrow0 + tk - tq + 1) / kTcBN);\n"
     "    for (int j = 0; j < n_mine; ++j, ++it) {\n      const int st"),
    ("va, ragged,\n                   ragged ? tk - j * kTcBN - 2 * t4 : kTcBN, kTcBN);",
     "va, ragged || j >= n_free,\n                   ragged ? tk - j * kTcBN - 2 * t4 : kTcBN,\n"
     "                   qrow0 + r0 + tk - tq - j * kTcBN - 2 * t4);"),
    ("      add_tile(oacc, otile, corr);\n    }\n    epilogue<kNoMax>",
     "      add_tile(oacc, otile, corr);\n    }\n"
     "    for (int j = n_mine; j < n_item; ++j, ++it) {\n"
     "      const int st = it % kTcStages;\n"
     "      mbar_wait(&s.full[st], (it / kTcStages) & 1);\n"
     "      mbar_arrive(&s.empty[st]);\n"
     "    }\n    epilogue<kNoMax>"),
    ("  if (causal) {", "  if (false) {"),
)


def k4_probe_source(src: str) -> str:
    """The fp32 attention source with K4_PROBE_PATCHES applied."""
    from kotoba_whisper_tpu_torch.tools.beam_probe import replace_once

    for old, new in K4_PROBE_PATCHES:
        src = replace_once(src, old, new, "k4_probe")
    return src


def _k4_probe():
    """K4 fp32's probe: `k4_probe_source` built by its own nvcc into
    build/k4_probe/ -> its kwt_flash_attention_f32 entry."""
    from kotoba_whisper_tpu_torch.tools.beam_probe import build_variants

    src = k4_probe_source(open(_build.source_path("flash_attention_f32")).read())
    (lib, _), = build_variants(os.path.join(os.path.dirname(_build.BUILD_DIR), "k4_probe"),
                               {"wgmma_probe": src}, "flash_attention_f32",
                               "kwt_flash_attention_f32", "k4_probe").values()
    return lib.kwt_flash_attention_f32


def _k4_probe_call(fn, q, k, v):
    """A causal call of the probe's C entry on q, k, v with the wrapper's
    plan -> a call returning (o, lse)."""
    (b, tq, h), plan = fa._f32_plan((q.shape, q.stride()), (k.shape, k.stride()),
                                    (v.shape, v.stride()), True)
    o = q.new_empty((b, tq, h, 64))
    lse = q.new_empty((b, h, tq))

    def call():
        rc = fn(0, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), plan,
                _build.stream_handle(0))
        if rc != 0:
            raise RuntimeError(f"K4 fp32 probe launch failed: cudaError {rc}")
        return o, lse

    return call


def k4_sweep() -> dict:
    """Device ms of K4's fp32 form at K4_SWEEP's shapes, each beside its
    probe, which is first held to the twin (relative L2 and LSE max |err|
    <= 1e-5, the card test's bounds) -> {"BxTqxTkxH": ms,
    "BxTqxTkxH wgmma_probe": ms}."""
    probe = _k4_probe()
    out = {}
    for b, tq, tk, h in K4_SWEEP:
        q = _randn(b, tq, h, 64, seed=73, dtype=torch.float32)
        k, v = (_randn(b, tk, h, 64, seed=s, dtype=torch.float32) for s in (74, 75))
        name = f"{b}x{tq}x{tk}x{h}"
        out[name] = graph_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
        call = _k4_probe_call(probe, q, k, v)
        (o, lse), (ro, rlse) = call(), fa.flash_attention_reference(q, k, v, True)
        rel, lse_err = float((o - ro).norm() / ro.norm()), float((lse - rlse).abs().max())
        if not (rel <= 1e-5 and lse_err <= 1e-5):
            raise RuntimeError(f"K4 fp32 probe at {name} is off the twin: rel-L2 {rel:.3e}, "
                               f"LSE {lse_err:.3e}")
        out[f"{name} wgmma_probe"] = graph_ms(call)
    return out


def measure(reps: int) -> dict:
    # the probes' rows, then rows added later (K9), last: a
    # tree without them (the parent in turns) then allocates every other
    # row's tensors as this one does, at the same
    # addresses (on an H100 80GB HBM3 at 700 W the K2 beam int4 row's
    # identical kernel read 5-6 % apart in one run where only one tree
    # allocated the probe's tensors first, and alike with them last)
    makers = (_self_rows, _k2_cross_rows, _k1_f32_rows, _k5_rows, _k7_f32_rows, _k8_rows,
              _beam_rows, _ring_rows, _head_probe_rows, _ring_probe_rows, _k9_rows)
    rows = {}
    for make in makers:
        rows.update(make())
    rec = {name: {"device_ms": [graph_ms(call) for _ in range(reps)], "host_us": host_us(call)}
           for name, call in rows.items()}
    for name, call in rows.items():
        kernels = kernel_split(call)
        if len(kernels) > 1:
            rec[name]["kernels_ms"] = kernels
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reps", type=int, default=3, help="timings of each row")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the int8 head kernel's grids")
    ap.add_argument("--k5-sweep", action="store_true",
                    help="also time K5's fp32 causal form over batch, heads and T")
    ap.add_argument("--k4-sweep", action="store_true",
                    help="also time K4's fp32 form at its card tests' shapes")
    args = ap.parse_args(argv)
    resolve_device("cuda")
    rec = {"rows": measure(args.reps),
           "device": torch.cuda.get_device_name(0)}
    if args.sweep:
        rec["head_int8_sweep"] = head_sweep()
    if args.k5_sweep:
        rec["k5_f32_causal_sweep"] = k5_sweep()
    if args.k4_sweep:
        rec["k4_f32_sweep"] = k4_sweep()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    rec["nvidia_smi"] = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else None
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
