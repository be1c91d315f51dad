"""Chip smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py                # the check: one card, no arguments
    python3 chip_smoke.py --profile DIR  # also trace one main-path run, one
                                         # fused + w8a8 run and one train step
                                         # with torch.profiler, tables into DIR/

Phases, in order; any failure exits nonzero and prints no result line:

  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: every CUDA kernel of the port (csrc/*.cu) with nvcc, in parallel;
  3. kernels: the card's exponential rate (K9), then each kernel against
     its plain PyTorch twin on the card at the shapes of the path that runs
     it (large-v3; B=16 pseudo-labelling and encoder, B=8 x 128 labels
     training), with its time, the twin's time, a library call's time and
     the least time the card could take; each also with its device time
     alone and the library call's (a CUDA graph of 20 calls, replayed; K5's
     library call, autograd through SDPA, from torch.profiler's kernel
     times where a graph cannot capture it) and the host's time per call
     of each; K3 also on a wide-dynamic-range
     input, its raw values read by region against a float64 evaluation;
     K4's device time also by batch;
  4. main path: large-v3 width and depth with seeded random weights, bf16,
     int8 KV, B=16, 48 new tokens with eot disabled:
     log_mel_spectrogram -> generate_greedy, with launch counters checked;
     then at B=2, on three seeds, the kernel path against the plain path
     on the card: each encoder layer's attention (with a dropped-key-tile
     control), the whole encoder beside a one-ulp witness, the logits;
  4c. the same path with the inference transforms, fused projections and
     w8a8 (bench.py's fixed-*-w8a8 recipe): B=16 with launch counters and
     stage times, one B=64 batch, the B=2 kernel-vs-plain checks;
  4d. encoder variants at B=16 on the fused model: default, the fused stem
     (K7), KWT_FA_INT8=qk and qkpv (K8 in place of K1), enc_exp's fused_ln
     (K6), each with its time, rel-L2 against the default and launches;
  4b. train path: distillation of a 32+2-layer student initialised from a
     seeded random large-v3 teacher, B=8 x 128 labels, bf16 compute on fp32
     master weights: one warm-up step and 3 timed steps with launch
     counters checked; frozen encoder unchanged, decoder moved; at B=2 the
     kernel path against the plain path (loss and decoder gradients); one
     B=16 step in 2 microbatches;
  5. driver: cli/pseudo_label on synthetic WAV utterances in a tar shard,
     with its default fusion, then with --gemm_dtype int8 under
     KWT_FA_INT8=qk;
  5b. training driver: cli/create_student (4-layer encoder at large-v3
     width) -> cli/distill 2 steps, save -> resume to step 3 -> export;
  5c. the experiment tools' main(): enc_exp (fused_ln), stem_exp, vpu_cal
     (softmax and exp), few trials, their JSON lines parsed;
  6. a JSON line of every kernel with the launches of the path that runs
     it (K1-K3: the pseudo-labelling run; K4, K5: the 3 timed train steps;
     K6-K8: the 4d encoder runs; K9: the vpu_cal runs of 5c) and its
     numbers;
  7. the last line: {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# Published dense peaks of the card the port targets (NVIDIA H100 SXM data
# sheet): bf16 tensor FLOP/s, fp32 CUDA-core FLOP/s, memory bytes/s, int8
# tensor OP/s. Another card needs its own entry; the bounds are not guessed
# for it.
PEAKS = {"H100 80GB HBM3": (989e12, 67e12, 3.35e12, 1979e12)}
# Relative L2 error allowed of every kernel against its twin: ~10x the bf16
# rounding of K1's and K2's outputs; a dropped or mis-weighted key tile moves
# it by ~1e-1 on random inputs and by ~1.9e-2 on the encoder's own
# activations, whose softmax is nearly flat (phases 4 and 4c read that).
REL_L2_TOL = 1e-2
B = 16            # main-path batch (lockstep)
NEW_TOKENS = 48   # decode steps, eot disabled
TRAIN_B = 8       # train-path batch (the JAX package's train-b8)
LABELS = 128      # label length, the last 16 set to -100
TRAIN_STEPS = 3   # timed train steps after one warm-up step
# B=2 train step, kernel path vs plain path on the card (bf16 through the
# 32-layer frozen encoder and teacher): loss relative difference, and
# relative L2 of the student decoder's gradients, all parameters together.
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one fn() with no host in the way: fn captured `iters`
    times into a CUDA graph, the graph replayed (CUDA events), per call."""
    fn()  # warm-up outside the capture: builds, first-use attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def host_us(fn, calls: int = 200) -> float:
    """Host time of one fn() call, back to back (the card, never idle-bound
    here, lags behind): Python, checks, ctypes and the launch."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def library_device_ms(fn, iters: int = 20):
    """Device time of one fn() as graph_ms reads it, with "graph"; where fn
    cannot be captured in a CUDA graph, the summed device time of its
    kernels per call from torch.profiler over `iters` calls, with
    "profiler"."""
    try:
        return graph_ms(fn, iters), "graph"
    except RuntimeError as e:
        log(f"[kernel] a CUDA graph cannot capture the library call ({str(e)[:200]}); "
            "its device time is read from torch.profiler")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / 1e3 / iters, "profiler"


def bound(flops: float, flop_rate: float, nbytes: float, mem_rate: float,
          exp_s: float = 0.0, more_s: float = 0.0):
    """Least time (ms) and what sets it: the tensor or CUDA-core work
    (flops / flop_rate, plus `more_s` of other tensor work) or the
    exponentials (`exp_s`: they run on the special function units, beside
    the tensor cores), against the bytes."""
    t_ops = max(flops / flop_rate + more_s, exp_s) * 1e3
    t_bytes = nbytes / mem_rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def randn(*shape, seed, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)


def wav_bytes(audio: np.ndarray, sr: int = 16000) -> bytes:
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes()
    return struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(pcm), b"WAVE", b"fmt ", 16, 1, 1,
        sr, sr * 2, 2, 16, b"data", len(pcm),
    ) + pcm


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="trace one main-path run, one fused + w8a8 run and one "
                    "train step with torch.profiler and write their whole kernel "
                    "tables to DIR/profile_{main_path,w8a8_path,train_step}.txt")
    args = ap.parse_args()

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the card only")
        return 2
    from kotoba_whisper_tpu_torch.cli import create_student, pseudo_label
    from kotoba_whisper_tpu_torch.cli import distill as distill_cli
    from kotoba_whisper_tpu_torch.core.config import PRESETS, FeatureConfig, SpecialTokens
    from kotoba_whisper_tpu_torch.data import reazon
    from kotoba_whisper_tpu_torch.data.shards import ShardWriter
    from kotoba_whisper_tpu_torch.decode.greedy import (
        GenerateOptions, generate_greedy, transcribe_prompt,
    )
    from kotoba_whisper_tpu_torch.models import whisper
    from kotoba_whisper_tpu_torch.models.optimized import fuse_for_inference
    from kotoba_whisper_tpu_torch.models.quantized import quantize_for_inference
    from kotoba_whisper_tpu_torch.models.student_init import init_student_from_teacher
    from kotoba_whisper_tpu_torch.models.whisper import quantize_kv_rows
    from kotoba_whisper_tpu_torch.ops import _build
    from kotoba_whisper_tpu_torch.ops import conv_stem as cs
    from kotoba_whisper_tpu_torch.ops import decode_attention as da
    from kotoba_whisper_tpu_torch.ops import flash_attention as fa
    from kotoba_whisper_tpu_torch.ops import layer_norm as ln
    from kotoba_whisper_tpu_torch.ops import mel
    from kotoba_whisper_tpu_torch.tools import enc_exp, stem_exp, vpu_cal
    from kotoba_whisper_tpu_torch.train import distill, optim
    from kotoba_whisper_tpu_torch.train.checkpoint import get_last_checkpoint, import_hf_model

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain twins are fp32
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    peak_name = next((k for k in PEAKS if k in kind), None)
    if peak_name is None:
        raise RuntimeError(f"no peak rates for card {kind!r}: add its data sheet to PEAKS")
    bf16_rate, fp32_rate, mem_rate, int8_rate = PEAKS[peak_name]
    card = f"{kind} @ {smi.split(',')[-1].strip()}"
    log(f"[device] torch: {kind}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"peaks from the '{peak_name}' data sheet")
    log(smi)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    per_source = _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    log(f"[build] {time.perf_counter() - t0:.1f} s for {len(per_source)} sources "
        f"compiled in parallel ({', '.join(f'{k} {v:.1f} s' for k, v in per_source.items())}) "
        f"into {_build.BUILD_DIR}")

    # ---- 3. kernels against their plain twins, at main-path shapes --------
    # The exp term of the attention kernels' bounds is the data sheet's
    # special-function-unit rate (16 ex2 a clock per SM at the maximum SM
    # clock). K9's bare-exp loop reads how near one latency-bound loop comes
    # to it (per launch, and marginal: twice the iterations minus once); a
    # diagnostic only, never a bound.
    cal = vpu_cal.measure(op="exp", trials=3)
    exp_rate = cal["exp_per_s_peak"]
    log(f"[kernel] exp rate for the bounds: data sheet {exp_rate:.4g} exp/s (16/clock/SM at "
        f"the max SM clock); K9's exp2f loop reads {cal['exp_per_s']:.4g} per launch, "
        f"{cal['exp_per_s_marginal']:.4g} marginal "
        f"({cal['exp_per_s_marginal'] / cal['sms']:.4g} per SM) [{card}]")
    records = []
    launch_key = {}  # record name -> the counter that gives its launches
    large = PRESETS["large-v3"]
    h, d = large.encoder_attention_heads, large.d_model
    t_enc = large.max_source_positions
    cap = 3 + NEW_TOKENS  # self-KV capacity: prompt + new tokens

    def compare(got, ref):
        """Max |err| and relative L2 error of a kernel's output against its twin."""
        got, ref = got.float(), ref.float()
        return float((got - ref).abs().max()), float((got - ref).norm() / ref.norm())

    def fmt(v):
        return "null" if v is None else v if isinstance(v, str) else f"{v:.4f}"

    def record(name, source, replaces, errs, tol, ms, plain_ms, lib_ms, bnd, key=None,
               **timings):
        """One kernel's record; `timings` add device_ms (the kernel in a
        replayed CUDA graph), library_device_ms (the library call the same
        way, or null where there is none), host_us and library_host_us (the
        host's time per call of each)."""
        launch_key[name] = key or name[:2]
        err, rel = errs
        ok = err <= tol and rel <= REL_L2_TOL
        rec = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib_ms, **timings)
        log(f"[kernel] {name}: max_abs_err {err:.3e} (tol {tol:g}) rel_l2 {rel:.3e} "
            f"(tol {REL_L2_TOL:g}) "
            f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms {bnd[0]:.4f} "
            f"({bnd[1]})"
            f"{''.join(f' {k} {fmt(v)}' for k, v in timings.items())} [{card}] "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain twin")
        records.append(rec)

    # K1: encoder self-attention (B, 1500, 20, 64) bf16, once per layer
    q, k, v = (randn(B, t_enc, h, 64, seed=s) for s in (1, 2, 3))
    o, lse = fa.flash_attention_fwd(q, k, v)
    ro, rlse = fa.flash_attention_reference(q, k, v)
    errs = compare(o, ro)
    lse_err = float((lse - rlse).abs().max())
    del ro, rlse
    if lse_err > 1e-3:
        raise AssertionError(f"K1 LSE disagrees: {lse_err}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def k1_call():
        return fa.flash_attention_fwd(q, k, v)

    def k1_library():
        return F.scaled_dot_product_attention(qt, kt, vt)

    record(
        "K1 flash_attention_fwd (B=16, T=1500, H=20, D=64, bf16)",
        "kotoba_whisper_tpu_torch/csrc/flash_attention_sm90.cu",
        "kotoba_whisper_tpu/ops/flash_attention.py:69", errs, 5e-3,
        time_ms(k1_call), time_ms(lambda: fa.flash_attention_reference(q, k, v)),
        time_ms(k1_library),
        bound(4.0 * B * h * t_enc * t_enc * 64, bf16_rate,
              nbytes(q, k, v, o, lse), mem_rate, exp_s=B * h * t_enc * t_enc / exp_rate),
        device_ms=graph_ms(k1_call), library_device_ms=graph_ms(k1_library),
        host_us=host_us(k1_call), library_host_us=host_us(k1_library),
    )
    del q, k, v, o, lse, qt, kt, vt
    torch.cuda.empty_cache()

    # K2: decode-step attention, cross (T=1500) int8 and bf16, self int8
    for label, t, int8 in (("cross int8", t_enc, True), ("cross bf16", t_enc, False),
                           ("self int8", cap, True)):
        qd = randn(B, h, 64, seed=4)
        kf, vf = randn(B, t, d, seed=5), randn(B, t, d, seed=6)
        ks = vs = None
        if int8:
            kf, ks = quantize_kv_rows(kf)
            vf, vs = quantize_kv_rows(vf)
        out = da.decode_attention(qd, kf, vf, t, n_heads=h, k_scale=ks, v_scale=vs)
        ref = da.decode_attention_reference(qd, kf, vf, t, n_heads=h, k_scale=ks, v_scale=vs)
        errs = compare(out, ref)
        kb = (kf.float() * ks if int8 else kf).to(torch.bfloat16)
        vb = (vf.float() * vs if int8 else vf).to(torch.bfloat16)
        kh = kb.view(B, t, h, 64).transpose(1, 2)
        vh = vb.view(B, t, h, 64).transpose(1, 2)
        qh = qd[:, :, None]

        def call():
            return da.decode_attention(qd, kf, vf, t, n_heads=h, k_scale=ks, v_scale=vs)

        def library():
            return F.scaled_dot_product_attention(qh, kh, vh)

        record(
            f"K2 decode_attention {label} (B=16, T={t}, D=1280)",
            "kotoba_whisper_tpu_torch/csrc/decode_attention.cu",
            "kotoba_whisper_tpu/ops/decode_attention.py:165", errs, 2e-3,
            time_ms(call),
            time_ms(lambda: da.decode_attention_reference(
                qd, kf, vf, t, n_heads=h, k_scale=ks, v_scale=vs)),
            time_ms(library),
            bound(4.0 * B * t * d, fp32_rate, nbytes(qd, kf, vf, ks, vs, out), mem_rate),
            device_ms=graph_ms(call), library_device_ms=graph_ms(library),
            host_us=host_us(call), library_host_us=host_us(library),
        )
        del qd, kf, vf, ks, vs, out, ref, kb, vb, kh, vh, qh

    # K3: fused log-mel, (B, 480000) fp32 and int16 -> (B, 3000, 128)
    feat = FeatureConfig(n_mels=large.num_mel_bins)
    audio_np = (np.random.default_rng(0).standard_normal((B, feat.n_samples)) * 0.1
                ).astype(np.float32)
    window = torch.hann_window(feat.n_fft, periodic=True, device="cuda")
    fb_np = mel.mel_filterbank(201, feat.n_mels, 16000, 0.0, 8000.0)
    fb = torch.from_numpy(fb_np).cuda()
    # Operations the function needs per frame: window, a real FFT of n_fft
    # points (~2.5 N log2 N flops; the kernel's 200-point complex FFT and
    # real split come to about that), power, the mel product over the
    # filters' nonzeros and the log.
    bins = feat.n_fft // 2 + 1
    frame_flops = (feat.n_fft + 2.5 * feat.n_fft * math.log2(feat.n_fft) + 3 * bins
                   + 2 * int((fb_np != 0).sum()) + feat.n_mels)

    def stft_mel(x, w=window, f=fb):
        """The function in library calls, in the precision of x, w and f."""
        spec = torch.stft(x, feat.n_fft, feat.hop_length, window=w, center=True,
                          pad_mode="reflect", return_complex=True)[..., :-1]
        return torch.log10(torch.clamp(spec.abs().square().transpose(1, 2) @ f, min=1e-10))

    def int16_wire(a):
        return np.clip(np.round(a * 32768), -32768, 32767).astype(np.int16)

    for label, wire in (("fp32", audio_np), ("int16", int16_wire(audio_np))):
        x = torch.from_numpy(wire).cuda()
        got = mel.finish_log_mel(mel.log_mel_frames(x, feat))
        ref = mel.finish_log_mel(mel.log_mel_frames_reference(x, feat))
        errs = compare(got, ref)
        xf = mel._audio_f32(x)
        out_bytes = B * feat.n_frames * feat.n_mels * 4

        def call():
            return mel.log_mel_frames(x, feat)

        def library():
            return stft_mel(xf)

        record(
            f"K3 log_mel {label} (B=16, 480000 samples -> 3000 x 128)",
            "kotoba_whisper_tpu_torch/csrc/mel.cu",
            "kotoba_whisper_tpu/ops/mel_pallas.py:69", errs, 1e-4,
            time_ms(call), time_ms(lambda: mel.log_mel_frames_reference(x, feat)),
            time_ms(library),
            bound(B * feat.n_frames * frame_flops, fp32_rate, nbytes(x) + out_bytes, mem_rate),
            device_ms=graph_ms(call), library_device_ms=graph_ms(library),
            host_us=host_us(call), library_host_us=host_us(library),
        )
        del x, got, ref, xf
    # a wide dynamic range: a 440 Hz tone at amplitude 0.5 over noise at
    # 1e-4, with a stretch of exact zeros, puts mel bins near the max-8
    # clamp and at the 1e-10 floor (white noise at 0.1 puts none there).
    # After finish_log_mel only the bins above max-8 differ, so the raw
    # log10 values are also read, in three regions of a float64 evaluation
    # of the function (stft_mel): kept above max-8, clamped away, and at
    # the floor. Below max-8 an fp32 result is only as good as the frame's
    # energy allows, so in each region the kernel is held to the twin's
    # error against float64: at least as close as the plain fp32 version.
    # Frames of exact zeros give -10 exactly.
    t_s = np.arange(feat.n_samples) / feat.sampling_rate
    wide = (0.5 * np.sin(2 * np.pi * 440.0 * t_s)
            + 1e-4 * np.random.default_rng(1).standard_normal((B, feat.n_samples)))
    wide[:, feat.n_samples // 3: feat.n_samples // 2] = 0.0
    wide = wide.astype(np.float32)
    for label, wire in (("fp32", wide), ("int16", int16_wire(wide))):
        x = torch.from_numpy(wire).cuda()
        raw, twin = mel.log_mel_frames(x, feat), mel.log_mel_frames_reference(x, feat)
        err, rel = compare(mel.finish_log_mel(raw), mel.finish_log_mel(twin))
        xf = mel._audio_f32(x)
        truth = stft_mel(xf.double(), window.double(), fb.double())
        kept = truth > torch.amax(truth, dim=(1, 2), keepdim=True) - 8.0
        floor = truth <= -10.0
        regions = {"kept": kept, "clamped": ~kept & ~floor, "floor": floor}
        frames = F.pad(xf[:, None], (feat.n_fft // 2,) * 2, mode="reflect")[:, 0]
        silent = frames.unfold(-1, feat.n_fft, feat.hop_length)[:, :feat.n_frames]
        silent = silent.abs().amax(-1) == 0  # (B, frames) of exact zeros
        exact = bool((raw[silent] == -10.0).all()) and bool(silent.any())
        ok = err <= 1e-4 and rel <= REL_L2_TOL and exact
        parts = []
        for region, m in regions.items():
            e_k = float((raw.double() - truth).abs()[m].max())
            e_t = float((twin.double() - truth).abs()[m].max())
            ok = ok and e_k <= e_t
            parts.append(f"{region} {float(m.float().mean()):.3f} of the bins: "
                         f"|kernel - f64| {e_k:.3e} (tol: |twin - f64| {e_t:.3e})")
        log(f"[kernel] K3 log_mel {label}, wide dynamic range: max_abs_err {err:.3e} (tol 1e-4) "
            f"rel_l2 {rel:.3e} (tol {REL_L2_TOL:g}); raw log10 by region, "
            f"{'; '.join(parts)}; silent frames at -10 exactly: {exact} [{card}] "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("K3 on the wide-dynamic-range input disagrees with its twin "
                                 "or with the float64 function")
        del x, raw, twin, xf, truth, kept, floor, regions, frames, silent
    del wide
    torch.cuda.empty_cache()

    # K4: causal forward at the decoder's training shape (B=8, T=128). The
    # first rows see one or a few keys and return V's rows nearly
    # unaveraged (|O| up to ~4.5, where one bf16 rounding step is 2^-5), so
    # max |err| is held to 1e-2 of the twin's largest magnitude, as K5's.
    q, k, v = (randn(TRAIN_B, LABELS, h, 64, seed=s) for s in (7, 8, 9))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=True)
    k4_tol = 1e-2 * float(ro.float().abs().max())
    lse_err = float((lse - rlse).abs().max())
    if lse_err > 1e-3:
        raise AssertionError(f"K4 LSE disagrees: {lse_err}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = LABELS * (LABELS + 1) // 2  # (query, key) pairs the mask keeps

    def k4_call():
        return fa.flash_attention_fwd(q, k, v, causal=True)

    def k4_library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    record(
        f"K4 flash_attention_fwd causal (B={TRAIN_B}, T={LABELS}, H=20, D=64, bf16)",
        "kotoba_whisper_tpu_torch/csrc/flash_attention_sm90.cu",
        "kotoba_whisper_tpu/ops/flash_attention.py:222", compare(o, ro), k4_tol,
        time_ms(k4_call), time_ms(lambda: fa.flash_attention_reference(q, k, v, causal=True)),
        time_ms(k4_library),
        bound(4.0 * TRAIN_B * h * pairs * 64, bf16_rate, nbytes(q, k, v, o, lse), mem_rate,
              exp_s=TRAIN_B * h * pairs / exp_rate),
        device_ms=graph_ms(k4_call), library_device_ms=graph_ms(k4_library),
        host_us=host_us(k4_call), library_host_us=host_us(k4_library),
    )
    # K4's device time by batch at T=128: each (batch, head) is one
    # 128-row work item on a persistent grid of one CTA per SM, so a step
    # shows where the items pass the SM count and a second wave starts
    by_batch = []
    for b_sweep in (6, 7, 8, 13):
        qs_, ks_, vs_ = (randn(b_sweep, LABELS, h, 64, seed=s) for s in (7, 8, 9))
        by_batch.append(f"B={b_sweep} ({b_sweep * h} items) "
                        f"{graph_ms(lambda: fa.flash_attention_fwd(qs_, ks_, vs_, causal=True)):.4f}")
    log(f"[kernel] K4 device_ms by batch (T={LABELS}, {h} heads, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs): "
        f"{', '.join(by_batch)} [{card}]")
    del q, k, v, o, lse, ro, rlse, qt, kt, vt, qs_, ks_, vs_

    # K5: backward of the student decoder's causal self-attention (T=128:
    # one key tile, dQ written directly) and of its cross-attention (128
    # labels x 1500 encoder frames: dQ summed over 12 key tiles by fp32
    # reduce-adds). Each gradient is held to its twin by max |err| <= 1e-2
    # of the twin's largest magnitude (their scale follows the inputs) and
    # by REL_L2_TOL.
    for label, tk, causal in (("causal", LABELS, True), ("cross", t_enc, False)):
        q = randn(TRAIN_B, LABELS, h, 64, seed=10)
        k, v = randn(TRAIN_B, tk, h, 64, seed=11), randn(TRAIN_B, tk, h, 64, seed=12)
        do = randn(TRAIN_B, LABELS, h, 64, seed=13)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
        errs, tol = [], 0.0
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            err, rel = compare(g, r)
            g_tol = 1e-2 * float(r.float().abs().max())
            log(f"[kernel] K5 {label} {name}: max_abs_err {err:.3e} (tol {g_tol:.3e}) "
                f"rel_l2 {rel:.3e} (tol {REL_L2_TOL:g})")
            if err > g_tol or rel > REL_L2_TOL:
                raise AssertionError(f"K5 {label} {name} disagrees with its plain twin")
            errs.append((err, rel))
            tol = max(tol, g_tol)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        do_t = do.transpose(1, 2)
        n_pairs = LABELS * (LABELS + 1) // 2 if causal else LABELS * tk

        def k5_call():
            return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)

        def k5_library():
            return torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t, retain_graph=True)

        lib_dev, lib_by = library_device_ms(k5_library)
        record(
            f"K5 flash_attention_bwd {label} (B={TRAIN_B}, Tq={LABELS}, Tk={tk}, H=20, "
            "D=64, bf16; dQ, dK, dV)",
            "kotoba_whisper_tpu_torch/csrc/flash_attention_bwd.cu",
            "kotoba_whisper_tpu/ops/flash_attention.py:315",
            (max(e for e, _ in errs), max(r for _, r in errs)), tol,
            time_ms(k5_call),
            time_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                             causal=causal)),
            time_ms(k5_library),
            # S, dP, dV, dQ, dK: five products over the kept pairs, and
            # one exponential each
            bound(10.0 * TRAIN_B * h * n_pairs * 64, bf16_rate,
                  nbytes(q, k, v, o, lse, do, *got), mem_rate,
                  exp_s=TRAIN_B * h * n_pairs / exp_rate),
            device_ms=graph_ms(k5_call), library_device_ms=lib_dev,
            library_device_by=lib_by, host_us=host_us(k5_call),
            library_host_us=host_us(k5_library),
        )
        del q, k, v, do, o, lse, got, ref, qt, kt, vt, sdpa_out, do_t
    torch.cuda.empty_cache()

    def ulp_bf16(x: float) -> float:
        return 2.0 ** (math.floor(math.log2(x)) - 7)

    # K6: LayerNorm and the fused residual add + LayerNorm over the
    # encoder's (B*1500, 1280) bf16 rows; the LayerNorm held to one bf16
    # ulp of the twin's largest output (plus 2e-6), the sum bit for bit
    rows = B * t_enc
    x = randn(rows, d, seed=20) * 3 + 1
    y = randn(rows, d, seed=21)
    w = 1 + 0.1 * randn(d, seed=22)
    bb = 0.1 * randn(d, seed=23)
    got = ln.layer_norm(x, w, bb)
    ref = ln.layer_norm_reference(x, w, bb)

    def k6_call():
        return ln.layer_norm(x, w, bb)

    def k6_library():
        return F.layer_norm(x, (d,), w, bb)

    record(
        f"K6 layer_norm ({rows}, {d}) bf16",
        "kotoba_whisper_tpu_torch/csrc/layer_norm.cu",
        "kotoba_whisper_tpu/ops/layer_norm.py:45", compare(got, ref),
        ulp_bf16(float(ref.float().abs().max())) + 2e-6,
        time_ms(k6_call), time_ms(lambda: ln.layer_norm_reference(x, w, bb)),
        time_ms(k6_library),
        bound(10.0 * rows * d, fp32_rate, nbytes(x, w, bb, got), mem_rate), key="K6ln",
        device_ms=graph_ms(k6_call), library_device_ms=graph_ms(k6_library),
        host_us=host_us(k6_call), library_host_us=host_us(k6_library),
    )
    summed, got = ln.add_layer_norm(x, y, w, bb)
    ref_sum, ref = ln.add_layer_norm_reference(x, y, w, bb)
    if not (torch.equal(summed, x + y) and torch.equal(summed, ref_sum)):
        raise AssertionError("K6 add_layer_norm: the sum differs from x + y")

    def k6_add_call():
        return ln.add_layer_norm(x, y, w, bb)

    def k6_add_library():
        return F.layer_norm(x + y, (d,), w, bb)

    record(
        f"K6 add_layer_norm ({rows}, {d}) bf16",
        "kotoba_whisper_tpu_torch/csrc/layer_norm.cu",
        "kotoba_whisper_tpu/ops/layer_norm.py:52", compare(got, ref),
        ulp_bf16(float(ref.float().abs().max())) + 2e-6,
        time_ms(k6_add_call), time_ms(lambda: ln.add_layer_norm_reference(x, y, w, bb)),
        time_ms(k6_add_library),
        bound(11.0 * rows * d, fp32_rate, nbytes(x, y, w, bb, summed, got), mem_rate),
        key="K6add", device_ms=graph_ms(k6_add_call),
        library_device_ms=graph_ms(k6_add_library), host_us=host_us(k6_add_call),
        library_host_us=host_us(k6_add_library),
    )
    del x, y, w, bb, got, ref, summed, ref_sum

    # K7: the fused stem, (16, 128, 3000) -> (16, 1500, 1280); max |err|
    # held to 1e-2 of the twin's largest output (bf16 after fp32 sums)
    n_mels = large.num_mel_bins
    conv1 = torch.nn.Conv1d(n_mels, d, 3, padding=1, device="cuda")
    conv2 = torch.nn.Conv1d(d, d, 3, stride=2, padding=1, device="cuda")
    with torch.no_grad():
        for i, c in enumerate((conv1, conv2)):
            c.weight.copy_(randn(*c.weight.shape, seed=24 + i) * 0.02)
            c.bias.copy_(randn(d, seed=26 + i) * 0.1)
    conv1, conv2 = conv1.to(torch.bfloat16), conv2.to(torch.bfloat16)
    xs = randn(B, n_mels, 2 * t_enc, seed=28)
    with torch.no_grad():
        got = cs.conv_stem(conv1, conv2, xs)
        ref = cs.conv_stem_reference(conv1.weight, conv1.bias, conv2.weight, conv2.bias, xs)

        def cudnn_stem():
            hh = F.gelu(F.conv1d(xs, conv1.weight, conv1.bias, padding=1))
            return F.gelu(F.conv1d(hh, conv2.weight, conv2.bias, stride=2, padding=1))

        def k7_call():
            return cs.conv_stem(conv1, conv2, xs)

        stem_flops = 2.0 * B * 2 * t_enc * 3 * n_mels * d + 2.0 * B * t_enc * 3 * d * d
        record(
            f"K7 conv_stem (B={B}, {n_mels} x {2 * t_enc} -> {t_enc} x {d}, bf16)",
            "kotoba_whisper_tpu_torch/csrc/conv_stem.cu",
            "kotoba_whisper_tpu/ops/conv_stem.py:60", compare(got, ref),
            1e-2 * float(ref.float().abs().max()),
            time_ms(k7_call),
            time_ms(lambda: cs.conv_stem_reference(conv1.weight, conv1.bias, conv2.weight,
                                                   conv2.bias, xs)),
            time_ms(cudnn_stem),
            bound(stem_flops, bf16_rate, nbytes(xs, conv1.weight, conv1.bias, conv2.weight,
                                                conv2.bias, got), mem_rate),
            device_ms=graph_ms(k7_call), library_device_ms=graph_ms(cudnn_stem),
            host_us=host_us(k7_call), library_host_us=host_us(cudnn_stem),
        )
    del conv1, conv2, xs, got, ref
    torch.cuda.empty_cache()

    # K8: the int8 attention core at the encoder's shape, qk and qkpv; the
    # wrapper's K (and V) quantization is part of its time and the twin's
    q, k, v = (randn(B, t_enc, h, 64, seed=s) for s in (29, 30, 31))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    for mode in ("qk", "qkpv"):
        pv8 = mode == "qkpv"

        def twin():
            k8, ks = fa.quantize_k_rows(k)
            v_in, vs = fa.quantize_v_cols(v) if pv8 else (v, None)
            return fa.flash_attention_int8_reference(q, k8, ks, v_in, vs, pv8)

        def k8_call():
            return fa.flash_attention_int8(q, k, v, mode=mode)

        def k8_library():
            return F.scaled_dot_product_attention(qt, kt, vt)

        o, lse = k8_call()
        ro, rlse = twin()
        lse_err = float((lse - rlse).abs().max())
        if lse_err > 1e-3:
            raise AssertionError(f"K8 {mode} LSE disagrees: {lse_err}")
        pairs = B * h * t_enc * t_enc
        # the kernel's inputs: q, int8 K and its row scales, V (bf16, or
        # int8 and its column scales), and O and LSE
        kv_bytes = B * t_enc * d * (1 + (1 if pv8 else 2)) + B * h * t_enc * 4 + (
            B * h * 64 * 4 if pv8 else 0)
        record(
            f"K8 flash_attention_int8 {mode} (B={B}, T={t_enc}, H=20, D=64)",
            "kotoba_whisper_tpu_torch/csrc/flash_attention_int8.cu",
            "kotoba_whisper_tpu/ops/flash_attention.py:145", compare(o, ro), 5e-3,
            time_ms(k8_call), time_ms(twin), time_ms(k8_library),
            bound((4.0 if pv8 else 2.0) * pairs * 64, int8_rate, nbytes(q, o, lse) + kv_bytes,
                  mem_rate,
                  exp_s=pairs / exp_rate, more_s=0 if pv8 else 2.0 * pairs * 64 / bf16_rate),
            key=f"K8{mode}", device_ms=graph_ms(k8_call),
            library_device_ms=graph_ms(k8_library), host_us=host_us(k8_call),
            library_host_us=host_us(k8_library),
        )
        del o, lse, ro, rlse
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # K9: the calibration loop at the JAX tool's block (512 x 1536 x 64),
    # held to its twin by 1e-4 of the largest sum; no single library call
    # runs this loop
    xc = torch.from_numpy(np.random.default_rng(0).standard_normal((512, 1536)).astype(
        np.float32)).cuda()
    n_exp = 512 * 1536 * 64
    for op in ("softmax", "exp"):
        def k9_call():
            return vpu_cal.vpu_cal(xc, 64, op)

        got, ref = k9_call(), vpu_cal.vpu_cal_reference(xc, 64, op)
        log(f"[kernel] K9 {op}: library_ms null (no single PyTorch call runs the "
            "calibration loop)")
        record(
            f"K9 vpu_cal {op} (512 x 1536 x 64, fp32)",
            "kotoba_whisper_tpu_torch/csrc/vpu_cal.cu", "tools/vpu_cal.py:38",
            compare(got, ref), 1e-4 * float(ref.abs().max()),
            time_ms(k9_call), time_ms(lambda: vpu_cal.vpu_cal_reference(xc, 64, op)), None,
            bound(0.0, bf16_rate, nbytes(xc, got), mem_rate, exp_s=n_exp / exp_rate),
            key=f"K9{op}", device_ms=graph_ms(k9_call), library_device_ms=None,
            host_us=host_us(k9_call), library_host_us=None,
        )
    del xc

    # ---- 4. main path -----------------------------------------------------
    def every_count():
        """Launches of every kernel's wrapper since the last reset_every()."""
        return {"K1": fa.flash_attention_fwd.launches, "K2": da.decode_attention.launches,
                "K3": mel.log_mel_frames.launches, "K4": fa.flash_attention_fwd.causal_launches,
                "K5": fa.flash_attention_bwd.launches, "K6ln": ln.layer_norm.launches,
                "K6add": ln.add_layer_norm.launches, "K7": cs.conv_stem.launches,
                "K8": fa.flash_attention_int8.launches, "K9": vpu_cal.vpu_cal.launches}

    def reset_every():
        for fn in (fa.flash_attention_fwd, da.decode_attention, mel.log_mel_frames,
                   fa.flash_attention_bwd, ln.layer_norm, ln.add_layer_norm, cs.conv_stem,
                   fa.flash_attention_int8, vpu_cal.vpu_cal):
            fn.launches = 0
        fa.flash_attention_fwd.causal_launches = 0

    def nonzero(counts):
        return {k: n for k, n in counts.items() if n}

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = whisper.init_params(large, gen, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"[main] large-v3 ({sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
        f"params, 32+32 layers, d=1280) built on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    st = SpecialTokens.for_vocab(large.vocab_size)
    st_fixed = dataclasses.replace(st, eot=-1)  # fixed-length decode
    prompt = transcribe_prompt(st, st.lang_begin + 7)
    opts = GenerateOptions(prompt_ids=prompt, max_length=len(prompt) + NEW_TOKENS)
    audio = torch.from_numpy(audio_np).cuda()

    def pipeline(x):
        feats = mel.log_mel_spectrogram(x, feat).to(torch.bfloat16)
        return generate_greedy(model, feats, opts, st_fixed, kv_dtype="int8")

    pipeline(audio)  # warm-up: cuBLAS/cuDNN plans, allocator
    torch.cuda.synchronize()
    reset_every()
    t0 = time.perf_counter()
    toks = pipeline(audio)
    toks_host = toks.cpu().numpy()
    wall = time.perf_counter() - t0
    launches = nonzero(every_count())
    expect = {"K1": large.encoder_layers, "K2": 2 * large.decoder_layers * NEW_TOKENS, "K3": 1}
    log(f"[main] B={B} x {NEW_TOKENS} tokens: wall {wall:.3f} s, "
        f"{B * feat.chunk_length_s / wall:.1f} audio-s/s [{card}]; launches {launches}")
    if launches != expect:
        raise AssertionError(f"main path launches {launches}, expected {expect}")
    if toks_host.shape != (B, len(prompt) + NEW_TOKENS) or not (
        (toks_host >= 0).all() and (toks_host < large.vocab_size).all()
        and (toks_host[:, : len(prompt)] == prompt).all()
    ):
        raise AssertionError("main path tokens out of range or shape")

    # stage times of the same pipeline (device-synchronised host clock)
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t) * 1e3

    feats, mel_ms = timed(lambda: mel.log_mel_spectrogram(audio, feat).to(torch.bfloat16))
    enc, enc_ms = timed(lambda: whisper.encode(model, feats))
    _, cache_ms = timed(lambda: whisper.init_cache(model, enc, cap, kv_dtype="int8"))
    log(f"[main] stages: log-mel {mel_ms:.2f} ms, encode {enc_ms:.2f} ms, "
        f"init_cache {cache_ms:.2f} ms, decode loop ~{wall * 1e3 - mel_ms - enc_ms - cache_ms:.1f} ms "
        f"({(wall * 1e3 - mel_ms - enc_ms - cache_ms) / NEW_TOKENS:.2f} ms/step) [{card}]")
    del feats, enc

    def profile_run(fn, fname, label):
        """Trace one fn() with torch.profiler: kernel table into
        args.profile/fname, device busy share and the top kernels logged."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.profile, exist_ok=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        events = prof.key_averages()
        table = events.table(sort_by="self_device_time_total", row_limit=-1)
        with open(os.path.join(args.profile, fname), "w") as f:
            f.write(f"{card}\n{table}\n")
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        log(f"[profile] {label}: traced wall {prof_wall * 1e3:.1f} ms, device busy "
            f"{busy_us / 1e3:.1f} ms ({busy_us / 1e4 / prof_wall:.1f} %) [{card}]")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
            log(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms  "
                f"{e.count:6d}x  {e.key[:90]}")

    if args.profile:
        profile_run(lambda: pipeline(audio).cpu(), "profile_main_path.txt", "main path")

    # the kernel path against the plain path on the card, at B=2
    @contextlib.contextmanager
    def plain_path():
        saved = (whisper.flash_attention, whisper.decode_attention, mel.log_mel_frames)
        whisper.flash_attention = (
            lambda q, k, v, causal=False: fa.flash_attention_reference(q, k, v, causal)[0])
        whisper.decode_attention = da.decode_attention_reference
        mel.log_mel_frames = mel.log_mel_frames_reference
        try:
            yield
        finally:
            whisper.flash_attention, whisper.decode_attention, mel.log_mel_frames = saved

    def first_steps(m, x, tokens):
        feats = mel.log_mel_spectrogram(x, feat).to(torch.bfloat16)
        enc = whisper.encode(m, feats)
        cache = whisper.init_cache(m, enc, cap, kv_dtype="int8")
        ids = torch.tensor([prompt], device="cuda").repeat(x.shape[0], 1)
        _, cache = whisper.decode(m, ids[:, :-1], cache=cache)
        logits, _ = whisper.decode(m, ids[:, -1:], cache=cache)
        toks = generate_greedy(m, feats, opts, st_fixed, kv_dtype="int8") if tokens else None
        return feats, enc.float(), logits[:, 0], toks

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    @torch.inference_mode()
    def attention_per_layer(m, feats):
        """Every encoder layer's attention on the kernel path's own
        activations (q, k, v as the path makes them, fused column views
        included): rel-L2 of K1 against its twin, and of the twin with its
        first 64-key tile dropped against the twin (the fault to be seen)."""
        n_heads = m.cfg.encoder_attention_heads
        x = whisper.embed_audio(m, feats, m.dtype)
        got_rel, cut_rel = [], []
        for layer in m.model.encoder.layers:
            hn = whisper.layer_norm(layer.self_attn_layer_norm, x)
            q, k, v = whisper.qkv_projections(layer.self_attn, hn, hn, n_heads)
            ref = fa.flash_attention_reference(q, k, v)[0]
            got_rel.append(rel(whisper.flash_attention(q, k, v), ref))
            cut_rel.append(rel(fa.flash_attention_reference(q, k[:, 64:], v[:, 64:])[0], ref))
            x = whisper._encoder_layer(layer, n_heads, x)
        return got_rel, cut_rel

    def kernel_vs_plain(m, label, enc_tol):
        """B=2 kernel path against plain path on three seeds' audio. Each
        encoder layer's attention is held to REL_L2_TOL, as each kernel is
        in phase 3 (the path's softmax is nearly flat, so K1 reads ~6e-4
        there), and the dropped key tile must read above it (~1.9e-2); the
        first-step logits are held to 5e-2, and the whole encoder to
        enc_tol, or where that is None to 1.25 times a witness: the plain
        path against itself on features nudged one bf16 ulp (the kernel
        path reads 0.96-0.97 of it, in bf16 and in w8a8)."""
        for seed in range(3):
            small = audio[:2] if seed == 0 else torch.from_numpy(
                (np.random.default_rng(10 + seed).standard_normal((2, feat.n_samples)) * 0.1
                 ).astype(np.float32)).cuda()
            feats_k, enc_k, lg_k, tok_k = first_steps(m, small, tokens=seed == 0)
            with plain_path():
                feats_p, enc_p, lg_p, tok_p = first_steps(m, small, tokens=seed == 0)
                nudged = (feats_p.view(torch.int16) + 1).view(torch.bfloat16)
                witness = rel(whisper.encode(m, nudged), enc_p)
            got_rel, cut_rel = attention_per_layer(m, feats_k)
            enc_rel, lg_rel = rel(enc_k, enc_p), rel(lg_k, lg_p)
            tol = 1.25 * witness if enc_tol is None else enc_tol
            agree = "" if tok_k is None else (
                f", token agreement {float((tok_k == tok_p).float().mean()):.3f} over "
                f"{tok_k.numel()} tokens")
            log(f"[{label}] B=2 seed {seed}, kernel vs plain path on the card: attention per "
                f"layer rel-L2 max {max(got_rel):.3e} (tol {REL_L2_TOL:g}; dropped key tile "
                f"min {min(cut_rel):.3e}); encoder rel-L2 {enc_rel:.3e} (tol {tol:.3e}; "
                f"one-ulp witness {witness:.3e}); first-step logits rel-L2 {lg_rel:.3e} "
                f"(tol 5e-2), max |logit diff| {float((lg_k - lg_p).abs().max()):.3e}{agree}")
            finite = bool(torch.isfinite(enc_k).all() and torch.isfinite(lg_k).all())
            if not (finite and max(got_rel) <= REL_L2_TOL < min(cut_rel) and lg_rel <= 5e-2
                    and enc_rel <= tol):
                raise AssertionError(f"{label}: kernel path disagrees with the plain path")

    kernel_vs_plain(model, "main", enc_tol=2e-2)

    # ---- 4c. fused + w8a8 main path ----------------------------------------
    fuse_for_inference(model)  # lossless; phase 4d runs on this model
    t0 = time.perf_counter()
    qmodel = quantize_for_inference(copy.deepcopy(model))
    torch.cuda.synchronize()
    log(f"[4c] fused + w8a8 large-v3: quantized on the card in "
        f"{time.perf_counter() - t0:.2f} s (deep copy of the fused bf16 model included)")

    def pipeline_q(x):
        feats = mel.log_mel_spectrogram(x, feat).to(torch.bfloat16)
        return generate_greedy(qmodel, feats, opts, st_fixed, kv_dtype="int8")

    q_launches = {}
    for b_run, x_run in ((B, audio), (64, torch.from_numpy(
            (np.random.default_rng(3).standard_normal((64, feat.n_samples)) * 0.1
             ).astype(np.float32)).cuda())):
        pipeline_q(x_run)  # warm-up at this batch's shapes
        torch.cuda.synchronize()
        reset_every()
        t0 = time.perf_counter()
        toks_q = pipeline_q(x_run).cpu().numpy()
        wall_q = time.perf_counter() - t0
        q_launches[b_run] = nonzero(every_count())
        log(f"[4c] B={b_run} x {NEW_TOKENS} tokens, fused + w8a8: wall {wall_q:.3f} s, "
            f"{b_run * feat.chunk_length_s / wall_q:.1f} audio-s/s [{card}]; "
            f"launches {q_launches[b_run]}")
        if q_launches[b_run] != expect:
            raise AssertionError(f"4c launches {q_launches[b_run]}")
        if toks_q.shape != (b_run, len(prompt) + NEW_TOKENS) or not (
                (toks_q >= 0).all() and (toks_q < large.vocab_size).all()):
            raise AssertionError("4c tokens out of range or shape")
        if b_run == B:
            feats, mel_ms = timed(lambda: mel.log_mel_spectrogram(audio, feat).to(torch.bfloat16))
            enc, enc_ms = timed(lambda: whisper.encode(qmodel, feats))
            _, cache_ms = timed(lambda: whisper.init_cache(qmodel, enc, cap, kv_dtype="int8"))
            loop_ms = wall_q * 1e3 - mel_ms - enc_ms - cache_ms
            log(f"[4c] stages: log-mel {mel_ms:.2f} ms, encode {enc_ms:.2f} ms, init_cache "
                f"{cache_ms:.2f} ms, decode loop ~{loop_ms:.1f} ms "
                f"({loop_ms / NEW_TOKENS:.2f} ms/step) [{card}]")
            del feats, enc
        del x_run
    if args.profile:
        profile_run(lambda: pipeline_q(audio).cpu(), "profile_w8a8_path.txt",
                    "fused + w8a8 path")
    # w8a8 rounds every projection's input to 127 levels of its row's
    # absmax: a one-ulp bf16 difference between the paths can move a value
    # one int8 level (~0.8 % of the row's largest): the whole encoder
    # drifts ~3e-2 between the paths, as far as a one-ulp nudge of its
    # input moves the plain path, so it is held to that witness (with a
    # quarter's room) and the kernel layer by layer
    kernel_vs_plain(qmodel, "4c", enc_tol=None)
    del qmodel
    torch.cuda.empty_cache()

    # ---- 4d. encoder variants at B=16 ---------------------------------------
    feats16 = mel.log_mel_spectrogram(audio, feat).to(torch.bfloat16)
    enc_variants = (
        ("default", {}, lambda: whisper.encode(model, feats16), {"K1": 32}),
        ("stem_impl=pallas", {}, lambda: whisper.encode(model, feats16, stem_impl="pallas"),
         {"K1": 32, "K7": 1}),
        ("KWT_FA_INT8=qk", {"KWT_FA_INT8": "qk"}, lambda: whisper.encode(model, feats16),
         {"K8": 32}),
        ("KWT_FA_INT8=qkpv", {"KWT_FA_INT8": "qkpv"}, lambda: whisper.encode(model, feats16),
         {"K8": 32}),
        ("enc_exp fused_ln", {}, lambda: enc_exp.encode_fused_ln(model, feats16),
         {"K1": 32, "K6ln": 33, "K6add": 32}),
    )
    enc_launches, enc_default = {}, None
    for label, env, fn, expect_n in enc_variants:
        os.environ.update(env)
        try:
            fn()  # warm-up
            reset_every()
            out, ms = timed(fn)
            counts = nonzero(every_count())
        finally:
            for key in env:
                os.environ.pop(key)
        enc_launches[label] = counts
        out = out.float()
        if enc_default is None:
            enc_default = out
        rel = float((out - enc_default).norm() / enc_default.norm())
        log(f"[4d] encoder {label}: {ms:.2f} ms, rel-L2 vs default {rel:.3e}, launches "
            f"{counts} [{card}]")
        # int8 attention rounds every score of 32 layers: a looser bound
        if counts != expect_n or not bool(torch.isfinite(out).all()) or rel > (
                0.1 if "INT8" in label else 2e-2):
            raise AssertionError(f"4d {label}: launches {counts} (expected {expect_n}), "
                                 f"rel-L2 {rel}")
    del model, audio, feats16, enc_default, out
    torch.cuda.empty_cache()

    # ---- 4b. train path ---------------------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    teacher = whisper.init_params(large, gen, device="cuda", dtype=torch.float32)
    student, s_cfg = init_student_from_teacher(teacher, large, decoder_layers=2)
    teacher = teacher.to(torch.bfloat16).requires_grad_(False)  # as the JAX trainer casts it
    distill.freeze_encoder_(student)
    opt, sched = optim.make_optimizer(student, lr=1e-4, warmup_steps=500)
    state = distill.TrainState(student, opt)
    dc = distill.DistillConfig()  # 0.8 CE + KL(T=2), frozen shared encoder, bf16, remat
    train_step = distill.make_train_step(dc, sched)
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in student.parameters() if p.requires_grad)
    log(f"[train] teacher large-v3 (bf16) and student {s_cfg.encoder_layers}+"
        f"{s_cfg.decoder_layers} layers (fp32 master weights, {n_train / 1e6:.1f} M "
        f"trainable) built on the card in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)

    def train_batch(b):
        ids = rng.integers(10, 5000, size=(b, LABELS))
        labels = torch.from_numpy(ids).cuda()
        labels[:, -16:] = -100
        return {
            "input_features": torch.from_numpy(
                rng.standard_normal((b, large.num_mel_bins, feat.n_frames)).astype(np.float32)
            ).cuda().to(torch.bfloat16),
            "labels": labels,
            "decoder_input_ids": whisper.shift_labels_right(
                labels, large.decoder_start_token_id, large.pad_token_id),
        }

    batch = train_batch(TRAIN_B)
    enc_before = [p.detach().clone() for p in student.model.encoder.parameters()]
    dec_before = [p.detach().clone() for p in student.model.decoder.parameters()]
    train_step(state, teacher, batch)  # warm-up: cuBLAS plans, allocator; lr 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_every()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        metrics = train_step(state, teacher, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    train_launches = nonzero(every_count())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    metrics = {k: float(v) for k, v in metrics.items()}
    # per step: K1 = 32 encoder + 2 student cross + 2 recomputed (remat)
    # + 32 teacher cross; K4 = 2 + 2 recomputed + 32 teacher self;
    # K5 = 2 causal + 2 cross calls
    per_step = {"K1": large.encoder_layers + 2 * s_cfg.decoder_layers + large.decoder_layers,
                "K4": 2 * s_cfg.decoder_layers + large.decoder_layers,
                "K5": 2 * s_cfg.decoder_layers}
    log(f"[train] B={TRAIN_B} x {LABELS} labels: {step_s * 1e3:.1f} ms/step over "
        f"{TRAIN_STEPS} steps, {TRAIN_B * feat.chunk_length_s / step_s:.1f} training "
        f"audio-s/s/card, peak memory {peak_gb:.2f} GB [{card}]; launches over the "
        f"{TRAIN_STEPS} steps {train_launches}; metrics {metrics}")
    if train_launches != {k: TRAIN_STEPS * n for k, n in per_step.items()}:
        raise AssertionError(f"train launches {train_launches}, expected "
                             f"{TRAIN_STEPS} x {per_step}")
    if not all(math.isfinite(v) for v in metrics.values()) or state.step != TRAIN_STEPS + 1:
        raise AssertionError(f"train step metrics {metrics} at step {state.step}")
    if not all(torch.equal(a, p) for a, p in zip(enc_before, student.model.encoder.parameters())):
        raise AssertionError("the frozen encoder changed")
    moved = sum(not torch.equal(a, p) for a, p in zip(dec_before, student.model.decoder.parameters()))
    if moved != len(dec_before):
        raise AssertionError(f"{len(dec_before) - moved} decoder parameters did not move")
    del enc_before, dec_before

    if args.profile:
        profile_run(lambda: train_step(state, teacher, batch), "profile_train_step.txt",
                    "train step")

    # the kernel path against the plain path on the card, at B=2: loss and
    # the student decoder's gradients (no optimizer update)
    small = {k: v[:2] for k, v in batch.items()}

    def loss_and_grads():
        loss, _ = distill.distill_loss(student, teacher, dc, small)
        loss.backward()
        params = [p for p in student.parameters() if p.requires_grad]
        grads = torch.cat([p.grad.float().flatten() for p in params])
        for p in params:
            p.grad = None
        return float(loss.detach()), grads

    loss_k, grads_k = loss_and_grads()
    with plain_path():
        loss_p, grads_p = loss_and_grads()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = float((grads_k - grads_p).norm() / grads_p.norm())
    log(f"[train] B=2 kernel vs plain path on the card: loss {loss_k:.6f} vs {loss_p:.6f} "
        f"(rel {loss_rel:.3e}, tol {TRAIN_LOSS_TOL:g}), student decoder gradients "
        f"rel-L2 {grad_rel:.3e} (tol {TRAIN_GRAD_TOL:g})")
    if not (math.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_TOL and grad_rel <= TRAIN_GRAD_TOL):
        raise AssertionError("train kernel path disagrees with the plain path")
    del grads_k, grads_p

    # one B=16 step in two microbatches of 8
    reset_every()
    t0 = time.perf_counter()
    mb_metrics = distill.make_train_step(dataclasses.replace(dc, num_microbatches=2), sched)(
        state, teacher, train_batch(2 * TRAIN_B))
    mb_loss = float(mb_metrics["loss"])
    mb_s = time.perf_counter() - t0
    mb_launches = nonzero(every_count())
    log(f"[train] B={2 * TRAIN_B} in 2 microbatches: {mb_s * 1e3:.1f} ms, loss {mb_loss:.4f}, "
        f"launches {mb_launches} [{card}]")
    if mb_launches != {k: 2 * n for k, n in per_step.items()} or not math.isfinite(mb_loss):
        raise AssertionError(f"microbatch step: launches {mb_launches}, loss {mb_loss}")
    del teacher, student, state, opt, batch, small
    torch.cuda.empty_cache()

    # ---- 5. driver ----------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(1)
        n_utts = 6
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        reazon.write_tar_shard(os.path.join(data, "000.tar"), [
            (f"000/utt{i}.wav", wav_bytes(rng.standard_normal(16000 * (2 + i)) * 0.1))
            for i in range(n_utts)
        ])
        # the driver's default (fused projections), then w8a8 projections
        # with the int8 attention core in the encoder: two batches of 4
        n_batches = -(-n_utts // 4)
        for extra, env, expect_enc in (
                ([], {}, {"K1": 32 * n_batches}),
                (["--gemm_dtype", "int8"], {"KWT_FA_INT8": "qk"}, {"K8": 32 * n_batches})):
            out = os.path.join(tmp, "out" + "".join(extra))
            t0 = time.perf_counter()
            buf = io.StringIO()
            os.environ.update(env)
            reset_every()
            try:
                with contextlib.redirect_stdout(buf):
                    pseudo_label.main([
                        "--dataset_dir", data, "--output_dir", out,
                        "--model", "preset:large-v3", "--tokenizer", "byte",
                        "--batch_size", "4", "--max_label_length", "24",
                        "--kv_dtype", "int8", "--wire_dtype", "int16", *extra,
                    ])
            finally:
                for key in env:
                    os.environ.pop(key)
            counts = nonzero(every_count())
            rows = [json.loads(line) for line in open(os.path.join(out, "pseudo_labels.jsonl"))]
            log(f"[driver] {' '.join(extra) or 'default (fused)'} "
                f"{' '.join(f'{k}={v}' for k, v in env.items())}: {buf.getvalue().strip()} in "
                f"{time.perf_counter() - t0:.1f} s; encoder launches "
                f"{ {k: counts.get(k, 0) for k in ('K1', 'K8')} }")
            if len(rows) != n_utts or not all(
                isinstance(r["whisper_transcript"], list) and r["whisper_transcript"] for r in rows
            ):
                raise AssertionError(f"driver wrote {len(rows)} records for {n_utts} utterances")
            if {k: counts.get(k, 0) for k in ("K1", "K8") if counts.get(k)} != expect_enc:
                raise AssertionError(f"driver encoder launches {counts}, expected {expect_enc}")

    # ---- 5b. training driver --------------------------------------------------
    # A 4-layer encoder at large-v3 width keeps the student's exports and
    # checkpoints (~0.8 GB each) short; the decoder is the 2-layer student.
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(2)
        split = os.path.join(tmp, "split")
        writer = ShardWriter(split, shard_size=4)
        for i in range(6):
            toks = rng.integers(10, 5000, int(rng.integers(8, 24))).tolist()
            feats_i = rng.standard_normal((large.num_mel_bins, feat.n_frames)).astype(np.float32)
            writer.add({"name": f"utt{i}", "labels": [st.sot, *toks, st.eot]}, feats_i)
        writer.close()
        stu, out = os.path.join(tmp, "student"), os.path.join(tmp, "run")
        distill_args = [
            "--data_dir", split, "--student", stu, "--teacher", "preset:large-v3",
            "--output_dir", out, "--per_device_train_batch_size", "2",
            "--max_label_length", "32", "--warmup_steps", "1", "--logging_steps", "1",
            "--save_steps", "100", "--num_train_epochs", "2",
        ]
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            create_student.main(["--teacher", "preset:large-v3", "--save_dir", stu,
                                 "--encoder_layers", "4", "--decoder_layers", "2"])
            t_create = time.perf_counter() - t0
            distill_cli.main(distill_args + ["--max_steps", "2"])
            t_first = time.perf_counter() - t0 - t_create
            distill_cli.main(distill_args + ["--max_steps", "3"])
        t_all = time.perf_counter() - t0
        said = buf.getvalue()
        with open(os.path.join(out, "metrics.run.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        exported, ex_cfg = import_hf_model(os.path.join(out, "final"))
        log(f"[driver] create_student {t_create:.1f} s, distill 2 steps {t_first:.1f} s, "
            f"resume to step 3 + export {t_all - t_create - t_first:.1f} s [{card}]; "
            f"logged losses {[round(r['train/loss'], 4) for r in logged]}")
        if not ([r["step"] for r in logged] == [1, 2, 3]
                and all(math.isfinite(r["train/loss"]) for r in logged)
                and "resumed from" in said
                and get_last_checkpoint(out)[1] == 3
                and (ex_cfg.encoder_layers, ex_cfg.decoder_layers) == (4, 2)
                and all(torch.isfinite(p).all() for p in exported.parameters())):
            raise AssertionError(f"training driver run is incomplete:\n{said[-3000:]}")
        del exported

    # ---- 5c. the experiment tools ---------------------------------------------
    tool_launches = {}
    for label, fn, argv in (
            ("enc_exp", enc_exp.main, ["--variant", "fused_ln", "--batch", str(B), "--trials", "2"]),
            ("stem_exp", stem_exp.main, ["--batch", str(B), "--trials", "2"]),
            ("vpu_cal softmax", vpu_cal.main, ["--op", "softmax", "--trials", "2"]),
            ("vpu_cal exp", vpu_cal.main, ["--op", "exp", "--trials", "2"])):
        buf = io.StringIO()
        reset_every()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fn(argv)
        tool_launches[label] = nonzero(every_count())
        lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.strip()]
        if not lines:
            raise AssertionError(f"{label} printed no JSON line")
        for line in lines:
            log(f"[tools] {label}: {json.dumps(line)}")
        log(f"[tools] {label}: {time.perf_counter() - t0:.1f} s, launches "
            f"{tool_launches[label]} [{card}]")
        torch.cuda.empty_cache()

    # ---- 6. kernels line, 7. result ------------------------------------------
    path_launches = {
        "K1": launches["K1"], "K2": launches["K2"], "K3": launches["K3"],
        "K4": train_launches["K4"], "K5": train_launches["K5"],
        "K6ln": enc_launches["enc_exp fused_ln"]["K6ln"],
        "K6add": enc_launches["enc_exp fused_ln"]["K6add"],
        "K7": enc_launches["stem_impl=pallas"]["K7"],
        "K8qk": enc_launches["KWT_FA_INT8=qk"]["K8"],
        "K8qkpv": enc_launches["KWT_FA_INT8=qkpv"]["K8"],
        "K9softmax": tool_launches["vpu_cal softmax"].get("K9", 0),
        "K9exp": tool_launches["vpu_cal exp"].get("K9", 0)}
    for rec in records:
        rec["launches"] = path_launches[launch_key[rec["name"]]]
        if rec["launches"] < 1:
            raise AssertionError(f"{rec['name']} never launched on the path that runs it")
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
