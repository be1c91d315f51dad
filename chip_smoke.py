"""Chip smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py                # the check: one card, no arguments
    python3 chip_smoke.py --profile DIR  # also trace one main-path run with
                                         # torch.profiler, table into DIR/

Phases, in order; any failure exits nonzero and prints no result line:

  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: every CUDA kernel of the port (csrc/*.cu) with nvcc, in parallel;
  3. kernels: each kernel against its plain PyTorch twin on the card at the
     main path's shapes (large-v3, B=16), with its time, the twin's time, a
     library call's time and the least time the card could take;
  4. main path: large-v3 width and depth with seeded random weights, bf16,
     int8 KV, B=16, 48 new tokens with eot disabled:
     log_mel_spectrogram -> generate_greedy, with launch counters checked;
     then at B=2 the kernel path against the plain path on the card;
  5. driver: cli/pseudo_label on synthetic WAV utterances in a tar shard;
  6. a JSON line of every kernel with its main-path launches and numbers;
  7. the last line: {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
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
# sheet): bf16 tensor FLOP/s, fp32 CUDA-core FLOP/s, memory bytes/s. Another
# card needs its own entry; the bounds are not guessed for it.
PEAKS = {"H100 80GB HBM3": (989e12, 67e12, 3.35e12)}
# Relative L2 error allowed of every kernel against its twin: ~10x the bf16
# rounding of K1's and K2's outputs; a dropped or mis-weighted key tile moves
# it by ~1e-1.
REL_L2_TOL = 1e-2
B = 16            # main-path batch (lockstep)
NEW_TOKENS = 48   # decode steps, eot disabled


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


def bound(flops: float, flop_rate: float, nbytes: float, mem_rate: float):
    t_ops, t_bytes = flops / flop_rate * 1e3, nbytes / mem_rate * 1e3
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
                    help="trace one main-path run with torch.profiler and "
                    "write its kernel table to DIR/profile_main_path.txt")
    args = ap.parse_args()

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the card only")
        return 2
    from kotoba_whisper_tpu_torch.cli import pseudo_label
    from kotoba_whisper_tpu_torch.core.config import PRESETS, FeatureConfig, SpecialTokens
    from kotoba_whisper_tpu_torch.data import reazon
    from kotoba_whisper_tpu_torch.decode.greedy import (
        GenerateOptions, generate_greedy, transcribe_prompt,
    )
    from kotoba_whisper_tpu_torch.models import whisper
    from kotoba_whisper_tpu_torch.models.whisper import quantize_kv_rows
    from kotoba_whisper_tpu_torch.ops import _build
    from kotoba_whisper_tpu_torch.ops import decode_attention as da
    from kotoba_whisper_tpu_torch.ops import flash_attention as fa
    from kotoba_whisper_tpu_torch.ops import mel

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
    bf16_rate, fp32_rate, mem_rate = PEAKS[peak_name]
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
    records = []
    large = PRESETS["large-v3"]
    h, d = large.encoder_attention_heads, large.d_model
    t_enc = large.max_source_positions
    cap = 3 + NEW_TOKENS  # self-KV capacity: prompt + new tokens

    def compare(got, ref):
        """Max |err| and relative L2 error of a kernel's output against its twin."""
        got, ref = got.float(), ref.float()
        return float((got - ref).abs().max()), float((got - ref).norm() / ref.norm())

    def record(name, source, replaces, errs, tol, ms, plain_ms, lib_ms, bnd):
        err, rel = errs
        ok = err <= tol and rel <= REL_L2_TOL
        rec = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib_ms)
        log(f"[kernel] {name}: max_abs_err {err:.3e} (tol {tol:g}) rel_l2 {rel:.3e} "
            f"(tol {REL_L2_TOL:g}) "
            f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms {bnd[0]:.4f} "
            f"({bnd[1]}) [{card}] {'ok' if ok else 'FAIL'}")
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
    record(
        "K1 flash_attention_fwd (B=16, T=1500, H=20, D=64, bf16)",
        "kotoba_whisper_tpu_torch/csrc/flash_attention.cu",
        "kotoba_whisper_tpu/ops/flash_attention.py:69", errs, 5e-3,
        time_ms(lambda: fa.flash_attention_fwd(q, k, v)),
        time_ms(lambda: fa.flash_attention_reference(q, k, v)),
        time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
        bound(4.0 * B * h * t_enc * t_enc * 64, bf16_rate,
              nbytes(q, k, v, o, lse), mem_rate),
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
        record(
            f"K2 decode_attention {label} (B=16, T={t}, D=1280)",
            "kotoba_whisper_tpu_torch/csrc/decode_attention.cu",
            "kotoba_whisper_tpu/ops/decode_attention.py:165", errs, 2e-3,
            time_ms(lambda: da.decode_attention(qd, kf, vf, t, n_heads=h, k_scale=ks, v_scale=vs)),
            time_ms(lambda: da.decode_attention_reference(
                qd, kf, vf, t, n_heads=h, k_scale=ks, v_scale=vs)),
            time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh)),
            bound(4.0 * B * t * d, fp32_rate, nbytes(qd, kf, vf, ks, vs, out), mem_rate),
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
    # points (~2.5 N log2 N flops), power, the mel product over the filters'
    # nonzeros and the log. The kernel's dense Hann-folded DFT does ~30x
    # more; that is its design's cost, not the function's.
    bins = feat.n_fft // 2 + 1
    frame_flops = (feat.n_fft + 2.5 * feat.n_fft * math.log2(feat.n_fft) + 3 * bins
                   + 2 * int((fb_np != 0).sum()) + feat.n_mels)

    def stft_mel(x):
        spec = torch.stft(x, feat.n_fft, feat.hop_length, window=window, center=True,
                          pad_mode="reflect", return_complex=True)[..., :-1]
        return torch.log10(torch.clamp(spec.abs().square().transpose(1, 2) @ fb, min=1e-10))

    for label, wire in (("fp32", audio_np),
                        ("int16", np.clip(np.round(audio_np * 32768), -32768, 32767
                                          ).astype(np.int16))):
        x = torch.from_numpy(wire).cuda()
        got = mel.finish_log_mel(mel.log_mel_frames(x, feat))
        ref = mel.finish_log_mel(mel.log_mel_frames_reference(x, feat))
        errs = compare(got, ref)
        xf = mel._audio_f32(x)
        out_bytes = B * feat.n_frames * feat.n_mels * 4
        record(
            f"K3 log_mel {label} (B=16, 480000 samples -> 3000 x 128)",
            "kotoba_whisper_tpu_torch/csrc/mel.cu",
            "kotoba_whisper_tpu/ops/mel_pallas.py:69", errs, 1e-4,
            time_ms(lambda: mel.log_mel_frames(x, feat)),
            time_ms(lambda: mel.log_mel_frames_reference(x, feat)),
            time_ms(lambda: stft_mel(xf)),
            bound(B * feat.n_frames * frame_flops, fp32_rate, nbytes(x) + out_bytes, mem_rate),
        )
        del x, got, ref, xf
    torch.cuda.empty_cache()

    # ---- 4. main path -----------------------------------------------------
    counters = (fa.flash_attention_fwd, da.decode_attention, mel.log_mel_frames)

    def reset():
        for c in counters:
            c.launches = 0

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
    reset()
    t0 = time.perf_counter()
    toks = pipeline(audio)
    toks_host = toks.cpu().numpy()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    expect = {"flash_attention_fwd": large.encoder_layers,
              "decode_attention": 2 * large.decoder_layers * NEW_TOKENS,
              "log_mel_frames": 1}
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

    if args.profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(args.profile, exist_ok=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipeline(audio).cpu()
            prof_wall = time.perf_counter() - t0
        events = prof.key_averages()
        table = events.table(sort_by="self_device_time_total", row_limit=40)
        with open(os.path.join(args.profile, "profile_main_path.txt"), "w") as f:
            f.write(f"{card}\n{table}\n")
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        log(f"[profile] traced wall {prof_wall * 1e3:.1f} ms, device busy "
            f"{busy_us / 1e3:.1f} ms ({busy_us / 1e4 / prof_wall:.1f} %) [{card}]")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
            log(f"[profile] {e.self_device_time_total / 1e3:9.2f} ms  "
                f"{e.count:6d}x  {e.key[:90]}")

    # the kernel path against the plain path on the card, at B=2
    @contextlib.contextmanager
    def plain_path():
        saved = (whisper.flash_attention, whisper.decode_attention, mel.log_mel_frames)
        whisper.flash_attention = lambda q, k, v: fa.flash_attention_reference(q, k, v)[0]
        whisper.decode_attention = da.decode_attention_reference
        mel.log_mel_frames = mel.log_mel_frames_reference
        try:
            yield
        finally:
            whisper.flash_attention, whisper.decode_attention, mel.log_mel_frames = saved

    def first_steps(x):
        feats = mel.log_mel_spectrogram(x, feat).to(torch.bfloat16)
        enc = whisper.encode(model, feats)
        cache = whisper.init_cache(model, enc, cap, kv_dtype="int8")
        ids = torch.tensor([prompt], device="cuda").repeat(x.shape[0], 1)
        _, cache = whisper.decode(model, ids[:, :-1], cache=cache)
        logits, _ = whisper.decode(model, ids[:, -1:], cache=cache)
        toks = generate_greedy(model, feats, opts, st_fixed, kv_dtype="int8")
        return enc.float(), logits[:, 0], toks

    small = audio[:2]
    enc_k, lg_k, tok_k = first_steps(small)
    with plain_path():
        enc_p, lg_p, tok_p = first_steps(small)
    rel = lambda a, b: float((a - b).norm() / b.norm())
    enc_rel, lg_rel = rel(enc_k, enc_p), rel(lg_k, lg_p)
    agree = float((tok_k == tok_p).float().mean())
    finite = bool(torch.isfinite(enc_k).all() and torch.isfinite(lg_k).all())
    log(f"[main] B=2 kernel vs plain path on the card: encoder rel-L2 {enc_rel:.3e} "
        f"(tol 2e-2), first-step logits rel-L2 {lg_rel:.3e} (tol 5e-2), "
        f"max |logit diff| {float((lg_k - lg_p).abs().max()):.3e}, "
        f"token agreement {agree:.3f} over {tok_k.numel()} tokens")
    if not (finite and enc_rel <= 2e-2 and lg_rel <= 5e-2):
        raise AssertionError("kernel path disagrees with the plain path")
    del model, audio, small
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
        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            pseudo_label.main([
                "--dataset_dir", data, "--output_dir", out,
                "--model", "preset:large-v3", "--tokenizer", "byte",
                "--batch_size", "4", "--max_label_length", "24",
                "--kv_dtype", "int8", "--wire_dtype", "int16", "--no_fuse",
            ])
        rows = [json.loads(line) for line in open(os.path.join(out, "pseudo_labels.jsonl"))]
        log(f"[driver] {buf.getvalue().strip()} in {time.perf_counter() - t0:.1f} s")
        if len(rows) != n_utts or not all(
            isinstance(r["whisper_transcript"], list) and r["whisper_transcript"] for r in rows
        ):
            raise AssertionError(f"driver wrote {len(rows)} records for {n_utts} utterances")

    # ---- 6. kernels line, 7. result ------------------------------------------
    for rec in records:
        fn = {"K1": "flash_attention_fwd", "K2": "decode_attention",
              "K3": "log_mel_frames"}[rec["name"][:2]]
        rec["launches"] = launches[fn]
        if rec["launches"] < 1:
            raise AssertionError(f"{rec['name']} never launched on the main path")
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
