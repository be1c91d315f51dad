"""chip_smoke.py's phase 4 (lockstep greedy) and phase 4e (--stream:
continuous batching), and K2's ring and beam wrappers as 4e's and 4f's
steps call them (--ring, --beam), each alone on the card, so two trees of
the repository can be timed in turns (one process each, alternating which
runs first) on one card: run it from two `git archive` checkouts, copying
this file into one that lacks it.

Every shape is fixed, as the smoke's: large-v3 (32+32 layers) with seeded
random weights in bf16, int8 KV, eot disabled. One warm-up, then --trials
timed runs (host clock, ending in a device synchronise). Prints one JSON
line with the card's name.

Default: phase 4's batch of 16 windows of seeded noise, log_mel_spectrogram
-> generate_greedy, 48 tokens after a 3-token prompt. Each trial also times
log-mel, encode and init_cache alone; the decode loop's ms a step is the
wall less those over 48, as phase 4 logs it.

--stream: phase 4e's stream-real on the fused model, from the inputs that
`stream_workload` draws for both (192 windows, bench.py's budgets) through
`run_stream` (a window of 48 rows refilled 16 at a time, log-mel in refill
batches inside the timed run). The warm-up decodes a 96-window prefix.

--ring: K2's ring wrapper at 4e's shape (48 rows, T=176 slots, 20 heads,
int8), one cache a decoder layer (32, more than L2 holds), each row's
valid length one of bench.py's budgets. Prints the device us a call (a
CUDA graph of one step's 32 calls, replayed 20 times) and the host us a
call in each trial: the time to issue 4 steps of 32 calls, the clock
stopped before the device synchronise (as the smoke's host_us), so a
slower kernel does not show in it while the launch queue has room. Beside
it, in the same trial, the prefix wrapper's host us on the same caches
(valid 26, the budgets' mean): a yardstick inside one process, since host
speed drifts between processes.

--beam: the same for K2's beam wrapper at 4f's shape (12 groups x 5
beams over T=1500, 20 heads, int8); the prefix yardstick takes each
group's first beam over the same keys.

`beam_stream_workload` and `run_beam_stream` hold phase 4g's inputs and
stream (bench.py's beam-stream-w8a8 geometry), which chip_smoke.py draws.

Usage: python -m kotoba_whisper_tpu_torch.tools.step_time [--stream | --ring | --beam]
       [--trials 3]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.config import PRESETS, FeatureConfig, SpecialTokens
from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.decode.greedy import (
    GenerateOptions, generate_greedy, transcribe_prompt,
)
from kotoba_whisper_tpu_torch.decode.streaming import StreamConfig, generate_greedy_streaming
from kotoba_whisper_tpu_torch.decode.streaming_beam import (
    BeamStreamConfig,
    generate_beam_streaming,
)
from kotoba_whisper_tpu_torch.models import whisper
from kotoba_whisper_tpu_torch.models.optimized import fuse_for_inference
from kotoba_whisper_tpu_torch.ops import decode_attention as da
from kotoba_whisper_tpu_torch.ops import mel

PRESET = "large-v3"
BATCH, NEW_TOKENS = 16, 48  # phase 4
STREAM = StreamConfig(batch=48, encode_batch=16, steps_per_round=8)  # phase 4e
STREAM_WINDOWS, STREAM_CAPACITY = 192, 176
BEAM_GROUPS, BEAM_WIDTH = 12, 5  # phase 4f
# phase 4g: bench.py's beam-stream-w8a8 (run_stream_beam): 96 windows, 12
# groups x 5 beams (W=60), refills of 6, 8 steps a round, ring layout,
# log-mel in batches of 16
BEAM_STREAM = BeamStreamConfig(groups=12, num_beams=5, encode_batch=6, steps_per_round=8)
BEAM_STREAM_WINDOWS, BEAM_STREAM_MEL_BATCH = 96, 16
K2_STEPS = 4  # decode steps of 32 calls a --ring or --beam trial


def realistic_stops(n: int, prompt_len: int, rng) -> np.ndarray:
    """Total-token budgets ~ 6 + Gamma(k=3.2, theta=5.9): bench.py's
    `_realistic_stops`, the JAX bench's fit of the ReazonSpeech
    pseudo-label lengths (mean ~25 tokens with the prompt, tail to 170)."""
    text = rng.gamma(3.2, 5.9, size=n)
    return np.clip(prompt_len + 3 + text, 10, 170).astype(np.int64)


def stream_workload(st: SpecialTokens, feat: FeatureConfig):
    """Phase 4e's inputs, drawn as bench.py's stream-real draws them (the
    audio, then the budgets, from one generator seeded 0) -> (audio
    (192, n_samples) bf16 on the card, prompt ids, budgets, options)."""
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(
        rng.standard_normal((STREAM_WINDOWS, feat.n_samples)).astype(np.float32) * 0.1
    ).cuda().to(torch.bfloat16)
    prompt = transcribe_prompt(st, st.lang_begin + 6)
    stops = realistic_stops(STREAM_WINDOWS, len(prompt), rng)
    return audio, prompt, stops, GenerateOptions(prompt_ids=prompt, max_length=STREAM_CAPACITY)


def beam_stream_workload(st: SpecialTokens, feat: FeatureConfig):
    """Phase 4g's inputs, drawn as bench.py's beam-stream-w8a8 draws them
    (the audio, then the budgets, from one generator seeded 0) -> (audio
    (96, n_samples) bf16 on the card, prompt ids, budgets, options with
    capacity 176)."""
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(
        rng.standard_normal((BEAM_STREAM_WINDOWS, feat.n_samples)).astype(np.float32) * 0.1
    ).cuda().to(torch.bfloat16)
    prompt = transcribe_prompt(st, st.lang_begin + 6)
    stops = realistic_stops(BEAM_STREAM_WINDOWS, len(prompt), rng)
    return audio, prompt, stops, GenerateOptions(prompt_ids=prompt, max_length=STREAM_CAPACITY)


def run_beam_stream(model, audio, opts, st, stops, feat, kv_dtype="int8"):
    """generate_beam_streaming over the windows of `audio` (the first
    len(audio) budgets), int8 KV (bench.py's; int4 in phase 4j), log-mel in
    batches of 16 as bench.py's beam stream computes it -> (tokens,
    scores)."""
    b = BEAM_STREAM_MEL_BATCH
    feats = torch.cat([mel.log_mel_spectrogram(audio[i:i + b].float(), feat).to(torch.bfloat16)
                       for i in range(0, audio.shape[0], b)])
    return generate_beam_streaming(model, feats, opts, st, kv_dtype=kv_dtype, stream=BEAM_STREAM,
                                   stop_at=stops[:audio.shape[0]])


def run_stream(model, audio, opts, st_fixed, stops, feat, kv_dtype="int8"):
    """generate_greedy_streaming over the windows of `audio` (the first
    len(audio) budgets), int8 KV (int4 in phase 4j), log-mel in
    refill-sized batches."""
    e = STREAM.encode_batch
    feats = torch.cat([mel.log_mel_spectrogram(audio[i:i + e].float(), feat).to(torch.bfloat16)
                       for i in range(0, audio.shape[0], e)])
    return generate_greedy_streaming(model, feats, opts, st_fixed, kv_dtype=kv_dtype,
                                     stream=STREAM, stop_at=stops[:audio.shape[0]])


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _lockstep(model, cfg, trials):
    feat = FeatureConfig(n_mels=cfg.num_mel_bins)
    st = SpecialTokens.for_vocab(cfg.vocab_size)
    prompt = transcribe_prompt(st, st.lang_begin + 7)
    opts = GenerateOptions(prompt_ids=prompt, max_length=len(prompt) + NEW_TOKENS)
    audio = torch.from_numpy((np.random.default_rng(0).standard_normal(
        (BATCH, feat.n_samples)) * 0.1).astype(np.float32)).cuda()

    def features():
        return mel.log_mel_spectrogram(audio, feat).to(torch.bfloat16)

    def pipeline():
        return generate_greedy(model, features(), opts, dataclasses.replace(st, eot=-1),
                               kv_dtype="int8")

    pipeline()  # warm-up: kernel builds, library plans, the allocator
    walls, steps, enc_s = [], [], []
    for _ in range(trials):
        _, wall = _timed(pipeline)
        feats, mel_s = _timed(features)
        enc, e_s = _timed(lambda: whisper.encode(model, feats))
        _, cache_s = _timed(lambda: whisper.init_cache(model, enc, len(prompt) + NEW_TOKENS,
                                                       kv_dtype="int8"))
        walls.append(wall)
        enc_s.append(e_s)
        steps.append((wall - mel_s - e_s - cache_s) / NEW_TOKENS * 1e3)
        del feats, enc
    return {"wall_s": walls, "decode_ms_per_step": steps,
            "median_decode_ms_per_step": float(np.median(steps)),
            "encode_ms": float(np.median(enc_s)) * 1e3}


def _stream(model, cfg, trials):
    model = fuse_for_inference(model)
    feat = FeatureConfig(n_mels=cfg.num_mel_bins)
    st = SpecialTokens.for_vocab(cfg.vocab_size)
    audio, _, stops, opts = stream_workload(st, feat)
    st_fixed = dataclasses.replace(st, eot=-1)
    run_stream(model, audio[:2 * STREAM.batch], opts, st_fixed, stops, feat)  # warm-up
    walls = [_timed(lambda: run_stream(model, audio, opts, st_fixed, stops, feat))[1]
             for _ in range(trials)]
    rates = [STREAM_WINDOWS * feat.chunk_length_s / w for w in walls]
    return {"wall_s": walls, "audio_s_per_s": rates,
            "median_audio_s_per_s": float(np.median(rates))}


def _k2(cfg, trials, form):
    """K2's ring (or beam) wrapper at its path's shape, one cache a decoder
    layer, with the prefix wrapper on the same caches as the yardstick."""
    h = cfg.decoder_attention_heads
    g = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    if form == "ring":
        rows, t = STREAM.batch, STREAM_CAPACITY
        q = randn(rows, h, 64)
    else:
        rows, t = BEAM_GROUPS, cfg.max_source_positions
        q = randn(rows, BEAM_WIDTH, h, 64)
    caches = [whisper.quantize_kv_rows(randn(rows, t, h * 64))
              + whisper.quantize_kv_rows(randn(rows, t, h * 64))
              for _ in range(cfg.decoder_layers)]  # (k, k_scale, v, v_scale) a layer
    extra = {}
    if form == "ring":
        budgets = realistic_stops(rows, 4, np.random.default_rng(0))
        valid = torch.from_numpy(budgets.astype(np.int32)).cuda()
        prefix_valid = int(round(float(budgets.mean())))
        ring_pos = torch.tensor(40, dtype=torch.int32, device="cuda")
        q_prefix = q
        extra["mean_valid"] = float(budgets.mean())

        def step():
            for k, ks, v, vs in caches:
                da.decode_attention(q, k, v, valid, n_heads=h, k_scale=ks, v_scale=vs,
                                    ring_pos=ring_pos)
    else:
        prefix_valid, q_prefix = t, q[:, 0]

        def step():
            for k, ks, v, vs in caches:
                da.decode_attention_beam(q, k, v, n_heads=h, k_scale=ks, v_scale=vs)

    def prefix_step():
        for k, ks, v, vs in caches:
            da.decode_attention(q_prefix, k, v, prefix_valid, n_heads=h, k_scale=ks,
                                v_scale=vs)

    for _ in range(3):
        step()
        prefix_step()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        graph.replay()
    end.record()
    end.synchronize()
    calls = K2_STEPS * len(caches)
    host_us, prefix_us = [], []
    for _ in range(trials):
        for fn, acc in ((step, host_us), (prefix_step, prefix_us)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(K2_STEPS):
                fn()
            acc.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return {f"{form}_device_us": start.elapsed_time(end) / (20 * len(caches)) * 1e3,
            f"{form}_host_us": host_us, "prefix_host_us": prefix_us,
            f"median_{form}_host_us": float(np.median(host_us)),
            "median_prefix_host_us": float(np.median(prefix_us)), **extra}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--stream", action="store_true",
                      help="time phase 4e's continuous batching instead of lockstep")
    mode.add_argument("--ring", action="store_true",
                      help="time K2's ring wrapper at phase 4e's shape")
    mode.add_argument("--beam", action="store_true",
                      help="time K2's beam wrapper at phase 4f's groups and beams")
    ap.add_argument("--trials", type=int, default=3)
    args = ap.parse_args(argv)

    resolve_device("cuda")
    cfg = PRESETS[PRESET]
    if args.ring or args.beam:
        rec = _k2(cfg, args.trials, "ring" if args.ring else "beam")
    else:
        model = whisper.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                    device="cuda", dtype=torch.bfloat16)
        rec = (_stream if args.stream else _lockstep)(model, cfg, args.trials)
    rec["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
