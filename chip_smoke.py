"""Chip smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py                # the check: one card, no arguments
    python3 chip_smoke.py --profile DIR  # also trace one main-path run, one
                                         # fused + w8a8 run, one beam stream,
                                         # 4h's 10 s and 300 s calls of each
                                         # model's config (a), one stream-real
                                         # run, one beam search and one train
                                         # step with torch.profiler, tables
                                         # into DIR/

Phases, in order; any failure exits nonzero and prints no result line:

  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: every CUDA kernel of the port (csrc/*.cu) with nvcc, in parallel;
  3. kernels: the card's exponential rate (K9; a marginal rate above 1.05x
     the data sheet's fails the run), then each kernel against
     its plain PyTorch twin on the card at the shapes of the path that runs
     it (large-v3; B=16 pseudo-labelling and encoder, B=8 x 128 labels
     training), with its time, the twin's time, a library call's time and
     the least time the card could take (K2 also in its ring form, W=48 x
     T=176 with most rows wrapped and a rolled-prefix control, and its beam
     form, 12 groups x 5 beams over T=1500, then 12 x 8 and 2 x 17 beams
     against the fp32 twin); K2's self form (the ring kernel without a
     ring slot) on phase 4's self call, int8, B=16 x T=51; K1, K2's prefix
     (cross int8), self (int8), ring and beam forms also at a
     tensor-parallel shard's 10 heads (a K/V width of 640); K2 in the int4
     cache's modes (bf16 per-head scales): prefix cross int4 (also at 10
     heads), self int8, ring self int8, beam cross int4; each also with
     its device time
     alone and the library call's (a CUDA graph of 20 calls, replayed; K5's
     library call, autograd through SDPA, from torch.profiler's kernel
     times where a graph cannot capture it) and the host's time per call
     of each; K3 also on a wide-dynamic-range
     input, its raw values read by region against a float64 evaluation;
     K4's device time also by batch; K8's quantize pre-pass also bit for
     bit against the twin quantizers, and its pre-pass and main kernel
     each timed alone; then the fp32 forms at phase 4k's shapes: K1 (B=16,
     T=1500; its bound the three TF32 products, the FFMA bound and SDPA's
     distance from the twin beside), K4 (B=8 x 128, the same bound), K2's
     prefix form
     (cross T=1500 with fp32, int8 and int4 K/V), self form (T=51), ring
     form (W=48 at T=176 and T=448, the latter in boxes) and beam form (12 x 5 over T=1500, fp32 and int4
     K/V), K5 (causal B=8 x 128, its one-launch cluster form, and cross 128
     x 1500, its split form on 3xTF32 wgmma: dQ, dK, dV; autograd through
     SDPA beside it; both bounds the three TF32 products), K8 with fp32 q
     (qk and qkpv at B=16, T=1500, its pre-pass bit for bit), K6 on fp32 rows (24000 x 1280, LayerNorm and
     the fused add) and K7 (16, 128, 3000, on 3xTF32 wgmma, its bound the
     three TF32 products; cuDNN conv + GELU twice with TF32 off beside
     it), each held to its fp32 twin by relative L2 <= 1e-5
     above a control >= 1e-2 (a dropped key tile; K6: a 64-column chunk
     not written; K7: conv1's first tap skipped), the library call on the
     same fp32 tensors beside it with its kernel named; the JAX package's
     switches at the encoder's shape: K1's no-max form (KWT_FA_NOMAX) and
     K1 under KWT_FA_EXP2 (its own kernel, held to the exp2 twin), bf16
     and fp32, and K8's no-max forms, qk and qkpv, bf16 and fp32 q (their
     pre-pass's key bounds bit for bit), each no-max form also on
     fa.no_max_witness: rows past their max by >= 110 read 0 in kernel and
     twin alike, and the max-based twin reads >= 0.5 away from both;
  4. main path: large-v3 width and depth with seeded random weights, bf16,
     int8 KV, B=16, 48 new tokens with eot disabled:
     log_mel_spectrogram -> generate_greedy, with launch counters checked;
     then at B=2, on three seeds, the kernel path against the plain path
     on the card: each encoder layer's attention (with a dropped-key-tile
     control), the whole encoder beside a one-ulp witness, the logits;
  4c. the same path with the inference transforms, fused projections and
     w8a8 (bench.py's fixed-*-w8a8 recipe): B=16 with launch counters and
     stage times, one B=64 batch, the B=2 kernel-vs-plain checks;
  4g. beam-stream-w8a8 (bench.py's run_stream_beam) on that model:
     continuous-batching beam search of 96 synthetic 30 s windows, 12
     groups x 5 beams, refills of 6, 8 steps a round, ring layout, int8 KV,
     capacity 176, bench.py's budgets, eot live, mel inside the timed
     window; a warm-up on 24 windows, the best of 2 trials, with the time
     in refills and in steps; launches by form (K2 ring 32 and beam 32 a
     step, K1 32 a refill, K3 once a mel batch of 16); every utterance the
     prompt, then at most its budget's tokens, then pads, a finite score;
     at 2 groups the kernel path against the plain path (first-step
     logits);
  4h. serving (the JAX package's stage 6 at its runtime table's configs):
     decode/pipeline.AsrPipeline and eval/speed.evaluate_speed on
     distil-large-v3 (32 + 2 layers, built here, fused, and a w8a8 copy)
     and large-v3 (4c's models), max_length 32, 15 s chunks, durations
     10 / 30 / 60 / 300 s of generate_dummy_audio, configs (a) compute KV
     and GEMMs, (b) int8 KV + w8a8, (c) (b) over the int16 wire; 1 warm-up
     and 3 trials a duration, seconds and audio-s/s beside nvidia-smi's name
     and power limit; one 300 s call a config with its launches (K3 1, K1
     one an encoder layer, K2 prefix and self one a decoder layer a step); on PCM-sourced
     300 s audio the int16 and fp32 wires' log-mel bit for bit and (b) and
     (c) the same transcript; 5 beams at 30 s (K2 self and beam one a layer
     a step); at 25 s (2 chunks) and at the 300 s call's batch the
     first-step logits of (a) and (b) against the plain path; every
     transcript text, every chunk's timestamps ordered (but for a segment
     opened past the audio's end and never closed, which the merge ends at
     the audio's end: a JAX fault the port copies); the records
     written through the port's writer and its runtime_pivot_table
     printed, six rows of four durations;
  4d. encoder variants at B=16 on the fused model: default, the fused stem
     (K7), KWT_FA_INT8=qk and qkpv (K8 in place of K1), enc_exp's fused_ln
     (K6), KWT_FA_NOMAX=1, KWT_FA_EXP2=1 and KWT_FA_NOMAX=1 with
     KWT_FA_INT8=qk and qkpv, each with its time, rel-L2 against the
     default (for the switches a reading), launches and C entries; the
     switches' kernel path also against their plain path at B=2;
  4e. stream-real (the JAX bench's headline): continuous-batching greedy
     decode of 192 synthetic 30 s windows, window 48, refills of 16, int8
     KV, budgets from bench.py's ReazonSpeech length fit, eot disabled, mel
     on the card inside the timed window, on the fused bf16 model; its
     KWT_STREAM_TRACE phases and launch counts (K2 64 a step: 32 ring, 32
     cross; K1 32 and K3 one a refill); every row the prompt, then its
     budget's tokens, then pads; then lockstep B=16 on the same windows and
     budgets, and the share of utterances whose tokens agree (reported);
  4f. lockstep beam search, 12 groups x 5 beams, prompt + 48 tokens, int8
     KV, fused bf16 model, launches by form (K2 32 self and 32 beam a
     step); at 2 groups the kernel path against the plain path (first-step
     logits), scores and tokens reported;
  4b. train path: distillation of a 32+2-layer student initialised from a
     seeded random large-v3 teacher, B=8 x 128 labels, bf16 compute on fp32
     master weights: one warm-up step and 3 timed steps with launch
     counters checked; frozen encoder unchanged, decoder moved; at B=2 the
     kernel path against the plain path (loss and decoder gradients), and
     again under KWT_FA_NOMAX=1 (every K1 call through its no-max form,
     K5 on its LSE); one B=16 step in 2 microbatches; then the bilingual trainer's step (5c's
     timed step): 2 datasets x B=4 x 128 labels, KL on the first, launches
     checked, at B=2 the kernel path against the plain path;
  4j. the int4 KV cache (packed int4 cross K/V, int8 self K/V, bf16
     per-head scales) on the fused bf16 model: (a) phase 4's B=16 batch
     (launches K1 32, K3 1, K2 prefix 1536 and self 1536; the share of tokens equal to
     phase 4's int8 tokens), (b) 4f's beam search, (c) a stream on 4e's
     settings over 48 windows, (d) a beam stream on 4g's settings over 24
     windows, (e) AsrPipeline at 30 s, 1 warm-up and 3 trials, (f) at B=2
     on three seeds the first-step logits of the kernel path against the
     plain path; launches by form, the cross cache's bytes in int8 and
     int4, audio-s/s beside phases 4 and 4f;
  4k. fp32 (the JAX package's --dtype float32): large-v3 with seeded
     random fp32 weights through the kernels' fp32 forms: (a) phase 4's
     B=16 batch with int8, int4 and compute KV (launches K1 32, K3 1, K2
     prefix 1536 and self 1536 each), (b) 4f's beam search with compute and int4 KV, (c) a stream on
     4e's settings over 48 windows, (d) AsrPipeline at 30 s, (e) at B=2 on
     three seeds the kernel path, under torch's default TF32 flags, against
     the plain path: encoder and first-step logits within 1e-4, the 48
     greedy tokens equal (beside a witness: the encoder with the model's
     TF32 guard bypassed); (f) 4d's encoder variants on this model (the
     K7 stem, K8 under KWT_FA_INT8=qk and qkpv, enc_exp's fused_ln through
     K6, the switches), each with its time, launches and rel-L2 against
     the default;
     audio-s/s and the fp32 cross cache's bytes;
  4b-f32. (after 4i(a)) 4b's step in fp32: a seeded fp32 large-v3 teacher
     and its 32+2-layer student, B=8 x 128 labels, one warm-up step (its
     launches by C entry: the fp32 forms only) and 3 timed steps, launches
     as 4b's, the frozen encoder unchanged and the decoder moved; at B=2
     the kernel path under torch's default TF32 flags against the plain
     path (loss within 1e-5, decoder gradients within 1e-4), beside a
     witness (4b's bf16 step on the same rows reads above that bar); then
     the bilingual step in fp32 (5c's datasets, launches as 5c's);
  4i. parallel on one card: (a) a one-rank NCCL group and its mesh: one
     lockstep stage-2 batch and one data-parallel distillation step,
     launches as phases 4 and 4b; (b) tensor parallel over two ranks on
     card 0 (a gloo group the script builds itself, NCCL refusing two
     ranks on one card): large-v3 fused bf16 and fused + w8a8 at 10 heads
     a rank, int8 KV, B=16, prompt + 48 tokens (w8a8: + TP_W8A8_TOKENS,
     24, for the smoke's time), the share of tokens equal
     to the one-card run, the first-step logits against it (rel-L2 5e-2),
     each rank's launches and wall, then a beam search and a stream for
     K2's beam and ring forms at 10 heads and a short int4-cache batch for
     its prefix form there; (c), run inside phase 5, data
     parallel over two ranks on card 0: stage 2 through the driver's rank
     body with --num_devices 2 (every utterance once, in the one-card
     order) and one distillation step at 4b's shape, 4 rows a rank (equal
     loss and grad_norm on both, within 1e-2 of 4b's one-card step);
  5. drivers: cli/pseudo_label on synthetic WAV utterances in a tar shard,
     with its default fusion, then with --gemm_dtype int8 under
     KWT_FA_INT8=qk, then --streaming, then --num_beams 3, then
     --streaming --num_beams 3, then --dtype float32 in lockstep, with
     --streaming, with --num_beams 3 and under KWT_FA_INT8=qk (K8's fp32-q
     form), then lockstep under KWT_FA_NOMAX=1; then through `python -m
     kotoba_whisper_tpu_torch`: filter on the labels with --skip_filtering
     (K3 on the card) and with the WER gate, merge of the two chunks;
  5b. create-student (4-layer encoder at large-v3 width) -> distill 2
     steps on the merged split, save -> resume to step 3 -> export, and
     create-student --dtype float32 (K1 6 and K4 2 launches), distill
     --dtype float32 for 2 steps (K1, K4 and K5 in fp32); then stage 6
     through `python -m kotoba_whisper_tpu_torch`: prepare-eval-set
     from a manifest of synthetic WAVs to tar+tsv, eval of the exported
     student on it, again with --stable_ts --punctuator, and a third time
     from a copy of the first run's output, where every prediction comes
     from the cache (no launch); cli.eval_diff --strict --tolerance 1e-6 of
     the third run against the first; speed at 10 s, one trial; eval and
     speed at 10 s with --dtype float32; report of the metric and the
     runtime JSONL; then (a) the ASR -> MT cascade: a random-weights NLLB
     checkpoint at NLLB-200-distilled-600M's widths (config.json,
     pytorch_model.bin, a hand-written unigram tokenizer.json over all
     256206 ids), eval --cascaded_mt --dtype float32 of the student on the
     same set (the ASR half's launches those of the plain fp32 eval, the
     MT half on stock torch ops), and the MT model on the card against its
     CPU plain path on the set's first sentence: first-step logits, the
     full decoder over the 128 greedy tokens, and the card's cached step
     over them against the CPU's full decoder, each within F32_PATH_TOL,
     and the greedy tokens equal; (b) ESB: prepare-eval-set
     --corpus librispeech --to_tar on a tiny LibriSpeech layout, then eval
     on the tar set; (c) eval/scaling.scaling_report at one card over the
     student's encoder (K1 launched). parity-check and the NeMo baseline
     are not driven here: they need `transformers` and `reazonspeech`,
     which the card's machine lacks (tests/test_torch_parity_check.py and
     tests/test_torch_cascaded.py run them on the CPU);
  5c. bilingual distillation: stage 2 with --text_lang_task
     ja:transcribe,en:translate, stage 3 keeping both label columns, then
     `python -m kotoba_whisper_tpu_torch distill-bilingual` on that chunk as
     two datasets (transcribe.ja+translate.en with KL, transcribe.ja
     without) from 5b's student, 2 steps and an HF export, then one step
     with --dtype float32;
  5d. the experiment tools' main(): enc_exp (fused_ln, and fused_ln
     --dtype float32 at B=4), stem_exp, vpu_cal (softmax and exp), few
     trials, their JSON lines parsed;
  6. a JSON line of every kernel with the launches of the path that runs
     it (K1, K2 prefix and self: the pseudo-labelling run; K2 ring and beam: the 4g
     beam stream; K3: phase 5's filter; K4, K5: the 3 timed train steps;
     K6-K8: the 4d encoder runs; K9: the vpu_cal runs of 5d; the 10-head
     records: rank 0 of 4i(b); the int4 cache's records: 4j (a) prefix and
     self, (b) beam, (c) ring; the fp32 records: 4k (a) K1, prefix and self, (b) beam, (c)
     ring, (f) K6-K8, 5b's create-student --dtype float32 for K4, and the
     3 timed steps of 4b-f32 for K5; the switches' records: 4d's and
     4k(f)'s switch variants) and its
     numbers, K1, K2 and K3 also with their launches in 4h's 300 s call of
     large-v3 (a), K2's beam form in 4h's beam call (`serving_launches`);
  7. the last line: {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import csv
import dataclasses
import gc
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

# Expandable segments: freed, the fp32 paths' multi-GB caches would
# otherwise be split for later small tensors and stay reserved past
# empty_cache (80 GB reserved for 0.3 GB allocated), and the ranks spawned
# onto card 0 (4i) would find it full; with them empty_cache unmaps every
# free page. CUDA graphs' private pools keep plain segments. Set before
# torch touches the card; the spawned ranks inherit it.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# Published dense peaks of the card the port targets (NVIDIA H100 SXM data
# sheet): bf16 tensor FLOP/s, fp32 CUDA-core FLOP/s, memory bytes/s, int8
# tensor OP/s, TF32 tensor FLOP/s. Another card needs its own entry; the
# bounds are not guessed for it.
PEAKS = {"H100 80GB HBM3": (989e12, 67e12, 3.35e12, 1979e12, 495e12)}
# Relative L2 error allowed of every kernel against its twin: ~10x the bf16
# rounding of K1's and K2's outputs; a dropped or mis-weighted key tile moves
# it by ~1e-1 on random inputs and by ~1.9e-2 on the encoder's own
# activations, whose softmax is nearly flat (phases 4 and 4c read that).
REL_L2_TOL = 1e-2
# The fp32 forms (fp32 arithmetic end to end) are held to their fp32 twins
# by relative L2 <= F32_REL_TOL, ~100x fp32 rounding of sums in another
# order; each record's control, the twin with one 64-key tile of keys
# dropped, must read at least F32_CONTROL_MIN, so the bar can see such a
# fault.
F32_REL_TOL, F32_CONTROL_MIN = 1e-5, 1e-2
# phase 4k: fp32 large-v3, its encoder and first-step logits against the
# plain path (relative L2), the kernel path under torch's default TF32 flags
F32_PATH_TOL = 1e-4
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
# the same in fp32 (phase 4b-f32): the kernel path, under torch's default
# TF32 flags, against the plain path; 4b's bf16 gradients must read above
# F32_TRAIN_GRAD_TOL against the fp32 plain path, so the bar can see an
# error of bf16's size
F32_TRAIN_LOSS_TOL = 1e-5
F32_TRAIN_GRAD_TOL = 1e-4
# phase 4h: the serving table's settings (eval_pipeline/runtime_pipeline.tpu-v5e.jsonl)
SERVE_DURATIONS = (10, 30, 60, 300)
SERVE_MAX_LENGTH = 32
SERVE_WARMUP, SERVE_TRIALS = 1, 3   # the JAX harness's 2 and 5, cut for the smoke's time
# phase 4j: the int4 streams' windows, fewer than 4e's 192 and 4g's 96
J_STREAM_WINDOWS, J_BEAM_STREAM_WINDOWS = 48, 24
# phase 4i(b): the w8a8 TP=2 run's decode steps, half of NEW_TOKENS: two
# ranks on one card over gloo are host-bound (its 48 steps took 36-80 s
# on an H100 80GB HBM3 at 700 W)
TP_W8A8_TOKENS = 24


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


def every_count():
    """Launches of every kernel's wrapper since the last reset_every()."""
    from kotoba_whisper_tpu_torch.ops import conv_stem as cs
    from kotoba_whisper_tpu_torch.ops import decode_attention as da
    from kotoba_whisper_tpu_torch.ops import flash_attention as fa
    from kotoba_whisper_tpu_torch.ops import layer_norm as ln
    from kotoba_whisper_tpu_torch.ops import mel
    from kotoba_whisper_tpu_torch.tools import vpu_cal

    return {"K1": fa.flash_attention_fwd.launches, "K2": da.decode_attention.launches,
            "K2self": da.decode_attention.self_launches,
            "K2ring": da.decode_attention.ring_launches,
            "K2beam": da.decode_attention_beam.launches, "K3": mel.log_mel_frames.launches,
            "K4": fa.flash_attention_fwd.causal_launches,
            "K5": fa.flash_attention_bwd.launches, "K6ln": ln.layer_norm.launches,
            "K6add": ln.add_layer_norm.launches, "K7": cs.conv_stem.launches,
            "K8": fa.flash_attention_int8.launches, "K9": vpu_cal.vpu_cal.launches,
            "K1nomax": fa.flash_attention_fwd.nomax_launches,
            "K8nomax": fa.flash_attention_int8.nomax_launches}


def reset_every():
    from kotoba_whisper_tpu_torch.ops import conv_stem as cs
    from kotoba_whisper_tpu_torch.ops import decode_attention as da
    from kotoba_whisper_tpu_torch.ops import flash_attention as fa
    from kotoba_whisper_tpu_torch.ops import layer_norm as ln
    from kotoba_whisper_tpu_torch.ops import mel
    from kotoba_whisper_tpu_torch.tools import vpu_cal

    for fn in (fa.flash_attention_fwd, da.decode_attention, da.decode_attention_beam,
               mel.log_mel_frames, fa.flash_attention_bwd, ln.layer_norm,
               ln.add_layer_norm, cs.conv_stem, fa.flash_attention_int8, vpu_cal.vpu_cal):
        fn.launches = 0
    fa.flash_attention_fwd.causal_launches = 0
    da.decode_attention.ring_launches = da.decode_attention.self_launches = 0
    fa.flash_attention_fwd.nomax_launches = fa.flash_attention_int8.nomax_launches = 0


@contextlib.contextmanager
def counting_entries():
    """Counts, by name, the C entries the wrappers look up inside the
    block: one a launch (the no-max and fp32 forms have entries of their
    own). -> the dict of counts."""
    from kotoba_whisper_tpu_torch.ops import _build

    entries, real = {}, _build.function

    def counted(name, fn):
        entries[fn] = entries.get(fn, 0) + 1
        return real(name, fn)

    _build.function = counted
    try:
        yield entries
    finally:
        _build.function = real


def card_memory() -> str:
    """The card memory this process holds, after freeing what nothing
    references (cycles included) back to the card."""
    gc.collect()
    torch.cuda.empty_cache()
    return (f"card memory of this process: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
            f"allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")


def nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# NLLB-200-distilled-600M's published widths (facebook/nllb-200-distilled-600M,
# config.json), the cascade's MT model in phase 5 (stage 6)
NLLB_600M = dict(vocab_size=256206, d_model=1024, encoder_layers=12, decoder_layers=12,
                 encoder_attention_heads=16, decoder_attention_heads=16,
                 encoder_ffn_dim=4096, decoder_ffn_dim=4096, max_position_embeddings=1024)


def write_nllb_checkpoint(path: str, seed: int) -> None:
    """A random-weights NLLB checkpoint at NLLB_600M: config.json,
    pytorch_model.bin (torch.save of HF-named fp32 tensors, made on the
    card) and a hand-written unigram tokenizer.json whose pieces span
    every id (so every id the random model emits decodes): <s> <pad> </s>
    <unk> at 0-3, the eval sentences' words, hex pieces, and jpn_Jpan and
    eng_Latn as added tokens at the last two ids. The shared embedding is
    drawn at std 0.002, a tenth of the init's: at d_model 1024 the scaled
    input token otherwise dominates the tied logits, and the random model
    repeats eng_Latn, which decodes to nothing."""
    from kotoba_whisper_tpu_torch.models import text_seq2seq as ts

    os.makedirs(path, exist_ok=True)
    cfg = ts.TextSeq2SeqConfig(**NLLB_600M)
    model = ts.init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    with torch.no_grad():
        model.model.shared.weight.mul_(0.1)
    sd = {f"model.{k}": v.cpu() for k, v in model.model.state_dict().items()}
    del model
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": "m2m_100", "architectures": ["M2M100ForConditionalGeneration"],
                   "pad_token_id": 1, "eos_token_id": 2, "bos_token_id": 0,
                   "decoder_start_token_id": 2, "scale_embedding": True, **NLLB_600M}, f)
    n_pieces = NLLB_600M["vocab_size"] - 2
    words = ["▁評価", "▁発話", "▁評", "価", "発", "話"] + [f"▁{i}" for i in range(10)]
    vocab = [["<s>", 0.0], ["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]] + [
        [w, -3.0] for w in words]
    vocab += [[f"▁x{i:x}", -8.0 - 1e-5 * i] for i in range(n_pieces - len(vocab))]
    added = [{"id": n_pieces + i, "content": c, "special": True}
             for i, c in enumerate(("jpn_Jpan", "eng_Latn"))]
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump({"added_tokens": added, "normalizer": {"type": "NFKC"},
                   "model": {"type": "Unigram", "unk_id": 3, "vocab": vocab}}, f,
                  ensure_ascii=False)


@dataclasses.dataclass(frozen=True)
class EncoderScaling:
    """make_pipeline / make_batch of eval/scaling.scaling_report for the
    Whisper encoder of an HF-layout checkpoint dir over seeded log-mel
    rows: `rows_per_device` 30 s windows a rank, in bf16."""

    model_dir: str
    rows_per_device: int

    def make_pipeline(self, dev: torch.device):
        from kotoba_whisper_tpu_torch.cli.common import load_model
        from kotoba_whisper_tpu_torch.models.whisper import encode

        model, _ = load_model(self.model_dir, dev, torch.bfloat16)
        return lambda batch: encode(model, batch["mel"].to(torch.bfloat16), device=dev)

    def make_batch(self, n_devices: int) -> dict:
        with open(os.path.join(self.model_dir, "config.json")) as f:
            cfg = json.load(f)
        return {"mel": np.random.default_rng(0).standard_normal(
            (self.rows_per_device * n_devices, cfg["num_mel_bins"],
             2 * cfg["max_source_positions"])).astype(np.float32)}


def cached_step_logits(model, src, tokens) -> torch.Tensor:
    """The NLLB decoder's cached step (generate_greedy_text's) teacher-forced
    over `tokens`: fp32 logits (B, T, vocab) on the model's device."""
    from kotoba_whisper_tpu_torch.models import text_seq2seq as ts
    from kotoba_whisper_tpu_torch.models.whisper import exact_fp32

    dev = next(model.parameters()).device
    ids, tokens = torch.as_tensor(src).long().to(dev), tokens.long().to(dev)
    f32 = torch.float32
    with torch.inference_mode(), exact_fp32(f32):
        mask = ts._key_mask(model, ids)
        cache = ts._init_cache(model, ts._encode(model, ids, f32), tokens.shape[1], f32)
        return torch.stack([ts._decode_step(model, tokens[:, t:t + 1], cache, mask, f32)
                            for t in range(tokens.shape[1])], 1)


def stage6_cascade_esb_scaling(tmp: str, student_dir: str, eval_set: str, eval32_counts: dict,
                               n_eval: int, card: str) -> None:
    """Phase 5's stage-6 parts (a)-(c) on 5b's exported student and the
    stage-6 eval set in `tmp`; `eval32_counts` are the plain fp32 eval's
    launches on that set, which the cascade's ASR half must repeat."""
    from kotoba_whisper_tpu_torch.__main__ import main as cli
    from kotoba_whisper_tpu_torch.data import reazon
    from kotoba_whisper_tpu_torch.eval.cascaded_s2t import source_ids
    from kotoba_whisper_tpu_torch.eval.scaling import scaling_report
    from kotoba_whisper_tpu_torch.models import text_seq2seq as ts
    from kotoba_whisper_tpu_torch.tokenizer.unigram import NllbTokenizer

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).norm() / b.norm())

    # ---- 5 (stage 6, a): the cascade, eval --cascaded_mt in fp32 ---------------
    # A random NLLB checkpoint at NLLB-200-distilled-600M's widths, then the
    # exported student's fp32 eval on the same set through the ASR -> MT
    # cascade: the ASR half's launches are the plain fp32 eval's (the MT
    # half runs on stock torch ops, as the JAX package runs it in XLA);
    # then the MT model on the card against its CPU plain path on the eval
    # set's first sentence: first-step logits and greedy tokens.
    nllb_dir, eval_mt = os.path.join(tmp, "nllb"), os.path.join(tmp, "eval_mt")
    t0 = time.perf_counter()
    write_nllb_checkpoint(nllb_dir, seed=5)
    t_write = time.perf_counter() - t0
    buf = io.StringIO()
    reset_every()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli(["eval", "--model", student_dir, "--tokenizer", "byte", "--dataset_dir", eval_set,
             "--dataset_name", "synth", "--output_dir", eval_mt, "--dtype", "float32",
             "--cascaded_mt", nllb_dir])
    t_mt = time.perf_counter() - t0
    mt_counts = nonzero(every_count())
    with open(os.path.join(eval_mt, "metric.ja.translate.jsonl")) as f:
        mt_metric = json.loads(f.read().splitlines()[-1])
    (mt_csv,) = [n for n in os.listdir(eval_mt) if n.startswith("model-")]
    with open(os.path.join(eval_mt, mt_csv), encoding="utf-8") as f:
        mt_rows = list(csv.DictReader(f))
    log(f"[5(a) cascade] NLLB checkpoint at 600M widths written in {t_write:.1f} s; eval "
        f"--cascaded_mt --dtype float32: {t_mt:.1f} s [{card}]; launches {mt_counts} "
        f"(plain fp32 eval {eval32_counts}); task {mt_metric['task']}, cer_norm "
        f"{mt_metric['cer_norm']:.2f}; translations "
        f"{[r['prediction_raw'][:40] for r in mt_rows]}")
    if not (mt_counts == eval32_counts and mt_metric["task"] == "translate"
            and len(mt_rows) == n_eval and all(r["prediction_raw"] for r in mt_rows)):
        raise AssertionError(f"eval --cascaded_mt: launches {mt_counts}, metric {mt_metric}, "
                             f"{len(mt_rows)} rows")
    t0 = time.perf_counter()
    nllb_cpu, nllb_cfg = ts.load_hf_checkpoint(nllb_dir)
    nllb_gpu = copy.deepcopy(nllb_cpu).to("cuda")
    nllb_tok = NllbTokenizer.from_pretrained_dir(nllb_dir)
    sentence = "評価 発話 0"  # the eval set's first transcript
    src = source_ids(nllb_tok.encode(sentence, "jpn_Jpan"), nllb_cfg.pad_token_id)
    dec = np.asarray([[nllb_cfg.decoder_start_token_id, nllb_tok.lang_id("eng_Latn")]])
    models = (("cuda", nllb_gpu), ("cpu", nllb_cpu))
    enc = {where: ts.encode(m, src, device=where) for where, m in models}
    step_logits = {where: ts.decode(m, dec, enc[where], src, device=where).cpu()
                   for where, m in models}
    mt_rel = rel(step_logits["cuda"], step_logits["cpu"])
    mt_tokens = {where: ts.generate_greedy_text(
        m, src, forced_bos=nllb_tok.lang_id("eng_Latn"), max_length=128,
        device=where).cpu() for where, m in models}
    # The random model repeats a token, so equal tokens say little of the
    # cache and the positions: also the full decoder teacher-forced over the
    # greedy output (card vs CPU), and the card's cached step over the same
    # tokens against the CPU's full decoder, at every position.
    full = {where: ts.decode(m, mt_tokens["cpu"], enc[where], src, device=where).cpu()
            for where, m in models}
    full_rel = rel(full["cuda"], full["cpu"])
    cached_rel = rel(cached_step_logits(nllb_gpu, src, mt_tokens["cpu"]).cpu(), full["cpu"])
    log(f"[5(a) cascade] NLLB on the card against its CPU plain path, source {src.shape[1]} "
        f"wide: first-step logits rel-L2 {mt_rel:.2e}, full decoder over the 128 greedy "
        f"tokens {full_rel:.2e}, the card's cached step against it {cached_rel:.2e} "
        f"(<= {F32_PATH_TOL:.0e}); greedy tokens equal: "
        f"{bool(torch.equal(mt_tokens['cuda'], mt_tokens['cpu']))}, "
        f"{len(set(mt_tokens['cpu'][0].tolist()))} distinct ({time.perf_counter() - t0:.1f} s)")
    if not (max(mt_rel, full_rel, cached_rel) <= F32_PATH_TOL
            and torch.equal(mt_tokens["cuda"], mt_tokens["cpu"])):
        raise AssertionError(f"NLLB card vs CPU: rel-L2 {mt_rel:.2e} / {full_rel:.2e} / "
                             f"{cached_rel:.2e}, tokens {mt_tokens['cuda'][0, :16].tolist()} vs "
                             f"{mt_tokens['cpu'][0, :16].tolist()}")
    del enc, full
    del nllb_cpu, nllb_gpu
    shutil.rmtree(nllb_dir)
    torch.cuda.empty_cache()

    # ---- 5 (stage 6, b): ESB, prepare-eval-set --corpus librispeech --to_tar ----
    # A tiny LibriSpeech layout (chapter dirs, .trans.txt rows, .flac members
    # holding WAV bytes: the native decoder reads the content), prepared to a
    # manifest and tar+tsv, then the student's eval on the tar set.
    rng = np.random.default_rng(6)
    libri = os.path.join(tmp, "LibriSpeech", "test-clean", "1089", "134686")
    os.makedirs(libri)
    esb_secs = (4, 9)
    with open(os.path.join(libri, "1089-134686.trans.txt"), "w") as f:
        for i, sec in enumerate(esb_secs):
            with open(os.path.join(libri, f"1089-134686-000{i}.flac"), "wb") as w:
                w.write(reazon.wav_bytes(rng.standard_normal(16000 * sec) * 0.1))
            f.write(f"1089-134686-000{i} HE HOPED THERE WOULD BE STEW {i}\n")
    esb_out, esb_eval = os.path.join(tmp, "esb_librispeech"), os.path.join(tmp, "eval_esb")
    buf = io.StringIO()
    reset_every()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli(["prepare-eval-set", "--corpus", "librispeech", "--split", "test.clean",
             "--input", os.path.join(tmp, "LibriSpeech", "test-clean"), "--output_dir",
             esb_out, "--to_tar"])
        cli(["eval", "--model", student_dir, "--tokenizer", "byte", "--dataset_dir",
             os.path.join(esb_out, "tar"), "--dataset_name", "esb/librispeech",
             "--language", "en", "--output_dir", esb_eval])
    esb_counts = nonzero(every_count())
    with open(os.path.join(esb_eval, "metric.en.transcribe.jsonl")) as f:
        esb_metric = json.loads(f.read().splitlines()[-1])
    tar_files = sorted(os.listdir(os.path.join(esb_out, "tar")))
    log(f"[5(b) esb] prepare-eval-set --corpus librispeech --to_tar, then eval: "
        f"{time.perf_counter() - t0:.1f} s [{card}]; {buf.getvalue().splitlines()[:2]}; "
        f"tar set {tar_files}; launches {esb_counts}; cer_norm {esb_metric['cer_norm']:.2f}")
    if not (esb_counts.get("K1") == 4 * len(esb_secs) and esb_counts.get("K3") == len(esb_secs)
            and esb_counts.get("K2") and esb_metric["dataset"] == "esb/librispeech"):
        raise AssertionError(f"ESB route: launches {esb_counts}, metric {esb_metric}")

    # ---- 5 (stage 6, c): the scaling report at one card -------------------------
    # eval/scaling.scaling_report over the student's encoder (4 layers at
    # large-v3 width, bf16), 16 windows, one warm-up and 2 trials, at count 1:
    # one rank in this process (cli/common.launch).
    job = EncoderScaling(student_dir, rows_per_device=B)
    reset_every()
    t0 = time.perf_counter()
    points = scaling_report(job.make_pipeline, job.make_batch, audio_seconds_per_item=30.0,
                            device_counts=[1], n_trials=2)
    scale_counts = nonzero(every_count())
    log(f"[5(c) scaling] {[dataclasses.asdict(p) for p in points]} in "
        f"{time.perf_counter() - t0:.1f} s [{card}]; launches {scale_counts}")
    if not ([p.n_devices for p in points] == [1] and points[0].efficiency == 1.0
            and points[0].audio_s_per_s > 0 and scale_counts.get("K1") == 4 * 3):
        raise AssertionError(f"scaling report {points}, launches {scale_counts}")
    torch.cuda.empty_cache()


def main_audio(feat) -> np.ndarray:
    """Phase 3's and 4's B=16 input: seeded noise at 0.1."""
    return (np.random.default_rng(0).standard_normal((B, feat.n_samples)) * 0.1
            ).astype(np.float32)


def first_step_logits(model, feats, prompt, capacity, kv_dtype="int8"):
    """The first sampled position's fp32 logits: encode, an int8 (or
    `kv_dtype`) cache, the prompt prefill, one step."""
    from kotoba_whisper_tpu_torch.models import whisper

    with torch.inference_mode():
        cache = whisper._init_cache(model, whisper.encoder_forward(model, feats), capacity,
                                    kv_dtype)
        ids = torch.tensor([prompt], device=feats.device).repeat(feats.shape[0], 1)
        _, cache = whisper._decode_step(model, ids[:, :-1], cache)
        logits, _ = whisper._decode_step(model, ids[:, -1:], cache)
    return logits[:, 0].float()


def train_rng_batch(large, feat, b: int, rng):
    """4b's batch: b rows of seeded features and 128 labels, the last 16
    set to -100."""
    from kotoba_whisper_tpu_torch.models import whisper

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


def join_card0_group(rank: int, port: int):
    """One of two ranks sharing card 0: a gloo group that this script
    builds itself (NCCL refuses two ranks on one card; the drivers' rule,
    a card a rank over NCCL, is unchanged)."""
    from kotoba_whisper_tpu_torch.parallel import multihost

    torch.cuda.set_device(0)
    multihost.initialize(f"tcp://127.0.0.1:{port}", 2, rank, device="cuda:0", backend="gloo",
                         local_size=2)


def tp_options(prompt, quant: bool):
    """4i(b)'s GenerateOptions: prompt + NEW_TOKENS, w8a8 + TP_W8A8_TOKENS."""
    from kotoba_whisper_tpu_torch.decode.greedy import GenerateOptions

    return GenerateOptions(prompt_ids=prompt, max_length=len(prompt) + (
        TP_W8A8_TOKENS if quant else NEW_TOKENS))


def tp_rank(rank: int, port: int, out_dir: str) -> None:
    """Phase 4i(b), one rank of a model group of 2 on card 0: large-v3 at
    full width (seed 0, fused bf16, then fused + w8a8) split over the
    group, int8 KV, B=16, prompt + 48 tokens (w8a8: + TP_W8A8_TOKENS; eot
    disabled); the first-step logits; then 2 groups x 5 beams and a stream of 8 windows (W=4), 8
    tokens each, for K2's beam and ring forms at the shard's 10 heads, and
    B=16 x 8 tokens over the int4 cache for its prefix form there. Each
    timed run is the model's first (no warm-up): its wall is a record."""
    from kotoba_whisper_tpu_torch.core.config import PRESETS, FeatureConfig, SpecialTokens
    from kotoba_whisper_tpu_torch.core.mesh import MeshConfig, build_mesh
    from kotoba_whisper_tpu_torch.decode.beam import generate_beam
    from kotoba_whisper_tpu_torch.decode.greedy import (
        GenerateOptions, generate_greedy, transcribe_prompt,
    )
    from kotoba_whisper_tpu_torch.decode.streaming import StreamConfig, generate_greedy_streaming
    from kotoba_whisper_tpu_torch.models import whisper
    from kotoba_whisper_tpu_torch.models.optimized import fuse_for_inference
    from kotoba_whisper_tpu_torch.models.quantized import quantize_for_inference
    from kotoba_whisper_tpu_torch.ops import mel
    from kotoba_whisper_tpu_torch.parallel import multihost, sharded

    join_card0_group(rank, port)
    mesh = build_mesh(MeshConfig(data=1, model=2), "cuda")
    large = PRESETS["large-v3"]
    feat = FeatureConfig(n_mels=large.num_mel_bins)
    st = SpecialTokens.for_vocab(large.vocab_size)
    st_fixed = dataclasses.replace(st, eot=-1)
    prompt = transcribe_prompt(st, st.lang_begin + 7)
    short = GenerateOptions(prompt_ids=prompt, max_length=len(prompt) + 8)
    feats = mel.log_mel_spectrogram(torch.from_numpy(main_audio(feat)).cuda(), feat).to(
        torch.bfloat16)
    out, info = {}, {}

    def model(quant):
        m = fuse_for_inference(whisper.init_params(
            large, torch.Generator(device="cuda").manual_seed(0), device="cuda",
            dtype=torch.bfloat16))
        if quant:
            quantize_for_inference(m)  # the whole model's scales, then its shards
        return sharded.place_params(mesh, m, model_sharded=True)

    def timed(label, fn):
        torch.cuda.synchronize()
        reset_every()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        info[label] = {"wall_s": time.perf_counter() - t0, "launches": nonzero(every_count())}
        return r

    for label, quant in (("bf16", False), ("w8a8", True)):
        m = model(quant)
        o = tp_options(prompt, quant)
        out[f"{label}/tokens"] = timed(label, lambda: generate_greedy(
            m, feats, o, st_fixed, kv_dtype="int8")).cpu().numpy()
        out[f"{label}/logits"] = first_step_logits(m, feats, prompt, o.max_length
                                                   ).cpu().numpy()
        info[f"{label}/heads"] = whisper.rank_heads(m, large.decoder_attention_heads)
        if not quant:
            timed("beam", lambda: generate_beam(m, feats[:2], short, st_fixed, num_beams=5,
                                                kv_dtype="int8"))
            timed("stream", lambda: generate_greedy_streaming(
                m, feats[:8], short, st_fixed, kv_dtype="int8",
                stream=StreamConfig(batch=4, encode_batch=4, steps_per_round=8)))
            timed("int4", lambda: generate_greedy(m, feats, short, st_fixed, kv_dtype="int4"))
        del m
        torch.cuda.empty_cache()
    np.savez(os.path.join(out_dir, f"tp{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"tp{rank}.json"), "w") as f:
        json.dump(info, f)
    multihost.shutdown()


def dp_rank(rank: int, port: int, out_dir: str, pl_args: list) -> None:
    """Phase 4i(c), one of two data ranks on card 0: stage 2 through the
    driver's rank body (cli/pseudo_label._run, --num_devices 2: the batch's
    rows split in two blocks, the first rank gathering and writing), then
    one distillation step at 4b's shape: 4b's seeded teacher, student and
    global batch of 8, the rank's 4 rows, the global means and gradients."""
    from kotoba_whisper_tpu_torch.cli import pseudo_label
    from kotoba_whisper_tpu_torch.core.config import PRESETS, FeatureConfig
    from kotoba_whisper_tpu_torch.core.mesh import DATA_AXIS, MeshConfig, build_mesh
    from kotoba_whisper_tpu_torch.models import whisper
    from kotoba_whisper_tpu_torch.models.student_init import init_student_from_teacher
    from kotoba_whisper_tpu_torch.parallel import multihost, sharded
    from kotoba_whisper_tpu_torch.train import distill, optim

    join_card0_group(rank, port)
    info = {}
    reset_every()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        pseudo_label._run(pseudo_label._parser().parse_args(pl_args), torch.device("cuda", 0))
    info["pseudo_label"] = {"wall_s": time.perf_counter() - t0, "said": said.getvalue(),
                            "launches": nonzero(every_count())}
    large = PRESETS["large-v3"]
    feat = FeatureConfig(n_mels=large.num_mel_bins)
    mesh = build_mesh(MeshConfig(data=2, model=1), "cuda")
    teacher = whisper.init_params(large, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda", dtype=torch.float32)
    student, _ = init_student_from_teacher(teacher, large, decoder_layers=2)
    teacher = teacher.to(torch.bfloat16).requires_grad_(False)
    distill.freeze_encoder_(student)
    opt, sched = optim.make_optimizer(student, lr=1e-4, warmup_steps=500)
    state = distill.TrainState(student, opt)
    step = distill.make_train_step(distill.DistillConfig(), sched,
                                   data_group=mesh.get_group(DATA_AXIS))
    batch = train_rng_batch(large, feat, TRAIN_B, np.random.default_rng(0))
    rows = torch.from_numpy(sharded.rank_rows(TRAIN_B, *sharded.data_coords(mesh))).cuda()
    mine = {k: v[rows] for k, v in batch.items()}
    reset_every()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(state, teacher, mine)
    torch.cuda.synchronize()
    info["step"] = {"wall_s": time.perf_counter() - t0, "rows": rows.tolist(),
                    "launches": nonzero(every_count()),
                    "metrics": {k: float(v) for k, v in metrics.items()}}
    with open(os.path.join(out_dir, f"dp{rank}.json"), "w") as f:
        json.dump(info, f)
    multihost.shutdown()


def spawn_ranks(fn, *args) -> None:
    """Two ranks of fn(rank, *args), started together; an error in either
    fails the phase."""
    import torch.multiprocessing as mp

    mp.spawn(fn, args=args, nprocs=2, join=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="trace one main-path run, one fused + w8a8 run, one beam "
                    "stream, 4h's 10 s and 300 s serving calls, one stream-real run, "
                    "one beam search and one train step with torch.profiler and write "
                    "their whole kernel tables to DIR/profile_*.txt")
    args = ap.parse_args()

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the card only")
        return 2
    from kotoba_whisper_tpu_torch.cli import pseudo_label
    from kotoba_whisper_tpu_torch.core.config import PRESETS, FeatureConfig, SpecialTokens
    from kotoba_whisper_tpu_torch.data import reazon
    from kotoba_whisper_tpu_torch.data.collator import CollatorConfig, collate_audio
    from kotoba_whisper_tpu_torch.decode import beam as beam_loop
    from kotoba_whisper_tpu_torch.decode import greedy as greedy_loop
    from kotoba_whisper_tpu_torch.decode import streaming_beam as sb
    from kotoba_whisper_tpu_torch.decode.beam import generate_beam
    from kotoba_whisper_tpu_torch.decode.greedy import (
        GenerateOptions, generate_greedy, transcribe_prompt,
    )
    from kotoba_whisper_tpu_torch.decode.logits_rules import apply_rules
    from kotoba_whisper_tpu_torch.decode.longform import chunk_audio
    from kotoba_whisper_tpu_torch.decode.pipeline import AsrPipeline
    from kotoba_whisper_tpu_torch.decode.streaming import _pool as stream_pool
    from kotoba_whisper_tpu_torch.decode.streaming import _prompt_tokens as stream_prompt_tokens
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
    from kotoba_whisper_tpu_torch.eval import report
    from kotoba_whisper_tpu_torch.eval.speed import evaluate_speed, generate_dummy_audio
    from kotoba_whisper_tpu_torch.ops import mel
    from kotoba_whisper_tpu_torch.tokenizer.whisper_tokenizer import WhisperTokenizer
    from kotoba_whisper_tpu_torch.tools import enc_exp, stem_exp, step_time, vpu_cal
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
    bf16_rate, fp32_rate, mem_rate, int8_rate, tf32_rate = PEAKS[peak_name]
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
    # clock). K9's bare-exp loop reads how near the card comes to it (per
    # launch, and marginal: twice the iterations minus once); a diagnostic
    # only, never a bound. A marginal rate above 1.05x the data sheet's
    # means the loop skipped exponentials: that fails the run (phase 3's K9
    # records hold each row's sum of its row sums, which sees a skipped or
    # misplaced exponential that the softmax form's sum / l, ~1, does not).
    cal = vpu_cal.measure(op="exp", trials=3)
    exp_rate = cal["exp_per_s_peak"]
    log(f"[kernel] exp rate for the bounds: data sheet {exp_rate:.4g} exp/s (16/clock/SM at "
        f"the max SM clock); K9's ex2 loop reads {cal['exp_per_s']:.4g} per launch, "
        f"{cal['exp_per_s_marginal']:.4g} marginal "
        f"({cal['exp_per_s_marginal'] / cal['sms']:.4g} per SM) [{card}]")
    if cal["exp_per_s_marginal"] > 1.05 * exp_rate:
        raise AssertionError(f"K9's marginal exp rate {cal['exp_per_s_marginal']:.4g}/s is above "
                             f"1.05x the data sheet's {exp_rate:.4g}/s: it skipped work")
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
               rel_tol=REL_L2_TOL, control=None, **timings):
        """One kernel's record; `timings` add device_ms (the kernel in a
        replayed CUDA graph), library_device_ms (the library call the same
        way, or null where there is none), host_us and library_host_us (the
        host's time per call of each). `control`, where given, is the
        relative L2 of a twin with a key tile dropped, which must read at
        least F32_CONTROL_MIN."""
        launch_key[name] = key or name[:2]
        err, rel = errs
        ok = err <= tol and rel <= rel_tol and (control is None or control >= F32_CONTROL_MIN)
        if control is not None:
            timings = {"control_rel_l2": control, **timings}
        rec = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=None, max_abs_err=err, rel_l2=rel, ms=ms, plain_ms=plain_ms,
                   bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib_ms, **timings)
        log(f"[kernel] {name}: max_abs_err {err:.3e} (tol {tol:g}) rel_l2 {rel:.3e} "
            f"(tol {rel_tol:g}) "
            f"ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms {bnd[0]:.4f} "
            f"({bnd[1]})"
            f"{''.join(f' {k} {fmt(v)}' for k, v in timings.items())} [{card}] "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain twin")
        records.append(rec)

    # Each attention kernel also runs at a tensor-parallel shard's shapes:
    # a model group of 2 holds 10 of the 20 heads on each card, flat K/V of
    # 640 (phase 4i(b) launches them); those records count 4i(b)'s launches
    h_tp = h // 2
    tp_key = {h: "", h_tp: "tp"}

    def tp_tag(hh):
        return "" if hh == h else f", TP=2 shard"

    # K1: encoder self-attention (B, 1500, 20, 64) bf16, once per layer
    for hh in (h, h_tp):
        q, k, v = (randn(B, t_enc, hh, 64, seed=s) for s in (1, 2, 3))
        o, lse = fa.flash_attention_fwd(q, k, v)
        ro, rlse = fa.flash_attention_reference(q, k, v)
        errs = compare(o, ro)
        lse_err = float((lse - rlse).abs().max())
        del ro, rlse
        if lse_err > 1e-3:
            raise AssertionError(f"K1 LSE disagrees at H={hh}: {lse_err}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def k1_call():
            return fa.flash_attention_fwd(q, k, v)

        def k1_library():
            return F.scaled_dot_product_attention(qt, kt, vt)

        record(
            f"K1 flash_attention_fwd (B=16, T=1500, H={hh}, D=64, bf16{tp_tag(hh)})",
            "kotoba_whisper_tpu_torch/csrc/flash_attention_sm90.cu",
            "kotoba_whisper_tpu/ops/flash_attention.py:69", errs, 5e-3,
            time_ms(k1_call), time_ms(lambda: fa.flash_attention_reference(q, k, v)),
            time_ms(k1_library),
            bound(4.0 * B * hh * t_enc * t_enc * 64, bf16_rate,
                  nbytes(q, k, v, o, lse), mem_rate, exp_s=B * hh * t_enc * t_enc / exp_rate),
            key="K1" + tp_key[hh],
            device_ms=graph_ms(k1_call), library_device_ms=graph_ms(k1_library),
            host_us=host_us(k1_call), library_host_us=host_us(k1_library),
        )
        del q, k, v, o, lse, qt, kt, vt
        torch.cuda.empty_cache()

    # K2 in its K/V modes: bf16; int8 with fp32 per-row scales (kv_dtype
    # "int8"); and the int4 cache's (kv_dtype "int4", phase 4j): the cross
    # K/V int4 packed two a byte, the self K/V int8, each with bf16 scales
    # a (row, head). The library call takes the same K/V dequantized to bf16.
    def quantized(x, hh, mode):
        """(R, T, D) -> (stored K or V, scales or None) in K/V mode `mode`."""
        if mode == "bf16":
            return x, None
        if mode == "int8":
            return quantize_kv_rows(x)
        codes, scale = whisper.quantize_kv_heads(x, hh, 4 if mode == "int4" else 8)
        return (whisper.pack_int4(codes) if mode == "int4" else codes), scale

    def bf16_heads(x, scale, hh):
        """(R, T, *) stored K or V -> (R, H, T, 64) bf16."""
        r, t_x = x.shape[:2]
        return whisper._dequant(x, scale, torch.bfloat16).view(r, t_x, hh, 64).transpose(1, 2)

    mode_tag = {"bf16": "bf16", "int8": "int8", "int4": "int4, bf16 per-head scales",
                "int8h": "int8, bf16 per-head scales"}
    int4_key = {"bf16": "", "int8": "", "int4": "int4", "int8h": "int4"}  # the run of 4j

    # K2 prefix form: cross (T=1500) int8, bf16 and int4; K2's self form
    # (the ring kernel without ring_pos: phase 4's self cache, T=51): int8 in
    # both scale forms; at the shard's heads cross int8 and int4, self int8
    for hh, label, t, kv in ((h, "cross", t_enc, "int8"), (h, "cross", t_enc, "bf16"),
                             (h, "self", cap, "int8"), (h, "cross", t_enc, "int4"),
                             (h, "self", cap, "int8h"), (h_tp, "cross", t_enc, "int8"),
                             (h_tp, "self", cap, "int8"), (h_tp, "cross", t_enc, "int4")):
        dd = hh * 64
        qd = randn(B, hh, 64, seed=4)
        kf, ks = quantized(randn(B, t, dd, seed=5), hh, kv)
        vf, vs = quantized(randn(B, t, dd, seed=6), hh, kv)
        kw = dict(n_heads=hh, k_scale=ks, v_scale=vs)
        out = da.decode_attention(qd, kf, vf, t, **kw)
        errs = compare(out, da.decode_attention_reference(qd, kf, vf, t, **kw))
        kh, vh, qh = bf16_heads(kf, ks, hh), bf16_heads(vf, vs, hh), qd[:, :, None]

        def call():
            return da.decode_attention(qd, kf, vf, t, **kw)

        def library():
            return F.scaled_dot_product_attention(qh, kh, vh)

        is_self = label == "self"
        if da.self_form(t, kf.dtype) != is_self:
            raise AssertionError(f"K2 {label} call at T={t} would take the other form")
        record(
            f"K2 decode_attention {label} {mode_tag[kv]} (B=16, T={t}, D={dd}{tp_tag(hh)})",
            "kotoba_whisper_tpu_torch/csrc/decode_attention"
            f"{'_ring' if is_self else ''}.cu",
            "kotoba_whisper_tpu/ops/decode_attention.py:165", errs, 2e-3,
            time_ms(call), time_ms(lambda: da.decode_attention_reference(qd, kf, vf, t, **kw)),
            time_ms(library),
            bound(4.0 * B * t * dd, fp32_rate, nbytes(qd, kf, vf, ks, vs, out), mem_rate),
            key="K2" + ("self" if is_self else "") + int4_key[kv] + tp_key[hh],
            device_ms=graph_ms(call), library_device_ms=graph_ms(library),
            host_us=host_us(call), library_host_us=host_us(library),
        )
        del qd, kf, vf, ks, vs, out, kh, vh, qh

    # K2's cross call at 4e's window (48 rows over T=1500, int8): the row
    # kernel beside its plain twin and the library yardstick (SDPA over K/V
    # dequantized to bf16), which also stands beside the head kernel's bf16-q
    # probe (tools/kernel_time.py) at 16 and 48 rows; the launches are phase
    # 3's cross int8 record's (the same kernel)
    b_s = 48
    qd = randn(b_s, h, 64, seed=4)
    kf, ks = quantized(randn(b_s, t_enc, d, seed=5), h, "int8")
    vf, vs = quantized(randn(b_s, t_enc, d, seed=6), h, "int8")
    kw = dict(n_heads=h, k_scale=ks, v_scale=vs)
    errs = compare(da.decode_attention(qd, kf, vf, t_enc, **kw),
                   da.decode_attention_reference(qd, kf, vf, t_enc, **kw))
    kh, vh, qh = bf16_heads(kf, ks, h), bf16_heads(vf, vs, h), qd[:, :, None]

    def b48_call():
        return da.decode_attention(qd, kf, vf, t_enc, **kw)

    def b48_library():
        return F.scaled_dot_product_attention(qh, kh, vh)

    log(f"[kernel] K2 decode_attention cross int8 (B={b_s}, T={t_enc}, D={d}), 4e's window, "
        f"the row kernel: max_abs_err {errs[0]:.3e} rel_l2 {errs[1]:.3e} (tol 2e-3, "
        f"{REL_L2_TOL:g}) ms {time_ms(b48_call):.4f} plain_ms "
        f"{time_ms(lambda: da.decode_attention_reference(qd, kf, vf, t_enc, **kw)):.4f} "
        f"library_ms {time_ms(b48_library):.4f} device_ms {graph_ms(b48_call):.4f} "
        f"library_device_ms {graph_ms(b48_library):.4f} host_us {host_us(b48_call):.1f} "
        f"library_host_us {host_us(b48_library):.1f} [{card}]")
    if errs[0] > 2e-3 or errs[1] > REL_L2_TOL:
        raise AssertionError(f"K2 cross int8 at B={b_s} disagrees with its plain twin")
    del qd, kf, vf, ks, vs, kh, vh, qh

    # K2 ring form: a stream's self-attention at 4e's window (W=48 rows) and
    # 4g's (W=60, 12 groups x 5 beams), T=176 ring slots, per-row valid
    # lengths over [1, 176], a ring slot past which most rows wrap; int8 with
    # per-row scales, and with the int4 cache's per-head ones. Control: each
    # row rolled so that its ring becomes a prefix gives the prefix twin the
    # ring twin's output (both in fp32).
    t_s = 176
    for w_s, hh, kv in ((48, h, "int8"), (60, h, "int8"), (48, h_tp, "int8"), (48, h, "int8h")):
        dd = hh * 64
        qd = randn(w_s, hh, 64, seed=7)
        kf, ks = quantized(randn(w_s, t_s, dd, seed=8), hh, kv)
        vf, vs = quantized(randn(w_s, t_s, dd, seed=9), hh, kv)
        valid = torch.linspace(1, t_s, w_s, device="cuda").round().to(torch.int32)
        ring = torch.tensor(40, dtype=torch.int32, device="cuda")
        kw = dict(n_heads=hh, k_scale=ks, v_scale=vs)
        out = da.decode_attention(qd, kf, vf, valid, ring_pos=ring, **kw)
        ref = da.decode_attention_reference(qd, kf, vf, valid, ring_pos=ring, **kw)
        errs = compare(out, ref)
        flips = out != ref
        top = float(ref.float().abs()[flips].max()) if flips.any() else 0.0
        log(f"[kernel] K2 ring H={hh} {mode_tag[kv]}: {int(flips.sum())} of {out.numel()} bf16 "
            f"outputs differ from the twin's (fp32 sums in another order), the largest at "
            f"|twin| {top:.4f} (a bf16 ulp there: "
            f"{2.0 ** (math.floor(math.log2(top)) - 7) if top else 0.0:.2e})")
        slot = torch.remainder(
            ring + 1 - valid[:, None] + torch.arange(t_s, device="cuda")[None], t_s)  # (W, T)

        def rolled(x):
            return x.gather(1, slot[..., None].expand(-1, -1, x.shape[-1]))

        ring32 = da.decode_attention_reference(qd.float(), kf, vf, valid, ring_pos=ring, **kw)
        prefix32 = da.decode_attention_reference(qd.float(), rolled(kf), rolled(vf), valid,
                                                 n_heads=hh, k_scale=rolled(ks),
                                                 v_scale=rolled(vs))
        roll_err = float((ring32 - prefix32).abs().max())
        wrapped = int((valid > int(ring) + 1).sum())
        log(f"[kernel] K2 ring control: ring twin vs the prefix twin on rows rolled to a prefix, "
            f"fp32, max |diff| {roll_err:.3e} (tol 1e-5); {wrapped} of {w_s} rows wrap")
        if roll_err > 1e-5 or wrapped < w_s // 2:
            raise AssertionError("K2 ring twin disagrees with the rolled prefix twin")
        age = torch.remainder(ring - torch.arange(t_s, device="cuda"), t_s)
        mask = (age[None] < valid[:, None])[:, None, None, :]  # (W, 1, 1, T)
        kh, vh, qh = bf16_heads(kf, ks, hh), bf16_heads(vf, vs, hh), qd[:, :, None]

        def ring_call():
            return da.decode_attention(qd, kf, vf, valid, ring_pos=ring, **kw)

        def ring_library():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

        n_keys = int(valid.sum())
        # the grid the per-head form runs on
        plan = da.ring_plan(w_s, t_s, hh, kf.dtype,
                            torch.cuda.get_device_properties(0).multi_processor_count,
                            per_head=kv == "int8h")
        grid_tag = (f", ring kernel, {plan.heads} head(s) a CTA of {32 * da.RING_WARPS} threads, "
                    f"{plan.grid[0] * plan.grid[1]} CTAs, scale words by cp.async"
                    if kv == "int8h" else "")
        record(
            f"K2 decode_attention self ring {mode_tag[kv]} (W={w_s}, T={t_s}, D={dd}, ring_pos 40"
            f"{tp_tag(hh)}{grid_tag})",
            "kotoba_whisper_tpu_torch/csrc/decode_attention_ring.cu",
            "kotoba_whisper_tpu/ops/decode_attention.py:59", errs, 2e-3,
            time_ms(ring_call),
            time_ms(lambda: da.decode_attention_reference(qd, kf, vf, valid, ring_pos=ring, **kw)),
            time_ms(ring_library),
            # the bytes of the valid rows: their K and V and scales, q, out
            bound(4.0 * n_keys * dd, fp32_rate,
                  n_keys * 2 * (dd + ks[0, 0].numel() * ks.element_size())
                  + nbytes(qd, valid, out), mem_rate),
            key="K2ring" + int4_key[kv] + tp_key[hh],
            device_ms=graph_ms(ring_call), library_device_ms=graph_ms(ring_library),
            host_us=host_us(ring_call), library_host_us=host_us(ring_library),
        )
        del qd, kf, vf, ks, vs, out, ref, kh, vh, qh, mask, slot, ring32, prefix32

    # K2 beam form: beam search's cross-attention, 12 groups x 5 beams over
    # each group's one T=1500 row, int8, bf16 and int4
    g_b, k_b = 12, 5
    for hh, kv in ((h, "int8"), (h, "bf16"), (h_tp, "int8"), (h, "int4")):
        dd = hh * 64
        qb = randn(g_b, k_b, hh, 64, seed=10)
        kf, ks = quantized(randn(g_b, t_enc, dd, seed=11), hh, kv)
        vf, vs = quantized(randn(g_b, t_enc, dd, seed=12), hh, kv)
        kw = dict(n_heads=hh, k_scale=ks, v_scale=vs)
        out = da.decode_attention_beam(qb, kf, vf, **kw)
        errs = compare(out, da.decode_attention_reference_beam(qb, kf, vf, **kw))
        # the kernel and grid int4 runs on
        plan = da.beam_plan(g_b, t_enc, hh, k_b, kf.dtype,
                            torch.cuda.get_device_properties(0).multi_processor_count)
        grid_tag = (f", beam_int4_kernel (mma.sync, keys as M, {da.BEAM_INT4_BEAMS}-beam tiles, "
                    f"{da.BEAM_INT4_WARPS} consumer warps, {da.BEAM_INT4_CTAS_PER_SM} CTAs an SM), "
                    f"{plan.splits} key share(s), {plan.grid[0] * plan.grid[1] * g_b} CTAs"
                    if kv == "int4" else "")
        # (G, H, K, 64): the group's 5 queries a head
        kh, vh, qh = bf16_heads(kf, ks, hh), bf16_heads(vf, vs, hh), qb.transpose(1, 2)

        def beam_call():
            return da.decode_attention_beam(qb, kf, vf, **kw)

        def beam_library():
            return F.scaled_dot_product_attention(qh, kh, vh)

        record(
            f"K2 decode_attention cross beam {mode_tag[kv]} (G={g_b} x K={k_b}, T={t_enc}, "
            f"D={dd}{tp_tag(hh)}{grid_tag})",
            "kotoba_whisper_tpu_torch/csrc/decode_attention_beam.cu",
            "kotoba_whisper_tpu/ops/decode_attention.py:114", errs, 2e-3,
            time_ms(beam_call),
            time_ms(lambda: da.decode_attention_reference_beam(qb, kf, vf, **kw)),
            time_ms(beam_library),
            bound(4.0 * g_b * k_b * t_enc * dd, fp32_rate, nbytes(qb, kf, vf, ks, vs, out),
                  mem_rate),
            key="K2beam" + int4_key[kv] + tp_key[hh],
            device_ms=graph_ms(beam_call), library_device_ms=graph_ms(beam_library),
            host_us=host_us(beam_call), library_host_us=host_us(beam_library),
        )
        del qb, kf, vf, ks, vs, out, kh, vh, qh
    # beam counts the earlier kernel refused (it took at most 6): 12 x 8 and
    # 2 x 17 (two 16-beam tiles, keys split over a cluster), int8, held to
    # the fp32 twin
    for g_x, k_x in ((12, 8), (2, 17)):
        qb = randn(g_x, k_x, h, 64, seed=13)
        kf, ks = quantize_kv_rows(randn(g_x, t_enc, d, seed=14))
        vf, vs = quantize_kv_rows(randn(g_x, t_enc, d, seed=15))

        def beam_call():
            return da.decode_attention_beam(qb, kf, vf, n_heads=h, k_scale=ks, v_scale=vs)

        err, rel = compare(beam_call(), da.decode_attention_reference_beam(
            qb.float(), kf, vf, n_heads=h, k_scale=ks, v_scale=vs))
        ok = err <= 2e-3 and rel <= REL_L2_TOL
        plan = da.beam_plan(g_x, t_enc, h, k_x, torch.int8,
                            torch.cuda.get_device_properties(0).multi_processor_count)
        log(f"[kernel] K2 beam int8 G={g_x} x K={k_x}, T={t_enc} vs the fp32 twin: max_abs_err "
            f"{err:.3e} (tol 2e-3) rel_l2 {rel:.3e} (tol {REL_L2_TOL:g}); {plan}; "
            f"device_ms {graph_ms(beam_call):.4f} [{card}] {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2 beam form disagrees with its fp32 twin at {k_x} beams")
        del qb, kf, vf, ks, vs
    torch.cuda.empty_cache()

    # K3: fused log-mel, (B, 480000) fp32 and int16 -> (B, 3000, 128)
    feat = FeatureConfig(n_mels=large.num_mel_bins)
    audio_np = main_audio(feat)
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

    # K8: the int8 attention core at the encoder's shape, qk and qkpv; its
    # quantize pre-pass is part of its time (and the twin's quantizers of
    # the twin's), and is held to the twin quantizers bit for bit; the
    # pre-pass and the main kernel are also timed alone
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

        got = fa.int8_prepass(q, k, v, mode=mode)
        want = fa.int8_prepass_reference(k, v, pv8)
        for part, g, w in zip(("k8", "ks", "v8t", "vs"), got, want):
            if w is not None and not torch.equal(g, w):
                raise AssertionError(f"K8 {mode} pre-pass: {part} differs from the twin "
                                     "quantizers")
        log(f"[kernel] K8 {mode} pre-pass: {'k8, ks, v8t, vs' if pv8 else 'k8, ks'} equal "
            "the twin quantizers bit for bit")
        del got, want
        o, lse = k8_call()
        ro, rlse = twin()
        lse_err = float((lse - rlse).abs().max())
        if lse_err > 1e-3:
            raise AssertionError(f"K8 {mode} LSE disagrees: {lse_err}")
        _, _, scratch = fa._flash_int8_sm90(q, k, v, pv8)
        pairs = B * h * t_enc * t_enc
        # the call's inputs q, k, v (bf16) and outputs O and LSE
        record(
            f"K8 flash_attention_int8 {mode} (B={B}, T={t_enc}, H=20, D=64)",
            "kotoba_whisper_tpu_torch/csrc/flash_attention_int8.cu",
            "kotoba_whisper_tpu/ops/flash_attention.py:145", compare(o, ro), 5e-3,
            time_ms(k8_call), time_ms(twin), time_ms(k8_library),
            bound((4.0 if pv8 else 2.0) * pairs * 64, int8_rate, nbytes(q, k, v, o, lse),
                  mem_rate,
                  exp_s=pairs / exp_rate, more_s=0 if pv8 else 2.0 * pairs * 64 / bf16_rate),
            key=f"K8{mode}", device_ms=graph_ms(k8_call),
            prepass_device_ms=graph_ms(
                lambda: fa._flash_int8_sm90(q, k, v, pv8, phases=1, scratch=scratch)),
            main_device_ms=graph_ms(
                lambda: fa._flash_int8_sm90(q, k, v, pv8, phases=2, scratch=scratch)),
            library_device_ms=graph_ms(k8_library), host_us=host_us(k8_call),
            library_host_us=host_us(k8_library),
        )
        del o, lse, ro, rlse, scratch
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # The no-max forms (KWT_FA_NOMAX) and K1 under KWT_FA_EXP2. On random
    # inputs a no-max form and its max-based one agree to rounding, so each
    # no-max form is also held on fa.no_max_witness (B=2, T=1500, 20 heads):
    # odd rows >= 110 past their max (every p underflows: O = 0 in the twin
    # and, through the card's flush-to-zero ex2, in the kernel), even rows
    # at it, none in the 69-103 band where the card's ex2 and the twin's exp
    # part; the kernel within the record's bar of the no-max twin, the zero
    # rows equal, and the max-based twin >= 0.5 away from both, which a
    # kernel that ignored the switch would not be.
    witness_inputs = {}

    def witness_check(label, dtype, mode, rel_tol):
        if dtype not in witness_inputs:
            wq, wk, wv = (x.to("cuda", dtype) for x in fa.no_max_witness(2, t_enc, h, seed=7))
            slack = fa.no_max_slack(wq, wk)
            if not (float(slack[..., 1::2].min()) >= 110 and float(slack[..., 0::2].max()) <= 60):
                raise AssertionError(f"the no-max witness's rows are not in their classes: "
                                     f"odd min {float(slack[..., 1::2].min())}, even max "
                                     f"{float(slack[..., 0::2].max())}")
            witness_inputs[dtype] = (wq, wk, wv)
        wq, wk, wv = witness_inputs[dtype]
        got = fa.flash_attention_fwd(wq, wk, wv, int8_mode=mode, no_max=True)[0]
        twin = fa.flash_attention_fwd_reference(wq, wk, wv, int8_mode=mode, no_max=True)[0]
        max_twin = fa.flash_attention_fwd_reference(wq, wk, wv, int8_mode=mode, no_max=False)[0]
        zeros = (int((got[:, 1::2] == 0).all(-1).sum()), int((twin[:, 1::2] == 0).all(-1).sum()))
        n_odd = got[:, 1::2, :, 0].numel()
        rel_k = compare(got, twin)[1]
        apart = min(compare(max_twin, got)[1], compare(max_twin, twin)[1])
        ok = zeros == (n_odd, n_odd) and rel_k <= rel_tol and apart >= 0.5
        log(f"[kernel] {label} on the no-max witness: rel_l2 {rel_k:.3e} (tol {rel_tol:g}), zero "
            f"rows kernel {zeros[0]} / twin {zeros[1]} of {n_odd}, max-based twin {apart:.3f} "
            f"away (min 0.5) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: the no-max witness fails")
        return {"witness_rel_l2": rel_k, "witness_max_based_rel_l2": apart}

    # K1 no-max and K1 under exp2 at the encoder's shape, bf16; exp2 is K1's
    # own kernel (its ex2 after one FFMA is the exp2 branch's arithmetic),
    # held to the exp2 twin
    q, k, v = (randn(B, t_enc, h, 64, seed=s) for s in (75, 76, 77))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    for form, kw, key, line in (("no-max", dict(no_max=True), "K1nomax", 115),
                                ("exp2", dict(exp2=True), "K1exp2", 99)):
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        ro, rlse = fa.flash_attention_reference(q, k, v, **kw)
        lse_err = float((lse - rlse).abs().max())
        if lse_err > 1e-3:
            raise AssertionError(f"K1 {form} LSE disagrees: {lse_err}")

        def call():
            return fa.flash_attention_fwd(q, k, v, **kw)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt)

        record(
            f"K1 flash_attention_fwd {form} (B={B}, T={t_enc}, H={h}, D=64, bf16)",
            "kotoba_whisper_tpu_torch/csrc/flash_attention_sm90.cu",
            f"kotoba_whisper_tpu/ops/flash_attention.py:{line}", compare(o, ro), 5e-3,
            time_ms(call), time_ms(lambda: fa.flash_attention_reference(q, k, v, **kw)),
            time_ms(library),
            bound(4.0 * B * h * t_enc * t_enc * 64, bf16_rate, nbytes(q, k, v, o, lse), mem_rate,
                  exp_s=B * h * t_enc * t_enc / exp_rate),
            key=key, device_ms=graph_ms(call), library_device_ms=graph_ms(library),
            host_us=host_us(call), library_host_us=host_us(library),
            **(witness_check(f"K1 {form}", torch.bfloat16, "", REL_L2_TOL)
               if form == "no-max" else {}))
        del o, lse, ro, rlse
    del q, k, v, qt, kt, vt

    # K8 no-max, qk and qkpv, bf16: its pre-pass also writes each key's ks
    # ||k8|| and their max (held bit for bit to the twin), qkpv in one pass
    q, k, v = (randn(B, t_enc, h, 64, seed=s) for s in (78, 79, 80))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    for mode in ("qk", "qkpv"):
        pv8 = mode == "qkpv"
        got = fa.int8_prepass(q, k, v, mode=mode, no_max=True)
        want = fa.int8_prepass_reference(k, v, pv8, no_max=True)
        for part, g, w in zip(("k8", "ks", "v8t", "vs", "kn", "kmax"), got, want):
            if w is not None and not torch.equal(g, w):
                raise AssertionError(f"K8 {mode} no-max pre-pass: {part} differs from the twin")
        del got, want
        o, lse = fa.flash_attention_int8(q, k, v, mode=mode, no_max=True)
        ro, rlse = fa.flash_attention_fwd_reference(q, k, v, int8_mode=mode, no_max=True)
        if float((lse - rlse).abs().max()) > 1e-3:
            raise AssertionError(f"K8 {mode} no-max LSE disagrees")
        _, _, scratch = fa._flash_int8_sm90(q, k, v, pv8, no_max=True)
        pairs = B * h * t_enc * t_enc

        def call():
            return fa.flash_attention_int8(q, k, v, mode=mode, no_max=True)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt)

        record(
            f"K8 flash_attention_int8 {mode} no-max (B={B}, T={t_enc}, H={h}, D=64)",
            "kotoba_whisper_tpu_torch/csrc/flash_attention_int8.cu",
            "kotoba_whisper_tpu/ops/flash_attention.py:187", compare(o, ro), 5e-3,
            time_ms(call),
            time_ms(lambda: fa.flash_attention_fwd_reference(q, k, v, int8_mode=mode,
                                                             no_max=True)),
            time_ms(library),
            bound((4.0 if pv8 else 2.0) * pairs * 64, int8_rate, nbytes(q, k, v, o, lse),
                  mem_rate, exp_s=pairs / exp_rate,
                  more_s=0 if pv8 else 2.0 * pairs * 64 / bf16_rate),
            key=f"K8{mode}nomax", device_ms=graph_ms(call),
            prepass_device_ms=graph_ms(lambda: fa._flash_int8_sm90(
                q, k, v, pv8, phases=1, scratch=scratch, no_max=True)),
            main_device_ms=graph_ms(lambda: fa._flash_int8_sm90(
                q, k, v, pv8, phases=2, scratch=scratch, no_max=True)),
            library_device_ms=graph_ms(library), host_us=host_us(call),
            library_host_us=host_us(library),
            **witness_check(f"K8 {mode} no-max", torch.bfloat16, mode, REL_L2_TOL))
        del o, lse, ro, rlse, scratch
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # K9: the calibration loop at the JAX tool's block (512 x 1536 x 64),
    # held to its twin by 1e-4 of the largest sum, and each row's acc and
    # lsum (the sum of its row sums l, which a skipped exponential, a wrong
    # max or rebase moves) by rtol 1e-4; no single library call runs this
    # loop
    xc = torch.from_numpy(np.random.default_rng(0).standard_normal((512, 1536)).astype(
        np.float32)).cuda()
    n_exp = 512 * 1536 * 64
    for op in ("softmax", "exp"):
        def k9_call():
            return vpu_cal.vpu_cal(xc, 64, op)

        got, ref = k9_call(), vpu_cal.vpu_cal_reference(xc, 64, op)
        k9_rel = [float(((got[:, i] - ref[:, i]).abs() / ref[:, i].abs()).max()) for i in (0, 1)]
        log(f"[kernel] K9 {op}: max relative error acc {k9_rel[0]:.3e}, lsum {k9_rel[1]:.3e} "
            "(tol 1e-4); library_ms null (no single PyTorch call runs the calibration loop)")
        if not max(k9_rel) <= 1e-4:
            raise AssertionError(f"K9 {op} disagrees with its plain twin: relative errors "
                                 f"{k9_rel} (acc, lsum)")
        record(
            f"K9 vpu_cal {op} (512 x 1536 x 64, fp32; {vpu_cal.ROW_WARPS[op]} warps a row, "
            f"{vpu_cal.ROWS_PER_CTA} rows a CTA)",
            "kotoba_whisper_tpu_torch/csrc/vpu_cal.cu", "tools/vpu_cal.py:38",
            compare(got, ref), 1e-4 * float(ref.abs().max()),
            time_ms(k9_call), time_ms(lambda: vpu_cal.vpu_cal_reference(xc, 64, op)), None,
            bound(0.0, bf16_rate, nbytes(xc, got), mem_rate, exp_s=n_exp / exp_rate),
            key=f"K9{op}", device_ms=graph_ms(k9_call), library_device_ms=None,
            host_us=host_us(k9_call), library_host_us=None,
        )
    del xc

    # ---- 3 (fp32). the fp32 forms at the shapes of phase 4k's paths ----------
    # K1 and K4 (csrc/flash_attention_f32.cu) and K2's prefix, ring and beam
    # kernels on fp32 q (and fp32, int8 or int4 K/V), each held to its fp32
    # twin by relative L2 <= F32_REL_TOL and above its control (the twin
    # with the first 64-key tile dropped; in the ring each row's 64 oldest
    # keys); bounds: K1 and K4 their three TF32 products at the dense TF32
    # rate (and the exponentials), K2 its bytes; the library call SDPA on
    # the same fp32
    # tensors (K2's quantized K/V dequantized to fp32), the backend that ran
    # named by the kernel it launched.
    def sdpa_kernel_name(fn):
        """The CUDA kernel that takes most of the device time of 5 fn() calls."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        return max(kernels, key=lambda e: e.self_device_time_total).key[:96] if kernels else "?"

    def f32_heads(x, scale, hh):
        """(R, T, *) stored K or V -> (R, H, T, 64) fp32."""
        r, t_x = x.shape[:2]
        return whisper._dequant(x, scale, torch.float32).float().view(r, t_x, hh, 64).transpose(1, 2)

    def f32_record(name, source, replaces, got, ref, control_ref, call, plain, library, bnd,
                   key, **extra):
        err, rel_err = compare(got, ref)
        control = compare(control_ref, ref)[1]
        backend = sdpa_kernel_name(library)
        log(f"[kernel] {name}: library call ran {backend}")
        lib_dev, lib_by = library_device_ms(library)
        record(name, source, replaces, (err, rel_err), 1e-4 * float(ref.abs().max()),
               time_ms(call), time_ms(plain), time_ms(library), bnd, key=key,
               rel_tol=F32_REL_TOL, control=control, library_backend=backend,
               device_ms=graph_ms(call), library_device_ms=lib_dev, library_device_by=lib_by,
               host_us=host_us(call), library_host_us=host_us(library), **extra)

    f32 = torch.float32
    # K1 fp32: the encoder's self-attention (B=16, T=1500, 20 heads)
    q, k, v = (randn(B, t_enc, h, 64, seed=s, dtype=f32) for s in (40, 41, 42))
    o, lse = fa.flash_attention_fwd(q, k, v)
    ro, rlse = fa.flash_attention_reference(q, k, v)
    lse_err = float((lse - rlse).abs().max())
    if lse_err > 1e-5:
        raise AssertionError(f"K1 fp32 LSE disagrees: {lse_err}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def k1_f32_bound(pairs, *ts):
        """K1 and K4 fp32's bound: three TF32 products (3xTF32) of 4 * 64
        flops a (query, key) pair at the dense TF32 rate, the exponentials
        beside."""
        return bound(3 * 4.0 * pairs * 64, tf32_rate, nbytes(*ts), mem_rate,
                     exp_s=pairs / exp_rate)

    # the library call's own distance from the fp32 twin, beside its time
    lib_rel = compare(F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2), ro)[1]
    f32_record(
        f"K1 flash_attention_fwd fp32 (B={B}, T={t_enc}, H={h}, D=64)",
        "kotoba_whisper_tpu_torch/csrc/flash_attention_f32.cu",
        "kotoba_whisper_tpu/ops/flash_attention.py:69", o, ro,
        fa.flash_attention_reference(q, k[:, 64:], v[:, 64:])[0],
        lambda: fa.flash_attention_fwd(q, k, v), lambda: fa.flash_attention_reference(q, k, v),
        lambda: F.scaled_dot_product_attention(qt, kt, vt),
        k1_f32_bound(B * h * t_enc * t_enc, q, k, v, o, lse), "K1f32", library_rel_l2=lib_rel)
    del q, k, v, o, lse, ro, rlse, qt, kt, vt
    torch.cuda.empty_cache()
    # K4 fp32: the decoder's causal self-attention (B=8 x 128 labels), on
    # the causal 3xTF32 kernel
    q, k, v = (randn(TRAIN_B, LABELS, h, 64, seed=s, dtype=f32) for s in (43, 44, 45))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=True)
    if float((lse - rlse).abs().max()) > 1e-5:
        raise AssertionError("K4 fp32 LSE disagrees")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = LABELS * (LABELS + 1) // 2
    # control: rows 64.. without the first key tile (rows 0..63 see only it)
    cut = torch.cat([ro[:, :64], fa.flash_attention_reference(
        q[:, 64:], k[:, 64:], v[:, 64:], causal=True)[0]], 1)
    f32_record(
        f"K4 flash_attention_fwd causal fp32 (B={TRAIN_B}, T={LABELS}, H={h}, D=64; "
        "3xTF32 wgmma, a warpgroup a 64-row CTA)",
        "kotoba_whisper_tpu_torch/csrc/flash_attention_f32.cu",
        "kotoba_whisper_tpu/ops/flash_attention.py:222", o, ro, cut,
        lambda: fa.flash_attention_fwd(q, k, v, causal=True),
        lambda: fa.flash_attention_reference(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        k1_f32_bound(TRAIN_B * h * pairs, q, k, v, o, lse), "K4f32")
    del q, k, v, o, lse, ro, rlse, qt, kt, vt, cut

    def f32_kv(x, hh, mode):
        """(R, T, D) fp32 -> (stored K or V, scales or None) in K/V mode `mode`."""
        return (x, None) if mode == "fp32" else quantized(x, hh, mode)

    # K2 prefix form, fp32 q: cross (T=1500) with fp32 K/V (compute KV: the
    # row kernel), with int8 K/V and with packed int4 K/V (the head kernel);
    # K2's self form (its ring kernel's fp32 form without ring_pos): self
    # (T=51) fp32
    for label, t, kv, key in (("cross", t_enc, "fp32", "K2f32"), ("cross", t_enc, "int8",
                                                                   "K2f32int8"),
                              ("cross", t_enc, "int4", "K2f32int4"),
                              ("self", cap, "fp32", "K2selff32")):
        qd = randn(B, h, 64, seed=46, dtype=f32)
        kf, ks = f32_kv(randn(B, t, d, seed=47, dtype=f32), h, kv)
        vf, vs = f32_kv(randn(B, t, d, seed=48, dtype=f32), h, kv)
        kw = dict(n_heads=h, k_scale=ks, v_scale=vs)
        out = da.decode_attention(qd, kf, vf, t, **kw)
        ref = da.decode_attention_reference(qd, kf, vf, t, **kw)
        cut = da.decode_attention_reference(
            qd, kf[:, 64:], vf[:, 64:], t - 64, n_heads=h,
            k_scale=None if ks is None else ks[:, 64:], v_scale=None if vs is None else vs[:, 64:])
        kh, vh, qh = f32_heads(kf, ks, h), f32_heads(vf, vs, h), qd[:, :, None]
        kernel = ("ring kernel, self form" if label == "self" else
                  "row kernel" if kv == "fp32" else "head kernel")
        f32_record(
            f"K2 decode_attention {label} fp32 q, {kv} K/V, {kernel} (B={B}, T={t}, D={d})",
            "kotoba_whisper_tpu_torch/csrc/decode_attention"
            f"{'_ring' if label == 'self' else ''}.cu",
            "kotoba_whisper_tpu/ops/decode_attention.py:165", out, ref, cut,
            lambda: da.decode_attention(qd, kf, vf, t, **kw),
            lambda: da.decode_attention_reference(qd, kf, vf, t, **kw),
            lambda: F.scaled_dot_product_attention(qh, kh, vh),
            bound(4.0 * B * t * d, fp32_rate, nbytes(qd, kf, vf, ks, vs, out), mem_rate), key)
        del qd, kf, vf, ks, vs, out, ref, cut, kh, vh, qh

    # K2 ring form, fp32: the stream's window (W=48, T=176, one box a row)
    # and the decoder's most positions (T=448, boxes of 192 slots), fp32 K/V,
    # per-row valid lengths over [1, T], most rows wrapped past slot T - 1
    for t_r, ring_at in ((176, 40), (448, 300)):
        w_r = 48
        qd = randn(w_r, h, 64, seed=49, dtype=f32)
        kf, vf = randn(w_r, t_r, d, seed=50, dtype=f32), randn(w_r, t_r, d, seed=51, dtype=f32)
        valid = torch.linspace(1, t_r, w_r, device="cuda").round().to(torch.int32)
        ring = torch.tensor(ring_at, dtype=torch.int32, device="cuda")
        kw = dict(n_heads=h, ring_pos=ring)
        out = da.decode_attention(qd, kf, vf, valid, **kw)
        ref = da.decode_attention_reference(qd, kf, vf, valid, **kw)
        cut = da.decode_attention_reference(qd, kf, vf, torch.clamp(valid - 64, min=1), **kw)
        age = torch.remainder(ring - torch.arange(t_r, device="cuda"), t_r)
        mask = (age[None] < valid[:, None])[:, None, None, :]
        kh, vh, qh = f32_heads(kf, None, h), f32_heads(vf, None, h), qd[:, :, None]
        n_keys = int(valid.sum())
        plan = da.ring_plan(w_r, t_r, h, f32)
        log(f"[kernel] K2 ring fp32 T={t_r}: {plan}")
        f32_record(
            f"K2 decode_attention self ring fp32 (W={w_r}, T={t_r}, D={d}, ring_pos {ring_at}, "
            f"boxes of {plan.chunk})",
            "kotoba_whisper_tpu_torch/csrc/decode_attention_ring.cu",
            "kotoba_whisper_tpu/ops/decode_attention.py:59", out, ref, cut,
            lambda: da.decode_attention(qd, kf, vf, valid, **kw),
            lambda: da.decode_attention_reference(qd, kf, vf, valid, **kw),
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
            bound(4.0 * n_keys * d, fp32_rate, n_keys * 2 * d * 4 + nbytes(qd, valid, out),
                  mem_rate), "K2ringf32")
        del qd, kf, vf, out, ref, cut, kh, vh, qh, mask

    # K2 beam form, fp32 (FFMA): 12 groups x 5 beams over T=1500, fp32 K/V
    # (compute KV) and packed int4 with bf16 per-head scales
    for kv, key in (("fp32", "K2beamf32"), ("int4", "K2beamf32int4")):
        qb = randn(g_b, k_b, h, 64, seed=52, dtype=f32)
        kf, ks = f32_kv(randn(g_b, t_enc, d, seed=53, dtype=f32), h, kv)
        vf, vs = f32_kv(randn(g_b, t_enc, d, seed=54, dtype=f32), h, kv)
        kw = dict(n_heads=h, k_scale=ks, v_scale=vs)
        out = da.decode_attention_beam(qb, kf, vf, **kw)
        ref = da.decode_attention_reference_beam(qb, kf, vf, **kw)
        cut = da.decode_attention_reference_beam(
            qb, kf[:, 64:], vf[:, 64:], n_heads=h,
            k_scale=None if ks is None else ks[:, 64:], v_scale=None if vs is None else vs[:, 64:])
        kh, vh, qh = f32_heads(kf, ks, h), f32_heads(vf, vs, h), qb.transpose(1, 2)
        f32_record(
            f"K2 decode_attention cross beam fp32 q, {mode_tag.get(kv, kv)} K/V (G={g_b} x "
            f"K={k_b}, T={t_enc}, D={d})",
            "kotoba_whisper_tpu_torch/csrc/decode_attention_beam.cu",
            "kotoba_whisper_tpu/ops/decode_attention.py:114", out, ref, cut,
            lambda: da.decode_attention_beam(qb, kf, vf, **kw),
            lambda: da.decode_attention_reference_beam(qb, kf, vf, **kw),
            lambda: F.scaled_dot_product_attention(qh, kh, vh),
            bound(4.0 * g_b * k_b * t_enc * d, fp32_rate, nbytes(qb, kf, vf, ks, vs, out),
                  mem_rate), key)
        del qb, kf, vf, ks, vs, out, ref, cut, kh, vh, qh
    del kw

    def flat(*ts):
        return torch.cat([t.flatten() for t in ts])

    # K5 fp32 (csrc/flash_attention_bwd_f32.cu): the student decoder's causal
    # self-attention (B=8 x 128, the cluster form) and its cross-attention
    # (128 x 1500, the split form's 3xTF32 wgmma kernels) on the
    # fp32 K4 / K1 forward's O and LSE; dQ, dK and dV together against the
    # twin; control: the twin with the first 64 keys dropped (their dK and
    # dV rows zero); the library call autograd through SDPA on fp32 tensors
    for label, tk, causal in (("causal", LABELS, True), ("cross", t_enc, False)):
        q = randn(TRAIN_B, LABELS, h, 64, seed=55, dtype=f32)
        k, v = (randn(TRAIN_B, tk, h, 64, seed=s, dtype=f32) for s in (56, 57))
        do = randn(TRAIN_B, LABELS, h, 64, seed=58, dtype=f32)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal)
        cut_q, cut_k, cut_v = fa.flash_attention_bwd_reference(q, k[:, 64:], v[:, 64:], o, lse,
                                                               do, causal=causal)
        pad = torch.zeros_like(k[:, :64])
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            log(f"[kernel] K5 fp32 {label} {name}: rel_l2 {compare(g, r)[1]:.3e}")
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        do_t = do.transpose(1, 2)
        n_pairs = LABELS * (LABELS + 1) // 2 if causal else LABELS * tk
        f32_record(
            f"K5 flash_attention_bwd {label} fp32 (B={TRAIN_B}, Tq={LABELS}, Tk={tk}, H={h}, "
            "D=64; dQ, dK, dV)",
            "kotoba_whisper_tpu_torch/csrc/flash_attention_bwd_f32.cu",
            "kotoba_whisper_tpu/ops/flash_attention.py:315", flat(*got), flat(*ref),
            flat(cut_q, torch.cat([pad, cut_k], 1), torch.cat([pad, cut_v], 1)),
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal),
            lambda: fa.flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal),
            lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), do_t, retain_graph=True),
            # S, dP, dV, dQ, dK: five products over the kept pairs, each three
            # TF32 products (3xTF32) at the dense TF32 rate, one exp each
            bound(3 * 10.0 * TRAIN_B * h * n_pairs * 64, tf32_rate,
                  nbytes(q, k, v, o, lse, do, *got), mem_rate,
                  exp_s=TRAIN_B * h * n_pairs / exp_rate), "K5f32")
        del q, k, v, do, o, lse, got, ref, cut_q, cut_k, cut_v, pad, qt, kt, vt, sdpa_out, do_t

    # K8 fp32 q (the fp32-q kernel of csrc/flash_attention_int8.cu: s8 wgmma
    # scores; qk's P V in 3xTF32 wgmma, qkpv's on s8) at the encoder's shape,
    # qk and qkpv: its pre-pass bit for bit against the twin quantizers, O
    # against the twin on their codes; control: the twin with the first 64
    # keys dropped. The bound: qk's S at the int8 rate and its P V as three
    # TF32 products; qkpv's exponentials. The first design's FFMA bound for
    # qk's P V is logged beside it, not used.
    q, k, v = (randn(B, t_enc, h, 64, seed=s, dtype=f32) for s in (59, 60, 61))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = B * h * t_enc * t_enc

    def k8_f32_bound(pv8, *ts):
        return bound((4.0 if pv8 else 2.0) * pairs * 64, int8_rate, nbytes(*ts), mem_rate,
                     exp_s=pairs / exp_rate,
                     more_s=0 if pv8 else 3 * 2.0 * pairs * 64 / tf32_rate)

    def k8_f32_phases(mode, **kw):
        """K8 fp32's pre-pass and main kernel apart, device ms each."""
        pv8 = mode == "qkpv"
        _, _, scratch = fa._flash_int8_sm90(q, k, v, pv8, **kw)
        return dict(prepass_device_ms=graph_ms(
                        lambda: fa._flash_int8_sm90(q, k, v, pv8, phases=1, scratch=scratch, **kw)),
                    main_device_ms=graph_ms(
                        lambda: fa._flash_int8_sm90(q, k, v, pv8, phases=2, scratch=scratch, **kw)))

    log(f"[kernel] K8 fp32 qk: the first design's FFMA bound for its P V was "
        f"{2.0 * pairs * 64 / fp32_rate * 1e3:.4f} ms (S at the int8 rate beside it); the "
        f"3xTF32 bound is {3 * 2.0 * pairs * 64 / tf32_rate * 1e3:.4f} ms [{card}]")
    for mode in ("qk", "qkpv"):
        pv8 = mode == "qkpv"

        def twin(kk=k, vv=v):
            k8, ks = fa.quantize_k_rows(kk)
            v_in, vs = fa.quantize_v_cols(vv) if pv8 else (vv, None)
            return fa.flash_attention_int8_reference(q, k8, ks, v_in, vs, pv8)

        got = fa.int8_prepass(q, k, v, mode=mode)
        want = fa.int8_prepass_reference(k, v, pv8)
        for part, g, w in zip(("k8", "ks", "v8t", "vs"), got, want):
            if w is not None and not torch.equal(g, w):
                raise AssertionError(f"K8 fp32 {mode} pre-pass: {part} differs from the twin "
                                     "quantizers")
        log(f"[kernel] K8 fp32 {mode} pre-pass: {'k8, ks, v8t, vs' if pv8 else 'k8, ks'} equal "
            "the twin quantizers bit for bit")
        del got, want
        o, lse = fa.flash_attention_int8(q, k, v, mode=mode)
        ro, rlse = twin()
        if float((lse - rlse).abs().max()) > 1e-5:
            raise AssertionError(f"K8 fp32 {mode} LSE disagrees")
        f32_record(
            f"K8 flash_attention_int8 {mode} fp32 q (B={B}, T={t_enc}, H={h}, D=64)",
            "kotoba_whisper_tpu_torch/csrc/flash_attention_int8.cu",
            "kotoba_whisper_tpu/ops/flash_attention.py:145", o, ro,
            twin(k[:, 64:], v[:, 64:])[0],
            lambda: fa.flash_attention_int8(q, k, v, mode=mode), twin,
            lambda: F.scaled_dot_product_attention(qt, kt, vt),
            k8_f32_bound(pv8, q, k, v, o, lse), f"K8{mode}f32", **k8_f32_phases(mode))
        del o, lse, ro, rlse
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()

    # The fp32 no-max forms (K1, K8 qk and qkpv) and K1 fp32 under exp2 (its
    # own kernel, held to the exp2 twin), at the encoder's shape, each held
    # to its fp32 twin above the dropped-tile control, the no-max forms also
    # on the witness
    q, k, v = (randn(B, t_enc, h, 64, seed=s, dtype=f32) for s in (81, 82, 83))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    pairs = B * h * t_enc * t_enc
    for form, mode, kw, key, line in (
            ("no-max", "", dict(no_max=True), "K1f32nomax", 115),
            ("exp2", "", dict(exp2=True), "K1f32exp2", 99),
            ("qk no-max", "qk", dict(no_max=True), "K8qkf32nomax", 187),
            ("qkpv no-max", "qkpv", dict(no_max=True), "K8qkpvf32nomax", 187)):

        def twin(kk=k, vv=v, mode=mode, kw=kw):
            return fa.flash_attention_fwd_reference(q, kk, vv, int8_mode=mode, **kw)

        def call(mode=mode, kw=kw):
            return fa.flash_attention_fwd(q, k, v, int8_mode=mode, **kw)

        o, lse = call()
        ro, rlse = twin()
        if float((lse - rlse).abs().max()) > 1e-5 * max(1.0, float(rlse.abs().max())):
            raise AssertionError(f"fp32 {form} LSE disagrees")
        phases = {}
        if mode:
            name = f"K8 flash_attention_int8 {form} fp32 q (B={B}, T={t_enc}, H={h}, D=64)"
            source = "kotoba_whisper_tpu_torch/csrc/flash_attention_int8.cu"
            bnd = k8_f32_bound(mode == "qkpv", q, k, v, o, lse)
            phases = k8_f32_phases(mode, no_max=True)
        else:
            name = f"K1 flash_attention_fwd {form} fp32 (B={B}, T={t_enc}, H={h}, D=64)"
            source = "kotoba_whisper_tpu_torch/csrc/flash_attention_f32.cu"
            bnd = k1_f32_bound(pairs, q, k, v, o, lse)
        f32_record(
            name, source, f"kotoba_whisper_tpu/ops/flash_attention.py:{line}", o, ro,
            twin(k[:, 64:], v[:, 64:])[0], call, twin,
            lambda: F.scaled_dot_product_attention(qt, kt, vt), bnd, key, **phases,
            **(witness_check(f"{name.split(' (')[0]}", f32, mode, F32_REL_TOL)
               if "no-max" in form else {}))
        del o, lse, ro, rlse
    del q, k, v, qt, kt, vt
    witness_inputs.clear()
    torch.cuda.empty_cache()

    # K6 fp32 rows (csrc/layer_norm.cu) over the encoder's (B*1500, 1280),
    # fp32 weights: LayerNorm and the fused add (its sum bit for bit);
    # control: the twin with one 64-column chunk of each row not written
    rows = B * t_enc
    x = randn(rows, d, seed=62, dtype=f32) * 3 + 1
    y = randn(rows, d, seed=63, dtype=f32)
    w = 1 + 0.1 * randn(d, seed=64, dtype=f32)
    bb = 0.1 * randn(d, seed=65, dtype=f32)

    def unwritten(t):
        return torch.cat([torch.zeros_like(t[:, :64]), t[:, 64:]], 1)

    ref = ln.layer_norm_reference(x, w, bb)
    f32_record(
        f"K6 layer_norm ({rows}, {d}) fp32", "kotoba_whisper_tpu_torch/csrc/layer_norm.cu",
        "kotoba_whisper_tpu/ops/layer_norm.py:45", ln.layer_norm(x, w, bb), ref, unwritten(ref),
        lambda: ln.layer_norm(x, w, bb), lambda: ln.layer_norm_reference(x, w, bb),
        lambda: F.layer_norm(x, (d,), w, bb),
        bound(10.0 * rows * d, fp32_rate, nbytes(x, w, bb, ref), mem_rate), "K6lnf32")
    summed, got = ln.add_layer_norm(x, y, w, bb)
    ref_sum, ref = ln.add_layer_norm_reference(x, y, w, bb)
    if not (torch.equal(summed, x + y) and torch.equal(summed, ref_sum)):
        raise AssertionError("K6 add_layer_norm fp32: the sum differs from x + y")
    f32_record(
        f"K6 add_layer_norm ({rows}, {d}) fp32", "kotoba_whisper_tpu_torch/csrc/layer_norm.cu",
        "kotoba_whisper_tpu/ops/layer_norm.py:52", got, ref, unwritten(ref),
        lambda: ln.add_layer_norm(x, y, w, bb), lambda: ln.add_layer_norm_reference(x, y, w, bb),
        lambda: F.layer_norm(x + y, (d,), w, bb),
        bound(11.0 * rows * d, fp32_rate, nbytes(x, y, w, bb, summed, got), mem_rate),
        "K6addf32")
    del x, y, w, bb, got, ref, summed, ref_sum

    # K7 fp32 (csrc/conv_stem_f32.cu, 3xTF32 wgmma), (16, 128, 3000) -> (16, 1500, 1280);
    # control: the twin with conv1's first tap skipped; the library call
    # cuDNN conv + GELU twice, TF32 off (phase 1 turned it off)
    n_mels = large.num_mel_bins
    conv1 = torch.nn.Conv1d(n_mels, d, 3, padding=1, device="cuda")
    conv2 = torch.nn.Conv1d(d, d, 3, stride=2, padding=1, device="cuda")
    with torch.no_grad():
        for i, c in enumerate((conv1, conv2)):
            c.weight.copy_(randn(*c.weight.shape, seed=66 + i, dtype=f32) * 0.02)
            c.bias.copy_(randn(d, seed=68 + i, dtype=f32) * 0.1)
        xs = randn(B, n_mels, 2 * t_enc, seed=70, dtype=f32)
        w1_cut = conv1.weight.clone()
        w1_cut[:, :, 0] = 0

        def cudnn_stem32():
            hh = F.gelu(F.conv1d(xs, conv1.weight, conv1.bias, padding=1))
            return F.gelu(F.conv1d(hh, conv2.weight, conv2.bias, stride=2, padding=1))

        stem_flops = 2.0 * B * 2 * t_enc * 3 * n_mels * d + 2.0 * B * t_enc * 3 * d * d
        f32_record(
            f"K7 conv_stem (B={B}, {n_mels} x {2 * t_enc} -> {t_enc} x {d}, fp32)",
            "kotoba_whisper_tpu_torch/csrc/conv_stem_f32.cu",
            "kotoba_whisper_tpu/ops/conv_stem.py:60", cs.conv_stem(conv1, conv2, xs),
            cs.conv_stem_reference(conv1.weight, conv1.bias, conv2.weight, conv2.bias, xs),
            cs.conv_stem_reference(w1_cut, conv1.bias, conv2.weight, conv2.bias, xs),
            lambda: cs.conv_stem(conv1, conv2, xs),
            lambda: cs.conv_stem_reference(conv1.weight, conv1.bias, conv2.weight, conv2.bias,
                                           xs),
            cudnn_stem32,
            # each product three TF32 products (3xTF32) at the dense TF32 rate
            bound(3 * stem_flops, tf32_rate, nbytes(xs, conv1.weight, conv1.bias, conv2.weight,
                                                    conv2.bias) + B * t_enc * d * 4, mem_rate),
            "K7f32")
    del conv1, conv2, xs, w1_cut
    log(f"[kernel] after the fp32 records: {card_memory()}")

    # ---- 4. main path -----------------------------------------------------
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
    # K2: the cross call on the prefix form's clusters, the self call on the self form
    expect = {"K1": large.encoder_layers, "K2": large.decoder_layers * NEW_TOKENS,
              "K2self": large.decoder_layers * NEW_TOKENS, "K3": 1}
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
        saved = (whisper.flash_attention, whisper.decode_attention,
                 whisper.decode_attention_beam, mel.log_mel_frames)
        whisper.flash_attention = (  # the twin of the form the switches select
            lambda q, k, v, causal=False: fa.flash_attention_fwd_reference(
                q, k, v, causal=causal)[0])
        whisper.decode_attention = da.decode_attention_reference
        whisper.decode_attention_beam = da.decode_attention_reference_beam
        mel.log_mel_frames = mel.log_mel_frames_reference
        try:
            yield
        finally:
            (whisper.flash_attention, whisper.decode_attention, whisper.decode_attention_beam,
             mel.log_mel_frames) = saved

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

    def switch_variants(encode, feats):
        """The encoder under the JAX package's switches: KWT_FA_NOMAX (K1's
        no-max form), KWT_FA_EXP2 (K1 as it is), and KWT_FA_NOMAX with
        KWT_FA_INT8=qk and qkpv (K8's no-max forms); their launches and C
        entries (a layer's attention one each)."""
        n = large.encoder_layers
        return (("KWT_FA_NOMAX=1", {"KWT_FA_NOMAX": "1"}, lambda: encode(feats),
                 {"K1": n, "K1nomax": n}),
                ("KWT_FA_EXP2=1", {"KWT_FA_EXP2": "1"}, lambda: encode(feats), {"K1": n}),
                ("KWT_FA_NOMAX=1 KWT_FA_INT8=qk", {"KWT_FA_NOMAX": "1", "KWT_FA_INT8": "qk"},
                 lambda: encode(feats), {"K8": n, "K8nomax": n}),
                ("KWT_FA_NOMAX=1 KWT_FA_INT8=qkpv", {"KWT_FA_NOMAX": "1", "KWT_FA_INT8": "qkpv"},
                 lambda: encode(feats), {"K8": n, "K8nomax": n}))

    def encoder_variants(phase, m, feats, variants, tol):
        """Each variant: a warm-up, one timed run (its launches and C
        entries), its rel-L2 against the first (default) variant, held to
        `tol` (the int8 forms, which round every score of 32 layers, to 0.1);
        the switch variants' rel-L2 is a reading (the no-max forms may zero
        rows the default keeps, JAX's fault), and at B=2 their kernel path
        is held to their plain path (the switches' twins) by the same bars.
        -> launches by variant."""
        found, default = {}, None
        for label, env, fn, expect_n in variants:
            os.environ.update(env)
            try:
                fn()  # warm-up
                reset_every()
                with counting_entries() as entries:
                    out, ms = timed(fn)
                counts = nonzero(every_count())
                switch = "KWT_FA_NOMAX" in env or "KWT_FA_EXP2" in env
                if switch:
                    with torch.inference_mode():
                        enc_k = whisper.encode(m, feats[:2])
                        with plain_path():
                            enc_p = whisper.encode(m, feats[:2])
                    vs_plain = rel(enc_k, enc_p)
            finally:
                for key in env:
                    os.environ.pop(key)
            found[label] = counts
            out = out.float()
            if default is None:
                default = out
            drift = rel(out, default)
            bar = 0.1 if "INT8" in label else tol
            log(f"[{phase}] encoder {label}: {ms:.2f} ms, rel-L2 vs default {drift:.3e}"
                f"{' (a reading)' if switch else ''}, launches {counts}, C entries {entries}"
                + (f"; B=2 kernel vs plain path rel-L2 {vs_plain:.3e} (tol {bar:g})"
                   if switch else "") + f" [{card}]")
            # the no-max forms through their own C entries only
            entries_ok = not env.get("KWT_FA_NOMAX") or (
                all(e.endswith("_nomax") for e in entries)
                and sum(entries.values()) == large.encoder_layers)
            if counts != expect_n or not entries_ok or not bool(torch.isfinite(out).all()) or (
                    vs_plain > bar if switch else drift > bar):
                raise AssertionError(f"{phase} {label}: launches {counts} (expected {expect_n}), "
                                     f"rel-L2 {vs_plain if switch else drift}")
        return found

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

    # ---- 4g. beam-stream-w8a8: continuous-batching beam search -------------
    # bench.py's run_stream_beam on the fused + w8a8 model: 96 windows of
    # seeded noise, 12 groups x 5 beams (W=60), refills of 6, 8 steps a
    # round, ring layout, int8 KV, capacity 176, bench.py's budgets, eot
    # live; log-mel in batches of 16 inside the timed window; a warm-up on
    # 24 windows, then the best of 2 trials. Refills and steps are timed by
    # wrapping the module's own _refill and _steps (device-synchronised),
    # the steps counted by its apply_rules calls (one a step).
    audio_g, prompt_g, stops_g, opts_g = step_time.beam_stream_workload(st, feat)
    n_g, p_g, bcfg = audio_g.shape[0], len(prompt_g), step_time.BEAM_STREAM
    phase = {"refill_s": 0.0, "steps_s": 0.0, "refills": 0, "steps": 0}

    def timed_phase(fn, key):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(*a, **kw)
            torch.cuda.synchronize()
            phase[f"{key}_s"] += time.perf_counter() - t
            if key == "refill":
                phase["refills"] += 1
        return run

    def counted_rules(*a, **kw):
        phase["steps"] += 1
        return apply_rules(*a, **kw)

    sb_saved = (sb._refill, sb._steps, sb.apply_rules)
    sb._refill, sb._steps = timed_phase(sb._refill, "refill"), timed_phase(sb._steps, "steps")
    sb.apply_rules = counted_rules
    try:
        def beam_stream_run(n_run):
            return step_time.run_beam_stream(qmodel, audio_g[:n_run], opts_g, st, stops_g, feat)

        beam_stream_run(2 * bcfg.groups)  # warm-up on a prefix of the stream
        g_trials = []
        for _ in range(2):
            torch.cuda.synchronize()
            reset_every()
            phase.update(refill_s=0.0, steps_s=0.0, refills=0, steps=0)
            t0 = time.perf_counter()
            toks_g, scores_g = beam_stream_run(n_g)
            g_trials.append((time.perf_counter() - t0, dict(phase), nonzero(every_count())))
    finally:
        sb._refill, sb._steps, sb.apply_rules = sb_saved
    if args.profile:  # the warm-up's prefix, unwrapped: a trace of the whole
        # stream holds ~1.5 M events, which torch.profiler takes many minutes to table
        profile_run(lambda: beam_stream_run(2 * bcfg.groups), "profile_beam_stream.txt",
                    f"beam-stream-w8a8, first {2 * bcfg.groups} windows")
    wall_g, phase_g, g_counts = min(g_trials, key=lambda tr: tr[0])
    steps_g, refills_g = phase_g["steps"], phase_g["refills"]
    log(f"[4g] beam-stream-w8a8: {n_g} windows, {bcfg.groups} groups x {bcfg.num_beams} beams, "
        f"E={bcfg.encode_batch}, budgets mean {stops_g.mean():.2f} max {stops_g.max()}: best of "
        f"{len(g_trials)} trials wall {wall_g:.3f} s ({', '.join(f'{t[0]:.3f}' for t in g_trials)}"
        f"), {n_g * feat.chunk_length_s / wall_g:.1f} audio-s/s [{card}]; refills "
        f"{refills_g} in {phase_g['refill_s']:.3f} s ({phase_g['refill_s'] * 1e3 / refills_g:.1f}"
        f" ms each), steps {steps_g} in {phase_g['steps_s']:.3f} s "
        f"({phase_g['steps_s'] * 1e3 / max(steps_g, 1):.2f} ms a step), mel, harvest and the "
        f"rest {wall_g - phase_g['refill_s'] - phase_g['steps_s']:.3f} s; launches {g_counts}")
    want = {"K1": large.encoder_layers * refills_g, "K2ring": large.decoder_layers * steps_g,
            "K2beam": large.decoder_layers * steps_g,
            "K3": -(-n_g // step_time.BEAM_STREAM_MEL_BATCH)}
    if g_counts != want or refills_g != n_g // bcfg.encode_batch or steps_g < 1:
        raise AssertionError(f"4g launches {g_counts}, expected {want} ({refills_g} refills, "
                             f"{steps_g} steps)")
    bad = []
    for i in range(n_g):
        row, stop = toks_g[i], int(stops_g[i])
        sampled = row[p_g:stop].tolist()
        end = sampled.index(st.eot) + 1 if st.eot in sampled else len(sampled)
        if not ((row[:p_g] == prompt_g).all() and (row[stop:] == large.pad_token_id).all()
                and all(0 <= t < large.vocab_size for t in sampled[:end])
                and all(t == large.pad_token_id for t in sampled[end:])
                and np.isfinite(scores_g[i])):
            bad.append(i)
    ended = sum(int(st.eot in toks_g[i, p_g:int(stops_g[i])].tolist()) for i in range(n_g))
    if toks_g.shape != (n_g, opts_g.max_length) or bad:
        raise AssertionError(f"4g: utterances {bad[:10]} are not the prompt, then at most their "
                             "budget's tokens, then pads, with a finite score")
    log(f"[4g] every utterance: prompt, then at most its budget's tokens, then pads, finite "
        f"score; {ended} of {n_g} ended at eot before their budget; scores "
        f"{float(scores_g.min()):.4f} .. {float(scores_g.max()):.4f}")

    def beam_stream_first_logits(m, x):
        """The stream's first step at 2 groups: encode, refill (cross rows
        one a group, the prompt prefix at the slots trailing the ring
        slot), one step through K2's ring and beam forms."""
        feats_g = mel.log_mel_spectrogram(x, feat).to(torch.bfloat16)
        state = sb._empty_state(m, opts_g, 2, bcfg.num_beams, "int8", torch.device("cuda"))
        pool_tokens = stream_prompt_tokens(opts_g, large.pad_token_id, 2 * bcfg.num_beams,
                                           torch.device("cuda"))
        _, *pool = stream_pool(0, 2, 2, stops_g, opts_g.max_length, torch.device("cuda"))
        sb._refill(m, state, feats_g, pool_tokens, *pool, opts_g, bcfg.num_beams, True)
        rows = torch.arange(2 * bcfg.num_beams, device="cuda")
        last = state.tokens[rows, state.cache.length][:, None]
        logits, _ = whisper.decode(m, last, cache=state.cache, ring_pos=state.ring,
                                   beam_size=bcfg.num_beams)
        return logits[:, 0]

    lg_k = beam_stream_first_logits(qmodel, audio_g[:2].float())
    with plain_path():
        lg_p = beam_stream_first_logits(qmodel, audio_g[:2].float())
    lg_rel = rel(lg_k, lg_p)
    log(f"[4g] 2 groups x {bcfg.num_beams} beams, kernel vs plain path on the card: first-step "
        f"logits rel-L2 {lg_rel:.3e} (tol 5e-2), max |logit diff| "
        f"{float((lg_k - lg_p).abs().max()):.3e}")
    if not (bool(torch.isfinite(lg_k).all()) and lg_rel <= 5e-2):
        raise AssertionError("4g: the beam stream's kernel path disagrees with the plain path")
    audio_jg = audio_g[:J_BEAM_STREAM_WINDOWS].clone()  # phase 4j(d)'s windows
    del audio_g

    # ---- 4h. serving: AsrPipeline and evaluate_speed at the runtime table's configs
    # The JAX package's serving table (eval_pipeline/runtime_pipeline.tpu-v5e.jsonl)
    # names the configurations, never a target: distil-large-v3 (32 + 2
    # layers, a new model) and large-v3 (4c's fused bf16 model and its w8a8
    # copy), max_length 32, 15 s chunks, durations 10 / 30 / 60 / 300 s,
    # configs (a) compute KV and GEMMs, (b) int8 KV + w8a8, (c) (b) with the
    # int16 wire; generate_dummy_audio inputs, 1 warm-up + 3 trials (the JAX
    # harness takes 2 + 5; cut for the smoke's time). The tokenizer is a
    # byte-level stand-in with whisper's own id layout (50257 text ids, each
    # a byte; specials and 1501 timestamps where the model's vocab has them).
    serve_tok = WhisperTokenizer([bytes([i % 256]) for i in range(50257)], [],
                                 vocab_size=large.vocab_size)
    distil = PRESETS["distil-large-v3"]
    t_serve = t0 = time.perf_counter()
    dmodel = whisper.init_params(distil, torch.Generator(device="cuda").manual_seed(0),
                                 device="cuda", dtype=torch.bfloat16)
    fuse_for_inference(dmodel)
    serve_models = {
        "preset:distil-large-v3": (distil, dmodel, quantize_for_inference(copy.deepcopy(dmodel))),
        "preset:large-v3": (large, model, qmodel)}
    torch.cuda.synchronize()
    log(f"[4h] distil-large-v3 ({distil.encoder_layers}+{distil.decoder_layers} layers, "
        f"d={distil.d_model}) built, fused and quantized on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    serve_configs = (("a", "compute", "compute", "float32"), ("b", "int8", "int8", "float32"),
                     ("c", "int8", "int8", "int16"))
    serve_steps = []  # one entry a decode step, from the loops' apply_rules calls

    def counted_loop_rules(*a, **kw):
        serve_steps.append(1)
        return apply_rules(*a, **kw)

    def serve_call(pipe, audio_in):
        """One transcription with launches and decode steps counted."""
        reset_every()
        serve_steps.clear()
        out = pipe(audio_in)
        return out, nonzero(every_count()), len(serve_steps)

    def check_transcript(out, label, duration):
        """Text, and every chunk's timestamps ordered. One pair may not be:
        a segment the model opened and never closed ends at its chunk's end
        (decode/longform.merge_chunk_segments, as in the JAX package), which
        precedes its start where the model's last timestamp lies past the
        audio; the merge keeps such a segment only from the last chunk, so
        it can only be the final pair, ending at the input's duration
        (tests/test_torch_longform.py holds both packages to that pair)."""
        pairs = [c["timestamp"] for c in out["chunks"]]
        tail_open = bool(pairs) and pairs[-1][0] > pairs[-1][1] == round(duration, 2)
        ordered = pairs[:-1] if tail_open else pairs
        if not (isinstance(out["text"], str) and all(isinstance(c["text"], str)
                                                      for c in out["chunks"])
                and all(a <= b for a, b in ordered)):
            raise AssertionError(f"4h {label}: transcript {out['text']!r:.200} with chunk "
                                 f"timestamps {pairs[:20]}")
        return f"{len(pairs)} segments" + (", the last opened past the audio" if tail_open
                                           else "")

    def serve_first_logits(pipe, audio_in):
        """The pipeline's first decode step at its own chunks: collate to
        30 s, log-mel, encode, cache, prompt prefill, one step."""
        m = pipe.model
        chunks = chunk_audio(audio_in, pipe.chunking)
        batch = collate_audio([c.audio for c in chunks], CollatorConfig(n_samples=feat.n_samples))
        feats_h = mel.log_mel_spectrogram(batch, pipe.feat).to(torch.bfloat16)
        cache = whisper.init_cache(m, whisper.encode(m, feats_h), pipe.max_length,
                                   kv_dtype=pipe.kv_dtype)
        ids = torch.tensor([pipe.opts.prompt_ids], device="cuda").repeat(len(chunks), 1)
        _, cache = whisper.decode(m, ids[:, :-1], cache=cache)
        logits, _ = whisper.decode(m, ids[:, -1:], cache=cache)
        return logits[:, 0]

    serve_records, serve_launches = [], {}
    loops_saved = (greedy_loop.apply_rules, beam_loop.apply_rules)
    greedy_loop.apply_rules = beam_loop.apply_rules = counted_loop_rules
    with tempfile.TemporaryDirectory() as serve_dir:
        runtime_path = os.path.join(serve_dir, "runtime_pipeline.jsonl")
        try:
            for name, (cfg_h, m_bf16, m_w8a8) in serve_models.items():
                pipes = {}
                for label, kv, gemm, wire in serve_configs:
                    m_h = m_w8a8 if gemm == "int8" else m_bf16
                    pipes[label] = AsrPipeline(
                        model=m_h, tok=serve_tok, max_length=SERVE_MAX_LENGTH,
                        chunk_length_s=15.0, kv_dtype=kv, wire_dtype=wire)
                    recs = evaluate_speed(
                        pipes[label].transcribe, model_name=name, durations=SERVE_DURATIONS,
                        n_trials=SERVE_TRIALS, n_warmup=SERVE_WARMUP, output_path=runtime_path,
                        extra={"max_length": SERVE_MAX_LENGTH, "kv_dtype": kv, "gemm_dtype": gemm,
                               "chunk_length_s": 15.0,
                               **({"wire_dtype": "int16"} if wire == "int16" else {})})
                    serve_records += recs
                    for r in recs:
                        log(f"[4h] {name} ({label}) kv={kv} gemm={gemm} wire={wire}: "
                            f"{r['duration']:g} s of audio in {r['mean']:.4f} s (std "
                            f"{r['std']:.4f}, {r['trials']} trials), "
                            f"{r['duration'] / r['mean']:.1f} audio-s/s [{smi}]")
                    # one 300 s call with its launches counted
                    audio_300 = generate_dummy_audio(SERVE_DURATIONS[-1])
                    out, counts, steps = serve_call(pipes[label], audio_300)
                    n_chunks = len(chunk_audio(audio_300, pipes[label].chunking))
                    want = {"K1": cfg_h.encoder_layers, "K2": cfg_h.decoder_layers * steps,
                            "K2self": cfg_h.decoder_layers * steps, "K3": 1}
                    segments = check_transcript(out, f"{name} ({label})", SERVE_DURATIONS[-1])
                    log(f"[4h] {name} ({label}) 300 s: {n_chunks} chunks in one batch, {steps} "
                        f"decode steps, launches {counts}, {segments}, text "
                        f"{out['text'][:60]!r}")
                    if counts != want or not 1 <= steps < SERVE_MAX_LENGTH:
                        raise AssertionError(f"4h {name} ({label}) 300 s launches {counts}, "
                                             f"expected {want}")
                    if (name, label) == ("preset:large-v3", "a"):
                        serve_launches.update(counts)
                    if args.profile and label == "a":
                        for sec in (SERVE_DURATIONS[0], SERVE_DURATIONS[-1]):
                            audio_p = generate_dummy_audio(sec)
                            profile_run(lambda: pipes["a"](audio_p),
                                        f"profile_serving_{name.split(':')[1]}_{sec}s.txt",
                                        f"4h {name} (a), {sec} s")
                # the int16 wire on PCM-sourced audio: the log-mel bit for bit,
                # (b) and (c) the same transcript
                pcm_300 = np.clip(np.round(generate_dummy_audio(SERVE_DURATIONS[-1]) * 32768.0),
                                  -32768, 32767) / 32768.0
                pcm_300 = pcm_300.astype(np.float32)
                batch = collate_audio([c.audio for c in chunk_audio(pcm_300, pipes["b"].chunking)],
                                      CollatorConfig(n_samples=feat.n_samples))
                wire16 = np.clip(np.round(batch * 32768.0), -32768, 32767).astype(np.int16)
                mel32, mel16 = (mel.log_mel_spectrogram(x, pipes["b"].feat)
                                for x in (batch, wire16))
                out_b, out_c = pipes["b"](pcm_300), pipes["c"](pcm_300)
                log(f"[4h] {name}: PCM-sourced 300 s, int16 wire vs fp32 wire: log-mel bit for bit "
                    f"{bool(torch.equal(mel32, mel16))} ({tuple(mel32.shape)}), (b) and (c) "
                    f"transcripts equal {out_b == out_c}")
                if not (torch.equal(mel32, mel16) and out_b == out_c):
                    raise AssertionError(f"4h {name}: the int16 wire parts from the fp32 wire")
                # beam search, 5 beams, at 30 s
                beam_pipe = dataclasses.replace(pipes["a"], num_beams=5)
                out, counts, steps = serve_call(beam_pipe, generate_dummy_audio(30))
                want = {"K1": cfg_h.encoder_layers, "K2self": cfg_h.decoder_layers * steps,
                        "K2beam": cfg_h.decoder_layers * steps, "K3": 1}
                segments = check_transcript(out, f"{name} beam", 30)
                log(f"[4h] {name} (a) 30 s, 5 beams: {steps} steps, launches {counts}, "
                    f"{segments}, text {out['text'][:60]!r}")
                if counts != want or steps < 1:
                    raise AssertionError(f"4h {name} beam launches {counts}, expected {want}")
                if name == "preset:large-v3":
                    serve_launches["K2beam"] = counts["K2beam"]
                # the kernel path against the plain path at 25 s (2 chunks) and at
                # the timed 300 s call's batch (K1 over every chunk at once)
                for sec in (25, SERVE_DURATIONS[-1]):
                    audio_in = generate_dummy_audio(sec)
                    n_chunks = len(chunk_audio(audio_in, pipes["a"].chunking))
                    for label in ("a", "b"):
                        lg_k = serve_first_logits(pipes[label], audio_in)
                        with plain_path():
                            lg_p = serve_first_logits(pipes[label], audio_in)
                        lg_rel = rel(lg_k, lg_p)
                        log(f"[4h] {name} ({label}) {sec} s, {lg_k.shape[0]} chunks, kernel vs "
                            f"plain path on the card: first-step logits rel-L2 {lg_rel:.3e} "
                            f"(tol 5e-2), max |logit diff| "
                            f"{float((lg_k - lg_p).abs().max()):.3e}")
                        if not (lg_k.shape[0] == n_chunks and bool(torch.isfinite(lg_k).all())
                                and lg_rel <= 5e-2):
                            raise AssertionError(f"4h {name} ({label}) {sec} s: the kernel path "
                                                 "disagrees with the plain path")
                        del lg_k, lg_p
        finally:
            greedy_loop.apply_rules, beam_loop.apply_rules = loops_saved
        written = [json.loads(line) for line in open(runtime_path)]
    table = report.runtime_pivot_table(written)
    log(f"[4h] {time.perf_counter() - t_serve:.1f} s for the phase; runtime_pivot_table of the "
        "records written (mean seconds):\n" + table)
    rows = table.splitlines()[2:]
    if not (written == serve_records and len(rows) == len(serve_models) * len(serve_configs)
            and all(" - " not in row and row.count("|") == len(SERVE_DURATIONS) + 2
                    for row in rows)):
        raise AssertionError(f"4h: the runtime table holds {len(rows)} rows, expected "
                             f"{len(serve_models) * len(serve_configs)} with every duration")
    del qmodel, dmodel, serve_models, pipes, beam_pipe, m_bf16, m_w8a8, m_h
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
        *switch_variants(lambda x: whisper.encode(model, x), feats16),
    )
    enc_launches = encoder_variants("4d", model, feats16, enc_variants, 2e-2)
    del feats16
    torch.cuda.empty_cache()

    # ---- 4e. stream-real: continuous batching on the fused bf16 model -------
    # The JAX bench's headline: 192 synthetic 30 s windows, a window of 48
    # rows refilled 16 at a time, int8 KV, budgets from the ReazonSpeech
    # length fit drawn as bench.py draws them (audio first, then budgets,
    # from one generator seeded 0), eot disabled so every utterance decodes
    # exactly its budget; mel on the card in refill-sized batches inside
    # the timed window. Then the same windows and budgets in lockstep B=16
    # batches.
    audio_s, prompt_s, stops_s, opts_s = step_time.stream_workload(st, feat)
    n_s, max_s, p_s, scfg = audio_s.shape[0], opts_s.max_length, len(prompt_s), step_time.STREAM

    def stream_run(n_run):
        return step_time.run_stream(model, audio_s[:n_run], opts_s, st_fixed, stops_s, feat)

    stream_run(2 * scfg.batch)  # warm-up on a prefix of the stream
    torch.cuda.synchronize()
    reset_every()
    buf = io.StringIO()
    os.environ["KWT_STREAM_TRACE"] = "1"
    try:
        with contextlib.redirect_stderr(buf):
            t0 = time.perf_counter()
            toks_s = stream_run(n_s)
            wall_s = time.perf_counter() - t0
    finally:
        os.environ.pop("KWT_STREAM_TRACE")
    stream_counts = nonzero(every_count())
    trace = json.loads(next(line for line in buf.getvalue().splitlines()
                            if line.startswith("KWT_STREAM_TRACE ")).split(" ", 1)[1])
    steps_s = stream_counts.get("K2ring", 0) // large.decoder_layers
    refills = trace["refills"]
    log(f"[4e] stream-real: {n_s} windows, W={scfg.batch}, E={scfg.encode_batch}, budgets mean "
        f"{stops_s.mean():.2f} max {stops_s.max()} tokens: wall {wall_s:.3f} s, "
        f"{n_s * feat.chunk_length_s / wall_s:.1f} audio-s/s [{card}]; {steps_s} steps, "
        f"{refills} refills, {trace['steps'] * 1e3 / max(steps_s, 1):.2f} ms a step (steps "
        f"phase); KWT_STREAM_TRACE {json.dumps(trace)}; launches {stream_counts}")
    want = {"K1": large.encoder_layers * refills, "K2": large.decoder_layers * steps_s,
            "K2ring": large.decoder_layers * steps_s, "K3": refills}
    if stream_counts != want or refills != n_s // scfg.encode_batch:
        raise AssertionError(f"4e launches {stream_counts}, expected {want}")
    pad = large.pad_token_id
    bad = [i for i in range(n_s) if not (
        (toks_s[i, :p_s] == prompt_s).all() and toks_s[i, p_s] >= st.timestamp_begin
        and ((toks_s[i, p_s:stops_s[i]] >= 0) & (toks_s[i, p_s:stops_s[i]] < large.vocab_size)
             ).all() and (toks_s[i, stops_s[i]:] == pad).all())]
    pads_inside = sum(int((toks_s[i, p_s:stops_s[i]] == pad).any()) for i in range(n_s))
    if toks_s.shape != (n_s, max_s) or bad:
        raise AssertionError(f"4e: rows {bad[:10]} are not prompt, then stop - p tokens, "
                             "then pads")
    if args.profile:
        profile_run(lambda: stream_run(n_s), "profile_stream_real.txt", "stream-real")

    def lockstep_run(lo, hi):
        feats_l = mel.log_mel_spectrogram(audio_s[lo:hi].float(), feat).to(torch.bfloat16)
        return generate_greedy(model, feats_l, opts_s, st_fixed, kv_dtype="int8",
                               stop_at=torch.from_numpy(stops_s[lo:hi]).cuda())

    lockstep_run(0, B)  # warm-up at this shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks_l = np.concatenate([lockstep_run(i, i + B).cpu().numpy() for i in range(0, n_s, B)])
    wall_l = time.perf_counter() - t0
    agree = float(np.mean([(toks_s[i] == toks_l[i]).all() for i in range(n_s)]))
    log(f"[4e] lockstep on the same windows and budgets, B={B}: wall {wall_l:.3f} s, "
        f"{n_s * feat.chunk_length_s / wall_l:.1f} audio-s/s [{card}]; stream / lockstep "
        f"{wall_l / wall_s:.2f}x; utterances whose tokens agree {agree:.3f} (reported, not "
        f"gated: bf16 drift flips near-ties); rows with a pad id among their sampled tokens "
        f"{pads_inside}")
    audio_js = audio_s[:J_STREAM_WINDOWS].clone()  # phase 4j(c)'s windows
    del audio_s, toks_l
    torch.cuda.empty_cache()

    # ---- 4f. lockstep beam search on the fused bf16 model -------------------
    g_f, k_f = 12, 5
    opts_f = GenerateOptions(prompt_ids=prompt, max_length=len(prompt) + NEW_TOKENS)
    audio_f = torch.from_numpy(
        (np.random.default_rng(4).standard_normal((g_f, feat.n_samples)) * 0.1
         ).astype(np.float32)).cuda()

    def beam_run(m, x, groups=g_f):
        feats_b = mel.log_mel_spectrogram(x[:groups], feat).to(torch.bfloat16)
        return generate_beam(m, feats_b, opts_f, st_fixed, num_beams=k_f, kv_dtype="int8")

    beam_run(model, audio_f)  # warm-up
    torch.cuda.synchronize()
    reset_every()
    t0 = time.perf_counter()
    toks_b, scores_b = beam_run(model, audio_f)
    toks_b, scores_b = toks_b.cpu().numpy(), scores_b.cpu().numpy()
    wall_b = time.perf_counter() - t0
    beam_counts = nonzero(every_count())
    log(f"[4f] beam search, {g_f} groups x {k_f} beams, prompt + {NEW_TOKENS} tokens, int8 KV: "
        f"wall {wall_b:.3f} s, {g_f * feat.chunk_length_s / wall_b:.1f} audio-s/s, "
        f"{wall_b * 1e3 / NEW_TOKENS:.2f} ms a step (encode and init included) [{card}]; "
        f"launches {beam_counts} (K2 self {beam_counts.get('K2self', 0) // NEW_TOKENS} and beam "
        f"{beam_counts.get('K2beam', 0) // NEW_TOKENS} a step)")
    want = {"K1": large.encoder_layers, "K2self": large.decoder_layers * NEW_TOKENS,
            "K2beam": large.decoder_layers * NEW_TOKENS, "K3": 1}
    if beam_counts != want:
        raise AssertionError(f"4f launches {beam_counts}, expected {want}")
    if toks_b.shape != (g_f, len(prompt) + NEW_TOKENS) or not (
            (toks_b[:, : len(prompt)] == prompt).all() and np.isfinite(scores_b).all()
            and ((toks_b >= 0) & (toks_b < large.vocab_size)).all()):
        raise AssertionError("4f tokens or scores out of range or shape")
    if args.profile:
        profile_run(lambda: beam_run(model, audio_f)[0].cpu(), "profile_beam.txt", "beam search")

    def beam_first_logits(m, x):
        """The first beam step's logits: encode, a cache with one cross row
        a group, the prompt prefill fanned over the beams, one step."""
        feats_b = mel.log_mel_spectrogram(x, feat).to(torch.bfloat16)
        cache = whisper.init_cache(m, whisper.encode(m, feats_b), opts_f.max_length,
                                   kv_dtype="int8", beam_size=k_f)
        ids = torch.tensor([prompt], device="cuda").repeat(x.shape[0] * k_f, 1)
        _, cache = whisper.decode(m, ids[:, :-1], cache=cache, beam_size=k_f)
        logits, _ = whisper.decode(m, ids[:, -1:], cache=cache, beam_size=k_f)
        return logits[:, 0]

    lg_k = beam_first_logits(model, audio_f[:2])
    tk_k, sc_k = (t.cpu().numpy() for t in beam_run(model, audio_f, groups=2))
    with plain_path():
        lg_p = beam_first_logits(model, audio_f[:2])
        tk_p, sc_p = (t.cpu().numpy() for t in beam_run(model, audio_f, groups=2))
    lg_rel = rel(lg_k, lg_p)
    log(f"[4f] 2 groups, kernel vs plain path on the card: first-step logits rel-L2 "
        f"{lg_rel:.3e} (tol 5e-2); scores {sc_k.tolist()} vs {sc_p.tolist()}; token "
        f"agreement {float((tk_k == tk_p).mean()):.3f} over {tk_k.size} tokens")
    if not (bool(torch.isfinite(lg_k).all()) and lg_rel <= 5e-2):
        raise AssertionError("4f: the beam kernel path disagrees with the plain path")

    # ---- 4j. the int4 KV cache at large-v3 width and depth ---------------------
    # The fused bf16 model, kv_dtype="int4" (packed int4 cross K/V and int8
    # self K/V, each with bf16 per-head scales) in every decode mode: (a)
    # phase 4's B=16 batch, (b) 4f's beam search, (c) a stream on 4e's
    # settings over its first 48 windows, (d) a beam stream on 4g's settings
    # over its first 24 windows, (e) AsrPipeline at 30 s (compute GEMMs),
    # (f) the first-step logits of the kernel path against the plain path
    # at B=2 on three seeds; launches by form, the cross cache's bytes in
    # int8 and int4, audio-s/s beside phases 4 and 4f, and the share of
    # (a)'s tokens equal to phase 4's int8 tokens (records: the decode loops
    # are host-bound, so int4's halved cross reads show in device time).
    t_j = time.perf_counter()
    j_walls, j_counts = {}, {}

    def j_run(label, fn):
        torch.cuda.synchronize()
        reset_every()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        j_walls[label] = time.perf_counter() - t
        j_counts[label] = nonzero(every_count())
        return r

    def pipeline_int4(x):
        feats = mel.log_mel_spectrogram(x, feat).to(torch.bfloat16)
        return generate_greedy(model, feats, opts, st_fixed, kv_dtype="int4")

    pipeline_int4(audio)  # warm-up
    toks_j = j_run("a", lambda: pipeline_int4(audio)).cpu().numpy()
    share_j = float((toks_j == toks_host).mean())
    feats_j = mel.log_mel_spectrogram(audio, feat).to(torch.bfloat16)
    enc_j = whisper.encode(model, feats_j)
    cache_bytes = {}
    for kv in ("int8", "int4"):
        c = whisper.init_cache(model, enc_j, cap, kv_dtype=kv)
        cache_bytes[kv] = (nbytes(c.cross_k, c.cross_v), nbytes(c.cross_k_scale, c.cross_v_scale))
        del c
    del feats_j, enc_j
    torch.cuda.empty_cache()
    log(f"[4j-a] B={B} x {NEW_TOKENS} tokens, int4 KV: wall {j_walls['a']:.3f} s, "
        f"{B * feat.chunk_length_s / j_walls['a']:.1f} audio-s/s (phase 4, int8, unfused: "
        f"{B * feat.chunk_length_s / wall:.1f}) [{card}]; launches {j_counts['a']}; tokens "
        f"equal to phase 4's int8 run {share_j:.4f}; cross cache at B={B}: int8 "
        f"{cache_bytes['int8'][0] / 1e9:.4f} GB + {cache_bytes['int8'][1] / 1e6:.2f} MB of "
        f"scales, int4 {cache_bytes['int4'][0] / 1e9:.4f} GB + "
        f"{cache_bytes['int4'][1] / 1e6:.2f} MB")
    if j_counts["a"] != expect or toks_j.shape != toks_host.shape or not (
            (toks_j[:, : len(prompt)] == prompt).all()
            and ((toks_j >= 0) & (toks_j < large.vocab_size)).all()):
        raise AssertionError(f"4j(a): launches {j_counts['a']} (expected {expect}) or tokens")

    def beam_int4(groups=g_f):
        feats_b = mel.log_mel_spectrogram(audio_f[:groups], feat).to(torch.bfloat16)
        return generate_beam(model, feats_b, opts_f, st_fixed, num_beams=k_f, kv_dtype="int4")

    beam_int4()  # warm-up at the run's shapes
    toks_jb, scores_jb = (t.cpu().numpy() for t in j_run("b", beam_int4))
    want = {"K1": large.encoder_layers, "K2self": large.decoder_layers * NEW_TOKENS,
            "K2beam": large.decoder_layers * NEW_TOKENS, "K3": 1}
    log(f"[4j-b] beam search {g_f} x {k_f}, int4 KV: wall {j_walls['b']:.3f} s, "
        f"{g_f * feat.chunk_length_s / j_walls['b']:.1f} audio-s/s (4f, int8: "
        f"{g_f * feat.chunk_length_s / wall_b:.1f}) [{card}]; launches {j_counts['b']}")
    if j_counts["b"] != want or not (np.isfinite(scores_jb).all()
                                     and (toks_jb[:, : len(prompt)] == prompt).all()):
        raise AssertionError(f"4j(b): launches {j_counts['b']} (expected {want}) or scores")

    def stream_int4(n_run):
        return step_time.run_stream(model, audio_js[:n_run], opts_s, st_fixed, stops_s, feat,
                                    kv_dtype="int4")

    stream_int4(scfg.encode_batch)  # warm-up: the window's shapes are the run's
    toks_js = j_run("c", lambda: stream_int4(J_STREAM_WINDOWS))
    steps_j = j_counts["c"].get("K2ring", 0) // large.decoder_layers
    refills_j = J_STREAM_WINDOWS // scfg.encode_batch
    want = {"K1": large.encoder_layers * refills_j, "K2": large.decoder_layers * steps_j,
            "K2ring": large.decoder_layers * steps_j, "K3": refills_j}
    log(f"[4j-c] stream, int4 KV: {J_STREAM_WINDOWS} windows, W={scfg.batch}, "
        f"E={scfg.encode_batch}: wall {j_walls['c']:.3f} s, "
        f"{J_STREAM_WINDOWS * feat.chunk_length_s / j_walls['c']:.1f} audio-s/s (4e, int8, "
        f"{n_s} windows: {n_s * feat.chunk_length_s / wall_s:.1f}) [{card}]; {steps_j} steps; "
        f"launches {j_counts['c']}")
    bad = [i for i in range(J_STREAM_WINDOWS) if not (
        (toks_js[i, :p_s] == prompt_s).all() and (toks_js[i, stops_s[i]:] == pad).all())]
    if j_counts["c"] != want or steps_j < 1 or bad:
        raise AssertionError(f"4j(c): launches {j_counts['c']} (expected {want}), rows {bad[:10]}")

    def beam_stream_int4(n_run):
        return step_time.run_beam_stream(model, audio_jg[:n_run], opts_g, st, stops_g, feat,
                                         kv_dtype="int4")

    beam_stream_int4(bcfg.encode_batch)  # warm-up: the window's shapes are the run's
    toks_jg, scores_jg = j_run("d", lambda: beam_stream_int4(J_BEAM_STREAM_WINDOWS))
    steps_jg = j_counts["d"].get("K2beam", 0) // large.decoder_layers
    want = {"K1": large.encoder_layers * (J_BEAM_STREAM_WINDOWS // bcfg.encode_batch),
            "K2ring": large.decoder_layers * steps_jg, "K2beam": large.decoder_layers * steps_jg,
            "K3": -(-J_BEAM_STREAM_WINDOWS // step_time.BEAM_STREAM_MEL_BATCH)}
    log(f"[4j-d] beam stream, int4 KV, bf16 model: {J_BEAM_STREAM_WINDOWS} windows, "
        f"{bcfg.groups} groups x {bcfg.num_beams} beams, E={bcfg.encode_batch}: wall "
        f"{j_walls['d']:.3f} s, {J_BEAM_STREAM_WINDOWS * feat.chunk_length_s / j_walls['d']:.1f} "
        f"audio-s/s (4g, int8 + w8a8, {n_g} windows: {n_g * feat.chunk_length_s / wall_g:.1f}) "
        f"[{card}]; {steps_jg} steps; launches {j_counts['d']}")
    if j_counts["d"] != want or steps_jg < 1 or not (
            np.isfinite(scores_jg).all()
            and all((toks_jg[i, :p_g] == prompt_g).all() for i in range(J_BEAM_STREAM_WINDOWS))):
        raise AssertionError(f"4j(d): launches {j_counts['d']} (expected {want}) or scores")

    pipe_j = AsrPipeline(model=model, tok=serve_tok, max_length=SERVE_MAX_LENGTH,
                         chunk_length_s=15.0, kv_dtype="int4")
    with tempfile.TemporaryDirectory() as serve_dir:
        recs_j = evaluate_speed(
            pipe_j.transcribe, model_name="preset:large-v3", durations=(30,),
            n_trials=SERVE_TRIALS, n_warmup=SERVE_WARMUP,
            output_path=os.path.join(serve_dir, "runtime.jsonl"),
            extra={"max_length": SERVE_MAX_LENGTH, "kv_dtype": "int4", "gemm_dtype": "compute",
                   "chunk_length_s": 15.0})
    out_j = j_run("e", lambda: pipe_j(generate_dummy_audio(30.0)))
    mean_j = recs_j[0]["time (mean)"]
    log(f"[4j-e] AsrPipeline large-v3, compute GEMMs, int4 KV, 30 s: mean {mean_j:.4f} s of "
        f"{SERVE_TRIALS} trials ({30 / mean_j:.1f} audio-s/s) [{card}]; one call's launches "
        f"{j_counts['e']}; {check_transcript(out_j, 'int4 30 s', 30.0)}")
    if not (j_counts["e"].get("K2", 0) > 0 and j_counts["e"].get("K1") == large.encoder_layers):
        raise AssertionError(f"4j(e): launches {j_counts['e']}")

    def logits_int4(x):
        feats_x = mel.log_mel_spectrogram(x, feat).to(torch.bfloat16)
        return first_step_logits(model, feats_x, prompt, cap, kv_dtype="int4")

    for seed in range(3):
        small = torch.from_numpy((np.random.default_rng(20 + seed).standard_normal(
            (2, feat.n_samples)) * 0.1).astype(np.float32)).cuda()
        lg_k = logits_int4(small)
        with plain_path():
            lg_p = logits_int4(small)
        lg_rel = rel(lg_k, lg_p)
        log(f"[4j-f] B=2 seed {seed}, int4 KV, kernel vs plain path on the card: first-step "
            f"logits rel-L2 {lg_rel:.3e} (tol 5e-2), max |logit diff| "
            f"{float((lg_k - lg_p).abs().max()):.3e}")
        if not (bool(torch.isfinite(lg_k).all()) and lg_rel <= 5e-2):
            raise AssertionError("4j(f): the int4 kernel path disagrees with the plain path")
    log(f"[4j] audio-s/s, int4 KV: (a) lockstep {B * feat.chunk_length_s / j_walls['a']:.1f}, "
        f"(b) beam {g_f * feat.chunk_length_s / j_walls['b']:.1f}, (c) stream "
        f"{J_STREAM_WINDOWS * feat.chunk_length_s / j_walls['c']:.1f}, (d) beam stream "
        f"{J_BEAM_STREAM_WINDOWS * feat.chunk_length_s / j_walls['d']:.1f}, (e) serving 30 s "
        f"{30 / mean_j:.1f}; int8 in this call: phase 4 {B * feat.chunk_length_s / wall:.1f}, "
        f"4f {g_f * feat.chunk_length_s / wall_b:.1f}; {time.perf_counter() - t_j:.1f} s for "
        f"the phase [{card}]")
    int4_launches = {"K2int4": j_counts["a"]["K2"], "K2selfint4": j_counts["a"]["K2self"],
                     "K2beamint4": j_counts["b"]["K2beam"],
                     "K2ringint4": j_counts["c"]["K2ring"]}
    del audio_js, audio_jg, pipe_j

    # ---- 4k. fp32 at large-v3 width and depth --------------------------------
    # The JAX package's --dtype float32: large-v3 with seeded random fp32
    # weights (unfused), fp32 log-mel in, through the kernels' fp32 forms:
    # (a) phase 4's B=16 batch, prompt + 48 tokens, eot off, int8, int4 and
    # compute (fp32) KV, launches exact; (b) 4f's beam search (12 x 5) with
    # compute and int4 KV; (c) a stream on 4e's settings over its first 48
    # windows, compute KV (K2's fp32 ring form); (d) AsrPipeline at 30 s, 1
    # warm-up and 3 trials; (e) at B=2 on three seeds the kernel path, run
    # under torch's default TF32 flags (cuDNN's allow_tf32 on) so that the
    # model code alone keeps TF32 out, against the plain path: the encoder
    # and the first-step logits within F32_PATH_TOL and the 48 greedy tokens
    # equal. Audio-s/s beside phases 4 and 4f, the fp32 cross cache's bytes.
    t_k = time.perf_counter()
    model32 = whisper.init_params(large, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda", dtype=torch.float32)
    audio32 = torch.from_numpy(audio_np).cuda()
    k_walls, k_counts = {}, {}

    def k_run(label, fn):
        torch.cuda.synchronize()
        reset_every()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        k_walls[label] = time.perf_counter() - t
        k_counts[label] = nonzero(every_count())
        return r

    def greedy32(x, kv):
        return generate_greedy(model32, mel.log_mel_spectrogram(x, feat), opts, st_fixed,
                               kv_dtype=kv)

    for kv in ("int8", "int4", "compute"):
        if kv != "int4":  # int4 runs at int8's shapes, right after it
            greedy32(audio32, kv)  # warm-up
        toks_k = k_run(f"a-{kv}", lambda: greedy32(audio32, kv)).cpu().numpy()
        log(f"[4k-a] fp32 B={B} x {NEW_TOKENS} tokens, {kv} KV: wall {k_walls[f'a-{kv}']:.3f} s, "
            f"{B * feat.chunk_length_s / k_walls[f'a-{kv}']:.1f} audio-s/s (phase 4, bf16, int8: "
            f"{B * feat.chunk_length_s / wall:.1f}) [{card}]; launches {k_counts[f'a-{kv}']}")
        if k_counts[f"a-{kv}"] != expect or toks_k.shape != toks_host.shape or not (
                (toks_k[:, : len(prompt)] == prompt).all()
                and ((toks_k >= 0) & (toks_k < large.vocab_size)).all()):
            raise AssertionError(f"4k(a) {kv}: launches {k_counts[f'a-{kv}']} (expected "
                                 f"{expect}) or tokens")
    feats_k = mel.log_mel_spectrogram(audio32, feat)
    enc_k = whisper.encode(model32, feats_k)
    cross32 = {}
    for kv in ("compute", "int8"):
        c = whisper.init_cache(model32, enc_k, cap, kv_dtype=kv)
        cross32[kv] = nbytes(c.cross_k, c.cross_v, c.cross_k_scale, c.cross_v_scale)
        del c
    del feats_k, enc_k
    torch.cuda.empty_cache()
    log(f"[4k-a] cross cache at B={B}: fp32 {cross32['compute'] / 1e9:.4f} GB, int8 with its "
        f"scales {cross32['int8'] / 1e9:.4f} GB")

    def beam32(kv):
        return generate_beam(model32, mel.log_mel_spectrogram(audio_f[:g_f], feat), opts_f,
                             st_fixed, num_beams=k_f, kv_dtype=kv)

    want = {"K1": large.encoder_layers, "K2self": large.decoder_layers * NEW_TOKENS,
            "K2beam": large.decoder_layers * NEW_TOKENS, "K3": 1}
    for kv in ("compute", "int4"):
        beam32(kv)  # warm-up
        toks_kb, scores_kb = (t.cpu().numpy() for t in k_run(f"b-{kv}", lambda: beam32(kv)))
        log(f"[4k-b] fp32 beam search {g_f} x {k_f}, {kv} KV: wall {k_walls[f'b-{kv}']:.3f} s, "
            f"{g_f * feat.chunk_length_s / k_walls[f'b-{kv}']:.1f} audio-s/s (4f, bf16, int8: "
            f"{g_f * feat.chunk_length_s / wall_b:.1f}) [{card}]; launches {k_counts[f'b-{kv}']}")
        if k_counts[f"b-{kv}"] != want or not (np.isfinite(scores_kb).all()
                                               and (toks_kb[:, : len(prompt)] == prompt).all()):
            raise AssertionError(f"4k(b) {kv}: launches {k_counts[f'b-{kv}']} (expected {want}) "
                                 "or scores")

    audio_ks = step_time.stream_workload(st, feat)[0][:J_STREAM_WINDOWS].clone()
    torch.cuda.empty_cache()

    def stream32(n_run):
        return step_time.run_stream(model32, audio_ks[:n_run], opts_s, st_fixed, stops_s, feat,
                                    kv_dtype="compute")

    stream32(scfg.encode_batch)  # warm-up: the window's shapes are the run's
    toks_ks = k_run("c", lambda: stream32(J_STREAM_WINDOWS))
    steps_k = k_counts["c"].get("K2ring", 0) // large.decoder_layers
    refills_k = J_STREAM_WINDOWS // scfg.encode_batch
    want = {"K1": large.encoder_layers * refills_k, "K2": large.decoder_layers * steps_k,
            "K2ring": large.decoder_layers * steps_k, "K3": refills_k}
    log(f"[4k-c] fp32 stream, compute KV: {J_STREAM_WINDOWS} windows, W={scfg.batch}, "
        f"E={scfg.encode_batch}: wall {k_walls['c']:.3f} s, "
        f"{J_STREAM_WINDOWS * feat.chunk_length_s / k_walls['c']:.1f} audio-s/s (4e, bf16, "
        f"int8, {n_s} windows: {n_s * feat.chunk_length_s / wall_s:.1f}) [{card}]; {steps_k} "
        f"steps; launches {k_counts['c']}")
    bad = [i for i in range(J_STREAM_WINDOWS) if not (
        (toks_ks[i, :p_s] == prompt_s).all() and (toks_ks[i, stops_s[i]:] == pad).all())]
    if k_counts["c"] != want or steps_k < 1 or bad:
        raise AssertionError(f"4k(c): launches {k_counts['c']} (expected {want}), rows {bad[:10]}")
    del audio_ks

    pipe_k = AsrPipeline(model=model32, tok=serve_tok, max_length=SERVE_MAX_LENGTH,
                         chunk_length_s=15.0)
    with tempfile.TemporaryDirectory() as serve_dir:
        recs_k = evaluate_speed(
            pipe_k.transcribe, model_name="preset:large-v3", durations=(30,),
            n_trials=SERVE_TRIALS, n_warmup=SERVE_WARMUP,
            output_path=os.path.join(serve_dir, "runtime.jsonl"),
            extra={"max_length": SERVE_MAX_LENGTH, "kv_dtype": "compute", "dtype": "float32",
                   "chunk_length_s": 15.0})
    out_k = k_run("d", lambda: pipe_k(generate_dummy_audio(30.0)))
    mean_k = recs_k[0]["time (mean)"]
    log(f"[4k-d] AsrPipeline large-v3 fp32, compute KV, 30 s: mean {mean_k:.4f} s of "
        f"{SERVE_TRIALS} trials ({30 / mean_k:.1f} audio-s/s) [{card}]; one call's launches "
        f"{k_counts['d']}; {check_transcript(out_k, 'fp32 30 s', 30.0)}")
    if not (k_counts["d"].get("K2", 0) > 0 and k_counts["d"].get("K1") == large.encoder_layers):
        raise AssertionError(f"4k(d): launches {k_counts['d']}")
    del pipe_k

    def path32(x):
        """fp32 log-mel, the encoder, the first step's logits (compute KV)
        and the 48 greedy tokens."""
        feats_x = mel.log_mel_spectrogram(x, feat)
        return (whisper.encode(model32, feats_x).float(),
                first_step_logits(model32, feats_x, prompt, cap, kv_dtype="compute"),
                generate_greedy(model32, feats_x, opts, st_fixed, kv_dtype="compute").cpu())

    for seed in range(3):
        small = audio32[:2] if seed == 0 else torch.from_numpy(
            (np.random.default_rng(30 + seed).standard_normal((2, feat.n_samples)) * 0.1
             ).astype(np.float32)).cuda()
        # torch's own defaults for the kernel path: cuDNN may take TF32,
        # cuBLAS may not (the model code turns both off for fp32)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
        try:
            enc_k, lg_k, tok_k = path32(small)
            if seed == 0:
                # a witness of what TF32 does here: the encoder with the
                # model code's guard bypassed and both flags on
                saved_guard = whisper.exact_fp32
                whisper.exact_fp32 = lambda dtype: contextlib.nullcontext()
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    enc_tf32 = whisper.encode(model32, mel.log_mel_spectrogram(small, feat))
                finally:
                    whisper.exact_fp32 = saved_guard
        finally:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        with plain_path():
            enc_p, lg_p, tok_p = path32(small)
        if seed == 0:
            tf32_rel = rel(enc_tf32, enc_p)
            del enc_tf32
        enc_rel, lg_rel = rel(enc_k, enc_p), rel(lg_k, lg_p)
        same = bool(torch.equal(tok_k, tok_p))
        log(f"[4k-e] B=2 seed {seed}, fp32 kernel path (torch's default TF32 flags) vs plain "
            f"path on the card: encoder rel-L2 {enc_rel:.3e}, first-step logits rel-L2 "
            f"{lg_rel:.3e} (tol {F32_PATH_TOL:g} each; the encoder under TF32 reads "
            f"{tf32_rel:.3e}), max |logit diff| {float((lg_k - lg_p).abs().max()):.3e}, "
            f"{NEW_TOKENS} greedy tokens equal: {same}")
        if not (bool(torch.isfinite(enc_k).all() and torch.isfinite(lg_k).all())
                and enc_rel <= F32_PATH_TOL and lg_rel <= F32_PATH_TOL and same):
            raise AssertionError("4k(e): the fp32 kernel path disagrees with the plain path")
    log(f"[4k] audio-s/s, fp32: (a) lockstep int8 KV "
        f"{B * feat.chunk_length_s / k_walls['a-int8']:.1f}, compute KV "
        f"{B * feat.chunk_length_s / k_walls['a-compute']:.1f}, (b) beam compute KV "
        f"{g_f * feat.chunk_length_s / k_walls['b-compute']:.1f}, int4 KV "
        f"{g_f * feat.chunk_length_s / k_walls['b-int4']:.1f}, (c) stream "
        f"{J_STREAM_WINDOWS * feat.chunk_length_s / k_walls['c']:.1f}, (d) serving 30 s "
        f"{30 / mean_k:.1f}; bf16 in this call: phase 4 {B * feat.chunk_length_s / wall:.1f}, "
        f"4f {g_f * feat.chunk_length_s / wall_b:.1f}; {time.perf_counter() - t_k:.1f} s for "
        f"the phase [{card}]")
    # (f) the encoder variants in fp32, 4d's line on this model: default,
    # stem_impl="pallas" (K7's fp32 form), KWT_FA_INT8=qk and qkpv (K8's
    # fp32-q form) and enc_exp's fused_ln (K6's fp32 rows), each with its
    # time, launches and rel-L2 against the default (the int8 forms round
    # every score: 4d's looser bound; the others F32_PATH_TOL)
    feats_k = mel.log_mel_spectrogram(audio32, feat)
    k_enc_variants = (
        ("default", {}, lambda: whisper.encode(model32, feats_k), {"K1": 32}),
        ("stem_impl=pallas", {}, lambda: whisper.encode(model32, feats_k, stem_impl="pallas"),
         {"K1": 32, "K7": 1}),
        ("KWT_FA_INT8=qk", {"KWT_FA_INT8": "qk"}, lambda: whisper.encode(model32, feats_k),
         {"K8": 32}),
        ("KWT_FA_INT8=qkpv", {"KWT_FA_INT8": "qkpv"}, lambda: whisper.encode(model32, feats_k),
         {"K8": 32}),
        ("enc_exp fused_ln", {}, lambda: enc_exp.encode_fused_ln(model32, feats_k),
         {"K1": 32, "K6ln": 33, "K6add": 32}),
        *switch_variants(lambda x: whisper.encode(model32, x), feats_k),
    )
    k_enc_launches = encoder_variants("4k-f", model32, feats_k, k_enc_variants, F32_PATH_TOL)
    del feats_k
    fp32_launches = {"K1f32": k_counts["a-compute"]["K1"], "K2f32": k_counts["a-compute"]["K2"],
                     "K2selff32": k_counts["a-compute"]["K2self"],
                     "K2f32int8": k_counts["a-int8"]["K2"],
                     "K2f32int4": k_counts["a-int4"]["K2"],
                     "K2beamf32": k_counts["b-compute"]["K2beam"],
                     "K2beamf32int4": k_counts["b-int4"]["K2beam"],
                     "K2ringf32": k_counts["c"]["K2ring"],
                     "K7f32": k_enc_launches["stem_impl=pallas"]["K7"],
                     "K8qkf32": k_enc_launches["KWT_FA_INT8=qk"]["K8"],
                     "K8qkpvf32": k_enc_launches["KWT_FA_INT8=qkpv"]["K8"],
                     "K6lnf32": k_enc_launches["enc_exp fused_ln"]["K6ln"],
                     "K6addf32": k_enc_launches["enc_exp fused_ln"]["K6add"],
                     "K1f32nomax": k_enc_launches["KWT_FA_NOMAX=1"]["K1nomax"],
                     "K1f32exp2": k_enc_launches["KWT_FA_EXP2=1"]["K1"],
                     "K8qkf32nomax": k_enc_launches["KWT_FA_NOMAX=1 KWT_FA_INT8=qk"]["K8nomax"],
                     "K8qkpvf32nomax":
                         k_enc_launches["KWT_FA_NOMAX=1 KWT_FA_INT8=qkpv"]["K8nomax"]}
    # nothing of the phase stays on the card: a small tensor left in a split
    # block of one of its large segments would keep the whole segment
    del model32, audio32, small, enc_k, lg_k, enc_p, lg_p
    log(f"[4k] after the phase: {card_memory()}")

    # 4i(b)'s one-card reference: the fused bf16 model and its w8a8 copy at
    # phase 4's B=16 input, tokens and first-step logits through the kernels
    feats_tp = mel.log_mel_spectrogram(audio, feat).to(torch.bfloat16)
    tp_ref = {}
    for label, m in (("bf16", model), ("w8a8", None)):
        o = tp_options(prompt, m is None)
        m = m or quantize_for_inference(copy.deepcopy(model))
        tp_ref[label] = (generate_greedy(m, feats_tp, o, st_fixed, kv_dtype="int8").cpu(),
                         first_step_logits(m, feats_tp, prompt, o.max_length).cpu())
        del m
    del model, audio, audio_f, feats_tp
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
        return train_rng_batch(large, feat, b, rng)

    batch = train_batch(TRAIN_B)
    enc_before = [p.detach().clone() for p in student.model.encoder.parameters()]
    dec_before = [p.detach().clone() for p in student.model.decoder.parameters()]
    # warm-up: cuBLAS plans, allocator; lr 0. Its loss and grad_norm, the
    # step from the seeded weights, are 4i(c)'s one-card reference.
    warm = {k: float(v) for k, v in train_step(state, teacher, batch).items()}
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

    # the same under KWT_FA_NOMAX: every K1 call of the step (the frozen
    # encoder, the student's and the teacher's cross-attention) through its
    # no-max form, K5 on the no-max LSE; the plain path the no-max twin
    # under autograd; 4b's bounds
    os.environ["KWT_FA_NOMAX"] = "1"
    try:
        reset_every()
        with counting_entries() as nm_entries:
            loss_k, grads_k = loss_and_grads()
        nm_counts = nonzero(every_count())
        with plain_path():
            loss_p, grads_p = loss_and_grads()
    finally:
        os.environ.pop("KWT_FA_NOMAX")
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = float((grads_k - grads_p).norm() / grads_p.norm())
    want_nm = {**per_step, "K1nomax": per_step["K1"]}
    log(f"[train] KWT_FA_NOMAX=1, B=2 kernel vs plain path on the card: loss {loss_k:.6f} vs "
        f"{loss_p:.6f} (rel {loss_rel:.3e}, tol {TRAIN_LOSS_TOL:g}), student decoder gradients "
        f"rel-L2 {grad_rel:.3e} (tol {TRAIN_GRAD_TOL:g}); launches {nm_counts}, C entries "
        f"{nm_entries}")
    if nm_counts != want_nm or not (math.isfinite(loss_k) and loss_rel <= TRAIN_LOSS_TOL
                                    and grad_rel <= TRAIN_GRAD_TOL):
        raise AssertionError(f"train under KWT_FA_NOMAX: launches {nm_counts} (expected "
                             f"{want_nm}), or the kernel path disagrees with the plain path")
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

    # ---- 5c (its step). the bilingual trainer's step at full width ------------
    # train/distill_multitask on 4b's teacher and 2-layer student: two
    # datasets of B=4 x 128 labels, the first with two task keys and KL, the
    # second with one key and no KL (the v3 recipe's ja / en split); one
    # warm-up and 2 timed steps, launches checked; at B=2 a dataset the
    # kernel path against the plain path (loss and decoder gradients, 4b's
    # tolerances)
    from kotoba_whisper_tpu_torch.train import distill_multitask as mt

    specs = (mt.DatasetSpec("ja", ("transcribe.ja", "translate.en"), use_kl=True),
             mt.DatasetSpec("en", ("transcribe.ja",), use_kl=False))

    def bilingual_batches(b):
        out = []
        for spec in specs:
            tasks = {}
            for key in spec.task_keys:
                tb = train_batch(b)
                tasks[key] = {"labels": tb["labels"], "decoder_input_ids": tb["decoder_input_ids"]}
            out.append({"input_features": tb["input_features"], "tasks": tasks})
        return out

    bi_opt, bi_sched = optim.make_optimizer(student, lr=1e-4, warmup_steps=500)
    bi_state = distill.TrainState(student, bi_opt)
    bi_step = mt.make_multitask_train_step(dc, specs, bi_sched)
    bi_batch = bilingual_batches(4)
    bi_step(bi_state, teacher, bi_batch)  # warm-up
    torch.cuda.synchronize()
    reset_every()
    t0 = time.perf_counter()
    for _ in range(2):
        bi_metrics = bi_step(bi_state, teacher, bi_batch)
    torch.cuda.synchronize()
    bi_ms = (time.perf_counter() - t0) / 2 * 1e3
    bi_launches = nonzero(every_count())
    n_keys = sum(len(sp.task_keys) for sp in specs)
    n_kl = sum(len(sp.task_keys) for sp in specs if sp.use_kl)
    ls = s_cfg.decoder_layers
    bi_per_step = {"K1": large.encoder_layers * len(specs) + 2 * ls * n_keys
                   + large.decoder_layers * n_kl,
                   "K4": 2 * ls * n_keys + large.decoder_layers * n_kl, "K5": 2 * ls * n_keys}
    bi_metrics = {k: float(v) for k, v in bi_metrics.items()}
    log(f"[5c] bilingual step, 2 datasets x B=4 x {LABELS} labels (keys "
        f"{[sp.task_keys for sp in specs]}, KL on the first): {bi_ms:.1f} ms/step over 2 "
        f"steps [{card}]; launches {bi_launches}; metrics {bi_metrics}")
    if bi_launches != {k: 2 * n for k, n in bi_per_step.items()} or not all(
            math.isfinite(v) for v in bi_metrics.values()):
        raise AssertionError(f"5c step: launches {bi_launches}, expected 2 x {bi_per_step}")
    bi_small = [{"input_features": bt["input_features"][:2],
                 "tasks": {k: {n: v[:2] for n, v in tb.items()} for k, tb in bt["tasks"].items()}}
                for bt in bi_batch]

    def bi_loss_and_grads():
        loss, _ = mt.multitask_loss(student, teacher, dc, specs, bi_small)
        loss.backward()
        params = [p for p in student.parameters() if p.requires_grad]
        grads = torch.cat([p.grad.float().flatten() for p in params])
        for p in params:
            p.grad = None
        return float(loss.detach()), grads

    bl_k, bg_k = bi_loss_and_grads()
    with plain_path():
        bl_p, bg_p = bi_loss_and_grads()
    bl_rel = abs(bl_k - bl_p) / abs(bl_p)
    bg_rel = float((bg_k - bg_p).norm() / bg_p.norm())
    log(f"[5c] bilingual B=2 a dataset, kernel vs plain path on the card: loss {bl_k:.6f} vs "
        f"{bl_p:.6f} (rel {bl_rel:.3e}, tol {TRAIN_LOSS_TOL:g}), decoder gradients rel-L2 "
        f"{bg_rel:.3e} (tol {TRAIN_GRAD_TOL:g})")
    if not (math.isfinite(bl_k) and bl_rel <= TRAIN_LOSS_TOL and bg_rel <= TRAIN_GRAD_TOL):
        raise AssertionError("5c: the bilingual kernel path disagrees with the plain path")
    del bi_opt, bi_state, bi_batch, bi_small, bg_k, bg_p

    # ---- 4i(a). the distributed path on NCCL, one rank ----------------------
    # A one-rank NCCL group over card 0 and its (1, 1) mesh: one lockstep
    # stage-2 batch (phase 4's input and settings, 4b's seeded large-v3 as the
    # model, the rank's rows of the batch, the tokens gathered over the
    # group) and one distillation step with the global token counts, metrics
    # and gradients summed over the data group; launches as phases 4 and 4b.
    from kotoba_whisper_tpu_torch.core.mesh import DATA_AXIS, MeshConfig, build_mesh
    from kotoba_whisper_tpu_torch.parallel import multihost, sharded

    multihost.initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0, device=torch.device("cuda", 0))
    try:
        mesh1 = build_mesh(MeshConfig(data=1, model=1), "cuda")
        backend = torch.distributed.get_backend()
        m1 = sharded.place_params(mesh1, teacher, model_sharded=False)
        rows1 = sharded.place_batch(mesh1, torch.from_numpy(main_audio(feat)).cuda())
        reset_every()
        t0 = time.perf_counter()
        toks1 = generate_greedy(m1, mel.log_mel_spectrogram(rows1, feat).to(torch.bfloat16), opts,
                                st_fixed, kv_dtype="int8")
        gathered1 = multihost.all_gather_host(toks1.cpu().numpy())
        a_wall = time.perf_counter() - t0
        a_pl = nonzero(every_count())
        reset_every()
        t0 = time.perf_counter()
        a_metrics = distill.make_train_step(dc, sched, data_group=mesh1.get_group(DATA_AXIS))(
            state, teacher, batch)
        a_metrics = {k: float(v) for k, v in a_metrics.items()}
        a_step_ms = (time.perf_counter() - t0) * 1e3
        a_train = nonzero(every_count())
    finally:
        multihost.shutdown()
    log(f"[4i-a] one-rank {backend} group: stage-2 batch B={B} in {a_wall:.3f} s "
        f"({B * feat.chunk_length_s / a_wall:.1f} audio-s/s), launches {a_pl}, gathered "
        f"tokens {gathered1.shape}; DDP step {a_step_ms:.1f} ms, launches {a_train}, metrics "
        f"{a_metrics} [{card}]")
    if not (backend == "nccl" and a_pl == expect and a_train == per_step
            and gathered1.shape == (B, len(prompt) + NEW_TOKENS)
            and all(math.isfinite(v) for v in a_metrics.values())):
        raise AssertionError(f"4i(a): backend {backend}, launches {a_pl} / {a_train} "
                             f"(expected {expect} / {per_step}), tokens {gathered1.shape}")
    del teacher, student, state, opt, batch, small, m1, toks1
    torch.cuda.empty_cache()

    # ---- 4b-f32. the train path in fp32 ---------------------------------------
    # 4b's step at compute_dtype=float32 (the JAX package's --dtype float32:
    # fp32 compute, fp32 master weights): a seeded fp32 large-v3 teacher and
    # its 32+2-layer student, B=8 x 128 labels, remat; one warm-up step (its
    # launches by C entry: every attention through the fp32 forms), 3 timed
    # steps, launches as 4b's (K1 68, K4 36, K5 4 a step), the frozen encoder
    # unchanged and the decoder moved. At B=2 the kernel path, under torch's
    # default TF32 flags (the backward runs outside the model's TF32 guard:
    # its GEMMs follow torch's matmul flag, off by default), against the
    # plain path: loss within F32_TRAIN_LOSS_TOL, the student decoder's
    # gradients within F32_TRAIN_GRAD_TOL; witness: 4b's bf16 step (bf16
    # teacher, bf16 compute) on the same student and rows, whose gradients
    # must read above that bar. Then the bilingual step in fp32.
    t_32 = time.perf_counter()
    teacher32 = whisper.init_params(large, torch.Generator(device="cuda").manual_seed(0),
                                    device="cuda", dtype=torch.float32)
    student32, _ = init_student_from_teacher(teacher32, large, decoder_layers=2)
    teacher32.requires_grad_(False)
    distill.freeze_encoder_(student32)
    opt32, sched32 = optim.make_optimizer(student32, lr=1e-4, warmup_steps=500)
    state32 = distill.TrainState(student32, opt32)
    dc32 = dataclasses.replace(dc, compute_dtype=torch.float32)
    step32 = distill.make_train_step(dc32, sched32)

    def as_f32(bt):
        return {**bt, "input_features": bt["input_features"].float()}

    batch32 = as_f32(train_batch(TRAIN_B))
    enc_before = [p.detach().clone() for p in student32.model.encoder.parameters()]
    dec_before = [p.detach().clone() for p in student32.model.decoder.parameters()]
    with counting_entries() as entries:
        step32(state32, teacher32, batch32)  # warm-up, its launches by C entry
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_every()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        metrics32 = step32(state32, teacher32, batch32)
    torch.cuda.synchronize()
    step32_s = (time.perf_counter() - t0) / TRAIN_STEPS
    f32_train_launches = nonzero(every_count())
    metrics32 = {k: float(v) for k, v in metrics32.items()}
    want_entries = {"kwt_flash_attention_f32": per_step["K1"] + per_step["K4"],
                    "kwt_flash_attention_bwd_f32": per_step["K5"]}
    log(f"[4b-f32] B={TRAIN_B} x {LABELS} labels, fp32: {step32_s * 1e3:.1f} ms/step over "
        f"{TRAIN_STEPS} steps (4b, bf16: {step_s * 1e3:.1f}), "
        f"{TRAIN_B * feat.chunk_length_s / step32_s:.1f} training audio-s/s/card, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{card}]; launches over the "
        f"{TRAIN_STEPS} steps {f32_train_launches}; the warm-up step's C entries {entries}; "
        f"metrics {metrics32}")
    if f32_train_launches != {k: TRAIN_STEPS * n for k, n in per_step.items()} or (
            entries != want_entries):
        raise AssertionError(f"4b-f32 launches {f32_train_launches} (expected {TRAIN_STEPS} x "
                             f"{per_step}), entries {entries} (expected {want_entries})")
    if not all(math.isfinite(v) for v in metrics32.values()) or state32.step != TRAIN_STEPS + 1:
        raise AssertionError(f"4b-f32 metrics {metrics32} at step {state32.step}")
    if not all(torch.equal(a, p) for a, p in zip(enc_before,
                                                 student32.model.encoder.parameters())):
        raise AssertionError("4b-f32: the frozen encoder changed")
    moved = sum(not torch.equal(a, p)
                for a, p in zip(dec_before, student32.model.decoder.parameters()))
    if moved != len(dec_before):
        raise AssertionError(f"4b-f32: {len(dec_before) - moved} decoder parameters did not move")
    del enc_before, dec_before

    small32 = {k: v[:2] for k, v in batch32.items()}

    def loss_and_grads32(teacher_m, dc_m, rows):
        loss, _ = distill.distill_loss(student32, teacher_m, dc_m, rows)
        loss.backward()
        params = [p for p in student32.parameters() if p.requires_grad]
        grads = torch.cat([p.grad.float().flatten() for p in params])
        for p in params:
            p.grad = None
        return float(loss.detach()), grads

    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:  # torch's own defaults for the kernel path
        loss_k32, grads_k32 = loss_and_grads32(teacher32, dc32, small32)
    finally:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with plain_path():
        loss_p32, grads_p32 = loss_and_grads32(teacher32, dc32, small32)
    teacher_bf = copy.deepcopy(teacher32).to(torch.bfloat16)
    loss_w, grads_w = loss_and_grads32(
        teacher_bf, dc, {**small32, "input_features": small32["input_features"].to(torch.bfloat16)})
    del teacher_bf
    loss_rel32 = abs(loss_k32 - loss_p32) / abs(loss_p32)
    grad_rel32 = float((grads_k32 - grads_p32).norm() / grads_p32.norm())
    witness = float((grads_w - grads_p32).norm() / grads_p32.norm())
    log(f"[4b-f32] B=2 kernel path (torch's default TF32 flags) vs plain path on the card: loss "
        f"{loss_k32:.8f} vs {loss_p32:.8f} (rel {loss_rel32:.3e}, tol {F32_TRAIN_LOSS_TOL:g}), "
        f"student decoder gradients rel-L2 {grad_rel32:.3e} (tol {F32_TRAIN_GRAD_TOL:g}); "
        f"witness: 4b's bf16 step's gradients read {witness:.3e} (loss {loss_w:.6f}) against the "
        "fp32 plain path")
    if not (math.isfinite(loss_k32) and loss_rel32 <= F32_TRAIN_LOSS_TOL
            and grad_rel32 <= F32_TRAIN_GRAD_TOL and witness > F32_TRAIN_GRAD_TOL):
        raise AssertionError("4b-f32: the fp32 kernel path disagrees with the plain path, or the "
                             "bar cannot see bf16's error")
    del grads_k32, grads_p32, grads_w, small32

    # the bilingual step in fp32: 5c's datasets and keys, one warm-up and 2
    # timed steps, launches as 5c's
    bi32_opt, bi32_sched = optim.make_optimizer(student32, lr=1e-4, warmup_steps=500)
    bi32_state = distill.TrainState(student32, bi32_opt)
    bi32_step = mt.make_multitask_train_step(dc32, specs, bi32_sched)
    bi32_batch = [as_f32(bt) for bt in bilingual_batches(4)]
    bi32_step(bi32_state, teacher32, bi32_batch)  # warm-up
    torch.cuda.synchronize()
    reset_every()
    t0 = time.perf_counter()
    for _ in range(2):
        bi32_metrics = bi32_step(bi32_state, teacher32, bi32_batch)
    torch.cuda.synchronize()
    bi32_ms = (time.perf_counter() - t0) / 2 * 1e3
    bi32_launches = nonzero(every_count())
    bi32_metrics = {k: float(v) for k, v in bi32_metrics.items()}
    log(f"[4b-f32] bilingual step in fp32, 2 datasets x B=4 x {LABELS} labels: {bi32_ms:.1f} "
        f"ms/step over 2 steps (bf16: {bi_ms:.1f}) [{card}]; launches {bi32_launches}; metrics "
        f"{bi32_metrics}; {time.perf_counter() - t_32:.1f} s for the phase")
    if bi32_launches != {k: 2 * n for k, n in bi_per_step.items()} or not all(
            math.isfinite(v) for v in bi32_metrics.values()):
        raise AssertionError(f"4b-f32 bilingual: launches {bi32_launches}, expected 2 x "
                             f"{bi_per_step}")
    del teacher32, student32, state32, opt32, batch32, bi32_opt, bi32_state, bi32_batch
    log(f"[4b-f32] after the phase: {card_memory()}")

    # ---- 4i(b). tensor parallel over two ranks on card 0 -----------------------
    # Two spawned ranks share card 0 over a gloo group (tp_rank): large-v3
    # at full width split over a model group of 2 (10 heads, a K/V width of
    # 640 and half of each ffn a rank), fused bf16 then fused + w8a8, int8
    # KV, B=16, prompt + 48 tokens (w8a8: + 24); the share of tokens equal to the
    # one-card kernel run on the same weights (bf16 drift flips near ties:
    # a record, not a fault), the first-step logits held to it at rel-L2
    # 5e-2, each rank's launches and wall (two ranks on one card: a record,
    # not a claim); then K2's beam and ring forms at 10 heads.
    tp_dir = tempfile.mkdtemp(prefix="tp2_")
    log(f"[4i-b] before the ranks start: {card_memory()}")
    t0 = time.perf_counter()
    spawn_ranks(tp_rank, free_port(), tp_dir)
    tp_spawn_s = time.perf_counter() - t0
    tp_out = [dict(np.load(os.path.join(tp_dir, f"tp{r}.npz"))) for r in range(2)]
    tp_info = [json.load(open(os.path.join(tp_dir, f"tp{r}.json"))) for r in range(2)]
    shutil.rmtree(tp_dir)
    for label in ("bf16", "w8a8"):
        ref_toks, ref_logits = tp_ref[label]
        same = all(np.array_equal(tp_out[0][f"{label}/tokens"], o[f"{label}/tokens"])
                   for o in tp_out)
        share = float((tp_out[0][f"{label}/tokens"] == ref_toks.numpy()).mean())
        lg = [rel(torch.from_numpy(o[f"{label}/logits"]), ref_logits) for o in tp_out]
        walls = [i[label]["wall_s"] for i in tp_info]
        steps = TP_W8A8_TOKENS if label == "w8a8" else NEW_TOKENS
        log(f"[4i-b] TP=2 {label}, {steps} tokens: heads a rank {tp_info[0][f'{label}/heads']}; "
            f"ranks' tokens equal {same}; share equal to the one-card run {share:.4f}; first-step logits "
            f"rel-L2 {lg[0]:.3e} / {lg[1]:.3e} (tol 5e-2); wall {walls[0]:.3f} / {walls[1]:.3f} s "
            f"({B * feat.chunk_length_s / max(walls):.1f} audio-s/s for the group); launches "
            f"rank 0 {tp_info[0][label]['launches']}, rank 1 {tp_info[1][label]['launches']} "
            f"[{card}]")
        want = {"K1": large.encoder_layers, "K2": large.decoder_layers * steps,
                "K2self": large.decoder_layers * steps}
        if not (same and max(lg) <= 5e-2 and all(i[label]["launches"] == want
                                                  for i in tp_info)
                and tp_info[0][f"{label}/heads"] == h_tp):
            raise AssertionError(f"4i(b) {label}: ranks equal {same}, logits {lg}, launches "
                                 f"{[i[label]['launches'] for i in tp_info]} (expected {want})")
    for label, form in (("beam", "K2beam"), ("stream", "K2ring"), ("int4", "K2")):
        got = [i[label]["launches"] for i in tp_info]
        log(f"[4i-b] TP=2 {label} at 10 heads: launches {got[0]} / {got[1]}, wall "
            f"{tp_info[0][label]['wall_s']:.3f} s")
        if not (got[0] == got[1] and got[0].get(form, 0) > 0):
            raise AssertionError(f"4i(b) {label}: launches {got}")
    tp_launches = {"K1tp": tp_info[0]["bf16"]["launches"]["K1"],
                   "K2tp": tp_info[0]["bf16"]["launches"]["K2"],
                   "K2selftp": tp_info[0]["bf16"]["launches"]["K2self"],
                   "K2beamtp": tp_info[0]["beam"]["launches"]["K2beam"],
                   "K2ringtp": tp_info[0]["stream"]["launches"]["K2ring"],
                   "K2int4tp": tp_info[0]["int4"]["launches"]["K2"]}
    log(f"[4i-b] two ranks spawned, built, run and joined in {tp_spawn_s:.1f} s")

    # ---- 5. drivers: stage 2, then stage 3, merge, 4 and 5 -------------------
    # Six synthetic utterances of 2-7 s in a tar shard with transcripts.
    # Stage 2 (cli/pseudo_label) with its default fusion, then w8a8
    # projections with the int8 attention core in the encoder (two batches
    # of 4), continuous batching (two refills of 4), beam search, and beam
    # search with continuous batching (one group of 3 beams, refills of 1:
    # an encode an utterance). Then, in process through `python -m
    # kotoba_whisper_tpu_torch`: the filter on the default run's labels
    # with --skip_filtering (its log-mel through K3 on the card, int16
    # wire) and with the WER gate (the random model's labels miss every
    # transcript), each as one chunk; merge of the two chunks; and 5b.
    from kotoba_whisper_tpu_torch.__main__ import main as cli
    from kotoba_whisper_tpu_torch.cli import eval_diff

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(1)
        n_utts = 6
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        reazon.write_tar_shard(os.path.join(data, "000.tar"), [
            (f"000/utt{i}.wav", reazon.wav_bytes(rng.standard_normal(16000 * (2 + i)) * 0.1))
            for i in range(n_utts)
        ])
        with open(os.path.join(data, "transcript.tsv"), "w", encoding="utf-8") as f:
            f.write("\n".join(f"000/utt{i}.wav\tutterance number {i}" for i in range(n_utts)))
        n_batches = -(-n_utts // 4)
        for extra, env, expect_enc in (
                ([], {}, {"K1": 32 * n_batches}),
                (["--gemm_dtype", "int8"], {"KWT_FA_INT8": "qk"}, {"K8": 32 * n_batches}),
                (["--streaming"], {}, {"K1": 32 * n_batches}),
                (["--num_beams", "3"], {}, {"K1": 32 * n_batches}),
                (["--streaming", "--num_beams", "3"], {}, {"K1": 32 * n_utts}),
                # --dtype float32 (the kernels' fp32 forms) in lockstep,
                # continuous batching and beam search
                (["--dtype", "float32"], {}, {"K1": 32 * n_batches}),
                (["--dtype", "float32", "--streaming"], {}, {"K1": 32 * n_batches}),
                (["--dtype", "float32", "--num_beams", "3"], {}, {"K1": 32 * n_batches}),
                # and under KWT_FA_INT8=qk (K8's fp32-q form in the encoder)
                (["--dtype", "float32"], {"KWT_FA_INT8": "qk"}, {"K8": 32 * n_batches}),
                # lockstep under KWT_FA_NOMAX (K1's no-max form in the encoder)
                ([], {"KWT_FA_NOMAX": "1"}, {"K1": 32 * n_batches, "K1nomax": 32 * n_batches})):
            out = os.path.join(tmp, "out" + "".join(extra) + "".join(env.values()))
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
                f"{time.perf_counter() - t0:.1f} s; launches {counts}")
            if len(rows) != n_utts or not all(
                isinstance(r["whisper_transcript"], list) and r["whisper_transcript"] for r in rows
            ):
                raise AssertionError(f"driver wrote {len(rows)} records for {n_utts} utterances")
            if {k: n for k, n in counts.items() if k in ("K1", "K8", "K1nomax", "K8nomax")
                    } != expect_enc:
                raise AssertionError(f"driver encoder launches {counts}, expected {expect_enc}")
            if "--streaming" in extra and not counts.get("K2ring"):
                raise AssertionError(f"--streaming: no K2 ring launch in {counts}")
            if "--num_beams" in extra and not counts.get("K2beam"):
                raise AssertionError(f"--num_beams: no K2 beam launch in {counts}")
            if extra[:1] == ["--streaming"] and "--num_beams" in extra and not (
                    counts.get("K2ring") and counts.get("K2ring") == counts.get("K2beam")):
                raise AssertionError(f"--streaming --num_beams: K2 ring and beam launches {counts}")

        # ---- 4i(c). data parallel over two ranks on card 0 ---------------------
        # Two spawned ranks share card 0 over a gloo group (dp_rank): stage 2
        # through the driver's rank body with --num_devices 2 on the default
        # run's dataset and flags (each rank 2 rows of each batch of 4, the
        # first rank gathering and writing), every utterance once and in the
        # one-card order; then one distillation step at 4b's shape, each rank
        # 4 of the 8 rows: equal loss and grad_norm on both ranks, within 1e-2
        # of 4b's one-card step on the same rows from the same weights.
        dp_dir, dp_out = os.path.join(tmp, "dp2"), os.path.join(tmp, "out_dp2")
        os.makedirs(dp_dir)
        pl_args = ["--dataset_dir", data, "--output_dir", dp_out, "--model", "preset:large-v3",
                   "--tokenizer", "byte", "--batch_size", "4", "--max_label_length", "24",
                   "--kv_dtype", "int8", "--wire_dtype", "int16", "--num_devices", "2"]
        t0 = time.perf_counter()
        spawn_ranks(dp_rank, free_port(), dp_dir, pl_args)
        dp_spawn_s = time.perf_counter() - t0
        dp_info = [json.load(open(os.path.join(dp_dir, f"dp{r}.json"))) for r in range(2)]
        one = [json.loads(line) for line in open(os.path.join(tmp, "out", "pseudo_labels.jsonl"))]
        two = [json.loads(line) for line in open(os.path.join(dp_out, "pseudo_labels.jsonl"))]
        agree = sum(a["whisper_transcript"] == b["whisper_transcript"] for a, b in zip(one, two))
        audio_s = sum(2 + i for i in range(n_utts))
        pl_walls = [i["pseudo_label"]["wall_s"] for i in dp_info]
        log(f"[4i-c] DP=2 stage 2: {dp_info[0]['pseudo_label']['said'].strip()}; names in the "
            f"one-card order {[r['name'] for r in two] == [r['name'] for r in one]}; "
            f"{agree} of {n_utts} label sequences equal to the one-card run's; wall "
            f"{pl_walls[0]:.2f} / {pl_walls[1]:.2f} s ({audio_s / max(pl_walls):.1f} audio-s/s for "
            f"the pair, model build included); launches {dp_info[0]['pseudo_label']['launches']} "
            f"/ {dp_info[1]['pseudo_label']['launches']} [{card}]")
        if not ([r["name"] for r in two] == [r["name"] for r in one]
                and sorted(os.listdir(dp_out)) == ["pseudo_labels.csv", "pseudo_labels.jsonl"]
                and all(i["pseudo_label"]["launches"] == {"K1": 32 * n_batches,
                                                          "K2": i["pseudo_label"]["launches"]
                                                          .get("K2", 0),
                                                          "K2self": i["pseudo_label"]["launches"]
                                                          .get("K2self", 0),
                                                          "K3": n_batches}
                        and i["pseudo_label"]["launches"].get("K2")
                        and i["pseudo_label"]["launches"]["K2self"]
                        == i["pseudo_label"]["launches"]["K2"] for i in dp_info)):
            raise AssertionError(f"4i(c) stage 2: wrote {[r['name'] for r in two]}, launches "
                                 f"{[i['pseudo_label']['launches'] for i in dp_info]}")
        steps = [i["step"] for i in dp_info]
        d_rel = {k: abs(steps[0]["metrics"][k] - warm[k]) / abs(warm[k])
                 for k in ("loss", "grad_norm")}
        log(f"[4i-c] DP=2 step at 4b's shape (rows {steps[0]['rows']} / {steps[1]['rows']}): "
            f"loss {steps[0]['metrics']['loss']:.6f} / {steps[1]['metrics']['loss']:.6f}, "
            f"grad_norm {steps[0]['metrics']['grad_norm']:.6f} / "
            f"{steps[1]['metrics']['grad_norm']:.6f}; one card {warm['loss']:.6f}, "
            f"{warm['grad_norm']:.6f} (rel {d_rel['loss']:.3e}, {d_rel['grad_norm']:.3e}, tol "
            f"1e-2); step wall {steps[0]['wall_s'] * 1e3:.1f} / {steps[1]['wall_s'] * 1e3:.1f} ms "
            f"({TRAIN_B * feat.chunk_length_s / max(s_['wall_s'] for s_ in steps):.1f} training "
            f"audio-s/s for the pair); launches {steps[0]['launches']} / {steps[1]['launches']}; "
            f"two ranks spawned, built, run and joined in {dp_spawn_s:.1f} s [{card}]")
        if not (all(steps[0]["metrics"][k] == steps[1]["metrics"][k]
                    for k in ("loss", "ce_loss", "kl_loss", "grad_norm"))
                and max(d_rel.values()) <= 1e-2
                and steps[0]["rows"] == list(range(4)) and steps[1]["rows"] == list(range(4, 8))
                and all(s_["launches"] == per_step for s_ in steps)):
            raise AssertionError(f"4i(c) step: {steps}, one card {warm}")

        labels = os.path.join(tmp, "out", "pseudo_labels.jsonl")
        work = os.path.join(tmp, "work")
        filter_counts = {}
        for chunk, extra in ((0, ["--skip_filtering"]), (1, [])):
            buf = io.StringIO()
            reset_every()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli(["filter", "--dataset_dir", data, "--labels", labels, "--output_dir",
                     os.path.join(work, f"chunk_{chunk}", "filtered"), "--tokenizer", "byte",
                     "--n_mels", str(large.num_mel_bins), "--wire_dtype", "int16", *extra])
            filter_counts[chunk] = nonzero(every_count())
            log(f"[driver] filter {' '.join(extra) or '(WER gate)'}: {buf.getvalue().strip()} in "
                f"{time.perf_counter() - t0:.1f} s; launches {filter_counts[chunk]}")
        kept = [json.loads(line) for line in
                open(os.path.join(work, "chunk_0", "filtered", "filtered.jsonl"))]
        feats_f = np.load(os.path.join(work, "chunk_0", "filtered", "features.npz"))[
            "input_features"]
        gated = open(os.path.join(work, "chunk_1", "filtered", "filtered.jsonl")).read()
        if not (len(kept) == n_utts and feats_f.shape == (n_utts, large.num_mel_bins,
                                                          feat.n_frames)
                and np.isfinite(feats_f).all() and filter_counts[0] == {"K3": 1}
                and gated == "" and filter_counts[1] == {}):
            raise AssertionError(f"filter: kept {len(kept)} of {n_utts} with features "
                                 f"{feats_f.shape}, launches {filter_counts}; the WER gate kept "
                                 f"{len(gated.splitlines())}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(["merge", "--work_dir", work, "--output_dir", os.path.join(tmp, "merged"),
                 "--n_chunks", "2", "--chunks_per_split", "2", "--shard_size", "4"])
        merged = json.loads(buf.getvalue())
        split = os.path.join(tmp, "merged", "split_0")
        log(f"[driver] merge: {merged}; split_0 holds {sorted(os.listdir(split))}")
        if merged["splits"] != [split] or len(open(os.path.join(
                split, "filtered.jsonl")).read().splitlines()) != n_utts:
            raise AssertionError(f"merge wrote {merged}")

        # ---- 5b. training driver: create-student -> distill on the merged split
        # A 4-layer encoder at large-v3 width keeps the student's exports and
        # checkpoints (~0.8 GB each) short; the decoder is the 2-layer student.
        stu, out = os.path.join(tmp, "student"), os.path.join(tmp, "run")
        distill_args = [
            "distill", "--train_splits", os.path.join(tmp, "merged"), "--student", stu,
            "--teacher", "preset:large-v3", "--output_dir", out,
            "--per_device_train_batch_size", "2", "--max_label_length", "64",
            "--warmup_steps", "1", "--logging_steps", "1", "--save_steps", "100",
            "--num_train_epochs", "2",
        ]
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(["create-student", "--teacher", "preset:large-v3", "--save_dir", stu,
                 "--encoder_layers", "4", "--decoder_layers", "2"])
            t_create = time.perf_counter() - t0
            cli(distill_args + ["--max_steps", "2"])
            t_first = time.perf_counter() - t0 - t_create
            cli(distill_args + ["--max_steps", "3"])
        t_all = time.perf_counter() - t0
        said = buf.getvalue()
        with open(os.path.join(out, "metrics.run.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        exported, ex_cfg = import_hf_model(os.path.join(out, "final"))
        log(f"[driver] create-student {t_create:.1f} s, distill 2 steps {t_first:.1f} s, "
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
        # create-student --dtype float32: its dummy forward (4 encoder layers,
        # 2 decoder layers) through the fp32 K1 (self and cross) and K4
        buf = io.StringIO()
        reset_every()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli(["create-student", "--teacher", "preset:large-v3", "--save_dir",
                 os.path.join(tmp, "student32"), "--encoder_layers", "4", "--decoder_layers", "2",
                 "--dtype", "float32"])
        create32_counts = nonzero(every_count())
        log(f"[driver] create-student --dtype float32: {buf.getvalue().strip()[-200:]} in "
            f"{time.perf_counter() - t0:.1f} s; launches {create32_counts}")
        if create32_counts != {"K1": 4 + 2, "K4": 2}:
            raise AssertionError(f"create-student --dtype float32 launches {create32_counts}")
        # distill --dtype float32 (fp32 compute, the fp32 large-v3 teacher),
        # 2 steps from the same student: K1, K4 and K5 through their fp32 forms
        out32 = os.path.join(tmp, "run32")
        buf = io.StringIO()
        reset_every()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli([out32 if a == out else a for a in distill_args]
                + ["--max_steps", "2", "--dtype", "float32"])
        d32_counts = nonzero(every_count())
        with open(os.path.join(out32, "metrics.run.jsonl")) as f:
            logged32 = [json.loads(line) for line in f]
        log(f"[driver] distill --dtype float32, 2 steps: {time.perf_counter() - t0:.1f} s "
            f"[{card}]; launches {d32_counts}; logged losses "
            f"{[round(r['train/loss'], 4) for r in logged32]}")
        if not ([r["step"] for r in logged32] == [1, 2]
                and all(math.isfinite(r["train/loss"]) for r in logged32)
                and all(d32_counts.get(k) for k in ("K1", "K4", "K5"))):
            raise AssertionError(f"distill --dtype float32 is incomplete:\n{buf.getvalue()[-3000:]}")

        # ---- 5c. bilingual distillation through the CLI ---------------------------
        # Stage 2 with two columns (--text_lang_task ja:transcribe,en:translate),
        # stage 3 keeping both as labels/<key> (--skip_filtering), then
        # distill-bilingual on that chunk as two datasets: its transcribe.ja +
        # translate.en labels with KL, and its transcribe.ja labels without,
        # 5b's student, the large-v3 teacher, 2 steps, an HF export.
        bi_pl, bi_data, bi_run = (os.path.join(tmp, n) for n in ("pl_bi", "bi_data", "bi_run"))
        buf = io.StringIO()
        reset_every()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            pseudo_label.main([
                "--dataset_dir", data, "--output_dir", bi_pl, "--model", "preset:large-v3",
                "--tokenizer", "byte", "--batch_size", "4", "--max_label_length", "24",
                "--kv_dtype", "int8", "--wire_dtype", "int16",
                "--text_lang_task", "ja:transcribe,en:translate"])
            cli(["filter", "--dataset_dir", data, "--labels",
                 os.path.join(bi_pl, "pseudo_labels.jsonl"), "--output_dir", bi_data,
                 "--tokenizer", "byte", "--n_mels", str(large.num_mel_bins), "--wire_dtype",
                 "int16", "--skip_filtering", "--label_column",
                 "whisper_transcript/transcribe.ja,whisper_transcript/translate.en"])
            t_prep = time.perf_counter() - t0
            reset_every()
            cli(["distill-bilingual", "--dataset",
                 f"ja:{bi_data}:transcribe.ja+translate.en:kl", "--dataset",
                 f"en:{bi_data}:transcribe.ja:nokl", "--student", stu, "--teacher",
                 "preset:large-v3", "--output_dir", bi_run, "--per_dataset_batch_size", "2",
                 "--max_steps", "2", "--max_label_length", "64", "--warmup_steps", "1",
                 "--logging_steps", "1"])
        bi_counts = nonzero(every_count())
        with open(os.path.join(bi_run, "metrics.bilingual.jsonl")) as f:
            bi_logged = [json.loads(line) for line in f]
        bi_rows = [json.loads(line) for line in open(os.path.join(bi_data, "filtered.jsonl"))]
        bi_model, bi_cfg = import_hf_model(os.path.join(bi_run, "final"))
        bi_keyed = sorted(k for k in bi_rows[0] if k != "name")
        bi_losses = [{k: round(v, 4) for k, v in r.items() if k.startswith("train/")}
                     for r in bi_logged]
        log(f"[5c] distill-bilingual: stages 2 and 3 with two label columns {t_prep:.1f} s, "
            f"{len(bi_rows)} rows keyed {bi_keyed}; 2 steps + export "
            f"{time.perf_counter() - t0 - t_prep:.1f} s [{card}]; launches {bi_counts}; logged "
            f"{bi_losses}")
        want_keys = {f"train/{m}.{k}" for m in ("ce_loss", "kl_loss")
                     for k in ("transcribe.ja", "translate.en")}
        if not ([r["step"] for r in bi_logged] == [1, 2]
                and all(want_keys <= set(r) and all(math.isfinite(r[k]) for k in want_keys)
                        for r in bi_logged)
                and len(bi_rows) == n_utts
                and (bi_cfg.encoder_layers, bi_cfg.decoder_layers) == (4, 2)
                and all(torch.isfinite(p).all() for p in bi_model.parameters())
                and bi_counts.get("K4") and bi_counts.get("K5") and bi_counts.get("K1")):
            raise AssertionError(f"distill-bilingual run is incomplete:\n{buf.getvalue()[-3000:]}")
        del bi_model
        # distill-bilingual --dtype float32 on the same datasets, one step
        buf = io.StringIO()
        reset_every()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli(["distill-bilingual", "--dataset",
                 f"ja:{bi_data}:transcribe.ja+translate.en:kl", "--dataset",
                 f"en:{bi_data}:transcribe.ja:nokl", "--student", stu, "--teacher",
                 "preset:large-v3", "--output_dir", os.path.join(tmp, "bi_run32"),
                 "--per_dataset_batch_size", "2", "--max_steps", "1", "--max_label_length", "64",
                 "--warmup_steps", "1", "--logging_steps", "1", "--dtype", "float32"])
        bi32_counts = nonzero(every_count())
        with open(os.path.join(tmp, "bi_run32", "metrics.bilingual.jsonl")) as f:
            bi32_logged = [json.loads(line) for line in f]
        log(f"[5c] distill-bilingual --dtype float32, 1 step + export: "
            f"{time.perf_counter() - t0:.1f} s [{card}]; launches {bi32_counts}; logged "
            f"{[{k: round(v, 4) for k, v in r.items() if k.startswith('train/')} for r in bi32_logged]}")
        if not ([r["step"] for r in bi32_logged] == [1]
                and all(want_keys <= set(r) and all(math.isfinite(r[k]) for k in want_keys)
                        for r in bi32_logged)
                and all(bi32_counts.get(k) for k in ("K1", "K4", "K5"))):
            raise AssertionError(f"distill-bilingual --dtype float32 is incomplete:\n"
                                 f"{buf.getvalue()[-3000:]}")

        # ---- 5 (stage 6): prepare-eval-set -> eval -> eval_diff -> speed -> report
        # Four synthetic WAVs of 3-18 s (the last in two chunks) in a manifest
        # made into tar+tsv; 5b's exported student evaluated on them, plain,
        # with --stable_ts --punctuator, and again from a copy of the plain
        # run's output, where every prediction comes from the cache (no
        # kernel launches); eval_diff --strict of that run against the plain
        # one; its latency at 10 s; the report of both JSONLs.
        raw, eval_set = os.path.join(tmp, "raw_eval"), os.path.join(tmp, "eval_set")
        os.makedirs(raw)
        rng = np.random.default_rng(2)
        eval_secs = (3, 8, 13, 18)
        with open(os.path.join(raw, "manifest.jsonl"), "w", encoding="utf-8") as f:
            for i, sec in enumerate(eval_secs):
                with open(os.path.join(raw, f"e{i}.wav"), "wb") as w:
                    w.write(reazon.wav_bytes(rng.standard_normal(16000 * sec) * 0.1))
                f.write(json.dumps({"audio": f"e{i}.wav", "text": f"評価 発話 {i}"}) + "\n")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(["prepare-eval-set", "--input", raw, "--output_dir", eval_set,
                 "--shard_size", "2"])
        log(f"[driver] prepare-eval-set: {buf.getvalue().strip()}; {sorted(os.listdir(eval_set))}")
        if sorted(os.listdir(eval_set)) != ["000.tar", "001.tar", "transcript.tsv"]:
            raise AssertionError("prepare-eval-set did not write 2 shards and a transcript")
        student_dir = os.path.join(out, "final")
        eval_dirs, eval_counts = {}, {}
        for label, extra in (("plain", []),
                             ("stable_ts-punctuator", ["--stable_ts", "--punctuator"]),
                             ("cached", [])):
            eval_dirs[label] = os.path.join(tmp, f"eval_{label}")
            if label == "cached":
                shutil.copytree(eval_dirs["plain"], eval_dirs[label])
            buf = io.StringIO()
            reset_every()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli(["eval", "--model", student_dir, "--tokenizer", "byte", "--dataset_dir",
                     eval_set, "--dataset_name", "synth", "--output_dir", eval_dirs[label],
                     *extra])
            eval_counts[label] = nonzero(every_count())
            with open(os.path.join(eval_dirs[label], "metric.ja.transcribe.jsonl")) as f:
                metric = json.loads(f.read().splitlines()[-1])
            log(f"[driver] eval {label}: cer_norm {metric['cer_norm']:.2f}, wer_norm "
                f"{metric['wer_norm']:.2f} in {time.perf_counter() - t0:.1f} s; launches "
                f"{eval_counts[label]}")
        n_eval = len(eval_secs)
        if not (eval_counts["plain"] == eval_counts["stable_ts-punctuator"] == {
                "K1": 4 * n_eval, "K2": eval_counts["plain"].get("K2", 0),
                "K2self": eval_counts["plain"].get("K2", 0), "K3": n_eval}
                and eval_counts["plain"].get("K2") and eval_counts["cached"] == {}):
            raise AssertionError(f"eval launches {eval_counts}: each utterance one call of "
                                 "the kernels, none from the cache")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            eval_diff.main(["--ours", eval_dirs["cached"], "--reference", eval_dirs["plain"],
                            "--strict", "--tolerance", "1e-6"])
        summary = json.loads(buf.getvalue().splitlines()[-1])
        log(f"[driver] eval_diff --strict --tolerance 1e-6, cached run vs plain run: {summary}")
        if summary != {"kind": "summary", "compared": 2, "failures": 0}:
            raise AssertionError(f"eval_diff: {buf.getvalue()}")
        runtime_jsonl = os.path.join(tmp, "runtime_pipeline.jsonl")
        buf = io.StringIO()
        reset_every()
        with contextlib.redirect_stdout(buf):
            cli(["speed", "--model", student_dir, "--tokenizer", "byte", "--durations", "10",
                 "--n_trials", "1", "--output", runtime_jsonl])
        speed_counts = nonzero(every_count())
        with open(runtime_jsonl) as f:
            speed_rows = [json.loads(line) for line in f]
        log(f"[driver] speed: {json.dumps(speed_rows)}; launches {speed_counts} [{smi}]")
        if not (len(speed_rows) == 1 and speed_rows[0]["attention"] == "cuda"
                and speed_rows[0]["device"].startswith("cuda:") and speed_counts.get("K3") == 3):
            raise AssertionError(f"speed wrote {speed_rows} with launches {speed_counts}")
        # stage 6 in fp32: eval and speed --dtype float32 on the same student
        eval32 = os.path.join(tmp, "eval_fp32")
        buf = io.StringIO()
        reset_every()
        with contextlib.redirect_stdout(buf):
            cli(["eval", "--model", student_dir, "--tokenizer", "byte", "--dataset_dir", eval_set,
                 "--dataset_name", "synth", "--output_dir", eval32, "--dtype", "float32"])
        eval32_counts = nonzero(every_count())
        with open(os.path.join(eval32, "metric.ja.transcribe.jsonl")) as f:
            metric32 = json.loads(f.read().splitlines()[-1])
        log(f"[driver] eval --dtype float32: cer_norm {metric32['cer_norm']:.2f}, wer_norm "
            f"{metric32['wer_norm']:.2f}; launches {eval32_counts}")
        if not (eval32_counts.get("K1") == 4 * n_eval and eval32_counts.get("K3") == n_eval
                and eval32_counts.get("K2")):
            raise AssertionError(f"eval --dtype float32 launches {eval32_counts}")
        runtime32 = os.path.join(tmp, "runtime_fp32.jsonl")
        buf = io.StringIO()
        reset_every()
        with contextlib.redirect_stdout(buf):
            cli(["speed", "--model", student_dir, "--tokenizer", "byte", "--durations", "10",
                 "--n_trials", "1", "--output", runtime32, "--dtype", "float32"])
        speed32_counts = nonzero(every_count())
        with open(runtime32) as f:
            speed32_rows = [json.loads(line) for line in f]
        log(f"[driver] speed --dtype float32: {json.dumps(speed32_rows)}; launches "
            f"{speed32_counts} [{smi}]")
        if not (len(speed32_rows) == 1 and speed32_counts.get("K3") == 3
                and speed32_counts.get("K1") and speed32_counts.get("K2")):
            raise AssertionError(f"speed --dtype float32 wrote {speed32_rows} with launches "
                                 f"{speed32_counts}")
        for argv in (["--metric_jsonl", os.path.join(eval_dirs["cached"],
                                                      "metric.ja.transcribe.jsonl")],
                     ["--metric_jsonl", runtime_jsonl, "--runtime"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli(["report", *argv])
            lines = buf.getvalue().splitlines()
            log("[driver] report " + " ".join(argv[2:]) + ":\n" + "\n".join(lines))
            if len(lines) != 3 or not lines[2].startswith(f"| {student_dir}"):
                raise AssertionError(f"report printed {lines}")

        # ---- 5 (stage 6, a-c): the cascade, ESB, the scaling report
        stage6_cascade_esb_scaling(tmp, student_dir, eval_set, eval32_counts, n_eval, card)

    # ---- 5d. the experiment tools ---------------------------------------------
    tool_launches = {}
    for label, fn, argv in (
            ("enc_exp", enc_exp.main, ["--variant", "fused_ln", "--batch", str(B), "--trials", "2"]),
            ("enc_exp fp32", enc_exp.main, ["--variant", "fused_ln", "--batch", "4", "--trials",
                                            "1", "--dtype", "float32"]),
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

    if not all(tool_launches["enc_exp fp32"].get(k) for k in ("K1", "K6ln", "K6add")):
        raise AssertionError(f"enc_exp --dtype float32 launches {tool_launches['enc_exp fp32']}")

    # ---- 6. kernels line, 7. result ------------------------------------------
    path_launches = {
        "K1": launches["K1"], "K2": launches["K2"], "K2self": launches["K2self"],
        "K3": filter_counts[0]["K3"],
        "K2ring": g_counts["K2ring"], "K2beam": g_counts["K2beam"],
        "K4": train_launches["K4"], "K5": train_launches["K5"],
        "K6ln": enc_launches["enc_exp fused_ln"]["K6ln"],
        "K6add": enc_launches["enc_exp fused_ln"]["K6add"],
        "K7": enc_launches["stem_impl=pallas"]["K7"],
        "K8qk": enc_launches["KWT_FA_INT8=qk"]["K8"],
        "K8qkpv": enc_launches["KWT_FA_INT8=qkpv"]["K8"],
        "K1nomax": enc_launches["KWT_FA_NOMAX=1"]["K1nomax"],
        "K1exp2": enc_launches["KWT_FA_EXP2=1"]["K1"],
        "K8qknomax": enc_launches["KWT_FA_NOMAX=1 KWT_FA_INT8=qk"]["K8nomax"],
        "K8qkpvnomax": enc_launches["KWT_FA_NOMAX=1 KWT_FA_INT8=qkpv"]["K8nomax"],
        "K9softmax": tool_launches["vpu_cal softmax"].get("K9", 0),
        "K9exp": tool_launches["vpu_cal exp"].get("K9", 0), **tp_launches, **int4_launches,
        **fp32_launches, "K4f32": create32_counts["K4"], "K5f32": f32_train_launches["K5"]}
    for rec in records:
        rec["launches"] = path_launches[launch_key[rec["name"]]]
        if launch_key[rec["name"]] in serve_launches:  # 4h: large-v3 (a), 300 s; beam at 30 s
            rec["serving_launches"] = serve_launches[launch_key[rec["name"]]]
        if rec["launches"] < 1:
            raise AssertionError(f"{rec['name']} never launched on the path that runs it")
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
