"""Lockstep beam search by phase on the card, the counterpart of the JAX
package's tools/beam_exp.py, on large-v3 (seeded random bf16 weights,
fused; `--gemm int8`: w8a8) with groups x beams rows:

  encode_ms         the encoder (K1) over the G groups' windows
  init_shared_ms    init_cache(beam_size=K): the cross K/V projected and
                    quantized once a group
  prefill_ms        the prompt's first p - 1 tokens over the G x K rows
  step_shared_ms    a decode step over the shared cross K/V (K2's beam form
                    and its self form), the mean of --steps steps
  init_repl_ms      init_cache(beam_size=1) over the encoder output
                    broadcast to every beam: the cross K/V replicated K
                    times (the layout before the shared one)
  step_repl_ms      a step over the replicated cross K/V (K2's prefix form
                    over G x K rows)
  full_ms           generate_beam end to end at a fixed length (eot
                    disabled): the rules, the top 2K, the reorder and the
                    bookkeeping on top of the steps
  full_per_step_ms  full less encode, init and prefill, over its steps

Each phase: one warm-up call, then the best of --trials (host clock, each
ended by a device synchronise). The shared caches are freed before the
replicated ones are built. Prints one JSON line a phase as it is timed,
then the whole record with its config and the card's name.

Usage: python -m kotoba_whisper_tpu_torch.tools.beam_exp [--groups 9]
       [--beams 5] [--steps 32] [--trials 3] [--max_len 64]
       [--gemm compute|int8] [--kv compute|int8|int4] [--preset large-v3]
       [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.decode.beam import generate_beam
from kotoba_whisper_tpu_torch.decode.greedy import GenerateOptions, transcribe_prompt
from kotoba_whisper_tpu_torch.models import whisper
from kotoba_whisper_tpu_torch.models.quantized import quantize_for_inference
from kotoba_whisper_tpu_torch.ops import mel as mel_ops
from kotoba_whisper_tpu_torch.tools.step_time import device_name, fused_setup, sync


def timed(fn, trials: int, dev):
    """fn() once to warm up, then the best of `trials` -> (the last
    output, seconds). The previous output is dropped before each call, so
    two multi-GB caches are never held at once."""
    out = fn()
    sync(dev)
    best = None
    for _ in range(trials):
        out = None
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return out, best


@torch.inference_mode()
def _steps(model, cache, last, beam_size: int, n: int):
    """n decode steps feeding the same token, from `cache`'s fill."""
    logits = None
    for _ in range(n):
        logits, cache = whisper._decode_step(model, last, cache, beam_size=beam_size)
    return logits


def run(model, feats, st, *, beams=5, n_steps=32, trials=3, max_len=64, kv_dtype="int8",
        config=None) -> dict:
    """The phases over log-mel `feats` (G, n_mels, 3000) on `model`,
    printing each one's line -> the record."""
    g, k, dev = feats.shape[0], beams, feats.device
    prompt = transcribe_prompt(st, st.lang_begin + 6)
    p = len(prompt)
    if p - 1 + n_steps > max_len:
        raise ValueError(f"prompt {p} + {n_steps} steps do not fit max_len {max_len}")
    results = {}

    def record(name, val):
        results[name] = val
        print(json.dumps({name: val}), flush=True)

    enc, t = timed(lambda: whisper.encode(model, feats, device=dev), trials, dev)
    record("encode_ms", t * 1e3)

    def cache_for(e, beam_size):
        return whisper.init_cache(model, e, max_len, kv_dtype=kv_dtype, beam_size=beam_size,
                                  device=e.device)

    cache_s, t = timed(lambda: cache_for(enc, k), trials, dev)
    record("init_shared_ms", t * 1e3)
    tokens = torch.tensor([prompt] * (g * k), device=dev)

    def prefill():
        with torch.inference_mode():
            return whisper._decode_step(model, tokens[:, : p - 1], cache_s, beam_size=k)[1]

    cache_s2, t = timed(prefill, trials, dev)
    record("prefill_ms", t * 1e3)
    last = tokens[:, -1:]
    _, t = timed(lambda: _steps(model, cache_s2, last, k, n_steps), trials, dev)
    record("step_shared_ms", t / n_steps * 1e3)

    # the replicated cross K/V only after the shared caches are freed
    del cache_s, cache_s2
    if feats.is_cuda:
        torch.cuda.empty_cache()
    enc_beams = enc.repeat_interleave(k, dim=0)
    cache_r, t = timed(lambda: cache_for(enc_beams, 1), trials, dev)
    record("init_repl_ms", t * 1e3)
    del enc_beams
    _, t = timed(lambda: _steps(model, cache_r, last, 1, n_steps), trials, dev)
    record("step_repl_ms", t / n_steps * 1e3)
    del cache_r
    if feats.is_cuda:
        torch.cuda.empty_cache()

    # the whole search at a fixed length (no early stop: eot disabled)
    st_nx = dataclasses.replace(st, eot=-1)
    opts = GenerateOptions(prompt_ids=prompt, max_length=max_len)
    _, t = timed(lambda: generate_beam(model, feats, opts, st_nx, num_beams=k,
                                       kv_dtype=kv_dtype, device=dev), trials, dev)
    results["full_ms"] = t * 1e3
    results["full_per_step_ms"] = (results["full_ms"] - results["encode_ms"]
                                   - results["init_shared_ms"] - results["prefill_ms"]
                                   ) / (max_len - p)
    results["config"] = {"groups": g, "beams": k, "kv": kv_dtype, "steps": n_steps,
                         "max_len": max_len, **(config or {})}
    results["device"] = device_name(dev)
    print(json.dumps(results), flush=True)
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", default="large-v3")
    ap.add_argument("--groups", type=int, default=9)
    ap.add_argument("--beams", type=int, default=5)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--max_len", type=int, default=64)
    ap.add_argument("--gemm", default="compute", choices=["compute", "int8"])
    ap.add_argument("--kv", default="int8", choices=["compute", "int8", "int4"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, st, feat, model = fused_setup(args.preset, dev)
    if args.gemm == "int8":
        model = quantize_for_inference(model)
    audio = (np.random.default_rng(0).standard_normal((args.groups, feat.n_samples))
             * 0.1).astype(np.float32)
    feats = mel_ops.log_mel_spectrogram(audio, feat, device=dev).to(torch.bfloat16)
    return run(model, feats, st, beams=args.beams, n_steps=args.steps, trials=args.trials,
               max_len=args.max_len, kv_dtype=args.kv, config={"gemm": args.gemm})


if __name__ == "__main__":
    main()
