"""Continuous-batching decode by phase on the card, the counterpart of the
JAX package's tools/stream_exp.py: each phase of decode/streaming.py
alone, on large-v3 (seeded random bf16 weights, fused), through the
module's own `_empty_state`, `_pool`, `_refill` and `_steps`:

  empty_state_ms    the all-free window: its caches allocated and zeroed
  encode_refill_ms  one refill of E windows (encode, then each layer's
                    cross K/V and prompt prefix into the free rows), the
                    best of 3 after a warm-up
  round_ms          --steps decode steps over the full window at a fixed
                    length (the round never ends early), the best of
                    --rounds after a warm-up
  per_step_ms       round_ms / --steps

--lockstep times lockstep greedy alone instead (prompt + --steps tokens,
eot disabled, the E windows tiled to the W rows): lockstep_e2e_ms, one
run after a warm-up. Each time is host clock ended by a device
synchronise. Prints one JSON line with the config and the card's name.

Usage: python -m kotoba_whisper_tpu_torch.tools.stream_exp [--window 48]
       [--encode_batch 16] [--kv int8] [--rounds 6] [--steps 8]
       [--lockstep] [--preset large-v3] [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.decode import streaming
from kotoba_whisper_tpu_torch.decode.greedy import (
    GenerateOptions, generate_greedy, transcribe_prompt,
)
from kotoba_whisper_tpu_torch.ops import mel as mel_ops
from kotoba_whisper_tpu_torch.tools.step_time import device_name, fused_setup, sync

CAPACITY = 176      # the stream's max_length (bench.py's stream-real)
REFILL_STOP = 40    # the timed refills' budgets
REFILL_TRIALS = 3


def _clock(fn, dev) -> float:
    t0 = time.perf_counter()
    fn()
    sync(dev)
    return time.perf_counter() - t0


def lockstep(model, feats, st, *, window: int, n_steps: int, kv_dtype: str) -> dict:
    """lockstep_e2e_ms: generate_greedy over `feats` tiled to `window`
    rows, prompt + n_steps tokens, eot disabled."""
    dev = feats.device
    prompt = transcribe_prompt(st, st.lang_begin + 6)
    feats_w = feats.repeat(window // feats.shape[0] + 1, 1, 1)[:window]
    opts = GenerateOptions(prompt_ids=prompt, max_length=len(prompt) + n_steps)
    st_fixed = dataclasses.replace(st, eot=-1)

    def run():
        generate_greedy(model, feats_w, opts, st_fixed, kv_dtype=kv_dtype, device=dev)

    run()
    sync(dev)
    return {"lockstep_e2e_ms": _clock(run, dev) * 1e3, "device": device_name(dev)}


@torch.inference_mode()
def phases(model, feats, st, *, window: int, rounds: int, n_steps: int, kv_dtype: str) -> dict:
    """The stream's phases over the E windows `feats` (module doc) -> the
    record."""
    dev, e, w = feats.device, feats.shape[0], window
    prompt = transcribe_prompt(st, st.lang_begin + 6)
    opts = GenerateOptions(prompt_ids=prompt, max_length=CAPACITY)
    out = {}
    state = None

    def empty():
        nonlocal state
        state = streaming._empty_state(model, opts, w, kv_dtype, dev)

    out["empty_state_ms"] = _clock(empty, dev) * 1e3

    pool_tokens = streaming._prompt_tokens(opts, model.cfg.pad_token_id, e, dev)
    n_pool = e * (REFILL_TRIALS + 1)

    def refill(i, stop):
        _, *pool = streaming._pool(i * e, n_pool, e, np.full(n_pool, stop), opts.max_length, dev)
        streaming._refill(model, state, feats, pool_tokens, *pool, opts)

    refill(0, REFILL_STOP)
    sync(dev)
    out["encode_refill_ms"] = min(
        _clock(lambda: refill(i, REFILL_STOP), dev) for i in range(1, REFILL_TRIALS + 1)) * 1e3

    # fill the whole window first, so that the steps run at full occupancy
    while int(state.active.sum()) < w:
        refill(0, CAPACITY)
    sync(dev)
    never = w + 1  # free rows never reach it: fixed-length rounds

    def round_():
        streaming._steps(model, state, opts, st, never, n_steps)

    round_()
    sync(dev)
    best = min(_clock(round_, dev) for _ in range(rounds))
    out["round_ms"] = best * 1e3
    out["per_step_ms"] = best / n_steps * 1e3
    out["config"] = {"window": w, "encode_batch": e, "kv": kv_dtype}
    out["device"] = device_name(dev)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--window", type=int, default=48)
    ap.add_argument("--encode_batch", type=int, default=16)
    ap.add_argument("--kv", default="int8", choices=["compute", "int8", "int4"])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--preset", default="large-v3")
    ap.add_argument("--lockstep", action="store_true",
                    help="time lockstep greedy (prompt + --steps tokens) at the window's "
                         "batch instead")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    _, st, feat, model = fused_setup(args.preset, dev)
    audio = (np.random.default_rng(0).standard_normal((args.encode_batch, feat.n_samples))
             * 0.1).astype(np.float32)
    feats = mel_ops.log_mel_spectrogram(audio, feat, device=dev).to(torch.bfloat16)
    kw = dict(window=args.window, n_steps=args.steps, kv_dtype=args.kv)
    if args.lockstep:
        out = lockstep(model, feats, st, **kw)
    else:
        out = phases(model, feats, st, rounds=args.rounds, **kw)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
