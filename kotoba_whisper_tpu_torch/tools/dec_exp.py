"""Decode-step attribution on the card, the counterpart of the JAX
package's tools/dec_exp.py: the large-v3 incremental decode step at B=48,
int8 KV, fused projections (the fixed-48 bench's inner loop) under
ablations that split a step's cost into its terms:

- `full`:      one decode step + logits + timestamp rules + argmax.
- `no_head`:   the same step without the logits product, rules and argmax
               (whisper.logits_from patched, inside the timed steps only,
               to return the final LayerNorm's output) -> full - no_head =
               logits + rules + argmax.
- `cross_t64`: the cross K/V sliced to 64 source positions -> full -
               cross_t64 ~ the cross K/V read (K2's cross call over 1500
               keys).
- `w8a8`:      full with the projections quantized to w8a8
               (models/quantized.py) -> weights ~ 2 x (full - w8a8): int8
               halves the bytes of the decoder's weights.

The encoder output is synthesized (seeded noise): the encoder is timed by
tools/enc_exp.py. Each timed run gets a fresh cache, initialised and
prefilled with the prompt outside the timed region; then `--steps` eager
steps, ended by one device synchronise. In the JAX tool the steps are one
jitted lax.scan, so its time excludes the host; here each step's ops are
issued from the host, so the time includes that dispatch. Beside it,
`host_ms` is the host's time to issue the steps, the clock stopped before
the synchronise (as tools/step_time.py's host_us). Where every variant's
host_ms is at least HOST_BOUND of its total_ms, the card waits on the
host's issue: the attribution's differences then split the host's issue
time, not device work, and the record says so (`host_bound`). w8a8 runs
last, on the model quantized in place (its bf16 projections freed),
unless the caller passes a quantized copy.

Prints one JSON line a variant {name: {total_ms, per_step_ms, host_ms}}
(the best of --trials), `attribution_per_step` when all four ran, then
the whole record with its config, `host_bound` and the card's name.

Usage: python -m kotoba_whisper_tpu_torch.tools.dec_exp [--batch 48]
       [--steps 48] [--trials 3] [--kv int8]
       [--variants full,no_head,cross_t64,w8a8] [--preset large-v3]
       [--device cuda]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from unittest import mock

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.config import SpecialTokens
from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.decode.greedy import GenerateOptions, transcribe_prompt
from kotoba_whisper_tpu_torch.decode.logits_rules import apply_rules
from kotoba_whisper_tpu_torch.models import whisper
from kotoba_whisper_tpu_torch.models.quantized import quantize_for_inference
from kotoba_whisper_tpu_torch.tools.step_time import device_name, fused_setup, sync

VARIANTS = ("full", "no_head", "cross_t64", "w8a8")
NO_HEAD_TOKEN = 42  # the token every no_head step feeds back
HOST_BOUND = 0.9  # host_ms / total_ms from which a step is host-bound


def step_options(st: SpecialTokens, n_steps: int) -> GenerateOptions:
    """The <|ja|> transcribe prompt, capacity prompt + n_steps + 2."""
    prompt = transcribe_prompt(st, st.lang_begin + 6)
    return GenerateOptions(prompt_ids=prompt, max_length=len(prompt) + n_steps + 2)


@torch.inference_mode()
def prefilled_cache(model, enc, opts: GenerateOptions, kv_dtype: str):
    """-> (tokens (B, max_length) with the prompt, a cache over `enc`
    holding the prompt's first p - 1 tokens): the untimed set-up."""
    b, p = enc.shape[0], len(opts.prompt_ids)
    tokens = torch.zeros((b, opts.max_length), dtype=torch.long, device=enc.device)
    tokens[:, :p] = torch.tensor(opts.prompt_ids, device=enc.device)
    cache = whisper.init_cache(model, enc, opts.max_length, kv_dtype=kv_dtype, device=enc.device)
    _, cache = whisper._decode_step(model, tokens[:, : p - 1], cache)
    return tokens, cache


@torch.inference_mode()
def run_steps(model, tokens, cache, opts: GenerateOptions, st: SpecialTokens, n_steps: int,
              head: bool = True):
    """`n_steps` decode steps from the prefilled cache, writing each step's
    token into `tokens` (in place): the rule-masked argmax, or with
    head=False NO_HEAD_TOKEN, the step returning the final LayerNorm's
    output in place of the logits. -> tokens."""
    rc = opts.rule_config(st)
    cur = len(opts.prompt_ids)
    no_head = (contextlib.nullcontext() if head else
               mock.patch.object(whisper, "logits_from", lambda emb, x: x))
    with no_head:
        for _ in range(n_steps):
            out, cache = whisper._decode_step(model, tokens[:, cur - 1 : cur], cache)
            if head:
                tokens[:, cur] = torch.argmax(apply_rules(out[:, 0].float(), tokens, cur, rc),
                                              -1)
            else:
                tokens[:, cur] = NO_HEAD_TOKEN
            cur += 1
    return tokens


def time_steps(model, enc, opts, st, n_steps, trials, kv_dtype, head=True) -> dict:
    """One warm-up run, then the best of `trials`, each from a fresh
    prefilled cache -> {total_ms, per_step_ms, host_ms}."""
    best = None
    for trial in range(trials + 1):
        tokens, cache = prefilled_cache(model, enc, opts, kv_dtype)
        sync(enc.device)
        t0 = time.perf_counter()
        run_steps(model, tokens, cache, opts, st, n_steps, head)
        host = time.perf_counter() - t0
        sync(enc.device)
        wall = time.perf_counter() - t0
        del tokens, cache
        if trial and (best is None or wall < best[0]):
            best = (wall, host)
    return {"total_ms": best[0] * 1e3, "per_step_ms": best[0] / n_steps * 1e3,
            "host_ms": best[1] * 1e3}


def attribution(out: dict) -> dict:
    """The per-step split from the four variants' per_step_ms; the
    residual is what the three terms leave of `full`."""
    f = out["full"]["per_step_ms"]
    attr = {"logits_rules_argmax_ms": f - out["no_head"]["per_step_ms"],
            "cross_kv_stream_ms": f - out["cross_t64"]["per_step_ms"],
            "weight_stream_ms": 2 * (f - out["w8a8"]["per_step_ms"])}
    attr["residual_ms"] = f - sum(attr.values())
    return attr


def run(model, enc_full, st, variants=VARIANTS, *, n_steps=48, trials=3, kv_dtype="int8",
        w8a8_model=None) -> dict:
    """Time `variants` on `model` (fused, bf16) over the encoder output
    `enc_full` (B, 1500, d), printing each variant's line. w8a8 runs on
    `w8a8_model`, or on `model` quantized in place, which must then come
    last."""
    variants = list(variants)
    if "w8a8" in variants and w8a8_model is None and variants[-1] != "w8a8":
        raise ValueError("w8a8 quantizes the model in place: it must be the last variant")
    opts = step_options(st, n_steps)
    out = {"config": {"batch": enc_full.shape[0], "steps": n_steps, "kv": kv_dtype}}
    for name in variants:
        if name == "full":
            rec = time_steps(model, enc_full, opts, st, n_steps, trials, kv_dtype)
        elif name == "no_head":
            rec = time_steps(model, enc_full, opts, st, n_steps, trials, kv_dtype, head=False)
        elif name == "cross_t64":
            rec = time_steps(model, enc_full[:, :64], opts, st, n_steps, trials, kv_dtype)
        elif name == "w8a8":
            if w8a8_model is None:  # the bf16 projections are replaced, so freed
                w8a8_model = quantize_for_inference(model)
                if enc_full.is_cuda:
                    torch.cuda.empty_cache()
            rec = time_steps(w8a8_model, enc_full, opts, st, n_steps, trials, kv_dtype)
        else:
            raise ValueError(f"unknown variant {name!r}; one of {VARIANTS}")
        out[name] = rec
        print(json.dumps({name: rec}), flush=True)
    if set(VARIANTS) <= set(out):
        out["attribution_per_step"] = attribution(out)
        print(json.dumps({"attribution_per_step": out["attribution_per_step"]}), flush=True)
    out["host_bound"] = all(out[name]["host_ms"] >= HOST_BOUND * out[name]["total_ms"]
                            for name in variants)
    out["device"] = device_name(enc_full.device)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--kv", default="int8", choices=["compute", "int8", "int4"])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--preset", default="large-v3")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, st, _, model = fused_setup(args.preset, dev)
    enc_full = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (args.batch, cfg.max_source_positions, cfg.d_model)).astype(np.float32)
    ).to(dev, torch.bfloat16)
    out = run(model, enc_full, st, args.variants.split(","), n_steps=args.steps,
              trials=args.trials, kv_dtype=args.kv)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
