"""Continuous batching against lockstep decode on the card at the
realistic pseudo-label length distribution, the counterpart of the JAX
package's tools/stream_ab.py. Large-v3 (seeded random bf16 weights,
fused), B=48, budgets from step_time.realistic_stops (bench.py's gamma
fit), drawn with the audio from one generator seeded 0:

- lockstep-real: batches of --batch windows, each decoded to its longest
  budget (generate_greedy with per-row stop_at, eot disabled: a finished
  row cannot give up its slot), log-mel in batches of 16 inside the timed
  run.
- stream-real: decode/streaming.py on the same windows, budgets and
  special tokens (a window of --batch rows refilled 16 at a time, 8 steps
  a round), under KWT_STREAM_TRACE; the trace's phases go into the
  record's detail.
- --beam: lockstep-beam (batches of --batch // 5 groups x 5 beams, each to
  its longest budget rounded up to 16) and stream-beam
  (decode/streaming_beam.py, that many groups, refills of KWT_AB_EBATCH
  (4)), on the first KWT_AB_N (96) windows, eot live as in the JAX tool;
  stream-beam's trace goes into its detail as stream-real's does.
- --prefetch (the port's; the JAX tool has none): both streams with
  prefetch on (StreamConfig.prefetch), to hold them against a run
  without it.

The JAX tool decodes lockstep-real with eot disabled but stream-real with
eot live; here both take eot disabled, so that each utterance decodes
exactly its budget in both (as phase 4e of chip_smoke.py does), and --kv
sets both configs' cache (the JAX tool's lockstep is always int8). Each
config: one warm-up (lockstep: the first batch; streams: the first two
windows' worth), then one timed run (host clock, ended by a device
synchronise). Prints one JSON line a config {config, value (audio-s/s),
detail (all but lockstep-beam), device}.

Usage: python -m kotoba_whisper_tpu_torch.tools.stream_ab [--beam]
       [--n 192] [--batch 48] [--skip-lockstep] [--skip-stream]
       [--kv compute|int8|int4] [--prefetch] [--preset large-v3]
       [--device cuda]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import time

import numpy as np
import torch

from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.decode.beam import generate_beam
from kotoba_whisper_tpu_torch.decode.greedy import (
    GenerateOptions, generate_greedy, transcribe_prompt,
)
from kotoba_whisper_tpu_torch.decode.streaming import StreamConfig, generate_greedy_streaming
from kotoba_whisper_tpu_torch.decode.streaming_beam import (
    BeamStreamConfig, generate_beam_streaming,
)
from kotoba_whisper_tpu_torch.ops import mel as mel_ops
from kotoba_whisper_tpu_torch.tools.step_time import (
    STREAM_CAPACITY, device_name, fused_setup, realistic_stops, sync,
)

MEL_BATCH = 16
ENCODE_BATCH, STEPS_PER_ROUND = 16, 8


def workload(n: int, st, feat, dev):
    """-> (audio (n, n_samples) fp32 on dev, budgets, options): the budgets,
    then the audio, from one generator seeded 0 (the JAX tool's order)."""
    rng = np.random.default_rng(0)
    prompt = transcribe_prompt(st, st.lang_begin + 6)
    stops = realistic_stops(n, len(prompt), rng)
    audio = torch.from_numpy(
        (rng.standard_normal((n, feat.n_samples)) * 0.1).astype(np.float32)).to(dev)
    return audio, stops, GenerateOptions(prompt_ids=prompt, max_length=STREAM_CAPACITY)


def mel_all(audio, feat, dtype):
    return torch.cat([mel_ops.log_mel_spectrogram(audio[i:i + MEL_BATCH], feat,
                                                  device=audio.device).to(dtype)
                      for i in range(0, audio.shape[0], MEL_BATCH)])


def _record(config, n, feat, dt, dev, **detail):
    rec = {"config": config, "value": n * feat.chunk_length_s / dt}
    if detail:
        rec["detail"] = detail
    return {**rec, "device": device_name(dev)}


def lockstep_real(model, audio, stops, opts, st, feat, *, batch: int, kv_dtype: str):
    """-> (record, tokens (n, max_length))."""
    dev, n, dtype = audio.device, audio.shape[0], model.dtype
    st_nx = dataclasses.replace(st, eot=-1)

    def one_batch(feats_b, stops_b):
        return generate_greedy(model, feats_b, opts, st_nx, kv_dtype=kv_dtype,
                               stop_at=torch.from_numpy(stops_b).to(dev), device=dev)

    one_batch(mel_all(audio[:batch], feat, dtype), stops[:batch])  # warm-up
    sync(dev)
    t0 = time.perf_counter()
    feats = mel_all(audio, feat, dtype)
    toks = [one_batch(feats[i:i + batch], stops[i:i + batch]).cpu() for i in range(0, n, batch)]
    dt = time.perf_counter() - t0
    rec = _record("lockstep-real", n, feat, dt, dev,
                  batch_max=[int(stops[i:i + batch].max()) for i in range(0, n, batch)],
                  mean_stop=float(stops.mean()))
    return rec, torch.cat(toks).numpy()


def _traced(fn):
    """fn() under KWT_STREAM_TRACE, timed on the host clock -> (its
    result, seconds, the trace line's record or None); the captured
    stderr is passed on."""
    saved = os.environ.get("KWT_STREAM_TRACE")
    os.environ["KWT_STREAM_TRACE"] = "1"
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            t0 = time.perf_counter()
            out = fn()
            dt = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("KWT_STREAM_TRACE")
        else:
            os.environ["KWT_STREAM_TRACE"] = saved
    trace = [json.loads(line.split(" ", 1)[1]) for line in err.getvalue().splitlines()
             if line.startswith("KWT_STREAM_TRACE ")]
    sys.stderr.write(err.getvalue())
    return out, dt, trace[0] if trace else None


def stream_real(model, audio, stops, opts, st, feat, *, batch: int, kv_dtype: str,
                prefetch: bool = False):
    """-> (record, tokens (n, max_length)); the KWT_STREAM_TRACE line's
    phases go into the record's detail."""
    dev, n, dtype = audio.device, audio.shape[0], model.dtype
    st_nx = dataclasses.replace(st, eot=-1)
    scfg = StreamConfig(batch=batch, encode_batch=min(ENCODE_BATCH, batch),
                        steps_per_round=STEPS_PER_ROUND, prefetch=prefetch)

    def run(a):
        return generate_greedy_streaming(model, mel_all(a, feat, dtype), opts, st_nx,
                                         kv_dtype=kv_dtype, stream=scfg,
                                         stop_at=stops[:a.shape[0]], device=dev)

    run(audio[:2 * batch])  # warm-up
    sync(dev)
    toks, dt, trace = _traced(lambda: run(audio))
    return _record("stream-real", n, feat, dt, dev, window=batch, kv=kv_dtype,
                   trace=trace), toks


def lockstep_beam(model, audio, stops, opts, st, feat, *, groups: int, beams: int,
                  kv_dtype: str) -> dict:
    dev, n, dtype = audio.device, audio.shape[0], model.dtype
    feats = mel_all(audio, feat, dtype)
    batch_len = [((int(stops[i:i + groups].max()) + 15) // 16) * 16 for i in range(0, n, groups)]

    def one_batch(feats_b, max_len):
        toks, _ = generate_beam(model, feats_b, dataclasses.replace(opts, max_length=max_len), st,
                                num_beams=beams, kv_dtype=kv_dtype, device=dev)
        return toks.cpu()

    for t in sorted(set(batch_len)):  # warm-up at every length
        one_batch(feats[:groups], t)
    t0 = time.perf_counter()
    for i, t in zip(range(0, n, groups), batch_len):
        one_batch(feats[i:i + groups], t)
    return _record("lockstep-beam", n, feat, time.perf_counter() - t0, dev)


def stream_beam(model, audio, stops, opts, st, feat, *, groups: int, beams: int,
                encode_batch: int, kv_dtype: str, prefetch: bool = False) -> dict:
    """-> record; the KWT_STREAM_TRACE line's phases go into its detail."""
    dev, n, dtype = audio.device, audio.shape[0], model.dtype
    scfg = BeamStreamConfig(groups=groups, num_beams=beams, encode_batch=encode_batch,
                            steps_per_round=STEPS_PER_ROUND, prefetch=prefetch)

    def run(a):
        return generate_beam_streaming(model, mel_all(a, feat, dtype), opts, st,
                                       kv_dtype=kv_dtype, stream=scfg,
                                       stop_at=stops[:a.shape[0]], device=dev)

    run(audio[:2 * groups])  # warm-up
    sync(dev)
    _, dt, trace = _traced(lambda: run(audio))
    return _record("stream-beam", n, feat, dt, dev, groups=groups, kv=kv_dtype, trace=trace)


def run(model, st, feat, *, n=192, batch=48, beam=False, skip_lockstep=False,
        skip_stream=False, kv_dtype="int8", prefetch=False) -> list[dict]:
    """The configs main() runs, on `model` -> their records (each also
    printed)."""
    dev = next(model.parameters()).device
    audio, stops, opts = workload(n, st, feat, dev)
    recs = []
    if not beam:
        if not skip_lockstep:
            recs.append(lockstep_real(model, audio, stops, opts, st, feat, batch=batch,
                                      kv_dtype=kv_dtype)[0])
            print(json.dumps(recs[-1]), flush=True)
        if not skip_stream:
            recs.append(stream_real(model, audio, stops, opts, st, feat, batch=batch,
                                    kv_dtype=kv_dtype, prefetch=prefetch)[0])
            print(json.dumps(recs[-1]), flush=True)
        return recs
    k, g = 5, max(batch // 5, 1)
    nb = int(os.environ.get("KWT_AB_N", "96"))
    ebatch = int(os.environ.get("KWT_AB_EBATCH", "4"))
    kw = dict(groups=g, beams=k, kv_dtype=kv_dtype)
    if not skip_lockstep:
        recs.append(lockstep_beam(model, audio[:nb], stops[:nb], opts, st, feat, **kw))
        print(json.dumps(recs[-1]), flush=True)
    if not skip_stream:
        recs.append(stream_beam(model, audio[:nb], stops[:nb], opts, st, feat,
                                encode_batch=ebatch, prefetch=prefetch, **kw))
        print(json.dumps(recs[-1]), flush=True)
    return recs


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--beam", action="store_true")
    ap.add_argument("--skip-lockstep", action="store_true")
    ap.add_argument("--skip-stream", action="store_true")
    ap.add_argument("--kv", default="int8", choices=["compute", "int8", "int4"])
    ap.add_argument("--prefetch", action="store_true")
    ap.add_argument("--preset", default="large-v3")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    _, st, feat, model = fused_setup(args.preset, dev)
    return run(model, st, feat, n=args.n, batch=args.batch, beam=args.beam,
               skip_lockstep=args.skip_lockstep, skip_stream=args.skip_stream, kv_dtype=args.kv,
               prefetch=args.prefetch)


if __name__ == "__main__":
    main()
