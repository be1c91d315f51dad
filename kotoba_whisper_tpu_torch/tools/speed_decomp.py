"""One chunked serving call split into its phases on the card, the
counterpart of the JAX package's tools/speed_decomp.py: decode/pipeline.py's
work for one --duration s input (15 s chunks, greedy, max_length 32,
timestamps), each phase fenced by a device synchronise:

  host_chunk   decode/longform.chunk_audio + data/collator.collate_audio to
               the 30 s context (and the int16 wire's rounding)    (host)
  h2d          the batch's upload to the card, from pageable host memory
               (not pinned), synchronised                           (copy)
  mel          ops/mel.log_mel_spectrogram (K3), synchronised      (card)
  decode       decode/greedy.generate_greedy (K1, K2), synchronised (card)
  d2h          the tokens back to the host                          (copy)
  merge        decode/longform.merge_chunk_segments, the text      (host)
  total_split  the sum: one call with the fences above
  fused_total  the same call with no fence but the tokens' read-back,
               the shape eval/speed.py times

One warm-up of each form, then --trials of each; min and mean seconds. The
JAX tool's --attn picks its encoder attention; the port's encoder always
takes K1 on the card, so the flag is refused by name. --serving: w8a8
projections and int8 KV (the serving config); --wire int16 ships 16-bit
PCM. The model is --model (default seeded random large-v3) in bf16,
fused. Prints one JSON line {phase: {min_s, mean_s}, n_chunks, config,
device}.

Usage: python -m kotoba_whisper_tpu_torch.tools.speed_decomp
       [--duration 300] [--serving] [--max_length 32] [--trials 5]
       [--wire float32|int16] [--model preset:large-v3] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from kotoba_whisper_tpu_torch.cli import common
from kotoba_whisper_tpu_torch.core.config import FeatureConfig
from kotoba_whisper_tpu_torch.core.device import resolve_device
from kotoba_whisper_tpu_torch.data.collator import CollatorConfig, collate_audio
from kotoba_whisper_tpu_torch.decode.greedy import GenerateOptions, generate_greedy
from kotoba_whisper_tpu_torch.decode.longform import (
    ChunkingConfig, chunk_audio, merge_chunk_segments,
)
from kotoba_whisper_tpu_torch.eval.speed import generate_dummy_audio
from kotoba_whisper_tpu_torch.ops.mel import log_mel_spectrogram
from kotoba_whisper_tpu_torch.tools.step_time import device_name, sync

CHUNK_S = 15.0


class Decomp:
    """The serving call's pieces on `model` (on its card), in the
    pipeline's order: `split` with a fence after each phase, `fused`
    with none."""

    def __init__(self, model, tok, *, max_length: int, kv_dtype: str, wire: str):
        self.model, self.tok, self.kv_dtype, self.wire = model, tok, kv_dtype, wire
        self.dev = next(model.parameters()).device
        self.feat = FeatureConfig(n_mels=model.cfg.num_mel_bins)
        self.chunking = ChunkingConfig(chunk_length_s=CHUNK_S)
        self.opts = GenerateOptions(prompt_ids=tuple(tok.sot_sequence("ja", "transcribe")),
                                    max_length=max_length, return_timestamps=True)

    def host_batch(self, audio):
        chunks = chunk_audio(audio, self.chunking)
        arr = collate_audio([c.audio for c in chunks],
                            CollatorConfig(n_samples=self.feat.n_samples))
        if self.wire == "int16":
            arr = np.clip(np.round(arr * 32768.0), -32768, 32767).astype(np.int16)
        return chunks, arr

    def text(self, host_toks, chunks) -> str:
        segs = merge_chunk_segments(self.tok, host_toks, chunks, self.chunking)
        return "".join(s["text"] for s in segs)

    def split(self, audio, collect: dict | None = None) -> str:
        marks = [time.perf_counter()]
        chunks, arr = self.host_batch(audio)
        marks.append(time.perf_counter())
        dev_arr = torch.from_numpy(arr).to(self.dev)
        sync(self.dev)
        marks.append(time.perf_counter())
        mel = log_mel_spectrogram(dev_arr, self.feat, device=self.dev).to(self.model.dtype)
        sync(self.dev)
        marks.append(time.perf_counter())
        toks = generate_greedy(self.model, mel, self.opts, self.tok.special,
                               kv_dtype=self.kv_dtype, device=self.dev)
        sync(self.dev)
        marks.append(time.perf_counter())
        host_toks = toks.cpu().numpy()
        marks.append(time.perf_counter())
        text = self.text(host_toks, chunks)
        marks.append(time.perf_counter())
        if collect is not None:
            names = ("host_chunk", "h2d", "mel", "decode", "d2h", "merge")
            for name, a, b in zip(names, marks, marks[1:]):
                collect.setdefault(name, []).append(b - a)
            collect.setdefault("total_split", []).append(marks[-1] - marks[0])
        return text

    def fused(self, audio, collect: dict | None = None) -> str:
        t0 = time.perf_counter()
        chunks, arr = self.host_batch(audio)
        mel = log_mel_spectrogram(arr, self.feat, device=self.dev).to(self.model.dtype)
        toks = generate_greedy(self.model, mel, self.opts, self.tok.special,
                               kv_dtype=self.kv_dtype, device=self.dev)
        text = self.text(toks.cpu().numpy(), chunks)
        if collect is not None:
            collect.setdefault("fused_total", []).append(time.perf_counter() - t0)
        return text


def run(model, tok, *, duration=300.0, serving=False, max_length=32, trials=5,
        wire="float32", kv_dtype="compute") -> dict:
    """The phases on `model` (already fused, and quantized for --serving)
    -> the record."""
    d = Decomp(model, tok, max_length=max_length, kv_dtype=kv_dtype, wire=wire)
    audio = generate_dummy_audio(duration)
    d.split(audio)  # warm-ups of both forms
    d.fused(audio)
    phases: dict = {}
    for _ in range(trials):
        d.split(audio, phases)
    for _ in range(trials):
        d.fused(audio, phases)
    out = {k: {"min_s": float(np.min(v)), "mean_s": float(np.mean(v))} for k, v in phases.items()}
    out["n_chunks"] = len(chunk_audio(audio, d.chunking))
    out["config"] = {"duration": duration, "serving": serving, "max_length": max_length,
                     "wire": wire, "pinned": False}
    out["device"] = device_name(d.dev)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--duration", type=float, default=300.0)
    ap.add_argument("--model", default="preset:large-v3")
    ap.add_argument("--serving", action="store_true",
                    help="w8a8 projections + int8 KV (the serving config)")
    ap.add_argument("--max_length", type=int, default=32)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--attn", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--wire", default="float32", choices=["float32", "int16"],
                    help="int16: PCM wire format (half the h2d bytes; normalized on the card "
                         "in ops/mel.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.attn is not None:
        ap.error("--attn: the port's encoder always takes K1 on the card, so there is no "
                 "attention to choose")

    dev = resolve_device(args.device)
    tok = common.load_tokenizer("byte")
    model, _ = common.load_model(args.model, dev, torch.bfloat16)
    model = common.fuse_unless(model, False)
    kv = "compute"
    if args.serving:
        model = common.quantize_if(model, "int8")
        kv = "int8"
    out = run(model, tok, duration=args.duration, serving=args.serving,
              max_length=args.max_length, trials=args.trials, wire=args.wire, kv_dtype=kv)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
