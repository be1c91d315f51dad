"""Shared CLI plumbing: model/tokenizer loading, generation defaults, the
stage-6 drivers' serving pipeline, the jsonl interchange format and a
background prefetch for host work.

Pseudo labels are written as `pseudo_labels.jsonl` rows
{"name", "transcription", "whisper_transcript": [token ids]} plus a CSV
dump, the same files the JAX package's drivers write.
"""
from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Iterable, Iterator, TypeVar

import torch

from kotoba_whisper_tpu_torch.core.config import PRESETS
from kotoba_whisper_tpu_torch.tokenizer.whisper_tokenizer import WhisperTokenizer

T = TypeVar("T")


def load_tokenizer(spec: str) -> WhisperTokenizer:
    """'byte' | 'byte:<vocab_size>' | path to dir with vocab.json+merges.txt.

    For vocab-file dirs the language count comes from the checkpoint's
    config.json vocab_size when present (51866 -> 100 langs, v3), falling
    back to a 'v3' marker in the path, else the 99-language v2 layout."""
    if spec == "byte":
        return WhisperTokenizer.byte_vocab()
    if spec.startswith("byte:"):
        return WhisperTokenizer.byte_vocab(int(spec.split(":", 1)[1]))
    n_langs = 100 if "v3" in spec else 99
    cfg_path = os.path.join(spec, "config.json")
    if os.path.isfile(cfg_path):
        with open(cfg_path) as f:
            vocab_size = json.load(f).get("vocab_size")
        if vocab_size == 51866:
            n_langs = 100
        elif vocab_size == 51865:
            n_langs = 99
    return WhisperTokenizer.from_pretrained_dir(spec, n_langs=n_langs)


def load_model(spec: str, device: torch.device, dtype: torch.dtype, seed: int = 0):
    """'preset:<name>' (random init from a seeded generator on `device`) or
    an HF-layout checkpoint dir. Returns (model on device in dtype, cfg)."""
    from kotoba_whisper_tpu_torch.models import convert, whisper

    if spec.startswith("preset:"):
        cfg = PRESETS[spec.split(":", 1)[1]]
        gen = torch.Generator(device=device).manual_seed(seed)
        return whisper.init_params(cfg, gen, device=device, dtype=dtype), cfg
    model, cfg = convert.load_checkpoint(spec)
    return model.to(device=device, dtype=dtype), cfg


def fuse_unless(model, disabled: bool):
    """Lossless inference projection fusion (models/optimized.py) unless
    disabled: fewer, larger products in the decode loop."""
    if disabled:
        return model
    from kotoba_whisper_tpu_torch.models.optimized import fuse_for_inference

    return fuse_for_inference(model)


def quantize_if(model, gemm_dtype: str):
    """Opt-in w8a8 int8 projections (models/quantized.py). Changes the
    outputs: the operator validates pseudo-label quality."""
    if gemm_dtype == "compute":
        return model
    if gemm_dtype != "int8":
        raise SystemExit(f"unsupported --gemm_dtype {gemm_dtype}")
    from kotoba_whisper_tpu_torch.models.quantized import quantize_for_inference

    return quantize_for_inference(model)


def load_generation_defaults(model_spec: str) -> dict[str, Any]:
    """Decode defaults from a checkpoint dir's generation_config.json
    (HF layout): suppress lists and the initial-timestamp cap. Presets and
    dirs without the file get empty suppress lists."""
    defaults: dict[str, Any] = {
        "suppress_tokens": (),
        "begin_suppress_tokens": (),
        "max_initial_timestamp_index": 50,
    }
    path = os.path.join(model_spec, "generation_config.json")
    if os.path.isfile(path):
        with open(path) as f:
            g = json.load(f)
        if g.get("suppress_tokens"):
            defaults["suppress_tokens"] = tuple(g["suppress_tokens"])
        if g.get("begin_suppress_tokens"):
            defaults["begin_suppress_tokens"] = tuple(g["begin_suppress_tokens"])
        if g.get("max_initial_timestamp_index") is not None:
            defaults["max_initial_timestamp_index"] = g[
                "max_initial_timestamp_index"
            ]
    return defaults


def serving_pipeline(driver: str, arg, dev: torch.device, **pipe_kw):
    """The stage-6 drivers' AsrPipeline: tokenizer, model in --dtype on
    `dev`, fused unless --no_fuse, w8a8 with --gemm_dtype int8, the
    checkpoint's generation defaults, --chunk_length_s and --kv_dtype.
    Raises for what is not ported: --kv_dtype int4, and --dtype float32 on
    the card (K1 and K2 take bfloat16)."""
    from kotoba_whisper_tpu_torch.decode.pipeline import AsrPipeline

    if arg.kv_dtype == "int4":
        raise SystemExit(f"{driver}: --kv_dtype int4 is not ported yet")
    if dev.type == "cuda" and arg.dtype != "bfloat16":
        raise SystemExit(f"{driver}: --dtype {arg.dtype} on the card is not ported yet "
                         "(K1 and K2 take bfloat16)")
    dtype = torch.bfloat16 if arg.dtype == "bfloat16" else torch.float32
    tok = load_tokenizer(arg.tokenizer)
    model, _ = load_model(arg.model, dev, dtype)
    model = quantize_if(fuse_unless(model, arg.no_fuse), arg.gemm_dtype)
    return AsrPipeline(
        model=model, tok=tok, **load_generation_defaults(arg.model),
        chunk_length_s=arg.chunk_length_s, kv_dtype=arg.kv_dtype, device=dev, **pipe_kw,
    )


def read_jsonl(path: str) -> list[dict[str, Any]]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def write_jsonl(path: str, rows: Iterator[dict[str, Any]]) -> int:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = 0
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row, ensure_ascii=False) + "\n")
            n += 1
    return n


def batched(seq: Iterable[T], n: int) -> Iterator[list[T]]:
    batch = []
    for item in seq:
        batch.append(item)
        if len(batch) == n:
            yield batch
            batch = []
    if batch:
        yield batch


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Run `it` on a background thread, `depth` items ahead, so host work
    (audio decode, collation) overlaps device compute. An exception in the
    producer is re-raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    failure: list[BaseException] = []

    def producer():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # handed to the consumer, re-raised there
            failure.append(e)
        finally:
            q.put(done)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            if failure:
                raise failure[0]
            return
        yield item
