"""Shared CLI plumbing: model/tokenizer loading, generation defaults, the
stage-6 drivers' serving pipeline, the jsonl interchange format, a
background prefetch for host work and the drivers' multi-card launch.

Pseudo labels are written as `pseudo_labels.jsonl` rows
{"name", "transcription", "whisper_transcript": [token ids]} plus a CSV
dump, the same files the JAX package's drivers write.
"""
from __future__ import annotations

import json
import os
import queue
import socket
import threading
from typing import Any, Callable, Iterable, Iterator, TypeVar

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


def refuse_unported_fp32(driver: str, dtype: str, dev: torch.device) -> None:
    """--dtype float32 runs on the card through K1/K4's and K2's fp32 forms;
    KWT_FA_INT8 would move the encoder's attention to K8, whose fp32-q form
    is not ported yet: that combination raises before any card work."""
    mode = os.environ.get("KWT_FA_INT8", "")
    if dev.type == "cuda" and dtype == "float32" and mode:
        raise SystemExit(f"{driver}: KWT_FA_INT8={mode} with --dtype float32 on the card (K8's "
                         "fp32-q form) is not ported yet")


def serving_pipeline(driver: str, arg, dev: torch.device, **pipe_kw):
    """The stage-6 drivers' AsrPipeline: tokenizer, model in --dtype on
    `dev` (fp32 on the card through the kernels' fp32 forms), fused unless
    --no_fuse, w8a8 with --gemm_dtype int8, the checkpoint's generation
    defaults, --chunk_length_s and --kv_dtype. Raises for what is not
    ported (`refuse_unported_fp32`)."""
    from kotoba_whisper_tpu_torch.decode.pipeline import AsrPipeline

    refuse_unported_fp32(driver, arg.dtype, dev)
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


def add_distributed_flags(ap) -> None:
    """Multi-host flags shared by the stage drivers (the `accelerate launch
    --multi_gpu` equivalent): every host runs the same driver command with
    its own --process_id."""
    ap.add_argument("--coordinator_address", default=None,
                    help="host:port of host 0's first rank (the rendezvous); "
                    "with --num_processes P and --process_id i this host joins "
                    "a job of P hosts")
    ap.add_argument("--num_processes", type=int, default=None,
                    help="the number of hosts in the job")
    ap.add_argument("--process_id", type=int, default=None,
                    help="this host's index in the job")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(arg, local_rank: int, local: int, address: str) -> torch.device:
    """Join the job as rank process_id x local + local_rank of
    num_processes x local, on card `local_rank` (made current before any
    allocation) or on the CPU with --device cpu; returns the rank's device."""
    from kotoba_whisper_tpu_torch.core.device import resolve_device
    from kotoba_whisper_tpu_torch.parallel import multihost

    hosts = arg.num_processes or 1
    if resolve_device(arg.device).type == "cuda":
        dev = resolve_device(torch.device("cuda", local_rank))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        if "OMP_NUM_THREADS" not in os.environ:  # the host's cores split over its ranks
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // local))
    multihost.initialize(f"tcp://{address}", hosts * local, (arg.process_id or 0) * local
                         + local_rank, device=dev, local_size=local)
    return dev


def _rank_main(local_rank: int, body, arg, local: int, address: str) -> None:
    from kotoba_whisper_tpu_torch.parallel import multihost

    dev = init_distributed(arg, local_rank, local, address)
    try:
        body(arg, dev)
    finally:
        multihost.shutdown()


def launch(body: Callable[[Any, torch.device], None], arg, local: int) -> None:
    """Run a driver's body(arg, device) on `local` ranks of this host, one
    process a card (rank r on cuda:r, or a CPU process with --device cpu),
    in a job of --num_processes hosts. One rank in all runs in this
    process without a process group; more than one on this host are
    spawned (torch.multiprocessing), and an error in any fails the run."""
    from kotoba_whisper_tpu_torch.core.device import resolve_device

    hosts = arg.num_processes or 1
    if hosts > 1 and (arg.coordinator_address is None or arg.process_id is None):
        raise SystemExit("--num_processes > 1 needs --coordinator_address and --process_id")
    dev = resolve_device(arg.device)
    if hosts * local == 1:
        body(arg, dev)
        return
    if dev.type == "cuda" and torch.cuda.device_count() < local:
        raise SystemExit(f"{local} ranks on this host need {local} cards; "
                         f"{torch.cuda.device_count()} found")
    address = arg.coordinator_address or f"127.0.0.1:{_free_port()}"
    if local == 1:
        _rank_main(0, body, arg, local, address)
    else:
        import torch.multiprocessing as mp

        mp.spawn(_rank_main, args=(body, arg, local, address), nprocs=local)
