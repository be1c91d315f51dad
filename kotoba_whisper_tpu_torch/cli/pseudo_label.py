"""Stage-2 driver: teacher batch pseudo-labelling on the card.

Streams utterances from tar shards, decodes audio with the native core,
computes the log-mel features on the device (kernel K3), and decodes
token-id pseudo-labels with timestamps (encoder attention through K1, or
K8 under KWT_FA_INT8=qk|qkpv; decode-step attention through K2): greedy
or beam search (--num_beams N) in lockstep batches, or either with
continuous batching (--streaming: the decode window is refilled as rows,
or beam groups, finish, in super-batches of 4 x --batch_size utterances,
or of 4 x the groups with --num_beams N). Writes pseudo_labels.jsonl and
a CSV dump, the files the JAX driver writes.

The flags mirror the JAX driver's. As there, the attention projections
are fused for inference unless --no_fuse is given, and --gemm_dtype int8
quantizes the projections to w8a8, and --kv_dtype int8 or int4 quantizes
the KV cache (int4: packed cross K/V with per-head scales, read by K2).
--dtype float32 runs on the card through the fp32 forms of K1 and K2, in
every decode mode and KV dtype, and of K8 under KWT_FA_INT8.

Parallel runs, one process a card:
  - --num_devices N --mesh_model_axis M takes N x M cards of this host:
    each batch's rows split in N contiguous blocks, the teacher's heads and
    ffn over M cards (tensor parallel). The host's first rank gathers the
    tokens and writes the files in the order of a one-card run. --streaming
    with more than one card runs lockstep, with a warning, as in JAX.
  - --coordinator_address host:port --num_processes P --process_id i
    joins P hosts: each host takes its slice of the tar shards, writes
    rank-{i}/, and the first host merges them by utterance name.

Usage:
  python -m kotoba_whisper_tpu_torch.cli.pseudo_label \
      --dataset_dir /data/reazon --output_dir out/ \
      --model preset:large-v3 --tokenizer byte:51866 \
      --language ja --task transcribe --batch_size 16 --kv_dtype int8 \
      --gemm_dtype int8
"""
from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--model", default="preset:large-v3")
    ap.add_argument("--tokenizer", default="byte")
    ap.add_argument("--language", default="ja")
    ap.add_argument("--task", default="transcribe",
                    choices=["transcribe", "translate"])
    ap.add_argument("--text_lang_task", default=None,
                    help="comma list of lang:task pairs, e.g. "
                    "'ja:transcribe,en:translate': each decoded separately "
                    "per batch into whisper_transcript/{task}.{lang} columns")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--num_beams", type=int, default=1)
    ap.add_argument("--max_label_length", type=int, default=128)
    ap.add_argument("--return_timestamps", action="store_true", default=True)
    ap.add_argument("--no_timestamps", dest="return_timestamps",
                    action="store_false")
    ap.add_argument("--chunk_lo", type=int, default=None,
                    help="shard range start (idempotent-chunk recipe)")
    ap.add_argument("--chunk_hi", type=int, default=None)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--wire_dtype", default="float32",
                    choices=["float32", "int16"],
                    help="int16: ship audio to the device as 16-bit PCM and "
                    "normalize on device")
    ap.add_argument("--kv_dtype", default="compute",
                    choices=["compute", "int8", "int4"])
    ap.add_argument("--gemm_dtype", default="compute",
                    choices=["compute", "int8"])
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--no_fuse", action="store_true",
                    help="run without the inference projection fusion")
    ap.add_argument("--streaming", action="store_true")
    ap.add_argument("--num_devices", type=int, default=1,
                    help="data-parallel decode over N cards of this host")
    ap.add_argument("--mesh_model_axis", type=int, default=1,
                    help="tensor-parallel factor for the teacher (combine "
                    "with --num_devices)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; with no card and no "
                    "--device cpu the driver raises")
    from kotoba_whisper_tpu_torch.cli.common import add_distributed_flags

    add_distributed_flags(ap)
    return ap


def main(argv=None) -> None:
    from kotoba_whisper_tpu_torch.cli import common

    arg = _parser().parse_args(argv)
    common.launch(_run, arg, arg.num_devices * arg.mesh_model_axis)


def _run(arg, dev: torch.device) -> None:
    """One rank's run (the only one on one card)."""
    from kotoba_whisper_tpu_torch.cli import common
    from kotoba_whisper_tpu_torch.core.config import FeatureConfig
    from kotoba_whisper_tpu_torch.core.mesh import MeshConfig, build_mesh
    from kotoba_whisper_tpu_torch.data import reazon
    from kotoba_whisper_tpu_torch.data.collator import CollatorConfig, collate_audio
    from kotoba_whisper_tpu_torch.decode.beam import generate_beam
    from kotoba_whisper_tpu_torch.decode.greedy import GenerateOptions, generate_greedy
    from kotoba_whisper_tpu_torch.decode.streaming import StreamConfig, generate_greedy_streaming
    from kotoba_whisper_tpu_torch.decode.streaming_beam import (
        BeamStreamConfig,
        generate_beam_streaming,
    )
    from kotoba_whisper_tpu_torch.ops.mel import log_mel_spectrogram
    from kotoba_whisper_tpu_torch.parallel import multihost, sharded
    from kotoba_whisper_tpu_torch.train.logging import Throughput
    from kotoba_whisper_tpu_torch.utils import native

    dtype = torch.bfloat16 if arg.dtype == "bfloat16" else torch.float32

    tok = common.load_tokenizer(arg.tokenizer)
    model, cfg = common.load_model(arg.model, dev, dtype)
    model = common.quantize_if(common.fuse_unless(model, arg.no_fuse), arg.gemm_dtype)

    # more than one card on a host: a mesh over the job's ranks, each host
    # decoding its own batches (its rows over "data", the teacher's heads
    # over "model"); the host's first rank writes the host's files
    hosts = multihost.host_count()
    mesh = None
    if arg.num_devices * arg.mesh_model_axis > 1:
        if arg.batch_size % arg.num_devices:
            raise SystemExit("--batch_size must divide across --num_devices")
        mesh = build_mesh(MeshConfig(data=hosts * arg.num_devices, model=arg.mesh_model_axis),
                          dev.type)
        model = sharded.place_params(mesh, model, model_sharded=arg.mesh_model_axis > 1)
    writes = multihost.local_rank() == 0
    feat = FeatureConfig(n_mels=cfg.num_mel_bins)
    ccfg = CollatorConfig(n_samples=feat.n_samples)

    if arg.text_lang_task:
        lang_tasks = [tuple(p.split(":")) for p in arg.text_lang_task.split(",")]
    else:
        lang_tasks = [(arg.language, arg.task)]
    gen_defaults = common.load_generation_defaults(arg.model)
    task_opts = {
        f"{task}.{lang}": GenerateOptions(
            prompt_ids=tuple(
                tok.sot_sequence(lang, task, timestamps=arg.return_timestamps)
            ),
            max_length=arg.max_label_length,
            return_timestamps=arg.return_timestamps,
            **gen_defaults,
        )
        for lang, task in lang_tasks
    }

    def wire(a: np.ndarray) -> np.ndarray:
        if arg.wire_dtype == "int16":
            return np.clip(np.round(a * 32768.0), -32768, 32767).astype(np.int16)
        return a

    def gather(toks: np.ndarray) -> np.ndarray:
        """The host's rows from its ranks' (data block, model rank) parts,
        in batch order (model rank 0's copy of each block)."""
        group = multihost.host_group()
        toks = multihost.pad_across_processes(toks, 1, cfg.pad_token_id, group)
        parts = multihost.all_gather_host(toks, group)
        parts = parts.reshape(arg.num_devices, arg.mesh_model_axis, *toks.shape)
        return parts[:, 0].reshape(-1, toks.shape[1])

    def generate(batch_audio: np.ndarray) -> dict[str, np.ndarray]:
        if mesh is not None:
            batch_audio = sharded.place_batch(mesh, batch_audio, hosts)
        mel = log_mel_spectrogram(wire(batch_audio), feat, device=dev).to(dtype)
        out = {}
        for key, opts in task_opts.items():
            if arg.num_beams > 1:
                toks, _ = generate_beam(model, mel, opts, tok.special, num_beams=arg.num_beams,
                                        kv_dtype=arg.kv_dtype, device=dev)
            else:
                toks = generate_greedy(model, mel, opts, tok.special, kv_dtype=arg.kv_dtype,
                                       device=dev)
            out[key] = toks.cpu().numpy() if mesh is None else gather(toks.cpu().numpy())
        return out

    chunk_range = (
        (arg.chunk_lo, arg.chunk_hi)
        if arg.chunk_lo is not None and arg.chunk_hi is not None
        else None
    )
    utts = reazon.iter_dataset_dir(arg.dataset_dir, chunk_range=chunk_range,
                                   shard_slice=(multihost.host_index(), hosts) if hosts > 1
                                   else None)
    out_dir = (os.path.join(arg.output_dir, f"rank-{multihost.host_index()}") if hosts > 1
               else arg.output_dir)
    os.makedirs(out_dir, exist_ok=True)
    jsonl_path = os.path.join(out_dir, "pseudo_labels.jsonl")
    csv_path = os.path.join(out_dir, "pseudo_labels.csv")
    # this card's rate: the audio of its rows, shared by its model group
    tp = Throughput(n_cards=arg.mesh_model_axis)
    tp.start()
    n_done = 0

    def host_batches():
        """Audio decode + collation, run ahead on a background thread."""
        for batch in common.batched(utts, arg.batch_size):
            good, audio = [], []
            for u in batch:
                try:
                    wav, _ = native.decode_audio(u.audio_bytes, feat.sampling_rate)
                except ValueError:
                    print(f"warning: skipping undecodable audio {u.name}",
                          file=sys.stderr)
                    continue
                good.append(u)
                audio.append(wav)
            if good:
                yield good, audio, collate_audio(audio, ccfg)

    main_key = next(iter(task_opts))

    def make_record(u, wav, per_task, bi, writer):
        record = {"name": u.name, "transcription": u.transcription}
        for key, toks in per_task.items():
            ids = toks[bi].tolist()
            if tok.special.eot in ids:
                ids = ids[: ids.index(tok.special.eot) + 1]
            col = (
                "whisper_transcript"
                if not arg.text_lang_task
                else f"whisper_transcript/{key}"
            )
            record[col] = ids
            if key == main_key and writer is not None:
                text = tok.decode(
                    ids, skip_special_tokens=False, decode_with_timestamps=True,
                )
                writer.writerow([u.name, text])
        return record

    def rows_lockstep(writer):
        nonlocal n_done
        for batch, audio, arr in common.prefetch(host_batches()):
            if arg.limit is not None and n_done >= arg.limit:
                break
            if arr.shape[0] < arg.batch_size:
                # pad ragged batches to the full width: one shape
                pad_rows = arg.batch_size - arr.shape[0]
                arr = np.concatenate(
                    [arr, np.zeros((pad_rows,) + arr.shape[1:], arr.dtype)]
                )
            per_task = generate(arr)
            own = (sharded.place_batch(mesh, np.arange(arr.shape[0]), hosts) if mesh is not None
                   else range(len(batch)))
            tp.add(sum(len(audio[bi]) for bi in own if bi < len(batch)) / feat.sampling_rate)
            for bi, (u, wav) in enumerate(zip(batch, audio)):
                n_done += 1
                yield make_record(u, wav, per_task, bi, writer)

    def rows_streaming(writer):
        """Continuous batching: gather a super-batch of utterances, decode
        it with row (greedy) or beam-group refill (the cost follows the
        mean label length), emit the records in input order."""
        nonlocal n_done
        if arg.num_beams > 1:
            groups = max(arg.batch_size // arg.num_beams, 1)
            bcfg = BeamStreamConfig(groups=groups, num_beams=arg.num_beams,
                                    encode_batch=max(min(groups // 2, 8), 1), steps_per_round=8)
            encode_batch, super_n = bcfg.encode_batch, groups * 4
        else:
            scfg = StreamConfig(batch=arg.batch_size, encode_batch=min(16, arg.batch_size),
                                steps_per_round=8)
            encode_batch, super_n = scfg.encode_batch, arg.batch_size * 4

        def decode_stream(mels, opts):
            if arg.num_beams > 1:
                toks, _ = generate_beam_streaming(model, mels, opts, tok.special,
                                                  kv_dtype=arg.kv_dtype, stream=bcfg, device=dev)
                return toks
            return generate_greedy_streaming(model, mels, opts, tok.special,
                                             kv_dtype=arg.kv_dtype, stream=scfg, device=dev)

        def flush(buf):
            nonlocal n_done
            mels = torch.cat([
                log_mel_spectrogram(wire(np.stack([row for _, _, row in chunk])), feat,
                                    device=dev)
                for chunk in common.batched(buf, encode_batch)
            ])
            per_task = {key: decode_stream(mels, opts) for key, opts in task_opts.items()}
            tp.add(sum(len(wav) for _, wav, _ in buf) / feat.sampling_rate)
            for bi, (u, wav, _) in enumerate(buf):
                n_done += 1
                yield make_record(u, wav, per_task, bi, writer)

        buf = []
        for batch, audio, arr in common.prefetch(host_batches()):
            for bi, (u, wav) in enumerate(zip(batch, audio)):
                if arg.limit is not None and n_done + len(buf) >= arg.limit:
                    break
                buf.append((u, wav, arr[bi]))
            if len(buf) >= super_n:
                yield from flush(buf[:super_n])
                buf = buf[super_n:]
            if arg.limit is not None and n_done + len(buf) >= arg.limit:
                break
        if buf:
            yield from flush(buf)

    streaming = arg.streaming and mesh is None
    if arg.streaming and not streaming:
        print("warning: --streaming needs a single device; using lockstep batching",
              file=sys.stderr)

    def rows():
        if not writes:
            yield from (rows_streaming if streaming else rows_lockstep)(None)
            return
        with open(csv_path, "w", newline="") as cf:
            writer = csv.writer(cf)
            writer.writerow(["file_id", "whisper_transcript"])
            yield from (rows_streaming if streaming else rows_lockstep)(writer)

    if writes:
        n = common.write_jsonl(jsonl_path, rows())
    else:
        n = sum(1 for _ in rows())
    rate = tp.rate()
    if hosts > 1:
        multihost.barrier("pseudo_label_done")
        if multihost.is_main_process():
            n = _merge_rank_outputs(arg.output_dir, hosts, common)
        multihost.barrier("pseudo_label_merged")
    if writes:
        print(
            f"pseudo-labelled {n} utterances -> {jsonl_path} "
            f"({rate:.1f} audio-s/s/card on {dev})"
        )


def _merge_rank_outputs(output_dir: str, n_hosts: int, common) -> int:
    """Merge the hosts' rank-K/ files into top-level files, ordered by
    utterance name (the same order whatever the host count)."""
    records = []
    for k in range(n_hosts):
        records.extend(common.read_jsonl(
            os.path.join(output_dir, f"rank-{k}", "pseudo_labels.jsonl")))
    records.sort(key=lambda r: r["name"])
    n = common.write_jsonl(os.path.join(output_dir, "pseudo_labels.jsonl"), iter(records))
    csv_rows = []
    for k in range(n_hosts):
        with open(os.path.join(output_dir, f"rank-{k}", "pseudo_labels.csv"),
                  newline="") as f:
            rd = csv.reader(f)
            next(rd, None)  # header
            csv_rows.extend(rd)
    csv_rows.sort(key=lambda r: r[0])
    with open(os.path.join(output_dir, "pseudo_labels.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["file_id", "whisper_transcript"])
        w.writerows(csv_rows)
    return n


if __name__ == "__main__":
    main()
