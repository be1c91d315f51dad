"""Materialize an eval dataset into a framework-consumable layout.

Two modes:

1. Generic conversion (default): any layout data/eval_sets.py understands
   (HF saved-to-disk, jsonl manifest, tar+tsv) -> the canonical tar+tsv
   layout with 16 kHz WAV members. The reference pulls its ja_asr suites
   (common_voice_8_0, jsut_basic5000, reazonspeech_test) from the Hub at
   eval time; this materializes them once.

2. ESB corpus preparation (--corpus <name>): build one of the 8 English
   ESB eval corpora from its RAW distribution layout, with the
   reference's per-corpus transcript-cleanup semantics (data/esb.py,
   mirroring misc/esb_test.py:331-1105). Emits manifest.jsonl referencing
   the raw audio in place (eval reads manifests directly); add --to_tar
   to also convert it to tar+tsv under <output_dir>/tar.

Usage:
  python -m kotoba_whisper_tpu_torch.cli.prepare_eval_set \
      --input /data/hf/reazonspeech_test --output_dir /data/reazonspeech_test
  python -m kotoba_whisper_tpu_torch.cli.prepare_eval_set \
      --corpus librispeech --split test.clean --to_tar \
      --input /data/raw/LibriSpeech/test-clean --output_dir /data/esb/librispeech
"""
from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--input", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--shard_size", type=int, default=512,
                    help="utterances per tar shard")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--corpus", default=None,
                    help="ESB corpus name (ami/spgispeech/voxpopuli/"
                    "tedlium/gigaspeech/librispeech/common_voice/"
                    "earnings22): prepare from the raw distribution "
                    "layout instead of generic conversion")
    ap.add_argument("--split", default=None,
                    help="corpus split for --corpus (per-corpus default)")
    ap.add_argument("--to_tar", action="store_true",
                    help="with --corpus: also convert the manifest to "
                    "the tar+tsv layout")
    arg = ap.parse_args(argv)

    if arg.corpus:
        from kotoba_whisper_tpu_torch.data.esb import prepare_corpus

        n = prepare_corpus(arg.corpus, arg.input, arg.output_dir, arg.split)
        print(f"prepared {n} {arg.corpus} utterances -> "
              f"{arg.output_dir}/manifest.jsonl")
        if not arg.to_tar:
            return
        arg.input = arg.output_dir  # fall through: manifest -> tar+tsv
        arg.output_dir = os.path.join(arg.output_dir, "tar")

    from kotoba_whisper_tpu_torch.data.eval_sets import iter_eval_set
    from kotoba_whisper_tpu_torch.data.reazon import wav_bytes, write_tar_shard

    os.makedirs(arg.output_dir, exist_ok=True)
    tsv_rows: list[str] = []
    shard: list[tuple[str, bytes]] = []
    shard_idx = 0
    n = 0

    def flush():
        nonlocal shard, shard_idx
        if shard:
            write_tar_shard(
                os.path.join(arg.output_dir, f"{shard_idx:03x}.tar"), shard
            )
            shard_idx += 1
            shard = []

    for ex in iter_eval_set(arg.input, limit=arg.limit):
        name = f"{shard_idx:03x}/utt{n}.wav"
        shard.append((name, wav_bytes(ex.audio)))
        text = ex.text.replace("\t", " ").replace("\n", " ")
        tsv_rows.append(f"{name}\t{text}")
        n += 1
        if len(shard) >= arg.shard_size:
            flush()
    flush()

    with open(os.path.join(arg.output_dir, "transcript.tsv"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(tsv_rows) + ("\n" if tsv_rows else ""))
    print(f"wrote {n} utterances in {shard_idx} shard(s) -> {arg.output_dir}")


if __name__ == "__main__":
    main()
