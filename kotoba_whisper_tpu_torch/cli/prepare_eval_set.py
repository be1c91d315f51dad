"""Materialize an eval dataset into the tar+tsv layout.

Generic conversion: any layout data/eval_sets.py understands (HF
saved-to-disk, jsonl manifest, tar+tsv) -> the canonical tar+tsv layout
with 16 kHz WAV members. The reference pulls its ja_asr suites
(common_voice_8_0, jsut_basic5000, reazonspeech_test) from the Hub at
eval time; this materializes them once. The JAX driver's ESB corpus
preparation (--corpus, from a corpus's raw distribution layout) is not
ported yet and raises so.

Usage:
  python -m kotoba_whisper_tpu_torch.cli.prepare_eval_set \
      --input /data/hf/reazonspeech_test --output_dir /data/reazonspeech_test
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
                    help="ESB corpus name: prepare from the raw distribution "
                    "layout (not ported yet)")
    arg = ap.parse_args(argv)

    if arg.corpus:
        raise SystemExit(f"prepare_eval_set: --corpus {arg.corpus} (data/esb.py) is not "
                         "ported yet")

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
