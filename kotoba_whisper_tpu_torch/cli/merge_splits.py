"""Stage-4 driver: merge per-chunk filter outputs into split_N groups.

Counterpart of misc/merge_reazon_all_dataset.py (the reference merges 82
per-chunk Hub datasets into `split_N` configs of 10 chunks each, :11-79)
plus misc/preprocess_status_log.py's chunk-completion audit (--status).
Output is the sharded mmap layout (data/shards.py) that cli/distill.py
streams with bounded memory.
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--work_dir", required=True,
                    help="dir containing chunk_<i>/filtered stage outputs")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--n_chunks", type=int, default=82)
    ap.add_argument("--chunks_per_split", type=int, default=10)
    ap.add_argument("--shard_size", type=int, default=2048)
    ap.add_argument("--status", action="store_true",
                    help="only print the chunk-completion audit and exit")
    ap.add_argument("--allow_missing", action="store_true",
                    help="merge whatever chunks exist instead of failing")
    arg = ap.parse_args(argv)

    from kotoba_whisper_tpu_torch.data.merge import chunk_status, merge_chunks

    status = chunk_status(arg.work_dir, arg.n_chunks)
    if arg.status:
        print(json.dumps(status))
        return
    if status["missing"] and not arg.allow_missing:
        raise SystemExit(
            f"chunks missing filter output: {status['missing']} "
            f"(use --allow_missing to merge the {len(status['done'])} done)"
        )
    chunk_dirs = [
        os.path.join(arg.work_dir, f"chunk_{i}", "filtered")
        for i in status["done"]
    ]
    splits = merge_chunks(
        chunk_dirs, arg.output_dir,
        chunks_per_split=arg.chunks_per_split, shard_size=arg.shard_size,
    )
    print(json.dumps({"splits": splits, "n_chunks": len(chunk_dirs)}))


if __name__ == "__main__":
    main()
