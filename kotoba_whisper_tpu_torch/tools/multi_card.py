"""The drivers' parallel paths on several cards of one host, against one
card: stage 2 (`pseudo-label`) and stage 5 (`distill`) through `python -m
kotoba_whisper_tpu_torch`, one process a card over NCCL, as a user runs
them (with --device cpu, one gloo process a rank on the CPU instead).

    python -m kotoba_whisper_tpu_torch.tools.multi_card [--cards 4]
        [--model preset:large-v3] [--device cuda]

Seeded synthetic data under a temporary directory: 32 utterances of 2-7 s
of noise in 4 tar shards (stage 2), and a split of 32 rows of seeded
log-mel features with label sequences of 8-64 tokens (stage 5).

- Stage 2 on one card, then --num_devices N (data parallel), then
  --num_devices N/2 --mesh_model_axis 2 (the teacher over 2 cards): batch
  16, int8 KV, 24 tokens. Each run's wall is the driver's whole process
  (start, rank spawn, model build, decode, files); its files must hold the
  one-card run's utterances in the same order, and the share of label
  sequences equal to the one-card run's is reported (bf16 rounding of
  another batch split flips near-tied tokens).
- Stage 5: create-student (2 decoder layers), then distill 4 steps at a
  global batch of 8: 8 rows on one card, 8 / N a card on N cards. The
  logged losses must agree with one card's within 5e-2 (relative; bf16
  sums over other splits); ms a step is the driver's logged time of steps
  2-4.

One JSON line a run with nvidia-smi's card name and power limit (on the
card); a failed check exits nonzero after its line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def _cli(args: list[str], timeout: int) -> tuple[float, str]:
    """Run `python -m kotoba_whisper_tpu_torch <args>`; (wall s, output)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "kotoba_whisper_tpu_torch", *args],
                       capture_output=True, text=True, timeout=timeout)
    if r.returncode:
        raise RuntimeError(f"{args[0]} failed ({r.returncode}):\n{r.stdout[-3000:]}"
                           f"\n{r.stderr[-3000:]}")
    return time.perf_counter() - t0, r.stdout


def _card() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return None


def write_data(root: str, cfg, seed: int = 0) -> tuple[str, str, float]:
    """-> (tar dataset dir, split dir, seconds of audio)."""
    from kotoba_whisper_tpu_torch.data import reazon
    from kotoba_whisper_tpu_torch.data.shards import ShardWriter

    rng = np.random.default_rng(seed)
    data = os.path.join(root, "data")
    os.makedirs(data)
    secs = 0.0
    for s in range(4):
        utts = []
        for i in range(8):
            n = int(rng.integers(2 * 16000, 7 * 16000))
            secs += n / 16000
            utts.append((f"{s:03d}/utt{i}.wav", reazon.wav_bytes(rng.standard_normal(n) * 0.1)))
        reazon.write_tar_shard(os.path.join(data, f"{s:03d}.tar"), utts)
    split = os.path.join(root, "split")
    w = ShardWriter(split, shard_size=8)
    for i in range(32):
        labels = [cfg.decoder_start_token_id,
                  *rng.integers(10, min(cfg.vocab_size, 5000), int(rng.integers(8, 65))).tolist(),
                  cfg.eos_token_id]
        feats = rng.standard_normal((cfg.num_mel_bins, 2 * cfg.max_source_positions))
        w.add({"name": f"utt{i}", "labels": labels}, feats.astype(np.float32))
    w.close()
    return data, split, secs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--model", default="preset:large-v3")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=int, default=900, help="seconds a driver run may take")
    args = ap.parse_args(argv)
    from kotoba_whisper_tpu_torch.core.config import PRESETS

    cfg = PRESETS[args.model.split(":", 1)[1]]
    n = args.cards
    card = _card() if args.device == "cuda" else None
    dtype = ["--dtype", "bfloat16" if args.device == "cuda" else "float32"]
    dev = ["--device", args.device] + dtype
    ok = True

    def emit(rec: dict) -> None:
        print(json.dumps({**rec, "card": card}), flush=True)

    with tempfile.TemporaryDirectory() as root:
        data, split, secs = write_data(root, cfg)
        # the byte tokenizer in the model's id layout (100 languages at 51866)
        tok = f"byte:{cfg.vocab_size}" if cfg.vocab_size >= 51865 else "byte"
        base = ["pseudo-label", "--dataset_dir", data, "--model", args.model, "--tokenizer",
                tok, "--batch_size", "16", "--max_label_length", "24",
                "--kv_dtype", "int8", *dev]
        runs = {}
        for label, extra in (("1 card", []), (f"DP={n}", ["--num_devices", str(n)]),
                             (f"DP={n // 2} x TP=2", ["--num_devices", str(n // 2),
                                                      "--mesh_model_axis", "2"])):
            out = os.path.join(root, f"pl{len(runs)}")
            wall, said = _cli(base + ["--output_dir", out, *extra], args.timeout)
            with open(os.path.join(out, "pseudo_labels.jsonl")) as f:
                runs[label] = [json.loads(line) for line in f]
            one = runs["1 card"]
            same_order = [r["name"] for r in runs[label]] == [r["name"] for r in one]
            equal = sum(a["whisper_transcript"] == b["whisper_transcript"]
                        for a, b in zip(runs[label], one)) / len(one)
            ok &= same_order and len(runs[label]) == 32
            emit({"stage": 2, "run": label, "wall_s": wall, "audio_s": secs,
                  "audio_s_per_s": secs / wall, "utterances": len(runs[label]),
                  "one_card_order": same_order, "share_equal_to_one_card": equal,
                  "driver": said.strip().splitlines()[-1:]})

        student = os.path.join(root, "student")
        _cli(["create-student", "--teacher", args.model, "--save_dir", student,
              "--decoder_layers", "2", *dev], args.timeout)
        logged = {}
        for label, extra in (("1 card", ["--per_device_train_batch_size", "8",
                                          "--num_devices", "1"]),
                             (f"DP={n}", ["--per_device_train_batch_size", str(8 // n),
                                          "--num_devices", str(n)])):
            out = os.path.join(root, f"run{len(logged)}")
            wall, _ = _cli(["distill", "--train_splits", split, "--student", student,
                            "--teacher", args.model, "--output_dir", out, "--max_steps", "4",
                            "--max_label_length", "64", "--warmup_steps", "1",
                            "--logging_steps", "1", "--save_steps", "100", "--no_prefetch",
                            *extra, *dev], args.timeout)
            with open(os.path.join(out, "metrics.run.jsonl")) as f:
                logged[label] = [json.loads(line) for line in f]
            losses = [r["train/loss"] for r in logged[label]]
            ref = [r["train/loss"] for r in logged["1 card"]]
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
            ok &= len(losses) == 4 and bool(np.isfinite(losses).all()) and rel <= 5e-2
            emit({"stage": 5, "run": label, "wall_s": wall, "global_batch": 8,
                  "ms_a_step": 1e3 * float(np.mean([r["train/time"]
                                                    for r in logged[label][1:]])),
                  "losses": losses, "max_rel_to_one_card": rel})
    emit({"ok": bool(ok), "cards": n, "model": args.model, "device": args.device})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
