"""Stage-3 driver: WER filtering + label preparation + log-mel vectorize.

Counterpart of run_data_filtering.py (semantics in data/filtering.py):
reads pseudo_labels.jsonl, drops rows whose pseudo-label WER vs. ground
truth exceeds the threshold, samples timestamp/prompt conditioning, applies
audio/label length filters, and emits filtered.jsonl + features.npz (the
`.vectorized` stage — computed on the card in batches by the log-mel
kernel K3 rather than in CPU worker pools). The JAX driver's flags, plus
--device.

Usage:
  python -m kotoba_whisper_tpu_torch.cli.data_filter \
      --dataset_dir /data/reazon --labels out/pseudo_labels.jsonl \
      --output_dir filtered/ --tokenizer byte:51866 --n_mels 128 \
      --wire_dtype int16
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset_dir", required=True, help="tar shards + tsv")
    ap.add_argument("--labels", required=True, help="pseudo_labels.jsonl")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--tokenizer", default="byte")
    ap.add_argument("--language", default="ja")
    ap.add_argument("--wer_threshold", type=float, default=10.0)
    ap.add_argument("--timestamp_probability", type=float, default=0.2)
    ap.add_argument("--condition_on_prev_probability", type=float, default=0.2)
    ap.add_argument("--max_label_length", type=int, default=128)
    ap.add_argument("--max_duration_in_seconds", type=float, default=30.0)
    ap.add_argument("--min_duration_in_seconds", type=float, default=0.0)
    ap.add_argument("--n_mels", type=int, default=80)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--wire_dtype", default="float32",
                    choices=["float32", "int16"],
                    help="int16 PCM upload for the on-device log-mel "
                    "stage (see pseudo_label --wire_dtype)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; with no card and no "
                    "--device cpu the driver raises")
    ap.add_argument("--skip_filtering", action="store_true")
    ap.add_argument("--skip_logmel", action="store_true")
    ap.add_argument(
        "--label_column", default="whisper_transcript",
        help="transcript column(s) to process, comma-separated — v3 "
        "bilingual datasets carry one column per (task, lang), e.g. "
        "'whisper_transcript/transcribe.ja,whisper_transcript/translate.en' "
        "(run_data_filtering_v3.py:161-223 semantics). With several "
        "columns, each is label-prepared into its own labels/<key> output "
        "column; the WER filter applies to the first column.",
    )
    arg = ap.parse_args(argv)

    from kotoba_whisper_tpu_torch.cli import common
    from kotoba_whisper_tpu_torch.core.config import FeatureConfig
    from kotoba_whisper_tpu_torch.core.device import resolve_device
    from kotoba_whisper_tpu_torch.data import filtering, reazon
    from kotoba_whisper_tpu_torch.data.collator import CollatorConfig, collate_audio
    from kotoba_whisper_tpu_torch.eval.normalizers import make_normalizer
    from kotoba_whisper_tpu_torch.ops.mel import log_mel_spectrogram
    from kotoba_whisper_tpu_torch.utils import native

    dev = resolve_device(arg.device)
    tok = common.load_tokenizer(arg.tokenizer)
    norm = make_normalizer(arg.language)
    fcfg = filtering.FilterConfig(
        wer_threshold=arg.wer_threshold,
        timestamp_probability=arg.timestamp_probability,
        condition_on_prev_probability=arg.condition_on_prev_probability,
        max_label_length=arg.max_label_length,
        min_duration_s=arg.min_duration_in_seconds,
        max_duration_s=arg.max_duration_in_seconds,
        seed=arg.seed,
    )
    feat = FeatureConfig(n_mels=arg.n_mels)
    columns = [c.strip() for c in arg.label_column.split(",") if c.strip()]
    multi = len(columns) > 1
    # one LabelPreparer per column: prompt-conditioning history is
    # per-column (the reference processes columns independently)
    preps = {c: filtering.LabelPreparer(tok, fcfg) for c in columns}

    by_name = {r["name"]: r for r in common.read_jsonl(arg.labels)}

    kept_rows = []
    kept_audio = []
    n_total = n_wer_dropped = n_len_dropped = 0
    for u in reazon.iter_dataset_dir(arg.dataset_dir):
        row = by_name.get(u.name)
        if row is None:
            continue
        n_total += 1
        col_ids = {c: row.get(c) for c in columns}
        if any(v is None for v in col_ids.values()):
            continue
        if not arg.skip_filtering:
            # WER gate on the primary (transcribe) column
            if not filtering.is_wer_in_range(
                u.transcription or row.get("transcription") or "",
                col_ids[columns[0]], tok, norm, arg.wer_threshold,
            ):
                n_wer_dropped += 1
                continue
        try:
            audio, _ = native.decode_audio(u.audio_bytes, feat.sampling_rate)
        except ValueError:
            n_len_dropped += 1
            continue
        labels_by_col = {
            c: preps[c].prepare(ids) for c, ids in col_ids.items()
        }
        prep0 = preps[columns[0]]
        if not (
            prep0.audio_in_range(len(audio))
            and all(prep0.labels_in_range(l) for l in labels_by_col.values())
        ):
            n_len_dropped += 1
            continue
        if multi:
            out_row = {"name": u.name}
            for c, l in labels_by_col.items():
                key = c.split("/", 1)[1] if "/" in c else c
                out_row[f"labels/{key}"] = l
        else:
            out_row = {"name": u.name, "labels": labels_by_col[columns[0]]}
        kept_rows.append(out_row)
        kept_audio.append(audio)

    os.makedirs(arg.output_dir, exist_ok=True)
    out_jsonl = os.path.join(arg.output_dir, "filtered.jsonl")
    common.write_jsonl(out_jsonl, iter(kept_rows))

    if not arg.skip_logmel and kept_audio:
        ccfg = CollatorConfig(n_samples=feat.n_samples)
        feats = []
        for batch in common.batched(kept_audio, arg.batch_size):
            arr = collate_audio(batch, ccfg)
            if arg.wire_dtype == "int16":
                arr = np.clip(
                    np.round(arr * 32768.0), -32768, 32767
                ).astype(np.int16)
            feats.append(
                log_mel_spectrogram(arr, feat, device=dev).cpu().numpy().astype(np.float16)
            )
        features = np.concatenate(feats, axis=0)
        np.savez(
            os.path.join(arg.output_dir, "features.npz"),
            input_features=features,
        )

    print(
        f"kept {len(kept_rows)}/{n_total} "
        f"(wer-dropped {n_wer_dropped}, length-dropped {n_len_dropped}) "
        f"-> {out_jsonl}"
    )


if __name__ == "__main__":
    main()
