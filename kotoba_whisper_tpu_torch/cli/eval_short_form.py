"""Stage-6 driver: short-form CER/WER evaluation.

Counterpart of run_short_form_eval.py: loads an eval set (tar shards + TSV
transcripts), runs the chunked ASR pipeline (decode/pipeline.py), and
writes prediction CSVs + metric JSONL records (eval/shortform.py owns the
schema). The flags mirror the JAX driver's; --device is the port's. Not
ported yet, and raising so: a NeMo model spec (the baseline zoo's
ReazonSpeech model) and --cascaded_mt (the ASR -> MT translation cascade).

Usage:
  python -m kotoba_whisper_tpu_torch.cli.eval_short_form \
      --model student/ --tokenizer byte --dataset_dir /data/eval_set \
      --output_dir eval_pipeline [--stable_ts --punctuator]
"""
from __future__ import annotations

import argparse

# model names that the JAX driver routes to its NeMo baseline adapter
# (run_short_form_eval.py:171)
NEMO_MODELS = ("reazon-research/reazonspeech-nemo-v2", "nemo-v2")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True)
    ap.add_argument("--tokenizer", default="byte")
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--dataset_name", default=None)
    ap.add_argument("--language", default="ja")
    ap.add_argument("--task", default="transcribe")
    ap.add_argument("--chunk_length_s", type=float, default=15.0)
    ap.add_argument("--num_beams", type=int, default=1)
    ap.add_argument("--output_dir", default="eval_pipeline")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--kv_dtype", default="compute",
                    choices=["compute", "int8", "int4"])
    ap.add_argument("--gemm_dtype", default="compute",
                    choices=["compute", "int8"],
                    help="int8: w8a8 dense projections (models/quantized.py)")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--punctuator", action="store_true",
                    help="apply the punctuation add-on to pipeline chunks "
                    "(the v1.1/v2.1 eval variants)")
    ap.add_argument("--stable_ts", action="store_true",
                    help="apply timestamp repair to pipeline chunks")
    ap.add_argument("--no_fuse", action="store_true",
                    help="skip the lossless inference projection fusion")
    ap.add_argument("--cascaded_mt", default=None,
                    help="NLLB/M2M100 checkpoint dir for the cascaded "
                    "ASR->MT translation pipeline (not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; with no card and no --device cpu "
                    "the driver raises")
    arg = ap.parse_args(argv)

    if arg.model in NEMO_MODELS:
        raise SystemExit(f"eval_short_form: the NeMo baseline model {arg.model!r} is not "
                         "ported yet")
    if arg.cascaded_mt:
        raise SystemExit("eval_short_form: --cascaded_mt is not ported yet")

    from kotoba_whisper_tpu_torch.cli import common
    from kotoba_whisper_tpu_torch.core.device import resolve_device

    dev = resolve_device(arg.device)
    pipe = common.serving_pipeline(arg, dev, language=arg.language,
                                   task=arg.task, num_beams=arg.num_beams)

    transcribe = pipe.transcribe
    if arg.punctuator or arg.stable_ts:
        from kotoba_whisper_tpu_torch.eval.punctuator import Punctuator
        from kotoba_whisper_tpu_torch.eval.timestamp_repair import fix_timestamps

        # real pcs_47lang ONNX model when installed, rule-based otherwise
        punct = Punctuator.default() if arg.punctuator else None

        def transcribe(audio):  # noqa: F811 — add-on composition
            out = pipe(audio)
            chunks = out["chunks"]
            if arg.stable_ts:
                # None-fill + monotonicity + silence-based boundary
                # adjustment on the waveform (stable_timestamp.py:60-75)
                chunks = fix_timestamps(chunks, audio, 16000)
            if punct is not None:
                chunks = punct.punctuate(chunks)
            return "".join(c["text"] for c in chunks) if chunks else out["text"]

    _run_eval(arg, transcribe)


def _run_eval(arg, transcribe) -> None:
    """Load the eval set, run `transcribe`, write artifacts."""
    from kotoba_whisper_tpu_torch.data import reazon
    from kotoba_whisper_tpu_torch.eval.shortform import (
        EvalExample,
        evaluate_short_form,
    )
    from kotoba_whisper_tpu_torch.utils import native

    examples = []
    for u in reazon.iter_dataset_dir(arg.dataset_dir):
        if u.transcription is None:
            continue
        audio, _ = native.decode_audio(u.audio_bytes, 16000)
        examples.append(EvalExample(audio, u.transcription, u.name))
        if arg.limit is not None and len(examples) >= arg.limit:
            break

    record = evaluate_short_form(
        examples,
        transcribe,
        model_name=arg.model,
        dataset_name=arg.dataset_name or arg.dataset_dir,
        language=arg.language,
        task=arg.task,
        output_dir=arg.output_dir,
        punctuator=arg.punctuator,
        stable_ts=arg.stable_ts,
    )
    print(record)


if __name__ == "__main__":
    main()
